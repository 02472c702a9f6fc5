"""The SA-GAN of awentzonline/tartangan (``GAN_CONFIGS``' residual towers
with self-attention), trained by tartangan_torch's ``CNNTrainer``, and
its plain reference ``portbench/reference.py`` (see ``models/__init__.py``
for what a model module gives).

The counts. A step (``portbench/reference.py``) is a D step, on reals
(with R1 when its weight is not 0) and on G's fakes, then a G step
through D. Each convolution or dense layer of forward FLOPs F = 2 B H W
Cin Cout k^2 (output H W) is counted, with no recomputation, as:

- G in the D step: forward (F).
- D on the reals with R1: forward, the input gradient R1 takes (F each),
  then the backward through both: the input-gradient convolution's two
  derivatives (2F) and the forward's weight and input gradients (2F; the
  image's input gradient is not needed). Without R1: forward, weight and
  input gradient (3F; the first layer's input gradient not needed).
- D on the fakes: forward, weight and input gradient (3F; not the first
  layer's input gradient).
- The G step: G forward, weight and input gradient (3F; not the dense
  input layer's input gradient), D forward and input gradient (2F).
"""
from __future__ import annotations

import torch

from portbench import reference, weights
from portbench.flops import Attention, Conv

# the step's draws, (state, batch, z_d, z_g): z_d (iters_d, B, latent),
# z_g (B, latent)
DRAWS = {"z_d": 1, "z_g": 0}


def trainer_class():
    from tartangan_torch.train.cnn import CNNTrainer
    return CNNTrainer


def trainer_argv(cfg: dict, traffic: dict, data_path: str, out_dir: str,
                 seed: int, device: str) -> list:
    """The CLI flags of the run: the configuration's and the traffic's,
    every training setting spelled out."""
    hp = cfg["train"]
    return [data_path, "--config", cfg["program_config"],
            "--batch-size", str(traffic["batch_size"]),
            "--dtype", cfg["dtype"], "--parity-blocks", cfg["parity_blocks"],
            "--g-base", "mlp", "--norm", "bn", "--activation", "relu",
            "--lr-g", repr(hp["lr_g"]), "--lr-d", repr(hp["lr_d"]),
            "--lr-target-g", repr(hp["ema"]),
            "--grad-penalty", repr(hp["grad_penalty"]),
            "--r1-interval", str(traffic["r1_interval"]), "--iters-d", "1",
            "--steps-per-call", "1", "--ema-start", "copy",
            "--seed", str(seed), "--output", out_dir, "--run-id", "portbench",
            "--quiet-logs", "--epochs", str(10 ** 9), "--device", device]


ARCH_KEYS = ("base_size", "latent_dims", "data_dims", "blocks", "attention")


def programs_config(cfg: dict) -> dict:
    """The configuration's shapes as the program's ``GAN_CONFIGS`` entry
    has them."""
    from tartangan_torch.configs import GAN_CONFIGS
    prog = GAN_CONFIGS[cfg["program_config"]]
    return {"base_size": prog.base_size, "latent_dims": prog.latent_dims,
            "data_dims": prog.data_dims, "blocks": list(prog.blocks),
            "attention": list(prog.attention),
            "num_blocks_per_scale": prog.num_blocks_per_scale}


def architecture(cfg: dict) -> dict:
    return {k: cfg[k] for k in ARCH_KEYS}


def image_size(arch: dict) -> int:
    return arch["base_size"] * 2 ** len(arch["blocks"])


def make_weights(arch: dict, hp: dict, seed: int, device) -> dict:
    return weights.make(reference.build(arch, hp), seed, device)


def draws(gen, b: int, arch: dict, device) -> dict:
    """One step's latents in the order the trainer draws them: z_d's one D
    update, then z_g."""
    z = [torch.randn(b, arch["latent_dims"], generator=gen, device=device)
         for _ in range(2)]
    return {"z_d": z[0][None], "z_g": z[1]}


# ---------------------------------------------------------------- counts
def _attention(name, b, c, res):
    return Attention(name, b, res * res, res * res // 4, max(c // 8, 1),
                     max(c // 2, 1))


def _attention_convs(name, b, c, res):
    ck, cv = max(c // 8, 1), max(c // 2, 1)
    return [Conv(f"{name}.{n}", b, ci, co, 1, res, res, res, res)
            for n, ci, co in (("theta", c, ck), ("phi", c, ck),
                              ("g", c, cv), ("o", cv, c))]


def generator_layers(cfg: dict, b: int):
    """(convs and dense layers in forward order, attentions) of G."""
    base, blocks = cfg["base_size"], cfg["blocks"]
    convs = [Conv("g.dense", b, cfg["latent_dims"], base * base * blocks[0],
                  1, 1, 1, 1, 1, dense=True)]
    attns, cin, res = [], blocks[0], base
    for i, cout in enumerate(blocks):
        r = res * 2
        convs += [Conv(f"g.{i}.conv0", b, cin, cout, 3, r, r, r, r),
                  Conv(f"g.{i}.conv1", b, cout, cout, 3, r, r, r, r)]
        if cin != cout:
            convs.append(Conv(f"g.{i}.proj", b, cin, cout, 1, r, r, r, r))
        if i in cfg["attention"]:
            convs += _attention_convs(f"g.{i}.attn", b, cout, r)
            attns.append(_attention(f"g.{i}.attn", b, cout, r))
        cin, res = cout, r
    convs.append(Conv("g.out", b, cin, cfg["data_dims"], 1, res, res, res,
                      res))
    return convs, attns


def discriminator_layers(cfg: dict, b: int):
    """(convs and dense layers in forward order, attentions) of D."""
    blocks = cfg["blocks"]
    res = cfg["base_size"] * 2 ** len(blocks)
    convs = [Conv("d.in", b, cfg["data_dims"], blocks[-1], 1, res, res, res,
                  res)]
    attns, cin = [], blocks[-1]
    for i in reversed(range(len(blocks))):
        cout, half = blocks[i], res // 2
        convs += [Conv(f"d.{i}.conv0", b, cin, cout, 3, res, res, res, res),
                  Conv(f"d.{i}.conv1", b, cout, cout, 3, res, res, res, res)]
        if cin != cout:
            convs.append(Conv(f"d.{i}.proj", b, cin, cout, 1, half, half,
                              half, half))
        if i in cfg["attention"]:
            convs += _attention_convs(f"d.{i}.attn", b, cout, half)
            attns.append(_attention(f"d.{i}.attn", b, cout, half))
        cin, res = cout, half
    convs.append(Conv("d.dense", b, cin, 1, 1, 1, 1, 1, 1, dense=True))
    return convs, attns


def conv_ops(cfg: dict, b: int, r1: bool):
    """[(layer, count)]: how many F-sized operations of each convolution
    and dense layer one step needs (see the module's docstring)."""
    g, _ = generator_layers(cfg, b)
    d, _ = discriminator_layers(cfg, b)
    ops = []
    for i, layer in enumerate(g):
        ops.append((layer, 1 + 3 - (i == 0)))
    for i, layer in enumerate(d):
        first = i == 0
        real = 6 - first if r1 else 3 - first
        ops.append((layer, real + (3 - first) + 2))
    return ops


def attention_ops(cfg: dict, b: int, r1: bool):
    """[(attention, forward FLOPs multiples, backward multiples)] of a
    step: G forward twice and backward once; D forward three times, and
    backward: reals (with R1: the input gradient, the backward through it,
    twice a backward, and through the forward), fakes, the G step."""
    _, ga = generator_layers(cfg, b)
    _, da = discriminator_layers(cfg, b)
    return ([(a, 2, 1) for a in ga]
            + [(a, 3, (1 + 2 + 1 if r1 else 1) + 1 + 1) for a in da])


def kernel_launches(cfg: dict, b: int, r1: bool):
    """{"k1": [(attention, with_lse, launches)], "k2": [(attention,
    launches)]}: the launches of the attention's kernels a step makes,
    K1 for each forward (G's in the D step without lse), K2 for each
    backward that is not the backward's own backward."""
    _, ga = generator_layers(cfg, b)
    _, da = discriminator_layers(cfg, b)
    k1 = ([(a, False, 1) for a in ga] + [(a, True, 1) for a in ga]
          + [(a, True, 3) for a in da])
    k2 = [(a, 1) for a in ga] + [(a, 4 if r1 else 3) for a in da]
    return {"k1": k1, "k2": k2}
