"""The structured scene GAN of awentzonline/tartangan (``SceneTrainer``,
``StructuredSceneGenerator``), trained by tartangan_torch's
``SceneTrainer``, and its plain reference ``portbench/reference_scene.py``
(see ``models/__init__.py`` for what a model module gives).

G is the structure block (a dense layer of the latent to P affine
transforms, P patch masks placed on an (S, S) canvas) and the residual G
blocks over ``blocks[log2(S / 4):]`` from S, the first taking the P
channels, with its self-attention numbered within that slice: at
'512thin', scene 16, it follows the 16-channel block at 256x256 (Ck 2,
Cv 8, 65,536 queries over 16,384 keys). D is SA-GAN's.

The counts are SA-GAN's (``models/sagan.py``) with this G: the structure
block's dense layer in place of G's input layer, its patch placement not
counted. The scene trainer builds its step without ``--r1-interval``, as
the published one does: R1 on every step, whatever ``r1`` says.
"""
from __future__ import annotations

import torch

from portbench import reference_scene as reference
from portbench import weights
from portbench.flops import Conv
from portbench.models import sagan
from portbench.models.sagan import image_size, programs_config  # noqa: F401

# the step's draws, (state, batch, z_d, z_g, noise_d=, noise_g=): the
# latents as SA-GAN's, the patch noise noise_d (iters_d, ps, ps) and
# noise_g (ps, ps), which have no batch axis
DRAWS = {"z_d": 1, "z_g": 0, "noise_d": None, "noise_g": None}

ARCH_KEYS = sagan.ARCH_KEYS + ("scene_size", "patch_size", "num_patches",
                               "patch_noise")


def trainer_class():
    from tartangan_torch.train.scene import SceneTrainer
    return SceneTrainer


def trainer_argv(cfg: dict, traffic: dict, data_path: str, out_dir: str,
                 seed: int, device: str) -> list:
    """SA-GAN's flags and the scene's."""
    return (sagan.trainer_argv(cfg, traffic, data_path, out_dir, seed, device)
            + ["--scene-size", str(cfg["scene_size"]),
               "--patch-size", str(cfg["patch_size"]),
               "--num-patches", str(cfg["num_patches"])]
            + (["--patch-noise"] if cfg["patch_noise"] else []))


def architecture(cfg: dict) -> dict:
    return {k: cfg[k] for k in ARCH_KEYS}


def make_weights(arch: dict, hp: dict, seed: int, device) -> dict:
    """``weights.make``'s, but the transforms' bias is the program's
    start, identity x 2 for every patch: its seeded weight moves each
    placement with the latent about that."""
    w = weights.make(reference.build(arch, hp), seed, device)
    bias = w["g"]["structure_generator.patch_transforms.bias"]
    bias.copy_(torch.tensor([2.0, 0, 0, 0, 2.0, 0],
                            device=bias.device).repeat(arch["num_patches"]))
    return w


def draws(gen, b: int, arch: dict, device) -> dict:
    """One step's draws in the order the trainer makes them: z_d's one D
    update, z_g, then the patch noise, noise_d and noise_g."""
    out = sagan.draws(gen, b, arch, device)
    if arch["patch_noise"]:
        ps = arch["patch_size"]
        out["noise_d"] = torch.randn((1, ps, ps), generator=gen,
                                     device=device)
        out["noise_g"] = torch.randn((ps, ps), generator=gen, device=device)
    return out


# ---------------------------------------------------------------- counts
def generator_layers(cfg: dict, b: int):
    """(convs and dense layers in forward order, attentions) of G."""
    p, res = cfg["num_patches"], cfg["scene_size"]
    convs = [Conv("g.structure", b, cfg["latent_dims"], 6 * p, 1, 1, 1, 1,
                  1, dense=True)]
    attns, cin = [], p
    for i, cout in enumerate(cfg["blocks"][reference.scene_index(cfg):]):
        r = res * 2
        convs += [Conv(f"g.{i}.conv0", b, cin, cout, 3, r, r, r, r),
                  Conv(f"g.{i}.conv1", b, cout, cout, 3, r, r, r, r)]
        if cin != cout:
            convs.append(Conv(f"g.{i}.proj", b, cin, cout, 1, r, r, r, r))
        if i in cfg["attention"]:
            convs += sagan._attention_convs(f"g.{i}.attn", b, cout, r)
            attns.append(sagan._attention(f"g.{i}.attn", b, cout, r))
        cin, res = cout, r
    convs.append(Conv("g.out", b, cin, cfg["data_dims"], 1, res, res, res,
                      res))
    return convs, attns


def conv_ops(cfg: dict, b: int, r1: bool):
    """[(layer, count)]: SA-GAN's counts (``sagan.conv_ops``) with this
    G, R1 on every step."""
    g, _ = generator_layers(cfg, b)
    ops = [(layer, 1 + 3 - (i == 0)) for i, layer in enumerate(g)]
    return ops + [(layer, n) for layer, n in sagan.conv_ops(cfg, b, True)
                  if layer.name.startswith("d.")]


def attention_ops(cfg: dict, b: int, r1: bool):
    """[(attention, forward multiples, backward multiples)]: G forward
    twice and backward once; D's as SA-GAN's with R1."""
    _, ga = generator_layers(cfg, b)
    _, da = sagan.discriminator_layers(cfg, b)
    return [(a, 2, 1) for a in ga] + [(a, 3, 1 + 2 + 1 + 1 + 1) for a in da]


def kernel_launches(cfg: dict, b: int, r1: bool):
    """SA-GAN's launches with R1 (``sagan.kernel_launches``) at this G's
    attention: K1 in G's forward without lse (the D step) and with it
    (the G step), 3 in D; K2 once in G and 4 times in D."""
    _, ga = generator_layers(cfg, b)
    _, da = sagan.discriminator_layers(cfg, b)
    return {"k1": ([(a, False, 1) for a in ga] + [(a, True, 1) for a in ga]
                   + [(a, True, 3) for a in da]),
            "k2": [(a, 1) for a in ga] + [(a, 4) for a in da]}
