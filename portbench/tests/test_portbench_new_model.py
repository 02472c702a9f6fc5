"""A model is added to the benchmark with new files alone: a copy of the
harness gets a toy model (a CNN trainer whose G adds a noise draw of its
own to its latents, through ``extra_draws``), its plain reference, its
configuration, traffic and limits, and entries appended to
``BENCHMARK.json``, and no file that was there changes. Its cell runs
through ``run.run_cell`` on the CPU: a sound run is correct, and one whose
step sees half the batch, or whose G optimizer gets the negated gradient,
is not; the draws are recorded by name, halved with the batch, and handed
to the reference as the program drew them."""
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

FILES = {
    "portbench/models/toy.py": '''
        """A toy model: the SA-GAN whose G adds a noise draw to its
        latents, ``noise_d`` in the D step and ``noise_g`` in the G step."""
        import torch

        from portbench import reference_toy as reference  # noqa: F401
        from portbench.models import sagan
        from portbench.models.sagan import (  # noqa: F401
            architecture, attention_ops, conv_ops, image_size,
            kernel_launches, make_weights, programs_config, trainer_argv)

        DRAWS = {"z_d": 1, "z_g": 0, "noise_d": 1, "noise_g": 0}
        DRAWN = []  # each step's noise as the trainer drew it
        SEEN = []  # the batch of each noise G was given


        def draws(gen, b, arch, device):
            out = sagan.draws(gen, b, arch, device)
            shape = (b, arch["latent_dims"])
            out["noise_d"] = torch.randn(shape, generator=gen,
                                         device=device)[None]
            out["noise_g"] = torch.randn(shape, generator=gen, device=device)
            return out


        def trainer_class():
            from tartangan_torch import configs
            from tartangan_torch.models.pluggan import Generator
            from tartangan_torch.train.cnn import CNNTrainer
            configs.GAN_CONFIGS["pb-toy"] = configs._cfg(16, (16, 8))

            class NoisyGenerator(Generator):
                def forward(self, z, train=True, noise=None):
                    if noise is None:
                        return super().forward(z, train)
                    SEEN.append(noise.shape[0])
                    return super().forward(z + noise, train)

            class NoisyTrainer(CNNTrainer):
                def build_generator(self):
                    g = super().build_generator()
                    g.__class__ = NoisyGenerator
                    return g

                def extra_draws(self, lead, n):
                    shape = lead + (n, self.gan_config.latent_dims)
                    out = {"noise_d": torch.randn(
                               lead + (self.args.iters_d,) + shape[-2:],
                               generator=self.z_gen, device=self.device),
                           "noise_g": torch.randn(
                               shape, generator=self.z_gen,
                               device=self.device)}
                    DRAWN.append({k: v.cpu() for k, v in out.items()})
                    return out
            return NoisyTrainer
        ''',
    "portbench/reference_toy.py": '''
        """The toy model's plain reference: SA-GAN's, its G's latents
        shifted by the step's noise draws."""
        from portbench import reference
        from portbench.reference import build, fp8, full_float32  # noqa

        RECEIVED = []  # every draw dict the reference was handed


        def _shifted(draws):
            return {"z_d": draws["z_d"] + draws["noise_d"],
                    "z_g": draws["z_g"] + draws["noise_g"]}


        class Trainer(reference.Trainer):
            def step(self, batch_u8, draws, gp_weight):
                RECEIVED.append(dict(draws))
                return super().step(batch_u8, _shifted(draws), gp_weight)

            def g_grads(self, draws):
                RECEIVED.append(dict(draws))
                return super().g_grads(_shifted(draws))
        ''',
    "portbench/configs/toy-tiny.json": '''
        {"name": "toy-tiny", "model": "toy", "program_config": "pb-toy",
         "base_size": 4, "latent_dims": 16, "data_dims": 3,
         "blocks": [16, 8], "num_blocks_per_scale": 1, "attention": [],
         "dtype": "f32", "parity_blocks": "auto",
         "train": {"lr_g": 1e-4, "lr_d": 4e-4, "ema": 1e-3,
                   "grad_penalty": 5.0, "adam_betas": [0.0, 0.999],
                   "adam_eps": 1e-8, "leaky_slope": 0.2, "bn_eps": 1e-5,
                   "bn_momentum": 0.9}}
        ''',
    "portbench/traffic/toy-b4.json": '''
        {"batch_size": 4, "images": 12, "r1_interval": 1, "check_steps": 3,
         "warm_steps": 4, "trace_steps": 2}
        ''',
    # float32 on both sides, which agree to ~1e-6 here: a reference that
    # left a draw out would read 1e-2 and more
    "portbench/limits/toy-tiny-b4.json": '''
        {"loss": 1e-4, "grad": 1e-4, "g_grad": 1e-4, "change": 1e-4}
        ''',
}

DRIVE = '''
import json, sys
sys.path[:0] = [{tree!r}, {root!r}]
import torch
from portbench import reference_toy, run
s = run.spec("toy-tiny-b4")
m, steps = s["model"], s["traffic"]["check_steps"]
out = {{}}
for fault in (None, "half_batch", "negated_g"):
    del m.DRAWN[:], m.SEEN[:], reference_toy.RECEIVED[:]
    result, res, _ = run.run_cell(s, 7, 0.0, False, "cpu", fault=fault)
    got, drawn = reference_toy.RECEIVED, m.DRAWN[:steps]
    out[str(fault)] = {{
        "correct": result["correct"], "numbers": res["numbers"],
        "noise_batches": sorted(set(m.SEEN)),
        "handed": len(got) == steps + 1 and all(
            torch.equal(got[t][k], drawn[t % steps][k])
            for t in range(steps + 1) for k in ("noise_d", "noise_g"))}}
print("RESULT " + json.dumps(out))
'''


def _copy_with_toy(tmp: Path) -> Path:
    tree = tmp / "tree"
    shutil.copytree(ROOT / "portbench", tree / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, text in FILES.items():
        path = tree / name
        assert not path.exists(), name
        path.write_text(textwrap.dedent(text).lstrip())
    bench["configs"].append({
        "name": "toy-tiny", "source": "a test's toy model",
        "file": "portbench/configs/toy-tiny.json", "reduced": [],
        "why": "G's latents shifted by a noise draw of the trainer's own"})
    bench["workloads"].append({
        "name": "toy-tiny-b4", "config": "toy-tiny", "traffic": "toy-b4",
        "chips": 1, "why": "the toy model's step"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    return tree


def test_a_model_of_new_files(tmp_path):
    tree = _copy_with_toy(tmp_path)
    # every file the harness had is there as it was
    for path in (ROOT / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT)
            assert (tree / rel).read_bytes() == path.read_bytes(), rel
    proc = subprocess.run(
        [sys.executable, "-c", DRIVE.format(tree=str(tree), root=str(ROOT))],
        cwd=tree, capture_output=True, text=True, timeout=600)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    assert lines, proc.stderr[-4000:]
    out = json.loads(lines[-1][len("RESULT "):])
    sound, half, negated = out["None"], out["half_batch"], out["negated_g"]
    assert sound["correct"], sound["numbers"]
    assert not half["correct"], half["numbers"]
    assert not negated["correct"], negated["numbers"]
    # the noise reached G at the batch's size, and at half of it when the
    # step saw half the batch
    assert sound["noise_batches"] == [4] and half["noise_batches"] == [2]
    # the reference got each set-up step's noise as the trainer drew it
    # (and step 1's again for G's gradient)
    assert sound["handed"] and half["handed"]
