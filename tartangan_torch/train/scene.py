"""Scene trainer: the CNN trainer's step and loop with the structured
scene generator (``models/scene.py::StructuredSceneGenerator``).

Counterpart of ``tartangan_tpu/train/scene.py``, with its flags
``--scene-size``, ``--patch-size``, ``--num-patches``,
``--refine-patches`` and ``--patch-noise``. With ``--patch-noise`` each G
apply multiplies the patch masks by one (ps, ps) normal draw; the JAX step
draws it from a "scene" key of its own in each G apply. Here the trainer
draws it outside the step with the latents (``extra_draws``): ``noise_d``
(iters_d, ps, ps) for the D steps' fakes and ``noise_g`` (ps, ps) for the
G step, so a captured graph (``--steps-per-call K``) reads it as a device
tensor; the sampler's applies draw their own (``generate``).

As the JAX trainer's, the step is built without ``--iters-d`` and
``--r1-interval`` (``train/scene.py:37-45`` passes neither): one D update
and R1 every step, whatever they say. D is the CNN trainer's.

Usage: python -m tartangan_torch.train.scene DATA.npz --config 512thin
       --batch-size 64 [--patch-noise] [--dtype bf16] [--device cuda|cpu]
"""
from __future__ import annotations

import torch

from ..models.scene import StructuredSceneGenerator
from ..parallel import mesh as M
from .cnn import CNNTrainer, make_cnn_train_step


class SceneTrainer(CNNTrainer):
    def build_generator(self):
        args = self.args
        return StructuredSceneGenerator(
            self.gan_config, scene_size=args.scene_size,
            patch_size=args.patch_size, num_patches=args.num_patches,
            refine_patches=args.refine_patches, patch_noise=args.patch_noise,
            norm=args.norm, activation=args.activation, dtype=self.dtype)

    def make_train_step(self):
        return make_cnn_train_step(grad_penalty=self.args.grad_penalty,
                                   ema_factor=self.args.lr_target_g,
                                   dtype=self.dtype)

    def _noise(self, lead: tuple) -> torch.Tensor:
        ps = self.args.patch_size
        return torch.randn(lead + (ps, ps), generator=self.z_gen,
                           device=self.device)

    def extra_draws(self, lead: tuple, n: int) -> dict:
        """With ``--patch-noise``: ``noise_d`` lead + (iters_d, ps, ps)
        (the step reads the first, as it makes one D update) and
        ``noise_g`` lead + (ps, ps), float32 normal draws."""
        if not self.args.patch_noise:
            return {}
        return {"noise_d": self._noise(lead + (self.args.iters_d,)),
                "noise_g": self._noise(lead)}

    def generate(self, n=None, target_g=False, z=None):
        """``Trainer.generate`` with a patch-noise draw of its own (the JAX
        sampler's "scene" key, ``train/scene.py:32-35``)."""
        if not self.args.patch_noise:
            return super().generate(n, target_g, z)
        if z is None:
            z = self.sample_z(n)
        z = torch.as_tensor(z, device=self.device)
        g = self.state.g_target if target_g else self.state.g
        with torch.no_grad(), M.replicated():
            return g(z, train=True, noise=self._noise(()))

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("--scene-size", type=int, default=16)
        p.add_argument("--patch-size", type=int, default=3)
        p.add_argument("--num-patches", type=int, default=20)
        p.add_argument("--refine-patches", action="store_true")
        p.add_argument("--patch-noise", action="store_true")


def main(argv=None):
    return SceneTrainer.run_cli(argv)


if __name__ == "__main__":
    main()
