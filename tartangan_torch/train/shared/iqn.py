"""Shared-filter IQN trainer: the IQN trainer's step and loop with the
shared-filter generator and the shared-filter discriminator that ends in
the IQN head (``models/shared.py``).

Counterpart of ``tartangan_tpu/train/shared/iqn.py``. The taus are drawn
by the trainer outside the step (``train/iqn.py::IQNTrainer.
extra_draws``).

Usage: python -m tartangan_torch.train.shared.iqn DATA.npz --config 512thin
       --batch-size 64 [--dtype bf16] [--device cuda|cpu]
"""
from __future__ import annotations

from ...models.shared import SharedIQNDiscriminator
from ..iqn import IQNTrainer
from .cnn import build_shared_generator


class SharedIQNTrainer(IQNTrainer):
    build_generator = build_shared_generator

    def build_discriminator(self):
        args = self.args
        return SharedIQNDiscriminator(self.gan_config, norm=args.norm,
                                      activation=args.activation,
                                      dtype=self.dtype)


def main(argv=None):
    return SharedIQNTrainer.run_cli(argv)


if __name__ == "__main__":
    main()
