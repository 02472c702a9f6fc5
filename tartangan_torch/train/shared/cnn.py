"""Shared-filter CNN trainer: the CNN trainer's step and loop with the
shared-filter generator and discriminator (one filter bank each,
``models/shared.py``).

Counterpart of ``tartangan_tpu/train/shared/cnn.py``. As there, the family
takes the CNN trainer's flags and ignores ``--parity-blocks``, ``--remat``
and ``--g-base`` (the JAX builders pass none of them on).

Usage: python -m tartangan_torch.train.shared.cnn DATA.npz --config 512thin
       --batch-size 64 [--dtype bf16] [--device cuda|cpu]
"""
from __future__ import annotations

from ...models.shared import SharedDiscriminator, SharedGenerator
from ..cnn import CNNTrainer


def build_shared_generator(trainer):
    args = trainer.args
    return SharedGenerator(trainer.gan_config, norm=args.norm,
                           activation=args.activation, g_base=args.g_base,
                           dtype=trainer.dtype)


class SharedCNNTrainer(CNNTrainer):
    build_generator = build_shared_generator

    def build_discriminator(self):
        args = self.args
        return SharedDiscriminator(self.gan_config, norm=args.norm,
                                   activation=args.activation,
                                   dtype=self.dtype)


def main(argv=None):
    return SharedCNNTrainer.run_cli(argv)


if __name__ == "__main__":
    main()
