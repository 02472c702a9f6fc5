"""Model-architecture configuration registry.

Parity: reference ``tartangan/models/pluggan.py:18-28`` (GANConfig namedtuple +
``scale_model``) and ``:199-406`` (the named GAN_CONFIGS registry). The numeric
contents of every named config match the reference so that ``--config``/
``--model-scale`` select identical architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Architecture spec for a generator/discriminator pair.

    ``max_size = base_size * 2 ** len(blocks)`` (reference pluggan.py:51-56).
    ``attention`` holds block indices after which a self-attention layer is
    inserted (reference pluggan.py:77-78, 103-104).
    """

    base_size: int
    latent_dims: int
    data_dims: int
    blocks: Tuple[int, ...]
    num_blocks_per_scale: int = 1
    attention: Tuple[int, ...] = ()

    def scale_model(self, scale: float) -> "GANConfig":
        """Multiply every block width by ``scale`` (pluggan.py:24-28)."""
        return dataclasses.replace(
            self, blocks=tuple(int(b * scale) for b in self.blocks)
        )

    @property
    def max_size(self) -> int:
        return self.base_size * 2 ** len(self.blocks)


def _cfg(latent_dims, blocks, attention=(), base_size=4, data_dims=3,
         num_blocks_per_scale=1):
    return GANConfig(
        base_size=base_size,
        latent_dims=latent_dims,
        data_dims=data_dims,
        blocks=tuple(blocks),
        num_blocks_per_scale=num_blocks_per_scale,
        attention=tuple(attention),
    )


# Names, widths and attention indices mirror reference pluggan.py:199-406.
# '8' is ours: a minimal single-scale config for fast tests/smoke runs.
GAN_CONFIGS = {
    '8': _cfg(32, (16,)),
    '16': _cfg(100, (64, 32)),
    '32': _cfg(128, (128, 64, 32)),
    '64': _cfg(128, (128, 128, 64, 32)),
    '128': _cfg(256, (128, 128, 64, 32, 16)),
    '128big': _cfg(256, (1024, 1024, 512, 256, 128)),
    '256': _cfg(256, (256, 256, 128, 64, 32, 16)),
    '256big': _cfg(256, (1024, 1024, 512, 256, 128, 64)),
    '512': _cfg(512, (256, 256, 256, 128, 64, 32, 16)),
    '512thin': _cfg(256, (128, 128, 128, 64, 32, 16, 8), attention=(3,)),
    '512thin-test': _cfg(128, (128, 120, 100, 64, 32, 16, 8), attention=(3,)),
    '1024': _cfg(512, (512, 512, 512, 256, 128, 64, 32, 16), attention=(3,)),
    '1024thin': _cfg(256, (256, 256, 256, 128, 64, 32, 16, 8), attention=(3,)),
    'test128': _cfg(64, (64, 32, 16, 8, 4), attention=(3,)),
    'test256': _cfg(256, (200, 180, 128, 64, 32, 16), attention=(3,)),
}
