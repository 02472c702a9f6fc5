"""Scene-composition generators: patches placed on a canvas by affine
transforms drawn from the latent.

Counterpart of ``tartangan_tpu/models/scene.py``: ``SceneStructureBlock``
(:32), ``ScenePatch`` (:89), ``SceneBlock`` (:130), ``SceneUpscale``,
``SceneOutput``, ``SceneGenerator`` (:175) and ``StructuredSceneGenerator``
(:211). The patch placement is ``ops/grid_sample.py`` (NHWC); the canvas
and the generators' outputs are NCHW. As in the JAX package, the P
patches of the structure block are folded into the batch and sampled by
one ``grid_sample`` (:80-86).

The structure block multiplies its masks by one (ps, ps) normal draw per
generator apply when ``patch_noise`` is on (the JAX package's "scene" rng
stream). Here the caller passes it as ``noise``: the trainer draws it
outside the step (``train/scene.py``), so a captured graph reads it as a
device tensor and a test can feed the JAX package's draw.

``StructuredSceneGenerator`` numbers its attention over
``config.blocks[scene_i:]`` (``scene_i = log2(scene_size / 4)``), as the
reference does (:243-245): at '512thin' with scene size 16 the attention
follows the fourth tower block, at 256x256 with 16 channels.

Each ``StructuredSceneGenerator`` call runs its structure block (the
transforms and masks, the noise, the grid and the sampling) inside a
``scene.structure`` span (``utils/tracing.py``), recorded only where the
port's spans are.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..configs import GANConfig
from ..ops.grid_sample import affine_grid, grid_sample
from ..ops.resize import upsample_nearest_2x
from ..utils import tracing
from ..utils.precision import wide
from .attention import SelfAttention2d
from .blocks import GeneratorOutput, ResidualGeneratorBlock
from .layers import AutoNamed, Dense, NormAct, _Conv2d, _Linear


class _ConstDense(_Linear):
    """A dense layer that starts at zero weights and a given bias (the
    reference's ``kernel_init=zeros`` with a constant ``bias_init``)."""

    def __init__(self, in_features: int, out_features: int, bias_value):
        super().__init__(in_features, out_features)
        self.register_buffer("_bias_value", torch.as_tensor(
            np.asarray(bias_value, np.float32)), persistent=False)
        self.init_parameters_(None)

    @torch.no_grad()
    def init_parameters_(self, generator):
        del generator
        self.weight.zero_()
        self.bias.copy_(self._bias_value)


class _LecunConv(_Conv2d):
    """A SAME 3x3 conv with flax's ``nn.Conv`` default init: a truncated
    normal kernel of variance 1 / fan_in (``lecun_normal``), zero bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, 3, padding=1)
        self.init_parameters_(None)

    @torch.no_grad()
    def init_parameters_(self, generator):
        # flax divides by the std of a unit normal truncated at +-2
        std = math.sqrt(1.0 / self.weight[0].numel()) / .87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        self.bias.zero_()


class SceneStructureBlock(nn.Module):
    """latent -> P patch masks, each affine-placed on a (scene, scene)
    canvas: (B, P, scene, scene), in float32 (float64 for a float64
    latent)."""

    def __init__(self, in_dims: int, num_patches: int = 20,
                 patch_size: int = 3, scene_size: int = 16,
                 refine_patches: bool = False, patch_noise: bool = True):
        super().__init__()
        p, ps = num_patches, patch_size
        self.num_patches, self.patch_size = p, ps
        self.scene_size = scene_size
        self.patch_noise = patch_noise
        if refine_patches:
            self.masks = Dense(in_dims, p * ps * ps)
        # identity x 2 (:64-72)
        self.patch_transforms = _ConstDense(
            in_dims, 6 * p, np.tile([2.0, 0, 0, 0, 2.0, 0], p))

    @property
    def output_channels(self) -> int:
        return self.num_patches

    def forward(self, z: torch.Tensor, train: bool = True,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        del train
        b = z.shape[0]
        p, ps, ss = self.num_patches, self.patch_size, self.scene_size
        z = z.to(wide(z.dtype))
        if hasattr(self, "masks"):
            masks = (1.0 - torch.sigmoid(self.masks(z))).reshape(b, p, ps, ps)
        else:
            masks = torch.ones((b, p, ps, ps), dtype=z.dtype,
                               device=z.device)
        transforms = self.patch_transforms(z).reshape(b * p, 2, 3)
        if self.patch_noise:
            if noise is None or noise.shape != (ps, ps):
                raise ValueError(f"patch noise needs a ({ps}, {ps}) draw, "
                                 f"got {None if noise is None else tuple(noise.shape)}")
            masks = masks * noise.to(z.dtype)
        grid = affine_grid(transforms, (b * p, ss, ss), align_corners=False)
        patches = grid_sample(masks.reshape(b * p, ps, ps, 1), grid,
                              align_corners=False)
        return patches.reshape(b, p, ss, ss).to(z.dtype)


class ScenePatch(nn.Module):
    """latent -> a tanh patch times its sigmoid alpha, affine-placed on the
    canvas: (patch on the canvas, alpha on the canvas), each NCHW."""

    def __init__(self, in_dims: int, patch_size: int = 12,
                 patch_channels: int = 3):
        super().__init__()
        self.patch_size, self.patch_channels = patch_size, patch_channels
        area = patch_size * patch_size * patch_channels
        self.patch = Dense(in_dims, area)
        self.alpha = _ConstDense(in_dims, area, np.zeros(area))
        self.patch_transform = _ConstDense(in_dims, 6, [1.0, 0, 0, 0, 1.0, 0])

    def forward(self, b_z: torch.Tensor, canvas_hw):
        b = b_z.shape[0]
        shape = (b, self.patch_size, self.patch_size, self.patch_channels)
        z = b_z.to(wide(b_z.dtype))
        alpha = torch.sigmoid(self.alpha(z)).reshape(shape)
        patch = torch.tanh(self.patch(z)).reshape(shape) * alpha
        theta = self.patch_transform(z).reshape(b, 2, 3)
        grid = affine_grid(theta, (b, *canvas_hw), align_corners=True)
        y = grid_sample(patch, grid, align_corners=True)
        mask = grid_sample(alpha, grid, align_corners=True)
        return y.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2)


class SceneBlock(nn.Module):
    """One compositing step on the state (z, canvas): code a patch from
    norm(z), paint it over the canvas through its alpha, refine the canvas
    with a 3x3 conv, and take the code from z."""

    def __init__(self, z_dims: int, canvas_channels: int,
                 patch_size: int = 12, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.NormAct_0 = NormAct(z_dims, norm, activation)
        self.z_code = Dense(z_dims, z_dims)
        self.patch = ScenePatch(z_dims, patch_size, canvas_channels)
        self.refine_canvas = _LecunConv(canvas_channels, canvas_channels)

    def forward(self, inputs, train: bool = True):
        z, canvas = inputs
        patch_z = self.z_code(self.NormAct_0(z.to(wide(z.dtype)), train))
        patch, mask = self.patch(patch_z, canvas.shape[2:])
        canvas = (1.0 - mask.to(canvas.dtype)) * canvas + patch.to(
            canvas.dtype)
        canvas = self.refine_canvas(canvas)
        return z - patch_z.to(z.dtype), canvas


class SceneUpscale(nn.Module):
    """Nearest 2x upsample of the canvas."""

    def forward(self, inputs, train: bool = True):
        z, canvas = inputs
        return z, upsample_nearest_2x(canvas)


class SceneOutput(nn.Module):
    """tanh of the canvas."""

    def forward(self, inputs, train: bool = True):
        z, canvas = inputs
        return z, torch.tanh(canvas)


class _SceneBase(AutoNamed):
    """Layers in flax's creation order under its auto-names."""

    def __init__(self, config: GANConfig, dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.dtype = dtype

    @property
    def max_size(self) -> int:
        return self.config.max_size


class SceneGenerator(_SceneBase):
    """Iterative patch painting: at each of the len(blocks) + 1 scales,
    5 * num_blocks_per_scale - 1 ``SceneBlock``s, then a 2x canvas upscale
    (none after the last); the canvas starts at zeros (B, data_dims, base,
    base) and ends in tanh. No trainer of either package uses it."""

    def __init__(self, config: GANConfig, patch_size: int = 12,
                 norm: str = "bn", activation: str = "relu",
                 dtype: torch.dtype | None = None):
        super().__init__(config, dtype)
        num_blocks = 5 * config.num_blocks_per_scale
        for block_i in range(len(config.blocks) + 1):
            for _ in range(num_blocks - 1):
                self._add(SceneBlock(config.latent_dims, config.data_dims,
                                     patch_size, norm=norm,
                                     activation=activation))
            if block_i < len(config.blocks):
                self._add(SceneUpscale())
        self._add(SceneOutput())

    def forward(self, z: torch.Tensor, train: bool = True,
                return_z_final: bool = False):
        cfg = self.config
        dtype = self.dtype or z.dtype
        canvas = torch.zeros((z.shape[0], cfg.data_dims, cfg.base_size,
                              cfg.base_size), dtype=dtype, device=z.device)
        state = (z.to(dtype), canvas)
        for name in self.layers:
            state = getattr(self, name)(state, train)
        return state if return_z_final else state[1]


class StructuredSceneGenerator(_SceneBase):
    """``SceneStructureBlock`` (``structure_generator``): a (P, scene,
    scene) map of placed masks, then the residual generator blocks over
    ``config.blocks[scene_i:]`` up to full size (attention after
    ``block_i in config.attention``, counted within that slice), then
    ``GeneratorOutput``: images (B, data_dims, H, W) in the compute
    dtype. With ``patch_noise`` each call takes ``noise`` (ps, ps)."""

    def __init__(self, config: GANConfig, scene_size: int = 16,
                 patch_size: int = 3, num_patches: int = 20,
                 refine_patches: bool = False, patch_noise: bool = True,
                 norm: str = "bn", activation: str = "relu",
                 dtype: torch.dtype | None = None):
        super().__init__(config, dtype)
        self.patch_noise = patch_noise
        structure = SceneStructureBlock(
            config.latent_dims, num_patches=num_patches,
            patch_size=patch_size, scene_size=scene_size,
            refine_patches=refine_patches, patch_noise=patch_noise)
        self._add(structure, "structure_generator")
        in_dims = structure.output_channels
        scene_i = int(np.log2(scene_size / 4))
        first_block = True
        for block_i, out_dims in enumerate(config.blocks[scene_i:]):
            self._add(ResidualGeneratorBlock(
                in_dims, out_dims, upsample=True, first_block=first_block,
                norm=norm, activation=activation))
            first_block = False
            for _ in range(config.num_blocks_per_scale - 1):
                self._add(ResidualGeneratorBlock(
                    out_dims, out_dims, upsample=False, first_block=False,
                    norm=norm, activation=activation))
            if config.attention and block_i in config.attention:
                self._add(SelfAttention2d(out_dims))
            in_dims = out_dims
        self._add(GeneratorOutput(in_dims, config.data_dims, norm=norm,
                                  activation=activation))

    def forward(self, z: torch.Tensor, train: bool = True,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        with tracing.span("scene.structure"):
            x = self.structure_generator(z, train, noise=noise)
        x = x.to(self.dtype or z.dtype)
        for name in self.layers[1:]:
            x = getattr(self, name)(x, train)
        return x
