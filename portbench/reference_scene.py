"""The plain reference of the structured scene GAN's training step.

Plain float32 PyTorch, with TF32 off, written from the published model
(awentzonline/tartangan ``tartangan/trainers/scene.py``, ``SceneTrainer``,
and ``tartangan/models/pluggan.py``, ``StructuredSceneGenerator``), and it
imports nothing of the program. D, the residual G blocks, BatchNorm, Adam,
the fp8 control and the step are SA-GAN's (``portbench/reference.py``);
this module adds G's structure block and an attention taken over blocks of
queries. Parameter names are those of the program's ``state_dict``.

G on a latent z (B, latent) and one (ps, ps) patch-noise draw:

- the structure block: a dense layer makes P affine transforms (2, 3) from
  z; each patch mask, ones (ps, ps) times the noise, is placed on a (S, S)
  canvas by bilinear sampling with zero padding at the grid ``base @
  theta^T``, whose base is the half-pixel centres (2 i + 1) / n - 1 of each
  axis: (B, P, S, S), always computed in float32 (or the witness's
  float64);
- the residual G blocks over ``blocks[log2(S / 4):]`` from S, the first of
  them taking the P channels without a pre-activation, with self-attention
  after the listed indices of that slice;
- norm, act, 1x1 conv, tanh.

The attention is SA-GAN's (``reference.SelfAttention``), computed over
blocks of queries: one block's logits at a time, and its backward
recomputes each block (``torch.utils.checkpoint``), so that no
(B, Lq, Lk) tensor is ever held. At the scene's 256x256 (B 64, 65,536
queries, 16,384 keys) the whole logits would take 275 GB in float32; a
block holds ``BLOCK_LOGITS`` of them. ``quant`` rounds inside each block
where SA-GAN's attention rounds: the fp8 control takes each block's
probabilities to its own scale.

Departures from the published model:

- The published trainer draws the patch noise inside G; here it is handed
  in (``Trainer.step``'s ``noise_d`` (1, ps, ps) and ``noise_g`` (ps, ps)),
  as the program draws it outside its step.
- ``refine_patches`` (masks from a dense layer of z) is not modelled: the
  configuration runs without it, with masks of ones.
- One residual block a scale (``num_blocks_per_scale`` 1), as '512thin'
  has it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from portbench import reference
from portbench.reference import _q, fp8, full_float32  # noqa: F401

BLOCK_LOGITS = 2 ** 30  # float32 logits of one query block: 4 GiB


# ---------------------------------------------------------------- structure
def half_pixel_centres(n, like):
    """The normalized centres of ``n`` pixels, (2 i + 1) / n - 1."""
    i = torch.arange(n, device=like.device, dtype=like.dtype)
    return (2 * i + 1) / n - 1


def affine_grid(theta, size):
    """theta (N, 2, 3) -> the grid (N, H, W, 2) of normalized (x, y): each
    pixel's half-pixel centre (x, y, 1) times theta^T."""
    h, w = size
    ys, xs = half_pixel_centres(h, theta), half_pixel_centres(w, theta)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def sample_bilinear(img, grid):
    """img (N, h, w) sampled bilinearly at ``grid`` (N, H, W, 2) of
    normalized (x, y) coordinates, pixel centres at the half-pixel points,
    zero outside the image -> (N, H, W)."""
    n, h, w = img.shape
    x = ((grid[..., 0] + 1) * w - 1) / 2
    y = ((grid[..., 1] + 1) * h - 1) / 2
    x0, y0 = x.detach().floor(), y.detach().floor()
    fx, fy = x - x0, y - y0
    flat = img.reshape(n, h * w)
    out = torch.zeros_like(x)
    for dx, dy, weight in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                           (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        index = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        value = flat.gather(1, index.reshape(n, -1)).reshape(x.shape)
        out = out + torch.where(inside, weight * value, torch.zeros_like(x))
    return out


class StructureBlock(nn.Module):
    """latent -> (B, P, S, S): P patch masks placed by affine transforms
    drawn from the latent (see the module's docstring)."""

    def __init__(self, latent, num_patches, patch_size, scene_size,
                 patch_noise):
        super().__init__()
        self.p, self.ps, self.ss = num_patches, patch_size, scene_size
        self.patch_noise = patch_noise
        self.patch_transforms = reference.Dense(latent, 6 * num_patches, None)

    def forward(self, z, noise):
        b, p, ps = z.shape[0], self.p, self.ps
        masks = torch.ones(b * p, ps, ps, dtype=z.dtype, device=z.device)
        if self.patch_noise:
            masks = masks * noise.to(z.dtype)
        theta = self.patch_transforms(z).reshape(b * p, 2, 3)
        grid = affine_grid(theta, (self.ss, self.ss))
        return sample_bilinear(masks, grid).reshape(b, p, self.ss, self.ss)


# ---------------------------------------------------------------- attention
class BlockedSelfAttention(reference.SelfAttention):
    """SA-GAN's self-attention over blocks of ``block_queries`` queries
    (None: as many as ``BLOCK_LOGITS`` logits take), each block recomputed
    in backward."""

    block_queries = None

    def forward(self, x):
        b, _, h, w = x.shape
        q = self.theta(x).flatten(2).transpose(1, 2)
        k = F.max_pool2d(self.phi(x), 2).flatten(2).transpose(1, 2)
        v = F.max_pool2d(self.g(x), 2).flatten(2).transpose(1, 2)
        q, k, v = (_q(self.quant, t) for t in (q, k, v))
        n = self.block_queries or max(1, BLOCK_LOGITS // (b * k.shape[1]))
        block = self._block
        if torch.is_grad_enabled():
            def block(*t):
                return checkpoint.checkpoint(self._block, *t,
                                             use_reentrant=False)
        o = torch.cat([block(q[:, i:i + n], k, v)
                       for i in range(0, q.shape[1], n)], 1)
        o = o.transpose(1, 2).reshape(b, -1, h, w)
        return _q(self.quant, self.gamma * self.o(o) + x)

    def _block(self, q, k, v):
        p = torch.softmax(torch.bmm(q, k.transpose(1, 2)), -1)
        return _q(self.quant, torch.bmm(_q(self.quant, p), v))


# ---------------------------------------------------------------- G
def scene_index(cfg) -> int:
    """log2(scene_size / 4): the first of ``blocks`` that G builds."""
    return (cfg["scene_size"] // 4).bit_length() - 1


class Generator(nn.Module):
    """The structured scene generator (see the module's docstring). Its
    ``noise`` is the patch-noise draw its next call takes."""

    def __init__(self, cfg, hp, quant=None):
        super().__init__()
        self.quant, self.noise = quant, None
        self.structure_generator = StructureBlock(
            cfg["latent_dims"], cfg["num_patches"], cfg["patch_size"],
            cfg["scene_size"], cfg["patch_noise"])
        self.layers, cin, n_attn = [], cfg["num_patches"], 0
        for i, cout in enumerate(cfg["blocks"][scene_index(cfg):]):
            self._add(f"ResidualGeneratorBlock_{i}",
                      reference.GBlock(cin, cout, i == 0, hp, quant))
            if i in cfg["attention"]:
                self._add(f"SelfAttention2d_{n_attn}",
                          BlockedSelfAttention(cout, quant))
                n_attn += 1
            cin = cout
        out = nn.Module()
        out.NormAct_0 = reference.NormAct(cin, hp, quant)
        out.Conv_0 = reference.Conv(cin, cfg["data_dims"], 1, quant)
        self.GeneratorOutput_0 = out

    def _add(self, name, module):
        setattr(self, name, module)
        self.layers.append(name)

    def forward(self, z):
        x = _q(self.quant, self.structure_generator(z, self.noise))
        for name in self.layers:
            x = getattr(self, name)(x)
        out = self.GeneratorOutput_0
        return _q(self.quant, torch.tanh(out.Conv_0(out.NormAct_0(x))))


def build(cfg, hp, quant=None):
    """(G, D) of configuration ``cfg``, hyperparameters ``hp``: D is
    SA-GAN's."""
    return Generator(cfg, hp, quant), reference.Discriminator(cfg, hp, quant)


# ---------------------------------------------------------------- step
class Trainer(reference.Trainer):
    """SA-GAN's step with the scene generator: its draws are SA-GAN's
    latents and the patch noise, ``noise_d`` (1, ps, ps) for the D step's
    fakes and ``noise_g`` (ps, ps) for the G step."""

    def __init__(self, cfg, hp, weights, device, quant=None,
                 dtype=torch.float32):
        self.hp, self.dtype = hp, dtype
        self.g, self.d = (m.to(device, dtype) for m in build(cfg, hp, quant))
        self.g_target = Generator(cfg, hp).to(device, dtype)
        for model, name in ((self.g, "g"), (self.g_target, "g"),
                            (self.d, "d")):
            model.load_state_dict(weights[name])
        self.g_target.requires_grad_(False)
        betas, eps = tuple(hp["adam_betas"]), hp["adam_eps"]
        self.opt_g = reference.Adam(self.g.parameters(), hp["lr_g"], betas,
                                    eps)
        self.opt_d = reference.Adam(self.d.parameters(), hp["lr_d"], betas,
                                    eps)
        self._noise_g = None

    def _noise(self, draws, name):
        t = draws.get(name)
        return None if t is None else t.to(self.dtype)

    def step(self, batch_u8, draws, gp_weight):
        noise_d = self._noise(draws, "noise_d")
        self.g.noise = None if noise_d is None else noise_d[0]
        self._noise_g = self._noise(draws, "noise_g")
        return super().step(batch_u8, draws, gp_weight)

    def _g_loss_grads(self, z_g):
        self.g.noise = self._noise_g
        return super()._g_loss_grads(z_g)

    def g_grads(self, draws):
        self._noise_g = self._noise(draws, "noise_g")
        return super().g_grads(draws)
