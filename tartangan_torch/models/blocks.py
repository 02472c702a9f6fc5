"""Generator and discriminator building blocks (NCHW).

Counterparts of ``tartangan_tpu/models/blocks.py``: ``GeneratorInputMLP``
(:537), ``GeneratorInputMLP1d`` (:555), ``TiledZGeneratorInput`` (:573),
``GeneratorBlock`` (:78), ``ResidualGeneratorBlock`` (:104),
``GeneratorOutput`` (:592), ``DiscriminatorInput`` (:649),
``DiscriminatorBlock`` (:694), ``ResidualDiscriminatorBlock`` (:717) and
``DiscriminatorOutput`` (:757);
the parity-domain forms ``ParityResidualGeneratorBlock`` (:376),
``ParityGeneratorOutput`` (:613), ``ParityResidualDiscriminatorBlock``
(:444) and ``ParityDiscriminatorInput`` (:664) with the folded BatchNorm
(:233-302); ``FusedResidualGeneratorBlock`` (:151); and the IQN and
InfoGAN discriminators' heads ``IQNDiscriminatorOutput`` (:799),
``LinearOutput`` (:830), ``GaussianParametersOutput`` (:843),
``MultiModelDiscriminatorOutput`` (:860), with
``DiscriminatorPoolOnlyOutput`` (:774). The plain and residual blocks,
``GeneratorOutput`` and ``DiscriminatorInput`` take ``ndim=1`` for the
text GAN's NCL sequences (``_upsample``, ``_avg_pool``, ``_shortcut_down``,
:62-76). Attribute names
follow the flax param tree (``NormAct_0``, ``Conv_0``, ``project_input``,
...; the fused block's flat ``conv1_kernel`` ...), so a parity block has the
plain block's tree and ``convert.py`` carries either. Every block takes
``(x, train)``; ``train=True`` normalizes with batch statistics. Every
block computes in its input's dtype, the compute dtype that ``Generator``
and ``Discriminator`` set, with the float32 weights cast at use
(``models/layers.py``), as the reference's ``dtype`` attribute does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import parity as P
from ..ops.gblock import _gblock_reference, fused_gblock
from ..ops.init import default_init_
from ..ops.parity_conv import fused_parity_conv
from ..ops.remat import checkpoint_block, tagged
from ..ops.resize import (
    avg_pool_2x,
    avg_pool_2x_1d,
    downsample_bilinear_half,
    downsample_bilinear_half_parity,
    downsample_bilinear_half_parity_to_parity,
    resize_linear_1d,
    upsample_nearest_2x,
    upsample_nearest_2x_1d,
)
from ..utils.precision import wide
from .iqn import IQN, iqn_loss
from .layers import (
    BatchNorm,
    Conv,
    Dense,
    NormAct,
    activation_fn,
    full_weight,
)


def _upsample(x, ndim):
    return upsample_nearest_2x(x) if ndim == 2 else upsample_nearest_2x_1d(x)


def _avg_pool(x, ndim):
    return avg_pool_2x(x) if ndim == 2 else avg_pool_2x_1d(x)


def _shortcut_down(x, ndim):
    """The D shortcut's half-size resample: bilinear with align_corners in
    2-D, linear without it in 1-D (the text GAN's)."""
    if ndim == 2:
        return downsample_bilinear_half(x, align_corners=True)
    return resize_linear_1d(x, x.shape[2] // 2, align_corners=False)


class RematBlock(nn.Module):
    """A tower block that ``--remat`` may rematerialize: with
    ``remat_policy`` set (``models/factories.py``), its ``block_forward``
    runs under ``ops/remat.py::checkpoint_block``, as the JAX package wraps
    the residual and parity blocks in ``nn.remat``. The values that
    ``convs`` saves are the calls tagged with ``tagged`` (JAX's ``_ckpt``,
    ``blocks.py:51-59``): the main-path convolutions."""

    remat_policy = None

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return checkpoint_block(self, self.block_forward, x, train,
                                self.remat_policy)


class ResidualGeneratorBlock(RematBlock):
    """Pre-activation residual up block.

    main: [norm, act,] conv3(in->out), norm, act, conv3(out->out)
    shortcut: 1x1 projection iff in != out; nearest-2x upsample applied to
    the block input before both paths.
    """

    def __init__(self, in_dims: int, out_dims: int, upsample: bool = True,
                 first_block: bool = False, norm: str = "bn",
                 activation: str = "relu", ndim: int = 2):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        self.upsample = upsample
        self.first_block = first_block
        self.norm, self.activation = norm, activation
        self.ndim = ndim
        # flax numbers NormAct modules in creation order: the input norm,
        # when there is one, is NormAct_0 and the mid norm NormAct_1
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3, ndim=ndim)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3, ndim=ndim)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1, ndim=ndim)

    def block_forward(self, x: torch.Tensor,
                      train: bool = True) -> torch.Tensor:
        # norm+act commute exactly with nearest upsampling (pointwise ops
        # on repeated values; the batch stats of the repeated tensor equal
        # those of the source), so they run at the small resolution, in
        # the same order as the reference (blocks.py:123-132)
        if self.upsample and not self.first_block:
            h = _upsample(self.NormAct_0(x, train), self.ndim)
            x = _upsample(x, self.ndim)
        else:
            if self.upsample:
                x = _upsample(x, self.ndim)
            h = x
            if not self.first_block:
                h = self.NormAct_0(h, train)
        h = tagged(self.Conv_0, h)
        h = getattr(self, self.mid_norm)(h, train)
        h = tagged(self.Conv_1, h)
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return x + h


class GeneratorBlock(nn.Module):
    """Non-residual pre-activation up block (``blocks.py:78-101``), the
    default factory's: [upsample,] [norm, act,] conv3(in->out), norm, act,
    conv3(out->out)."""

    def __init__(self, in_dims: int, out_dims: int, upsample: bool = True,
                 first_block: bool = False, norm: str = "bn",
                 activation: str = "relu", ndim: int = 2):
        super().__init__()
        self.upsample = upsample
        self.first_block = first_block
        self.ndim = ndim
        mid = "NormAct_0"  # flax's creation order
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3, ndim=ndim)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3, ndim=ndim)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.upsample:
            x = _upsample(x, self.ndim)
        if not self.first_block:
            x = self.NormAct_0(x, train)
        x = self.Conv_0(x)
        x = getattr(self, self.mid_norm)(x, train)
        return self.Conv_1(x)


class GeneratorInputMLP(nn.Module):
    """latent -> act(Linear) -> (B, out, size, size)."""

    def __init__(self, latent_dims: int, output_dims: int, size: int = 4,
                 activation: str = "relu"):
        super().__init__()
        self.output_dims = output_dims
        self.size = size
        self.activation = activation
        self.act = activation_fn(activation)
        self.Dense_0 = Dense(latent_dims, size ** 2 * output_dims)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        base = self.act(self.Dense_0(z))
        # flax reshapes the dense output as (B, H, W, C)
        base = base.reshape(-1, self.size, self.size, self.output_dims)
        return base.permute(0, 3, 1, 2).contiguous()


class GeneratorInputMLP1d(nn.Module):
    """latent -> act(Linear) -> (B, out, size), the text GAN's input."""

    def __init__(self, latent_dims: int, output_dims: int, size: int = 4,
                 activation: str = "relu"):
        super().__init__()
        self.output_dims = output_dims
        self.size = size
        self.act = activation_fn(activation)
        self.Dense_0 = Dense(latent_dims, size * output_dims)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        # flax reshapes the dense output as (B, L, C)
        base = self.act(self.Dense_0(z)).reshape(-1, self.size,
                                                 self.output_dims)
        return base.permute(0, 2, 1).contiguous()


class TiledZGeneratorInput(nn.Module):
    """Tile z to a (B, latent, size, size) map."""

    def __init__(self, latent_dims: int, output_dims: int, size: int = 4,
                 activation: str = "relu"):
        super().__init__()
        if latent_dims != output_dims:
            raise ValueError("TiledZGeneratorInput needs latent_dims == "
                             f"output_dims, got {latent_dims}, {output_dims}")
        self.latent_dims = latent_dims
        self.size = size

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        b, c = z.shape
        return z[:, :, None, None].expand(b, c, self.size, self.size)


class GeneratorOutput(nn.Module):
    """norm -> act -> 1x1 conv -> tanh."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu", output_activation: str = "tanh",
                 ndim: int = 2):
        super().__init__()
        if output_activation not in ("tanh", "id"):
            raise ValueError(f"unknown output activation '{output_activation}'")
        self.output_activation = output_activation
        self.in_dims = in_dims
        self.norm, self.activation = norm, activation
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Conv_0 = Conv(in_dims, out_dims, 1, ndim=ndim)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.Conv_0(self.NormAct_0(x, train))
        if self.output_activation == "tanh":
            x = torch.tanh(x)
        return x


class DiscriminatorInput(nn.Module):
    """1x1 conv image (or NCL sequence) -> features."""

    def __init__(self, in_dims: int, out_dims: int, ndim: int = 2):
        super().__init__()
        self.Conv_0 = Conv(in_dims, out_dims, 1, ndim=ndim)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        return self.Conv_0(x)


class DiscriminatorBlock(nn.Module):
    """Non-residual pre-activation down block (``blocks.py:694-714``), the
    default factory's: [norm, act,] conv3(in->out), norm, act,
    conv3(out->out), avgpool2."""

    def __init__(self, in_dims: int, out_dims: int, first_block: bool = False,
                 norm: str = "bn", activation: str = "relu", ndim: int = 2):
        super().__init__()
        self.first_block = first_block
        self.ndim = ndim
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3, ndim=ndim)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3, ndim=ndim)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if not self.first_block:
            x = self.NormAct_0(x, train)
        x = self.Conv_0(x)
        x = getattr(self, self.mid_norm)(x, train)
        return _avg_pool(self.Conv_1(x), self.ndim)


class ResidualDiscriminatorBlock(RematBlock):
    """Pre-activation residual down block.

    main: [norm, act,] conv3(in->out), norm, act, conv3(out->out), avgpool2
    shortcut: bilinear 0.5x (align_corners=True; 1-D: linear without it),
    then a 1x1 projection iff in != out.
    """

    def __init__(self, in_dims: int, out_dims: int, first_block: bool = False,
                 norm: str = "bn", activation: str = "relu", ndim: int = 2):
        super().__init__()
        self.first_block = first_block
        self.ndim = ndim
        # flax's creation order, as in ResidualGeneratorBlock
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3, ndim=ndim)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3, ndim=ndim)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1, ndim=ndim)

    def block_forward(self, x: torch.Tensor,
                      train: bool = True) -> torch.Tensor:
        h = x if self.first_block else self.NormAct_0(x, train)
        h = tagged(self.Conv_0, h)
        h = getattr(self, self.mid_norm)(h, train)
        h = _avg_pool(tagged(self.Conv_1, h), self.ndim)
        x = _shortcut_down(x, self.ndim)
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return x + h


class DiscriminatorOutput(nn.Module):
    """norm -> act -> sum-pool over every spatial axis -> Linear."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Dense_0 = Dense(in_dims, out_dims)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.NormAct_0(x, train)
        return self.Dense_0(x.sum(dim=tuple(range(2, x.dim()))))


class DiscriminatorPoolOnlyOutput(nn.Module):
    """norm -> act -> 1x1 (``pool='conv'``: 4x4, SAME) conv -> sum or
    mean pool (``blocks.py:774-797``)."""

    def __init__(self, in_dims: int, out_dims: int, pool: str = "sum",
                 norm: str = "bn", activation: str = "relu"):
        super().__init__()
        if pool not in ("sum", "avg", "conv"):
            raise ValueError(f"no pooling method named '{pool}'")
        self.pool = pool
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Conv_0 = Conv(in_dims, out_dims, 4 if pool == "conv" else 1)
        if pool == "conv":
            self.Conv_0.padding = (0, 0)  # padded in forward

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.NormAct_0(x, train)
        if self.pool == "conv":
            # flax's SAME for an even kernel pads 1 before and 2 after; the
            # feature map is returned as it is (NCHW)
            return self.Conv_0(F.pad(x, (1, 2, 1, 2)))
        feats = self.Conv_0(x)
        if self.pool == "avg":
            return feats.mean(dim=(2, 3))
        return feats.sum(dim=(1, 2, 3))[:, None]


class IQNDiscriminatorOutput(nn.Module):
    """IQN head (``blocks.py:799-827``): sum-pool the features, mix in the
    embedding of each tau, a linear output per quantile, and their mean
    over the quantiles as the prediction. With ``targets`` it also returns
    the quantile-Huber loss of the per-quantile outputs. ``taus`` (Q*B, 1)
    are the caller's (``models/iqn.py``)."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.out_dims = out_dims
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.IQN_0 = IQN(in_dims)
        self.to_output = Dense(in_dims, out_dims)

    def forward(self, x: torch.Tensor, train: bool = True, targets=None,
                taus: torch.Tensor | None = None):
        if taus is None:
            raise ValueError("the IQN head needs the quantiles taus")
        feats = self.NormAct_0(x, train).sum(dim=(2, 3))  # (B, F)
        p_target_tau = self.to_output(self.IQN_0(feats, taus, train))
        p_target = p_target_tau.reshape(
            self.IQN_0.num_quantiles, -1, self.out_dims).mean(0)
        if targets is None:
            return p_target
        loss = iqn_loss(p_target_tau, targets, taus.repeat(1, self.out_dims))
        return p_target, loss


class LinearOutput(nn.Module):
    """A linear head (``blocks.py:830-840``)."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.Dense_0 = Dense(in_dims, out_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class GaussianParametersOutput(nn.Module):
    """Linear -> act -> Linear -> (mu, log_sigma) (``blocks.py:843-857``)."""

    def __init__(self, in_dims: int, out_dims: int, activation: str = "relu"):
        super().__init__()
        self.out_dims = out_dims
        self.act = activation_fn(activation)
        self.Dense_0 = Dense(in_dims, in_dims)
        self.Dense_1 = Dense(in_dims, 2 * out_dims)

    def forward(self, x: torch.Tensor):
        h = self.Dense_1(self.act(self.Dense_0(x)))
        return h[:, :self.out_dims], h[:, self.out_dims:]


class MultiModelDiscriminatorOutput(nn.Module):
    """One norm, act and sum-pool trunk feeding several heads
    (``blocks.py:860-877``), the InfoGAN discriminator's output: a list
    of the heads' outputs. ``head_factories`` map in_dims to a module;
    each head is named as flax names it, by its class and a count
    (``LinearOutput_0``, ``LinearOutput_1``)."""

    def __init__(self, in_dims: int, head_factories=(), norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.heads = []
        counts = {}
        for factory in head_factories:
            head = factory(in_dims)
            kind = type(head).__name__
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(name, head)
            self.heads.append(name)

    def forward(self, x: torch.Tensor, train: bool = True):
        feats = self.NormAct_0(x, train).sum(dim=(2, 3))
        return [getattr(self, name)(feats) for name in self.heads]


# ------------------------------------------------------- parity-domain forms
class _FoldedBNCore(BatchNorm):
    """``BatchNorm`` of a parity stack (B, 4C, H, W): the statistics fold
    the parity axis (``ops/parity.py::folded_moments``), so they are the
    full-resolution tensor's. Same parameters and buffers as ``BatchNorm``,
    so the state-dict path is the plain block's
    ``NormAct_k.BatchNorm_0.{weight,bias,running_*}``: this one module
    plays the reference's ``_FoldedBNWrap`` and ``_FoldedBNCore``, as
    ``BatchNorm`` plays flax's wrapper and core. Gradients flow through
    the batch statistics; the running update (under ``update_batch_stats``)
    is outside autograd, with the folded mean and variance."""

    def forward(self, xp: torch.Tensor, train: bool = True) -> torch.Tensor:
        c = self.weight.shape[0]
        if train:
            m, v = P.folded_moments(xp, c)
            if self.update_stats:
                with torch.no_grad():
                    mom = self.momentum
                    self.running_mean.mul_(mom).add_(m, alpha=1 - mom)
                    self.running_var.mul_(mom).add_(v, alpha=1 - mom)
        else:
            m, v = self.running_mean, self.running_var
        inv = torch.rsqrt(v + self.eps) * self.weight
        scale = inv.repeat(4)[None, :, None, None]
        shift = (self.bias - m * inv).repeat(4)[None, :, None, None]
        return (xp.to(wide(xp.dtype)) * scale + shift).to(xp.dtype)


class _ParityNormAct(nn.Module):
    """``NormAct`` over a parity stack (folded statistics)."""

    def __init__(self, num_features: int, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        if norm == "bn":
            self.BatchNorm_0 = _FoldedBNCore(num_features)
        elif norm != "id":
            raise ValueError(f"unknown norm '{norm}'")
        self.act = activation_fn(activation)

    def forward(self, xp: torch.Tensor, train: bool = True) -> torch.Tensor:
        if hasattr(self, "BatchNorm_0"):
            xp = self.BatchNorm_0(xp, train)
        return self.act(xp)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


_PACKS = {"up": (P.pack_up_conv, P.pack_up_conv2),
          "full": (P.pack_full_conv, P.pack_full_conv2)}


def _parity_conv(h, conv, cout, mode, fused=False):
    """The parity blocks' convs (``blocks.py:345-373``): ``'up'`` is conv3x3
    over nearest-up2 of NCHW ``h``, ``'full'`` the full-resolution conv3x3
    over the parity stack ``h``; both give a (B, 4*cout, H, W) parity stack.
    The merged-tap kernel (K3) when ``fused``, else ``conv_parity2`` under
    ``ops.parity.MERGED_TAP``, else the 3x3-packed conv."""
    w, b = full_weight(conv), conv.bias
    if fused:
        return _nchw(fused_parity_conv(_nhwc(h), w, b, cout, mode))
    pack3, pack2 = _PACKS[mode]
    if P.MERGED_TAP:
        return P.conv_parity2(h, pack2(w), cout, b.repeat(4))
    return P.conv2d(h, pack3(w), b.repeat(4), padding=1)


class ParityResidualGeneratorBlock(RematBlock):
    """``ResidualGeneratorBlock`` in the parity (sub-pixel) domain, the same
    math: conv1(up2(h)) is a small-resolution conv with 4x the output
    channels (the upsampled tensor never exists), conv2 runs over the
    parity stack, one ``depth_to_space`` restores the layout. Under
    ``ops.parity.FUSED_G`` both convs go through the merged-tap kernel (K3,
    ``ops/parity_conv.py``). Same parameter tree as the plain block
    (``Conv_0``, ``Conv_1``, ``project_input`` hold the weights the packers
    read). Supported: upsample, not first, 2-D, norm in {bn, id}.

    ``emit_parity`` (set by ``Generator`` on the last tower block when a
    ``ParityGeneratorOutput`` follows) returns the (B, 4*out, H, W) parity
    stack instead of the restored layout.
    """

    def __init__(self, in_dims: int, out_dims: int, upsample: bool = True,
                 first_block: bool = False, norm: str = "bn",
                 activation: str = "relu", emit_parity: bool = False):
        super().__init__()
        if not upsample or first_block:
            raise ValueError("parity G block: upsample, not first, only")
        self.out_dims = out_dims
        self.emit_parity = emit_parity
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Conv_0 = Conv(in_dims, out_dims, 3)
        self.NormAct_1 = _ParityNormAct(out_dims, norm, activation)
        self.Conv_1 = Conv(out_dims, out_dims, 3)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1)

    def block_forward(self, x: torch.Tensor,
                      train: bool = True) -> torch.Tensor:
        cout = self.out_dims
        # norm+act commute with nearest upsampling; the upsample itself is
        # folded into conv1
        h = self.NormAct_0(x, train)
        y1p = tagged(_parity_conv, h, self.Conv_0, cout, "up", P.FUSED_G)
        h2 = self.NormAct_1(y1p, train)
        y2p = tagged(_parity_conv, h2, self.Conv_1, cout, "full",
                     P.FUSED_G)
        if hasattr(self, "project_input"):
            proj = self.project_input
            scp = P.conv2d(x, full_weight(proj).repeat(4, 1, 1, 1),
                           proj.bias.repeat(4))
        else:  # identity shortcut: all four parity planes of up2(x) are x
            scp = x.repeat(1, 4, 1, 1)
        yp = y2p + scp
        return yp if self.emit_parity else P.depth_to_space(yp, cout)


class ParityResidualDiscriminatorBlock(RematBlock):
    """``ResidualDiscriminatorBlock`` in the space-to-depth domain: both
    full-resolution convs run over parity stacks, and the average pool is
    folded into conv2's weights (``pack_down_conv``), so the block emits
    half resolution in standard layout. Plain torch ops, so the R1
    penalty's second-order gradient goes through it. Same parameter tree
    as the plain block.

    ``accept_parity`` takes the input already parity-stacked (the block's
    own ``space_to_depth`` is skipped and the bilinear shortcut samples the
    parity planes); ``emit_parity`` keeps the output parity-stacked (conv2
    + pool as one stride-2 conv with ``pack_down_parity_conv`` weights, the
    shortcut downsampled parity to parity). ``Discriminator`` sets both
    with ``set_layout``.
    """

    def __init__(self, in_dims: int, out_dims: int, first_block: bool = False,
                 norm: str = "bn", activation: str = "relu",
                 accept_parity: bool = False, emit_parity: bool = False):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        self.first_block = first_block
        self.norm, self.activation = norm, activation
        self.accept_parity = False
        self.emit_parity = emit_parity
        # flax's creation order, as in ResidualDiscriminatorBlock
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3)
        setattr(self, mid, _ParityNormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1)
        self.set_layout(accept_parity=accept_parity)

    def set_layout(self, accept_parity=None, emit_parity=None):
        """Switch the input or output layout; the input norm becomes the
        folded one (same parameters and buffers, carried over)."""
        if emit_parity is not None:
            self.emit_parity = emit_parity
        if accept_parity is None or accept_parity == self.accept_parity:
            return self
        self.accept_parity = accept_parity
        if not self.first_block:
            cls = _ParityNormAct if accept_parity else NormAct
            norm = cls(self.in_dims, self.norm, self.activation)
            norm.load_state_dict(self.NormAct_0.state_dict())
            self.NormAct_0 = norm
        return self

    def block_forward(self, x: torch.Tensor,
                      train: bool = True) -> torch.Tensor:
        cin, cout = self.in_dims, self.out_dims
        h = x if self.first_block else self.NormAct_0(x, train)
        hp = h if self.accept_parity else P.space_to_depth(h)
        y1p = tagged(_parity_conv, hp, self.Conv_0, cout, "full")
        h2 = getattr(self, self.mid_norm)(y1p, train)
        w2, b2 = full_weight(self.Conv_1), self.Conv_1.bias
        if self.emit_parity:
            # conv2 + pool emitting the parity stack of the half resolution
            y2 = tagged(lambda: P.conv2d(h2, P.pack_down_parity_conv(w2),
                                         b2.repeat(4), stride=2, padding=1))
            if self.accept_parity:
                x_sc = downsample_bilinear_half_parity_to_parity(x, cin)
            else:
                x_sc = P.space_to_depth(downsample_bilinear_half(x))
            if hasattr(self, "project_input"):
                proj = self.project_input
                x_sc = P.conv2d(x_sc, P.pack_point_conv(full_weight(proj)),
                                proj.bias.repeat(4))
            return x_sc + y2
        y2 = tagged(lambda: P.conv2d(h2, P.pack_down_conv(w2), b2,
                                     padding=1))
        if self.accept_parity:
            x_sc = downsample_bilinear_half_parity(x, cin)
        else:
            x_sc = downsample_bilinear_half(x)
        if hasattr(self, "project_input"):
            x_sc = self.project_input(x_sc)
        return x_sc + y2


class ParityGeneratorOutput(nn.Module):
    """``GeneratorOutput`` over a parity stack (B, 4*in, H, W): folded
    norm + act, a block-diagonal 1x1 conv (``pack_point_conv``), tanh on
    the parity planes, then one ``depth_to_space`` over the out channels.
    Same parameter tree as ``GeneratorOutput``; ``Generator`` swaps it in
    when the last tower block is a parity block."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu", output_activation: str = "tanh"):
        super().__init__()
        if output_activation not in ("tanh", "id"):
            raise ValueError(f"unknown output activation '{output_activation}'")
        self.out_dims = out_dims
        self.output_activation = output_activation
        self.NormAct_0 = _ParityNormAct(in_dims, norm, activation)
        self.Conv_0 = Conv(in_dims, out_dims, 1)

    def forward(self, xp: torch.Tensor, train: bool = True) -> torch.Tensor:
        xp = self.NormAct_0(xp, train)
        yp = P.conv2d(xp, P.pack_point_conv(full_weight(self.Conv_0)),
                      self.Conv_0.bias.repeat(4))
        if self.output_activation == "tanh":
            yp = torch.tanh(yp)
        return P.depth_to_space(yp, self.out_dims)


class ParityDiscriminatorInput(nn.Module):
    """``DiscriminatorInput`` in the space-to-depth domain: the image is
    parity-stacked first and the 1x1 conv runs block-diagonally; emits the
    parity layout for the first tower block (``accept_parity``). Same
    parameter tree as ``DiscriminatorInput``."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.Conv_0 = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        return P.conv2d(P.space_to_depth(x),
                        P.pack_point_conv(full_weight(self.Conv_0)),
                        self.Conv_0.bias.repeat(4))


# ------------------------------------------------------- fused G block
class FusedResidualGeneratorBlock(nn.Module):
    """``ResidualGeneratorBlock`` computed by the fused kernels K4/K5
    (``ops/gblock.py``), the same math. Training-mode BatchNorm with batch
    statistics, from ``_moments`` of x and K4's sums of conv1's output;
    eval mode runs ``_gblock_reference`` on the running statistics. It
    computes in x's dtype, the compute dtype (the reference casts x to it,
    ``blocks.py:218``, :227).

    Supported: upsample, not first, BatchNorm, leaky-relu ('relu'), 2-D.
    The parameters are the reference's flat ones: ``conv1_kernel``,
    ``conv1_bias``, ``conv2_kernel``, ``conv2_bias``, ``bn1_scale``,
    ``bn1_bias``, ``bn2_scale``, ``bn2_bias`` and, when in != out,
    ``project_kernel``, ``project_bias`` (kernels OIHW here, HWIO in the
    flax tree; ``convert.py`` maps them), and the running statistics are
    the buffers ``bn1_mean``, ``bn1_var``, ``bn2_mean``, ``bn2_var``,
    updated with momentum 0.9 under ``update_batch_stats``.
    ``use_kernel=False`` runs the kernels' plain versions on any device.
    """

    momentum = 0.9

    def __init__(self, in_dims: int, out_dims: int, upsample: bool = True,
                 first_block: bool = False, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        if not upsample or first_block or norm != "bn" \
                or activation != "relu":
            raise ValueError("fused block: unsupported configuration")
        cin, cout = in_dims, out_dims
        self.update_stats = False
        self.use_kernel = True
        self.conv1_kernel = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.conv1_bias = nn.Parameter(torch.empty(cout))
        self.conv2_kernel = nn.Parameter(torch.empty(cout, cout, 3, 3))
        self.conv2_bias = nn.Parameter(torch.empty(cout))
        self.bn1_scale = nn.Parameter(torch.ones(cin))
        self.bn1_bias = nn.Parameter(torch.zeros(cin))
        self.bn2_scale = nn.Parameter(torch.ones(cout))
        self.bn2_bias = nn.Parameter(torch.zeros(cout))
        if cin != cout:
            self.project_kernel = nn.Parameter(torch.empty(cout, cin, 1, 1))
            self.project_bias = nn.Parameter(torch.empty(cout))
        for name, n in (("bn1", cin), ("bn2", cout)):
            self.register_buffer(f"{name}_mean", torch.zeros(n))
            self.register_buffer(f"{name}_var", torch.ones(n))
        self.init_parameters_(None)

    def init_parameters_(self, generator):
        """torch's default conv init, as the reference's
        ``torch_kaiming_uniform`` / ``torch_bias_uniform``."""
        default_init_(self.conv1_kernel, self.conv1_bias, generator)
        default_init_(self.conv2_kernel, self.conv2_bias, generator)
        if hasattr(self, "project_kernel"):
            default_init_(self.project_kernel, self.project_bias, generator)

    def _params(self):
        """The ops' flat parameters; ``wp`` and ``bp`` are None for the
        identity shortcut (Cin == Cout), which K5 adds as x."""
        wp = bp = None
        if hasattr(self, "project_kernel"):
            wp = self.project_kernel[:, :, 0, 0].t()
            bp = self.project_bias
        return {"w1": self.conv1_kernel, "b1": self.conv1_bias,
                "w2": self.conv2_kernel, "b2": self.conv2_bias,
                "wp": wp, "bp": bp, "s1": self.bn1_scale, "o1": self.bn1_bias,
                "s2": self.bn2_scale, "o2": self.bn2_bias}

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1)
        if train:
            out, stats = fused_gblock(xh, self._params(),
                                      use_kernel=self.use_kernel)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    for name, batch in zip(("bn1_mean", "bn1_var", "bn2_mean",
                                            "bn2_var"), stats):
                        getattr(self, name).mul_(m).add_(batch, alpha=1 - m)
        else:
            out, _ = _gblock_reference(
                xh, self._params(),
                stats=(self.bn1_mean, self.bn1_var, self.bn2_mean,
                       self.bn2_var))
        return out.permute(0, 3, 1, 2).to(x.dtype)
