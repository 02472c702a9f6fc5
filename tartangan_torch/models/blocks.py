"""Generator and discriminator building blocks (NCHW).

Counterparts of ``tartangan_tpu/models/blocks.py``: ``GeneratorInputMLP``
(:537), ``TiledZGeneratorInput`` (:573), ``ResidualGeneratorBlock`` (:104),
``GeneratorOutput`` (:592), ``DiscriminatorInput`` (:649),
``ResidualDiscriminatorBlock`` (:717) and ``DiscriminatorOutput`` (:757);
the parity-domain forms ``ParityResidualGeneratorBlock`` (:376),
``ParityGeneratorOutput`` (:613), ``ParityResidualDiscriminatorBlock``
(:444) and ``ParityDiscriminatorInput`` (:664) with the folded BatchNorm
(:233-302); and ``FusedResidualGeneratorBlock`` (:151). Attribute names
follow the flax param tree (``NormAct_0``, ``Conv_0``, ``project_input``,
...; the fused block's flat ``conv1_kernel`` ...), so a parity block has the
plain block's tree and ``convert.py`` carries either. Every block takes
``(x, train)``; ``train=True`` normalizes with batch statistics.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import parity as P
from ..ops.gblock import _gblock_reference, fused_gblock
from ..ops.init import default_init_
from ..ops.parity_conv import fused_parity_conv
from ..ops.resize import (
    avg_pool_2x,
    downsample_bilinear_half,
    downsample_bilinear_half_parity,
    downsample_bilinear_half_parity_to_parity,
    upsample_nearest_2x,
)
from .layers import BatchNorm, Conv, Dense, NormAct, activation_fn


class ResidualGeneratorBlock(nn.Module):
    """Pre-activation residual up block.

    main: [norm, act,] conv3(in->out), norm, act, conv3(out->out)
    shortcut: 1x1 projection iff in != out; nearest-2x upsample applied to
    the block input before both paths.
    """

    def __init__(self, in_dims: int, out_dims: int, upsample: bool = True,
                 first_block: bool = False, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.upsample = upsample
        self.first_block = first_block
        # flax numbers NormAct modules in creation order: the input norm,
        # when there is one, is NormAct_0 and the mid norm NormAct_1
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        # norm+act commute exactly with nearest upsampling (pointwise ops
        # on repeated values; the batch stats of the repeated tensor equal
        # those of the source), so they run at the small resolution, in
        # the same order as the reference (blocks.py:123-132)
        if self.upsample and not self.first_block:
            h = upsample_nearest_2x(self.NormAct_0(x, train))
            x = upsample_nearest_2x(x)
        else:
            if self.upsample:
                x = upsample_nearest_2x(x)
            h = x
            if not self.first_block:
                h = self.NormAct_0(h, train)
        h = self.Conv_0(h)
        h = getattr(self, self.mid_norm)(h, train)
        h = self.Conv_1(h)
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return x + h


class GeneratorInputMLP(nn.Module):
    """latent -> act(Linear) -> (B, out, size, size)."""

    def __init__(self, latent_dims: int, output_dims: int, size: int = 4,
                 activation: str = "relu"):
        super().__init__()
        self.output_dims = output_dims
        self.size = size
        self.act = activation_fn(activation)
        self.Dense_0 = Dense(latent_dims, size ** 2 * output_dims)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        base = self.act(self.Dense_0(z))
        # flax reshapes the dense output as (B, H, W, C)
        base = base.reshape(-1, self.size, self.size, self.output_dims)
        return base.permute(0, 3, 1, 2).contiguous()


class TiledZGeneratorInput(nn.Module):
    """Tile z to a (B, latent, size, size) map."""

    def __init__(self, latent_dims: int, output_dims: int, size: int = 4,
                 activation: str = "relu"):
        super().__init__()
        if latent_dims != output_dims:
            raise ValueError("TiledZGeneratorInput needs latent_dims == "
                             f"output_dims, got {latent_dims}, {output_dims}")
        self.size = size

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        b, c = z.shape
        return z[:, :, None, None].expand(b, c, self.size, self.size)


class GeneratorOutput(nn.Module):
    """norm -> act -> 1x1 conv -> tanh."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu", output_activation: str = "tanh"):
        super().__init__()
        if output_activation not in ("tanh", "id"):
            raise ValueError(f"unknown output activation '{output_activation}'")
        self.output_activation = output_activation
        self.norm, self.activation = norm, activation
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Conv_0 = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.Conv_0(self.NormAct_0(x, train))
        if self.output_activation == "tanh":
            x = torch.tanh(x)
        return x


class DiscriminatorInput(nn.Module):
    """1x1 conv image -> features."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.Conv_0 = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        return self.Conv_0(x)


class ResidualDiscriminatorBlock(nn.Module):
    """Pre-activation residual down block.

    main: [norm, act,] conv3(in->out), norm, act, conv3(out->out), avgpool2
    shortcut: bilinear 0.5x (align_corners=True), then a 1x1 projection iff
    in != out.
    """

    def __init__(self, in_dims: int, out_dims: int, first_block: bool = False,
                 norm: str = "bn", activation: str = "relu"):
        super().__init__()
        self.first_block = first_block
        # flax's creation order, as in ResidualGeneratorBlock
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = x if self.first_block else self.NormAct_0(x, train)
        h = self.Conv_0(h)
        h = getattr(self, self.mid_norm)(h, train)
        h = avg_pool_2x(self.Conv_1(h))
        x = downsample_bilinear_half(x, align_corners=True)
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return x + h


class DiscriminatorOutput(nn.Module):
    """norm -> act -> spatial sum-pool -> Linear."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Dense_0 = Dense(in_dims, out_dims)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.NormAct_0(x, train)
        return self.Dense_0(x.sum(dim=(2, 3)))


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
        return (xp.float() * scale + shift).to(xp.dtype)


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
    w, b = conv.weight, conv.bias
    if fused:
        return _nchw(fused_parity_conv(_nhwc(h), w, b, cout, mode))
    pack3, pack2 = _PACKS[mode]
    if P.MERGED_TAP:
        return P.conv_parity2(h, pack2(w), cout, b.repeat(4))
    return P.conv2d(h, pack3(w), b.repeat(4), padding=1)


class ParityResidualGeneratorBlock(nn.Module):
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

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        cout = self.out_dims
        # norm+act commute with nearest upsampling; the upsample itself is
        # folded into conv1
        h = self.NormAct_0(x, train)
        y1p = _parity_conv(h, self.Conv_0, cout, "up", fused=P.FUSED_G)
        h2 = self.NormAct_1(y1p, train)
        y2p = _parity_conv(h2, self.Conv_1, cout, "full", fused=P.FUSED_G)
        if hasattr(self, "project_input"):
            proj = self.project_input
            scp = P.conv2d(x, proj.weight.repeat(4, 1, 1, 1),
                           proj.bias.repeat(4))
        else:  # identity shortcut: all four parity planes of up2(x) are x
            scp = x.repeat(1, 4, 1, 1)
        yp = y2p + scp
        return yp if self.emit_parity else P.depth_to_space(yp, cout)


class ParityResidualDiscriminatorBlock(nn.Module):
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

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        cin, cout = self.in_dims, self.out_dims
        h = x if self.first_block else self.NormAct_0(x, train)
        hp = h if self.accept_parity else P.space_to_depth(h)
        y1p = _parity_conv(hp, self.Conv_0, cout, "full")
        h2 = getattr(self, self.mid_norm)(y1p, train)
        w2, b2 = self.Conv_1.weight, self.Conv_1.bias
        if self.emit_parity:
            # conv2 + pool emitting the parity stack of the half resolution
            y2 = P.conv2d(h2, P.pack_down_parity_conv(w2), b2.repeat(4),
                          stride=2, padding=1)
            if self.accept_parity:
                x_sc = downsample_bilinear_half_parity_to_parity(x, cin)
            else:
                x_sc = P.space_to_depth(downsample_bilinear_half(x))
            if hasattr(self, "project_input"):
                proj = self.project_input
                x_sc = P.conv2d(x_sc, P.pack_point_conv(proj.weight),
                                proj.bias.repeat(4))
            return x_sc + y2
        y2 = P.conv2d(h2, P.pack_down_conv(w2), b2, padding=1)
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
        yp = P.conv2d(xp, P.pack_point_conv(self.Conv_0.weight),
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
                        P.pack_point_conv(self.Conv_0.weight),
                        self.Conv_0.bias.repeat(4))


# ------------------------------------------------------- fused G block
class FusedResidualGeneratorBlock(nn.Module):
    """``ResidualGeneratorBlock`` computed by the fused kernels K4/K5
    (``ops/gblock.py``), the same math. Training-mode BatchNorm with batch
    statistics, from ``_moments`` of x and K4's sums of conv1's output;
    eval mode runs ``_gblock_reference`` on the running statistics.

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
        if hasattr(self, "project_kernel"):
            wp = self.project_kernel[:, :, 0, 0].t()
            bp = self.project_bias
        else:  # identity shortcut as an I-projection (the same math)
            wp = torch.eye(self.bn1_scale.shape[0],
                           dtype=self.conv1_kernel.dtype,
                           device=self.conv1_kernel.device)
            bp = torch.zeros_like(self.conv1_bias)
        return {"w1": self.conv1_kernel, "b1": self.conv1_bias,
                "w2": self.conv2_kernel, "b2": self.conv2_bias,
                "wp": wp, "bp": bp, "s1": self.bn1_scale, "o1": self.bn1_bias,
                "s2": self.bn2_scale, "o2": self.bn2_bias}

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1).float()
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
