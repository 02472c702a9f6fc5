"""The plain reference of the training step that the benchmark's cells time.

Plain float32 PyTorch, with TF32 off, written from the published model
(awentzonline/tartangan ``tartangan/models/pluggan.py``, ``blocks.py`` and
``trainers/cnn.py``: the SA-GAN residual generator and discriminator,
BCE-with-logits, the R1 penalty on reals, Adam with betas (0, 0.999), an
EMA target generator) and imports nothing of the program. Parameter names
are those of the program's ``state_dict``, so the benchmark can hand both
the weights it makes.

One step on normalized reals ``real`` (NCHW float32 in [-1, 1]):

- D step: G(z_d) without a graph (G's BatchNorm statistics update); D on
  the reals, with R1 = mean over the batch of |dD(x)/dx|^2 summed over
  pixels when its weight is not 0, and D on the fakes; BCE over
  [reals, fakes] against [1, 0]; Adam on D's gradient of BCE + weight R1.
- G step: BCE of D(G(z_g)) against 1, differentiated for G only (D's
  statistics update), Adam on G.
- EMA: target += rate (G - target), parameters only.

BatchNorm normalizes with the batch mean and biased variance and updates
its running statistics as ``r = m r + (1 - m) batch`` (flax's momentum).
Leaky-relu has slope 0.2. The self-attention is SA-GAN's: theta, phi, g
and o are bias-free 1x1 convolutions to C/8, C/8, C/2 and C; phi and g are
2x2 max-pooled; o = softmax(theta^T phi) g, unscaled; out = gamma o + x.

``quant`` (a function on tensors), when given, rounds what the program
rounds to its compute type: the operands and the output of every
convolution, dense layer and attention product, and the output of every
normalization, activation and residual sum. The control of
``portbench/check.py`` passes ``fp8`` to compute the step in fp8 where the
program computes in bfloat16.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


def full_float32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------- fp8
def _round(x, dtype, fmax):
    """x rounded to ``dtype`` with a per-tensor scale that maps its largest
    magnitude to ``fmax`` (the usual fp8 recipe), in x's dtype."""
    with torch.no_grad():
        amax = x.abs().amax().float().clamp(min=1e-30)
        scale = fmax / amax
        y = (x * scale).clamp(-fmax, fmax).to(dtype).to(x.dtype) / scale
    return y


class _FP8(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2 (straight
    through, to any order)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _FP8Grad.apply(g)


class _FP8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)

    @staticmethod
    def backward(ctx, gg):
        return _FP8.apply(gg)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


def _q(quant, t):
    return t if quant is None else quant(t)


# ---------------------------------------------------------------- layers
class BatchNorm(nn.Module):
    def __init__(self, c, eps, momentum):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_stats = False
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        dims = (0, 2, 3)
        mean = x.mean(dims)
        var = (x - mean.view(1, -1, 1, 1)).square().mean(dims)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
                + self.bias.view(1, -1, 1, 1))


class NormAct(nn.Module):
    def __init__(self, c, hp, quant=None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(c, hp["bn_eps"], hp["bn_momentum"])
        self.slope = hp["leaky_slope"]
        self.quant = quant

    def forward(self, x):
        return _q(self.quant, F.leaky_relu(self.BatchNorm_0(x), self.slope))


class Conv(nn.Module):
    def __init__(self, cin, cout, k, quant, bias=True):
        super().__init__()
        self.quant = quant
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        w = self.weight
        return _q(self.quant, F.conv2d(_q(self.quant, x), _q(self.quant, w),
                                       self.bias, padding=w.shape[-1] // 2))


class Dense(nn.Module):
    def __init__(self, cin, cout, quant):
        super().__init__()
        self.quant = quant
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return _q(self.quant, F.linear(_q(self.quant, x),
                                       _q(self.quant, self.weight), self.bias))


def upsample2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class GBlock(nn.Module):
    """Pre-activation residual up block: main [norm, act,] conv3, norm,
    act, conv3 on the 2x nearest-upsampled input; shortcut the upsampled
    input, 1x1-projected when the width changes."""

    def __init__(self, cin, cout, first, hp, quant):
        super().__init__()
        self.first, self.quant = first, quant
        mid = "NormAct_0"
        if not first:
            self.NormAct_0 = NormAct(cin, hp, quant)
            mid = "NormAct_1"
        self.Conv_0 = Conv(cin, cout, 3, quant)
        setattr(self, mid, NormAct(cout, hp, quant))
        self.mid = mid
        self.Conv_1 = Conv(cout, cout, 3, quant)
        if cin != cout:
            self.project_input = Conv(cin, cout, 1, quant)

    def forward(self, x):
        x = upsample2(x)
        h = x if self.first else self.NormAct_0(x)
        h = self.Conv_1(getattr(self, self.mid)(self.Conv_0(h)))
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return _q(self.quant, x + h)


class DBlock(nn.Module):
    """Pre-activation residual down block: main [norm, act,] conv3, norm,
    act, conv3, 2x2 average pool; shortcut bilinear to half size (corners
    aligned), 1x1-projected when the width changes."""

    def __init__(self, cin, cout, first, hp, quant):
        super().__init__()
        self.first, self.quant = first, quant
        mid = "NormAct_0"
        if not first:
            self.NormAct_0 = NormAct(cin, hp, quant)
            mid = "NormAct_1"
        self.Conv_0 = Conv(cin, cout, 3, quant)
        setattr(self, mid, NormAct(cout, hp, quant))
        self.mid = mid
        self.Conv_1 = Conv(cout, cout, 3, quant)
        if cin != cout:
            self.project_input = Conv(cin, cout, 1, quant)

    def forward(self, x):
        h = x if self.first else self.NormAct_0(x)
        h = self.Conv_1(getattr(self, self.mid)(self.Conv_0(h)))
        h = F.avg_pool2d(h, 2)
        _, _, hh, ww = x.shape
        x = F.interpolate(x, size=(hh // 2, ww // 2), mode="bilinear",
                          align_corners=True)
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return _q(self.quant, x + h)


class SelfAttention(nn.Module):
    def __init__(self, c, quant):
        super().__init__()
        self.quant = quant
        ck, cv = max(c // 8, 1), max(c // 2, 1)
        self.theta = Conv(c, ck, 1, quant, bias=False)
        self.phi = Conv(c, ck, 1, quant, bias=False)
        self.g = Conv(c, cv, 1, quant, bias=False)
        self.o = Conv(cv, c, 1, quant, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        b, _, h, w = x.shape
        q = self.theta(x).flatten(2).transpose(1, 2)
        k = F.max_pool2d(self.phi(x), 2).flatten(2).transpose(1, 2)
        v = F.max_pool2d(self.g(x), 2).flatten(2).transpose(1, 2)
        p = torch.softmax(torch.bmm(_q(self.quant, q),
                                    _q(self.quant, k).transpose(1, 2)), -1)
        o = _q(self.quant, torch.bmm(_q(self.quant, p), _q(self.quant, v)))
        o = o.transpose(1, 2).reshape(b, -1, h, w)
        return _q(self.quant, self.gamma * self.o(o) + x)


class Generator(nn.Module):
    """latent -> act(Dense) as (B, 4, 4, C) -> blocks (+ attention after
    the listed block indices) -> norm, act, 1x1 conv, tanh."""

    def __init__(self, cfg, hp, quant=None):
        super().__init__()
        base, blocks = cfg["base_size"], cfg["blocks"]
        self.base, self.c0, self.slope = base, blocks[0], hp["leaky_slope"]
        self.input_block = nn.Module()
        self.input_block.Dense_0 = Dense(cfg["latent_dims"],
                                         base * base * blocks[0], quant)
        layers, cin = [], blocks[0]
        for i, cout in enumerate(blocks):
            layers.append(GBlock(cin, cout, i == 0, hp, quant))
            if i in cfg["attention"]:
                layers.append(SelfAttention(cout, quant))
            cin = cout
        self.blocks = nn.ModuleList(layers)
        self.output_block = nn.Module()
        self.output_block.NormAct_0 = NormAct(cin, hp, quant)
        self.output_block.Conv_0 = Conv(cin, cfg["data_dims"], 1, quant)
        self.quant = quant

    def forward(self, z):
        x = _q(self.quant,
               F.leaky_relu(self.input_block.Dense_0(z), self.slope))
        x = x.reshape(-1, self.base, self.base, self.c0).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        out = self.output_block
        return _q(self.quant, torch.tanh(out.Conv_0(out.NormAct_0(x))))


class Discriminator(nn.Module):
    """1x1 conv -> blocks over the reversed widths (+ attention) -> norm,
    act, sum over pixels, Dense to one logit."""

    def __init__(self, cfg, hp, quant=None):
        super().__init__()
        blocks = cfg["blocks"]
        self.input_block = nn.Module()
        self.input_block.Conv_0 = Conv(cfg["data_dims"], blocks[-1], 1, quant)
        layers, cin = [], blocks[-1]
        for i in reversed(range(len(blocks))):
            layers.append(DBlock(cin, blocks[i], i == len(blocks) - 1, hp,
                                 quant))
            if i in cfg["attention"]:
                layers.append(SelfAttention(blocks[i], quant))
            cin = blocks[i]
        self.blocks = nn.ModuleList(layers)
        self.output_block = nn.Module()
        self.output_block.NormAct_0 = NormAct(cin, hp, quant)
        self.output_block.Dense_0 = Dense(cin, 1, quant)

    def forward(self, x):
        x = self.input_block.Conv_0(x)
        for block in self.blocks:
            x = block(x)
        out = self.output_block
        return out.Dense_0(out.NormAct_0(x).sum((2, 3)))


def build(cfg, hp, quant=None):
    """(G, D) of configuration ``cfg``, hyperparameters ``hp``."""
    return Generator(cfg, hp, quant), Discriminator(cfg, hp, quant)


# ---------------------------------------------------------------- step
class Adam:
    """Adam as published (Kingma and Ba), float32."""

    def __init__(self, params, lr, betas, eps):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr / c1 * m / ((v / c2).sqrt() + self.eps))


@contextlib.contextmanager
def batch_stats(*models):
    bns = [m for model in models for m in model.modules()
           if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = False


def bce(logits, target):
    return (logits.clamp(min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def normalize(batch_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [-1, 1]."""
    return batch_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0


class Trainer:
    """G, its EMA target, D and both Adams: ``step`` runs one train step
    and returns its losses and each model's gradients (by name). ``dtype``
    float64 gives a witness of higher precision."""

    def __init__(self, cfg, hp, weights, device, quant=None,
                 dtype=torch.float32):
        self.hp, self.dtype = hp, dtype
        self.g, self.d = (m.to(device, dtype) for m in build(cfg, hp, quant))
        self.g_target = build(cfg, hp)[0].to(device, dtype)
        for model, name in ((self.g, "g"), (self.g_target, "g"),
                            (self.d, "d")):
            model.load_state_dict(weights[name])
        self.g_target.requires_grad_(False)
        betas, eps = tuple(hp["adam_betas"]), hp["adam_eps"]
        self.opt_g = Adam(self.g.parameters(), hp["lr_g"], betas, eps)
        self.opt_d = Adam(self.d.parameters(), hp["lr_d"], betas, eps)

    def step(self, batch_u8, draws, gp_weight):
        """One step on the draws the program's step took: ``z_d`` (1, B,
        latent; one D update) and ``z_g`` (B, latent)."""
        g, d = self.g, self.d
        real = normalize(batch_u8).to(self.dtype)
        z_d, z_g = draws["z_d"][0].to(self.dtype), draws["z_g"].to(self.dtype)
        b = real.shape[0]
        with torch.no_grad(), batch_stats(g):
            fake = g(z_d)
        d_params = list(d.parameters())
        with batch_stats(d):
            if gp_weight:
                real.requires_grad_(True)
                p_real = d(real)
                (dx,) = torch.autograd.grad(p_real.sum(), real,
                                            create_graph=True)
                gp = dx.square().reshape(b, -1).sum(1).mean()
            else:
                p_real = d(real)
                gp = torch.zeros((), device=real.device)
            p_fake = d(fake)
        labels = torch.cat([torch.ones(b, 1), torch.zeros(b, 1)]).to(real)
        d_loss = bce(torch.cat([p_real, p_fake]), labels) + gp_weight * gp
        d_grads = torch.autograd.grad(d_loss, d_params)
        self.opt_d.step(d_grads)

        with batch_stats(g, d):
            g_loss, g_grads = self._g_loss_grads(z_g)
        self.opt_g.step(g_grads.values())
        with torch.no_grad():
            for t, s in zip(self.g_target.parameters(), g.parameters()):
                t.lerp_(s, self.hp["ema"])
        return ({"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                 "gp": gp.detach()},
                {"d": dict(zip([n for n, _ in d.named_parameters()],
                               d_grads)),
                 "g": g_grads})

    def _g_loss_grads(self, z_g):
        """G's loss, BCE of D(G(z_g)) against 1, and G's gradient of it by
        name."""
        names, params = zip(*self.g.named_parameters())
        p = self.d(self.g(z_g))
        g_loss = bce(p, torch.ones_like(p))
        return g_loss, dict(zip(names, torch.autograd.grad(g_loss, params)))

    def g_grads(self, draws):
        """G's gradient at a step's latents ``z_g``, as the G step takes
        it, with nothing updated."""
        return self._g_loss_grads(draws["z_g"].to(self.dtype))[1]

    def state(self):
        """name -> tensor of everything the check compares after the
        steps: G's and D's parameters and statistics, the target's
        parameters."""
        out = {}
        for key, model in (("g", self.g), ("d", self.d)):
            for name, t in model.state_dict().items():
                out[f"{key}.{name}"] = t.detach().clone()
        for name, t in self.g_target.named_parameters():
            out[f"g_target.{name}"] = t.detach().clone()
        return out
