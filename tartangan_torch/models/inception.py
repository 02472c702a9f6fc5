"""InceptionV3 (pool3 features + logits), NCHW.

Counterpart of ``tartangan_tpu/models/inception.py``: the torchvision
``inception_v3`` trunk that the FID/IS wrapper runs (reference
inception_utils.py:50-92). Module and parameter names are torchvision's
(``Mixed_5b.branch1x1.conv.weight``, ``...bn.running_var``, ``fc.bias``), so
a torchvision state_dict loads by name; ``torch_key_map`` relates each one
to the JAX package's flat variable key (``params.Mixed_5b.branch1x1.conv.
kernel``), the key of the ``--inception-weights`` npz that both packages
read and write.

Every conv is bias-free + inference BatchNorm (eps 1e-3) + relu
(torchvision's ``BasicConv2d``). The network computes in float32.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import max_pool

WEIGHTS_ENV_VAR = "TARTANGAN_INCEPTION_WEIGHTS"


def _avg_pool_3x3_s1(x):
    """AvgPool2d(3, stride=1, padding=1) that counts the padding (the sum
    over the window divided by 9)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InferenceBatchNorm(nn.Module):
    """BatchNorm with the running statistics (flax ``use_running_average``)
    in one ``F.batch_norm`` launch; torchvision's names without
    ``num_batches_tracked``, and no train mode."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class BasicConv2d(nn.Module):
    def __init__(self, in_channels, out_channels, kernel, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel,
                              stride=stride, padding=padding, bias=False)
        self.bn = InferenceBatchNorm(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, in_channels, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, max_pool(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_channels, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avg_pool_3x3_s1(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3Features(nn.Module):
    """The torchvision InceptionV3 trunk of the FID wrapper: a normalized
    (B, 3, 299, 299) image -> (pool (B, 2048), logits (B, 1000))."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x):
        x = x.float()
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = max_pool(x, 3, 2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = max_pool(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool = torch.mean(x, dim=(2, 3))
        return pool, self.fc(pool)


# ------------------------------------------------- flax keys and shapes
# torch leaf -> (flax collection, flax leaf)
_LEAF = {"conv.weight": ("params", "kernel"),
         "bn.weight": ("params", "scale"), "bn.bias": ("params", "bias"),
         "bn.running_mean": ("batch_stats", "mean"),
         "bn.running_var": ("batch_stats", "var"),
         "fc.weight": ("params", "kernel"), "fc.bias": ("params", "bias")}
_LEAF_RE = re.compile(r"^(?:(.+)\.)?((?:conv|bn|fc)\.\w+)$")


def torch_key_map(model: nn.Module) -> dict:
    """The JAX package's flat variable key ('params.Mixed_5b.branch1x1.
    conv.kernel') -> ``model``'s state_dict key (the torchvision key), for
    every weight, in the order of the JAX package's flattened variable
    tree: collections, module names and leaves sorted at every level, as
    ``jax.tree_util`` rebuilds dicts. ``model`` is the network or one of
    its blocks."""
    mapping = {}
    for torch_key in model.state_dict():
        m = _LEAF_RE.match(torch_key)
        if m is None:
            raise KeyError(f"unmapped state_dict key {torch_key}")
        path, leaf = m.group(1), m.group(2)
        collection, flax_leaf = _LEAF[leaf]
        parts = [collection] + (path.split(".") if path else []) + \
            [leaf.split(".")[0], flax_leaf]
        mapping[tuple(parts)] = torch_key
    return {".".join(k): mapping[k] for k in sorted(mapping)}


def to_flax_layout(array: np.ndarray) -> np.ndarray:
    """A torch weight in the JAX package's layout: conv OIHW -> HWIO, fc
    (out, in) -> (in, out); vectors as they are."""
    if array.ndim == 4:
        return array.transpose(2, 3, 1, 0)
    return array.T if array.ndim == 2 else array


def from_flax_layout(array: np.ndarray) -> np.ndarray:
    """The inverse of ``to_flax_layout``: HWIO -> OIHW, (in, out) -> (out,
    in)."""
    if array.ndim == 4:
        return array.transpose(3, 2, 0, 1)
    return array.T if array.ndim == 2 else array


def flax_shape(tensor: torch.Tensor) -> tuple:
    """``tensor``'s shape in the JAX package's layout."""
    shape = tuple(tensor.shape)
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    return shape[::-1]


def init_inception(seed: int = 0) -> InceptionV3Features:
    """The network with the JAX package's template values
    (``init_inception``, ``tartangan_tpu/models/inception.py:211-255``),
    bit for bit: in the order of its flattened variable tree, each conv
    and fc kernel is drawn as ``rng.normal(0, fan_in ** -0.5, shape)`` in
    its flax shape from one ``np.random.default_rng(seed)``, then
    transposed; BatchNorm scale and var are 1, bias and mean 0.
    ``inception_calibrated.npz`` holds BatchNorm statistics calibrated for
    exactly these draws. On the CPU; the caller moves it. Built without
    torch's own initialization, so torch's global generator is not
    drawn from."""
    with torch.device("meta"):
        model = InceptionV3Features()
    model = model.to_empty(device="cpu").eval().requires_grad_(False)
    state = model.state_dict()
    rng = np.random.default_rng(seed)
    for flax_key, torch_key in torch_key_map(model).items():
        leaf = flax_key.split(".")[-1]
        if leaf in ("scale", "var"):
            state[torch_key].fill_(1.0)
        elif leaf in ("bias", "mean"):
            state[torch_key].zero_()
        else:  # conv and fc kernels
            shape = flax_shape(state[torch_key])
            fan_in = int(np.prod(shape[:-1])) or 1
            val = rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
            state[torch_key].copy_(torch.from_numpy(from_flax_layout(val)))
    return model


def load_flax_variables(model: nn.Module, flat: dict) -> nn.Module:
    """Copy JAX-layout arrays keyed by flat variable key into ``model`` (in
    place; shape-checked). Keys absent from ``flat`` keep their value."""
    state = model.state_dict()
    for flax_key, torch_key in torch_key_map(model).items():
        if flax_key not in flat:
            continue
        arr = np.asarray(flat[flax_key])
        target = state[torch_key]
        if arr.shape != flax_shape(target):
            raise ValueError(f"{flax_key} has shape {arr.shape}, expected "
                             f"{flax_shape(target)}")
        target.copy_(torch.from_numpy(
            np.ascontiguousarray(from_flax_layout(arr))).to(target.dtype))
    return model


def port_torch_state_dict(model: nn.Module, state_dict) -> nn.Module:
    """Load a torchvision ``inception_v3`` state_dict into ``model`` (in
    place): every weight of the trunk, by name, shape-checked; other keys
    (``AuxLogits``, ``num_batches_tracked``) are not read."""
    state = model.state_dict()
    for torch_key in torch_key_map(model).values():
        val = torch.as_tensor(np.asarray(state_dict[torch_key]))
        if tuple(val.shape) != tuple(state[torch_key].shape):
            raise ValueError(f"{torch_key}: {tuple(val.shape)} vs "
                             f"{tuple(state[torch_key].shape)}")
        state[torch_key].copy_(val)
    return model


def save_weights_npz(model: nn.Module, path) -> None:
    """The network's weights as the flat npz ``--inception-weights`` loads:
    keys are the JAX package's flat variable keys, arrays in its layout
    (``save_weights_npz``; uncompressed, as there)."""
    state = model.state_dict()
    np.savez(path, **{
        k: to_flax_layout(state[t].detach().cpu().numpy())
        for k, t in torch_key_map(model).items()})


def load_weights_npz(model: nn.Module, path) -> nn.Module:
    """Load an npz written by ``save_weights_npz`` (either package's) into
    ``model``, shape-checked leaf by leaf. A STATS-ONLY archive (every key
    under ``batch_stats.``, as the JAX package's ``eval/calibrate.py``
    writes) loads the BatchNorm running statistics and leaves every other
    weight as it is."""
    expected_all = list(torch_key_map(model))
    with np.load(path) as data:
        stats_only = all(k.startswith("batch_stats.") for k in data.files)
        expected = [k for k in expected_all
                    if not stats_only or k.startswith("batch_stats.")]
        missing = [k for k in expected if k not in data.files]
        if missing:
            raise KeyError(
                f"{path} is missing {len(missing)} inception variables "
                f"(first: {missing[0]}) — was it written by "
                "save_weights_npz / the port_weights CLI?")
        return load_flax_variables(model, {k: data[k] for k in expected})


def resolve_pretrained(model: nn.Module, weights_path=None):
    """Pretrained weights into ``model``: an explicit npz path wins, then
    the TARTANGAN_INCEPTION_WEIGHTS variable, then an installed
    torchvision's cache; otherwise the weights stay as they are. Returns
    (model, pretrained: bool). The npz comes from ``python -m
    tartangan_torch.eval.port_weights`` (or the JAX package's CLI)."""
    path = weights_path or os.environ.get(WEIGHTS_ENV_VAR)
    if path:
        return load_weights_npz(model, path), True
    return try_load_pretrained(model)


def try_load_pretrained(model: nn.Module):
    """Port torchvision's pretrained weights if torchvision and its weight
    cache are there; otherwise say so and keep ``model`` as it is."""
    try:
        from torchvision.models import inception_v3  # noqa: PLC0415
        net = inception_v3(pretrained=True, transform_input=False)
        return port_torch_state_dict(model, net.state_dict()), True
    except Exception as e:  # noqa: BLE001 - no torchvision, no cache
        print(f"[inception] pretrained weights unavailable ({e}); "
              "using provided init")
        return model, False
