"""SA-GAN style self-attention with 4x-downsampled keys/values.

Counterpart of ``tartangan_tpu/models/attention.py:34-80``: theta/phi/g are
bias-free 1x1 convs to C/8, C/8, C/2; phi and g are 2x2 max-pooled (HW/4
K/V length); beta = softmax(theta^T phi), unscaled; out = gamma * o(beta g) + x
with a learnable scalar gamma initialized to 0.

The attention runs through ``ops/attention.py::attention``: the CUDA kernel
for tensors on the card, its plain version for tensors on the CPU.
``use_kernel=False`` takes the plain version on any device (the JAX
package's ``use_pallas=False``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import attention, attention_plain
from ..ops.resize import max_pool_2x
from .layers import Conv


class SelfAttention2d(nn.Module):
    def __init__(self, in_dims: int, use_kernel: bool = True):
        super().__init__()
        ck = max(in_dims // 8, 1)
        cv = max(in_dims // 2, 1)
        self.in_dims = in_dims
        self.use_kernel = use_kernel
        self.theta = Conv(in_dims, ck, 1, use_bias=False)
        self.phi = Conv(in_dims, ck, 1, use_bias=False)
        self.g = Conv(in_dims, cv, 1, use_bias=False)
        self.o = Conv(cv, in_dims, 1, use_bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        b, _, h, w = x.shape

        def rows(t):  # (B, C, H, W) -> (B, H*W, C), row-major over (H, W)
            return t.flatten(2).transpose(1, 2).contiguous()

        q = rows(self.theta(x))
        k = rows(max_pool_2x(self.phi(x)))
        v = rows(max_pool_2x(self.g(x)))
        o = (attention if self.use_kernel else attention_plain)(q, k, v)
        o = o.transpose(1, 2).reshape(b, -1, h, w)
        return self.gamma.to(x.dtype) * self.o(o) + x
