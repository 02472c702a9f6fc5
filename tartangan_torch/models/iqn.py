"""Implicit Quantile Network head and the quantile-Huber regression loss.

Counterparts of ``tartangan_tpu/models/iqn.py``: ``CosineQuantileEmbedding``
(:22-38), ``QuantileEmbedding`` (:41-58), ``WeightedQuantileEmbedding``
(:61-83), ``IQN`` (:86-113) and ``iqn_loss`` (:116-137). The JAX package
draws the quantiles tau inside the head from a PRNG key; here the caller
draws them (the trainer, outside the train step, as it draws the latents)
and ``IQN`` takes them as an argument, so a test can feed the JAX
package's taus and a captured CUDA graph reads them as a device tensor.
Each layer computes in its input's dtype (``models/layers.py``); the
cosine features are computed in float32 and cast, and the loss is
computed in float32, as in the reference.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel.collectives import batch_mean
from .layers import BatchNorm, Dense, leaky_relu


class CosineQuantileEmbedding(nn.Module):
    """tau -> cos(pi * tau * [1..E]) -> Linear -> tanh."""

    def __init__(self, state_dims: int, embedding_dims: int = 64):
        super().__init__()
        self.embedding_dims = embedding_dims
        self.to_state = Dense(embedding_dims, state_dims)

    def forward(self, quantiles: torch.Tensor, dtype: torch.dtype,
                train: bool = True) -> torch.Tensor:
        """(N, 1) quantiles -> (N, state_dims) in ``dtype``."""
        del train
        steps = torch.arange(1, self.embedding_dims + 1,
                             dtype=torch.float32, device=quantiles.device)
        qs = quantiles.float() * math.pi * steps
        return torch.tanh(self.to_state(torch.cos(qs).to(dtype)))


class QuantileEmbedding(nn.Module):
    """tau tiled -> Linear -> leaky-relu -> BN -> Linear -> BN."""

    def __init__(self, state_dims: int, embedding_dims: int = 64):
        super().__init__()
        self.embedding_dims = embedding_dims
        self.Dense_0 = Dense(embedding_dims, embedding_dims)
        self.BatchNorm_0 = BatchNorm(embedding_dims)
        self.Dense_1 = Dense(embedding_dims, state_dims)
        self.BatchNorm_1 = BatchNorm(state_dims)

    def forward(self, quantiles: torch.Tensor, dtype: torch.dtype,
                train: bool = True) -> torch.Tensor:
        qs = quantiles.to(dtype).repeat(1, self.embedding_dims)
        qs = self.BatchNorm_0(leaky_relu(self.Dense_0(qs)), train)
        return self.BatchNorm_1(self.Dense_1(qs), train)


class WeightedQuantileEmbedding(nn.Module):
    """Inverse-distance-weighted mixture over a learned table of
    ``num_embeddings`` quantile embeddings."""

    def __init__(self, state_dims: int, num_embeddings: int = 20,
                 use_softmax: bool = True):
        super().__init__()
        self.use_softmax = use_softmax
        self.quantile_embeddings = nn.Parameter(
            torch.empty(num_embeddings, state_dims))
        self.init_parameters_(None)

    def init_parameters_(self, generator):
        """N(0, 1), the reference's ``nn.initializers.normal(1.0)``."""
        with torch.no_grad():
            self.quantile_embeddings.normal_(generator=generator)

    def forward(self, quantiles: torch.Tensor, dtype: torch.dtype,
                train: bool = True) -> torch.Tensor:
        del train
        table = self.quantile_embeddings
        n = table.shape[0]
        # jnp.linspace's values (torch.linspace rounds one of 20 apart,
        # which 1 / distance magnifies)
        indexes = torch.arange(n, dtype=torch.float32,
                               device=quantiles.device) / max(n - 1, 1)
        w = 1.0 / ((quantiles.float() - indexes).abs() + 1e-8)
        if self.use_softmax:
            w = torch.softmax(w, dim=-1)
        else:
            w = w / w.sum(-1, keepdim=True)
        return w.to(dtype) @ table.to(dtype)


class IQN(nn.Module):
    """Tile the features once per quantile and mix in each tau's cosine
    embedding (``quantile_dims`` = 20 cosine features, as the
    reference)."""

    def __init__(self, feature_dims: int, quantile_dims: int = 20,
                 num_quantiles: int = 8, mix: str = "mult"):
        super().__init__()
        if mix not in ("add", "mult"):
            raise ValueError(f"Unknown mix method {mix}")
        self.num_quantiles = num_quantiles
        self.mix = mix
        self.quantile_embedding = CosineQuantileEmbedding(feature_dims,
                                                          quantile_dims)

    def forward(self, x: torch.Tensor, taus: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        """(B, F) features and (Q*B, 1) taus -> (Q*B, F): row q*B + b is
        feature b mixed with tau q*B + b."""
        if taus.shape != (self.num_quantiles * x.shape[0], 1):
            raise ValueError(f"taus must be ({self.num_quantiles} * "
                             f"{x.shape[0]}, 1), got {tuple(taus.shape)}")
        x = x.repeat(self.num_quantiles, 1)
        emb = self.quantile_embedding(taus, x.dtype, train)
        return x + emb if self.mix == "add" else x * emb


def iqn_loss(preds: torch.Tensor, target: torch.Tensor, taus: torch.Tensor,
             k: float = 1.0) -> torch.Tensor:
    """tau-weighted Huber quantile regression loss, in float32 (float64 for
    float64 predictions), the target's gradient stopped.

    preds: (Q*B, O); target: (B, O) or (B,); taus: (Q*B, O).
    """
    wide = torch.promote_types(preds.dtype, torch.float32)
    target = target.detach()
    if target.dim() == 1:
        target = target[..., None]
    batch_size, output_dims = target.shape
    preds = preds.to(wide).reshape(-1, batch_size, output_dims)
    taus = taus.to(wide).reshape(-1, batch_size, output_dims)
    err = target.to(wide)[None] - preds
    huber = torch.where(err.abs() <= k, 0.5 * err.square(),
                        k * (err.abs() - 0.5 * k))
    weight = (taus - (err < 0).to(wide)).abs()
    return batch_mean((weight * huber).sum(0))
