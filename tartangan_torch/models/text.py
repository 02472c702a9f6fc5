"""SkipGram embedding (negative sampling) and nearest-neighbour decode.

Counterpart of ``tartangan_tpu/models/text.py``: ``SkipGram`` with its
loss (:36-50) and ``skipgram_lookup`` (:53). The text GAN trains the
embedding with the GAN (``train/text_cnn.py``) and decodes G's embedding
sequences back to vocabulary ids by scaled dot product, skipping the
``<unk>`` row and adding the offset back (the JAX package's fix of the
reference's off-by-one). The negatives of the loss are the caller's: the
trainer draws them outside the step, as the JAX step draws them from its
key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives as C
from ..parallel.collectives import batch_mean


class SkipGram(nn.Module):
    """Two (num_items, item_dims) tables, ``embedding_u`` (the items) and
    ``embedding_v`` (their contexts), N(0, 1) at init."""

    def __init__(self, num_items: int, item_dims: int):
        super().__init__()
        self.num_items = num_items
        self.embedding_u = nn.Parameter(torch.empty(num_items, item_dims))
        self.embedding_v = nn.Parameter(torch.empty(num_items, item_dims))
        self.init_parameters_(None)

    @torch.no_grad()
    def init_parameters_(self, generator):
        self.embedding_u.normal_(generator=generator)
        self.embedding_v.normal_(generator=generator)

    def rows(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the table ``name``, whole: under ``--tp`` each
        rank holds a slice of the D columns (``parallel/tp.py``) and the
        looked-up rows are gathered."""
        rows = getattr(self, name)[ids.long()]
        tp = getattr(self, "tp", None)
        return rows if tp is None else C.tp_gather(rows, -1, tp)

    def table(self, name: str = "embedding_u") -> torch.Tensor:
        """The table ``name`` whole (gathered under ``--tp``)."""
        t = getattr(self, name)
        tp = getattr(self, "tp", None)
        return t if tp is None else C.tp_gather(t, 1, tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Token ids (B, L) -> their embeddings (B, L, D), float32."""
        return self.rows("embedding_u", x)

    def loss(self, words: torch.Tensor, contexts: torch.Tensor,
             negatives: torch.Tensor) -> torch.Tensor:
        """Negative-sampling loss of ``words`` (B,) against their
        ``contexts`` (B, C) and the drawn ``negatives`` (B, C) ids."""
        emb_u = self.rows("embedding_u", words)               # (B, D)
        emb_v = self.rows("embedding_v", contexts)            # (B, C, D)
        scores = torch.einsum("bcd,bd->bc", emb_v, emb_u)
        pos_loss = F.logsigmoid(scores).sum(1)
        emb_v_neg = self.rows("embedding_v", negatives)
        neg_scores = torch.einsum("bcd,bd->bc", emb_v_neg, emb_u)
        neg_loss = F.logsigmoid(-neg_scores).sum(1)
        return -batch_mean(pos_loss + neg_loss)


def skipgram_lookup(embedding_u: torch.Tensor, zs: torch.Tensor,
                    skip_first: int = 1) -> torch.Tensor:
    """Nearest-vocabulary decode: ``embedding_u`` (V, D), ``zs`` (B, L, D)
    -> (B, L) int64 ids, the argmax over the rows after ``skip_first`` of
    ``(w . z) / ||w||``."""
    w = embedding_u.float()
    w_norm = w.square().sum(1).sqrt()[:, None]
    scores = torch.einsum("vd,bld->bvl", w, zs.to(w.device).float()) / w_norm
    return scores[:, skip_first:, :].argmax(1) + skip_first
