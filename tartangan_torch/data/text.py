"""Text dataset: tokenize documents, build a frequency vocabulary, and
batch fixed-length id sequences.

A copy of ``tartangan_tpu/data/text.py`` (torch-free there too):
``basic_english_tokenizer`` (torchtext's ``basic_english``), ``Vocab``
(frequency order, ties by token, the specials ``<unk>`` and ``<pad>``
first) and ``TextDataset``, over a plain-text file of one document a line,
a list of strings, or a pickled pandas DataFrame's ``column`` where pandas
imports.
"""
from __future__ import annotations

import re
from collections import Counter

import numpy as np

from ..utils.fs import smart_open

_PATTERNS = [
    (re.compile(r"\'"), " '  "),
    (re.compile(r"\""), ""),
    (re.compile(r"\."), " . "),
    (re.compile(r"<br \/>"), " "),
    (re.compile(r","), " , "),
    (re.compile(r"\("), " ( "),
    (re.compile(r"\)"), " ) "),
    (re.compile(r"\!"), " ! "),
    (re.compile(r"\?"), " ? "),
    (re.compile(r"\;"), " "),
    (re.compile(r"\:"), " "),
    (re.compile(r"\s+"), " "),
]


def basic_english_tokenizer(line: str):
    """torchtext's ``basic_english`` normalization and split."""
    line = line.lower()
    for pattern, repl in _PATTERNS:
        line = pattern.sub(repl, line)
    return line.strip().split()


class Vocab:
    """Frequency-ordered vocabulary with the specials first."""

    def __init__(self, frequencies: Counter, specials=("<unk>", "<pad>")):
        self.itos = list(specials) + [
            tok for tok, _ in sorted(
                frequencies.items(), key=lambda kv: (-kv[1], kv[0]))
            if tok not in specials
        ]
        self.stoi = {tok: i for i, tok in enumerate(self.itos)}
        self.unk_id = self.stoi["<unk>"]
        self.pad_id = self.stoi["<pad>"]

    def __len__(self):
        return len(self.itos)

    def encode(self, tokens):
        return [self.stoi.get(t, self.unk_id) for t in tokens]


class TextDataset:
    """Fixed-length token-id sequences over a document corpus."""

    def __init__(self, docs, doc_len: int = 128,
                 tokenizer=basic_english_tokenizer):
        self.doc_len = doc_len
        self.tokenizer = tokenizer
        tokenized = [tokenizer(doc) for doc in docs]
        frequencies = Counter()
        for toks in tokenized:
            frequencies.update(toks)
        self.vocab = Vocab(frequencies)
        self.doc_indexes = [np.asarray(self.vocab.encode(toks), np.int32)
                            for toks in tokenized]

    def __len__(self):
        return len(self.doc_indexes)

    def batch(self, indices, rng=None) -> np.ndarray:
        """(B, doc_len) int32: each document truncated, or padded with
        ``<pad>``."""
        out = np.full((len(indices), self.doc_len), self.vocab.pad_id,
                      np.int32)
        for row, i in enumerate(indices):
            idx = self.doc_indexes[i][:self.doc_len]
            out[row, :len(idx)] = idx
        return out

    @classmethod
    def from_path(cls, path, doc_len=128, column="summary", **kwargs):
        """A pickled pandas DataFrame's ``column`` where pandas imports and
        reads the file, else a plain-text file of one document a line."""
        docs = None
        try:
            import pandas as pd  # noqa: PLC0415
            with smart_open(path, "rb") as infile:
                df = pd.read_pickle(infile, compression=None)
            docs = list(df[column].astype(str))
        except Exception:
            with smart_open(path, "r") as infile:
                docs = [line.strip() for line in infile if line.strip()]
        return cls(docs, doc_len=doc_len, **kwargs)
