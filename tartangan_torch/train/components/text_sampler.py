"""Text samples: decode generated embedding sequences to text files.

Counterpart of ``tartangan_tpu/train/components/text_sampler.py``: a
fixed panel of 32 latents at train begin; every ``--gen-freq`` steps (and
at the end) decode 16 of G's sequences by nearest-vocabulary lookup
(``models/text.py::skipgram_lookup``) and write them wrapped at 70
columns, each followed by a rule, to ``samples/sample_{steps}.txt``.
"""
from __future__ import annotations

import textwrap

from ...utils.fs import maybe_makedirs, smart_open
from .base import TrainerComponent


class TextSamplerComponent(TrainerComponent):
    def on_train_begin(self, steps, logs):
        if self.writer:
            maybe_makedirs(self.sample_root, exist_ok=True)
        self.progress_samples = self.trainer.sample_z(32)

    def on_train_end(self, steps, logs):
        self.output_samples(f"{self.sample_root}/sample_{steps}.txt")

    def on_batch_end(self, steps, logs):
        if self.every(self.trainer.args.gen_freq, steps):
            self.output_samples(f"{self.sample_root}/sample_{steps}.txt")

    def output_samples(self, filename):
        trainer = self.trainer
        generated = trainer.sample_g(z=self.progress_samples)[:16]
        ids = trainer.lookup(generated).cpu().numpy()
        itos = trainer.dataset.vocab.itos
        if not self.writer:
            return
        with smart_open(filename, "w") as outfile:
            for row in ids:
                doc = " ".join(itos[i] for i in row)
                outfile.writelines(s + "\n" for s in textwrap.wrap(doc, 70))
                outfile.write("-" * 40 + "\n")

    @property
    def sample_root(self):
        return f"{self.trainer.output_root}/samples"
