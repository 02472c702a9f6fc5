"""Text GAN trainer: a SkipGram embedding trained with a 1-D conv GAN over
the embedded documents.

Counterpart of ``tartangan_tpu/train/text_cnn.py``: ``make_text_train_steps``
(:40-153) and ``TextCNNTrainer`` (:156-305). Every step trains the SkipGram
on one random context window a document (SGD at ``--lr-d``); for the first
``--pretrain-embedding`` steps that is all (``embed_step``, with the EMA
target's update), after them the CNN trainer's BCE + R1 + Adam + EMA
update follows on the documents embedded by the new tables
(``full_step``, ``--iters-d`` D updates). G and D are the plain residual
towers in 1-D (NCL: ``data_dims`` is ``--embedding-dims``), G with the
``"mlp1d"`` input and no output activation.

The window offsets (B,) in [0, 2 * context + 1) and the negatives
(B, 2 * context) are drawn by the trainer outside the step, with the
latents, as the JAX step draws them from its key. ``--steps-per-call``
> 1 raises, as in the JAX trainer. Checkpoints add ``embedding``
(``{embedding_u, embedding_v}``) and ``opt_emb`` (optax's stateless SGD,
``{"0": {}, "1": {}}``) to the JAX trainer's artifacts.

Usage: python -m tartangan_torch.train.text_cnn DOCS.txt --config 128
       --batch-size 128 --embedding-dims 64 [--context 3]
       [--pretrain-embedding N] [--device cuda|cpu]
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from ..configs import GAN_CONFIGS
from ..convert import from_flax, to_flax
from ..data.text import TextDataset
from ..models import factories as F
from ..models.pluggan import Discriminator, Generator
from ..models.text import SkipGram, skipgram_lookup
from ..ops.init import init_module_
from .cnn import CNNTrainer, gan_update
from .common import ema_update, make_adam
from .state import TextGANTrainState
from .trainer import checkpoint_component, metrics_component

# optax.sgd's state as flax serializes it: two empty states
_SGD_STATE = {"0": {}, "1": {}}


def make_text_train_steps(*, context, grad_penalty, ema_factor,
                          dtype=torch.float32, iters_d: int = 1):
    """(embed_step, full_step): ``embed_step(state, indexes, offsets,
    negatives)`` and ``full_step(state, indexes, offsets, negatives, z_d,
    z_g)``, each updating ``state`` in place and returning 0-d device
    tensors ``g_loss``, ``d_loss``, ``gp`` (0 in ``embed_step``) and
    ``embedding_loss``. ``indexes`` (B, L) are the token ids on the
    device."""
    window_size = 2 * context + 1

    def embedding_update(state, indexes, offsets, negatives):
        gather = offsets[:, None] + torch.arange(window_size,
                                                 device=indexes.device)
        windows = indexes.gather(1, gather.long())
        words = windows[:, context]
        contexts = torch.cat([windows[:, :context],
                              windows[:, context + 1:]], 1)
        state.opt_emb.zero_grad(set_to_none=True)
        loss = state.embedding.loss(words, contexts, negatives)
        loss.backward()
        state.opt_emb.step()
        return loss.detach()

    def embed_step(state, indexes, offsets, negatives):
        emb_loss = embedding_update(state, indexes, offsets, negatives)
        # the reference updates target-G every batch, pretraining too
        ema_update(state.g, state.g_target, ema_factor)
        zero = torch.zeros((), device=indexes.device)
        return {"g_loss": zero, "d_loss": zero, "gp": zero,
                "embedding_loss": emb_loss}

    def full_step(state, indexes, offsets, negatives, z_d, z_g):
        emb_loss = embedding_update(state, indexes, offsets, negatives)
        # the GAN sees the documents embedded by the new tables as fixed
        # real data, (B, D, L)
        with torch.no_grad():
            real = state.embedding(indexes).to(dtype).transpose(1, 2)
        metrics = gan_update(state, real.contiguous(), z_d, z_g,
                             gp_weight=grad_penalty, ema_factor=ema_factor,
                             iters_d=iters_d)
        return {**metrics, "embedding_loss": emb_loss}

    return embed_step, full_step


class TextCNNTrainer(CNNTrainer):
    """The JAX package's ``TextCNNTrainer``."""

    def prepare_dataset(self):
        # build_models() makes the dataset first (its vocabulary sizes the
        # embedding); train() then asks for it again
        if getattr(self, "dataset", None) is not None:
            return self.dataset
        return TextDataset.from_path(self.args.data_path,
                                     doc_len=self.gan_config.max_size)

    def build_models(self):
        args = self.args
        if self.steps_per_call > 1:
            raise NotImplementedError(
                "--steps-per-call chunking is not wired into the two-phase "
                "(embedding pretrain / full GAN) text step schedule")
        cfg = GAN_CONFIGS[args.config].scale_model(args.model_scale)
        # data_dims becomes the embedding width
        cfg = dataclasses.replace(cfg, data_dims=args.embedding_dims)
        self.gan_config = cfg
        self.dataset = self.prepare_dataset()

        init_gen = torch.Generator().manual_seed(args.seed)
        g, g_target, d = self.init_models(init_gen)
        embedding = self.place(init_module_(
            SkipGram(len(self.dataset.vocab), args.embedding_dims),
            init_gen).to(self.device))
        self.state = TextGANTrainState(
            g=g, g_target=g_target, d=d,
            opt_g=make_adam(g.parameters(), args.lr_g),
            opt_d=make_adam(d.parameters(), args.lr_d),
            embedding=embedding,
            opt_emb=torch.optim.SGD(embedding.parameters(), lr=args.lr_d))
        self.pretraining_embedding = args.pretrain_embedding
        self._embed_step, self._full_step = make_text_train_steps(
            context=args.context, grad_penalty=args.grad_penalty,
            ema_factor=args.lr_target_g, dtype=self.dtype,
            iters_d=args.iters_d)

    def build_generator(self):
        args = self.args
        return Generator(
            self.gan_config,
            input_factory=F.g_input_factory("mlp1d", args.activation),
            block_factory=F.g_block_factory(args.norm, args.activation,
                                            ndim=1),
            output_factory=F.g_output_factory(
                args.norm, args.activation, output_activation="id", ndim=1),
            dtype=self.dtype)

    def build_discriminator(self):
        args = self.args
        return Discriminator(
            self.gan_config,
            input_factory=F.d_input_factory(ndim=1),
            block_factory=F.d_block_factory(args.norm, args.activation,
                                            ndim=1),
            output_factory=F.d_output_factory(args.norm, args.activation),
            dtype=self.dtype)

    def text_draws(self, n: int) -> dict:
        """The embedding update's draws for ``n`` documents: the window
        offsets (n,) and the negatives (n, 2 * context), int64."""
        window = 2 * self.args.context + 1
        offsets = torch.randint(0, window, (n,), generator=self.z_gen,
                                device=self.device)
        negatives = torch.randint(
            0, len(self.dataset.vocab), (n, 2 * self.args.context),
            generator=self.z_gen, device=self.device)
        return {"offsets": offsets, "negatives": negatives}

    def train_batch(self, batch):
        # the global batch's draws, of which this rank keeps its rows
        n = self.args.batch_size
        draws = {k: self.shard(v) for k, v in self.text_draws(n).items()}
        if self.pretraining_embedding > 0:
            self.pretraining_embedding -= 1
            return self._embed_step(self.state, batch, **draws)
        return self._full_step(
            self.state, batch,
            z_d=self.shard(self.draw_z((self.args.iters_d, n)), 1),
            z_g=self.shard(self.draw_z((n,))), **draws)

    def lookup(self, zs) -> torch.Tensor:
        """Generated embedding sequences (B, L, D) -> vocabulary ids."""
        with torch.no_grad():
            table = self.state.embedding.table()
        return skipgram_lookup(table, torch.as_tensor(zs))

    def _checkpoint_artifacts(self):
        artifacts = super()._checkpoint_artifacts()
        artifacts["embedding"] = to_flax(self.state.embedding)["params"]
        artifacts["opt_emb"] = copy.deepcopy(_SGD_STATE)
        return artifacts

    def _load_checkpoint_artifacts(self, artifacts):
        super()._load_checkpoint_artifacts(artifacts)
        self.state.embedding.load_state_dict(
            from_flax({"params": artifacts["embedding"]}))
        if artifacts["opt_emb"] != _SGD_STATE:
            raise KeyError(f"opt_emb is not a stateless SGD's state: "
                           f"{artifacts['opt_emb']}")

    @classmethod
    def get_component_classes(cls, args):
        from .components.text_sampler import TextSamplerComponent
        classes = [TextSamplerComponent, checkpoint_component(args)]
        if args.metrics_collector:
            classes.append(metrics_component(args.metrics_collector))
        return classes

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("--embedding-dims", type=int, default=64)
        p.add_argument("--context", type=int, default=3)
        p.add_argument("--pretrain-embedding", type=int, default=10000)


def main(argv=None):
    return TextCNNTrainer.run_cli(argv)


if __name__ == "__main__":
    main()
