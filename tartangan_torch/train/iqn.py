"""IQN trainer: the quantile-regression discriminator workload.

Counterpart of ``tartangan_tpu/train/iqn.py``: ``make_iqn_train_step``
(:22-107), ``IQNTrainer`` (:110-140) and ``main``. The generator is the CNN
trainer's; the discriminator (``models/pluggan.py::IQNDiscriminator``)
ends in the IQN head, which returns its prediction and quantile-Huber
loss for given targets. The quantiles tau of every D forward are drawn by
the trainer outside the step, with the latents (``extra_draws``), where
the JAX step draws them from its key inside the head: ``taus_d``
(iters_d, 2, Q*B, 1), the real and the fake pass of each D update, and
``taus_g`` (Q*B, 1), the G step's.

Usage: python -m tartangan_torch.train.iqn DATA.npz --config 512thin
       --batch-size 64 [--dtype bf16] [--remat] [--device cuda|cpu]
"""
from __future__ import annotations

import torch

from ..models import factories as F
from ..models.layers import update_batch_stats
from ..models.losses import r1_gradient_penalty
from ..models.pluggan import IQNDiscriminator
from .cnn import CNNTrainer
from .common import ema_update, normalize_batch


def make_iqn_train_step(*, grad_penalty, ema_factor, dtype=torch.float32,
                        iters_d: int = 1):
    """``step(state, batch_u8, z_d, z_g, taus_d, taus_g) -> metrics``, as
    ``make_cnn_train_step``'s with the taus of each D forward: D's loss is
    the real pass's quantile loss against 1 plus the fake pass's against 0
    plus R1 on the real pass's prediction (the quantile mean, summed in
    float32); G's loss is the quantile loss of D on G's images against 1."""

    def train_step(state, batch_u8, z_d, z_g, taus_d, taus_g):
        g, d = state.g, state.d
        batch_size = batch_u8.shape[0]
        real = normalize_batch(batch_u8, dtype)
        ones = torch.ones((batch_size, 1), device=real.device)
        zeros = torch.zeros((batch_size, 1), device=real.device)
        gp = torch.zeros((), device=real.device)
        for it in range(iters_d):
            # ---- D step
            with torch.no_grad(), update_batch_stats(g):
                fake = g(z_d[it], train=True)
            state.opt_d.zero_grad(set_to_none=True)
            with update_batch_stats(d):
                def d_real(x):
                    return d(x, train=True, targets=ones,
                             taus=taus_d[it, 0])
                if grad_penalty:
                    gp, (_, loss_real) = r1_gradient_penalty(
                        d_real, real.detach().requires_grad_())
                else:
                    _, loss_real = d_real(real)
                _, loss_fake = d(fake, train=True, targets=zeros,
                                 taus=taus_d[it, 1])
            d_total = loss_real + loss_fake + grad_penalty * gp
            d_total.backward()
            state.opt_d.step()

        # ---- G step: only G's parameters are differentiated; D's batch
        # stats still update
        d.requires_grad_(False)
        try:
            state.opt_g.zero_grad(set_to_none=True)
            with update_batch_stats(g, d):
                _, g_loss = d(g(z_g, train=True), train=True, targets=ones,
                              taus=taus_g)
            g_loss.backward()
        finally:
            d.requires_grad_(True)
        state.opt_g.step()
        ema_update(g, state.g_target, ema_factor)
        return {"g_loss": g_loss.detach(), "d_loss": d_total.detach(),
                "gp": gp.detach()}

    return train_step


class IQNTrainer(CNNTrainer):
    """The JAX package's ``IQNTrainer``: the CNN trainer with the IQN
    discriminator and step."""

    def build_discriminator(self):
        args = self.args
        return IQNDiscriminator(
            self.gan_config,
            block_factory=self.d_block_factory(),
            output_factory=F.iqn_d_output_factory(args.norm, args.activation),
            dtype=self.dtype,
        )

    def make_train_step(self):
        return make_iqn_train_step(
            grad_penalty=self.args.grad_penalty,
            ema_factor=self.args.lr_target_g,
            dtype=self.dtype,
            iters_d=self.args.iters_d,
        )

    def extra_draws(self, lead: tuple, n: int) -> dict:
        """The taus, uniform in [0, 1), float32, as the JAX head draws
        them: ``taus_d`` lead + (iters_d, 2, Q*B, 1), ``taus_g``
        lead + (Q*B, 1)."""
        q = self.state.d.output_block.IQN_0.num_quantiles
        return {
            "taus_d": torch.rand(lead + (self.args.iters_d, 2, q * n, 1),
                                 generator=self.z_gen, device=self.device),
            "taus_g": torch.rand(lead + (q * n, 1), generator=self.z_gen,
                                 device=self.device),
        }

    def shard_extra(self, draws: dict, lead: tuple) -> dict:
        """This rank's taus: their rows are quantile-major (q * B + b), so
        each quantile's block keeps its rows."""
        if self.mesh is None:
            return draws
        q = self.state.d.output_block.IQN_0.num_quantiles

        def rows(t):
            blocks = t.unflatten(-2, (q, -1))
            return self.shard(blocks, blocks.dim() - 2).flatten(-3, -2)
        return {k: rows(v) for k, v in draws.items()}


def main(argv=None):
    return IQNTrainer.run_cli(argv)


if __name__ == "__main__":
    main()
