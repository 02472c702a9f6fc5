"""SA-GAN-style CNN trainer: BCE-with-logits adversarial loss, R1 gradient
penalty on reals, EMA target generator, alternating D/G Adam updates.

Counterpart of ``tartangan_tpu/train/cnn.py``: ``make_cnn_train_step``
(:35-152) and ``CNNTrainer`` (:155-260). The JAX step is one jitted
function of an immutable state; here it runs eagerly and updates the
state's modules and optimizers in place. The attention of G and D runs
through the CUDA kernels K1 (forward) and K2 (backward) on the card;
``--parity-blocks on`` builds the thin tower blocks in the parity domain,
whose G convs run through K3 under ``ops.parity.FUSED_G``. ``--dtype bf16``
computes in bfloat16 (the batch is normalized in it, G and D cast their
input to it) with float32 parameters, Adam state and EMA target; the losses
and R1's square run in float32 on the bfloat16 logits and input gradient,
as the reference's (``train/cnn.py:87-95``).

``--remat`` rematerializes the residual and parity blocks of both
towers under ``--remat-policy`` (``ops/remat.py``).

Usage: python -m tartangan_torch.train.cnn DATA.npz --config 512thin
       --batch-size 64 [--parity-blocks on] [--dtype bf16]
       [--remat [--remat-policy convs]] [--device cuda|cpu]
"""
from __future__ import annotations

import copy

import torch

from ..configs import GAN_CONFIGS
from ..models import factories as F
from ..models.layers import update_batch_stats
from ..models.losses import bce_with_logits, r1_gradient_penalty
from ..models.pluggan import Discriminator, Generator
from ..ops.init import init_module_
from .common import (
    bce_labels,
    ema_update,
    make_adam,
    normalize_batch,
    selu_reinit,
)
from .state import GANTrainState
from .trainer import Trainer


def gan_update(state, real, z_d, z_g, *, gp_weight, ema_factor,
               iters_d: int = 1, noise_d=None, noise_g=None):
    """The adversarial part of a step on the normalized reals ``real``:
    ``iters_d`` D updates (BCE, R1 with weight ``gp_weight``, Adam), then
    one G update and the EMA target, in place. ``z_d`` (iters_d, B,
    latent) and ``z_g`` (B, latent) are the latents; ``noise_d``
    (iters_d, ...) and ``noise_g``, when given, go to G's applies as
    ``noise`` (the scene generator's patch noise). Returns 0-d device
    tensors ``g_loss``, ``d_loss`` and ``gp``."""
    g, d = state.g, state.d
    batch_size = real.shape[0]
    labels = bce_labels(batch_size, device=real.device)
    gp = torch.zeros((), device=real.device)
    for it in range(iters_d):
        # ---- D step. G's forward keeps its batch-stat update (JAX's
        # g_stats1) but builds no graph
        g_kwargs = {} if noise_d is None else {"noise": noise_d[it]}
        with torch.no_grad(), update_batch_stats(g):
            fake = g(z_d[it], train=True, **g_kwargs)
        state.opt_d.zero_grad(set_to_none=True)
        with update_batch_stats(d):
            if gp_weight:
                gp, p_real = r1_gradient_penalty(
                    d, real.detach().requires_grad_())
            else:
                p_real = d(real, train=True)
            p_fake = d(fake, train=True)
        loss = bce_with_logits(torch.cat([p_real, p_fake], 0), labels)
        d_total = loss + gp_weight * gp
        d_total.backward()
        state.opt_d.step()

    # ---- G step: only G's parameters are differentiated; D's batch stats
    # still update (JAX's d_stats3)
    g_kwargs = {} if noise_g is None else {"noise": noise_g}
    d.requires_grad_(False)
    try:
        state.opt_g.zero_grad(set_to_none=True)
        with update_batch_stats(g, d):
            p = d(g(z_g, train=True, **g_kwargs), train=True)
        g_loss = bce_with_logits(p, torch.ones_like(p))
        g_loss.backward()
    finally:
        d.requires_grad_(True)
    state.opt_g.step()

    # ---- EMA target generator
    ema_update(g, state.g_target, ema_factor)
    return {"g_loss": g_loss.detach(), "d_loss": d_total.detach(),
            "gp": gp.detach()}


def make_cnn_train_step(*, grad_penalty, ema_factor,
                        dtype=torch.float32, iters_d: int = 1,
                        r1_interval: int = 1):
    """Build the CNN GAN step: ``step(state, batch_u8, z_d, z_g, noise_d=
    None, noise_g=None) -> metrics``. ``batch_u8`` is the uint8 NHWC batch
    on the device, ``z_d`` the (iters_d, B, latent) latents of the D steps
    and ``z_g`` the (B, latent) latents of the G step; the caller draws
    them, so a test can feed the JAX step's latents, and likewise the
    scene generator's patch noise (``gan_update``). The step updates
    ``state`` in place and returns 0-d device tensors ``g_loss``,
    ``d_loss`` and ``gp``.

    As in the JAX package, ``r1_interval > 1`` returns the step with R1
    weighted ``grad_penalty * r1_interval``, with ``.no_r1`` (the same
    step without the penalty) and ``.r1_interval`` attached; the trainer
    alternates them on its step count.
    """
    def _make(gp_weight):
        def train_step(state, batch_u8, z_d, z_g, noise_d=None,
                       noise_g=None):
            return gan_update(state, normalize_batch(batch_u8, dtype), z_d,
                              z_g, gp_weight=gp_weight,
                              ema_factor=ema_factor, iters_d=iters_d,
                              noise_d=noise_d, noise_g=noise_g)
        return train_step

    if r1_interval > 1 and grad_penalty:
        step = _make(grad_penalty * r1_interval)
        step.no_r1 = _make(0.0)
        step.r1_interval = r1_interval
        return step
    return _make(grad_penalty)


class CNNTrainer(Trainer):
    """The ``'512thin'``-class GAN trainer (JAX ``CNNTrainer``)."""

    def build_models(self):
        args = self.args
        self.gan_config = GAN_CONFIGS[args.config].scale_model(args.model_scale)
        g, g_target, d = self.init_models(
            torch.Generator().manual_seed(args.seed))
        self.state = GANTrainState(
            g=g, g_target=g_target, d=d,
            opt_g=make_adam(g.parameters(), args.lr_g),
            opt_d=make_adam(d.parameters(), args.lr_d),
        )
        step_fn = self.make_train_step()
        self._train_step = step_fn
        self._r1_interval = getattr(step_fn, "r1_interval", 1)
        self._train_step_alt = getattr(step_fn, "no_r1", None)

    def init_models(self, init_gen: torch.Generator):
        """G, its EMA target and D, drawn from ``init_gen`` and moved to the
        training device (``self.g`` is G)."""
        args = self.args
        g = init_module_(self.build_generator(), init_gen)
        d = init_module_(self.build_discriminator(), init_gen)
        if args.activation == "selu":
            selu_reinit(g, init_gen)
            selu_reinit(d, init_gen)
        if args.ema_start == "copy":
            g_target = copy.deepcopy(g)
        else:
            # reference quirk: the initial 'copy' is one EMA step from an
            # independent random init towards G
            g_target = init_module_(self.build_generator(), init_gen)
            ema_update(g, g_target, args.lr_target_g)
        g, g_target, d = (self.place(m.to(self.device))
                          for m in (g, g_target, d))
        g_target.requires_grad_(False)
        self.g = g
        return g, g_target, d

    def build_generator(self):
        args = self.args
        return Generator(
            self.gan_config,
            input_factory=F.g_input_factory(args.g_base, args.activation),
            block_factory=F.g_block_factory(
                args.norm, args.activation,
                parity=F.resolve_parity(args.parity_blocks),
                remat=args.remat, remat_policy_name=args.remat_policy),
            output_factory=F.g_output_factory(args.norm, args.activation),
            dtype=self.dtype,
        )

    def build_discriminator(self):
        args = self.args
        return Discriminator(
            self.gan_config,
            input_factory=F.d_input_factory(),
            block_factory=self.d_block_factory(),
            output_factory=F.d_output_factory(args.norm, args.activation),
            dtype=self.dtype,
        )

    def d_block_factory(self):
        """D's residual (or parity) blocks, rematerialized with --remat."""
        args = self.args
        return F.d_block_factory(
            args.norm, args.activation,
            parity=F.resolve_parity(args.parity_blocks),
            remat=args.remat, remat_policy_name=args.remat_policy)

    def make_train_step(self):
        return make_cnn_train_step(
            grad_penalty=self.args.grad_penalty,
            ema_factor=self.args.lr_target_g,
            dtype=self.dtype,
            iters_d=self.args.iters_d,
            r1_interval=self.args.r1_interval,
        )


def main(argv=None):
    return CNNTrainer.run_cli(argv)


if __name__ == "__main__":
    main()
