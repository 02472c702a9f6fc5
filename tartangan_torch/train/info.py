"""InfoGAN trainer: the adversarial loss plus the latent code's
reconstruction.

Counterpart of ``tartangan_tpu/train/info.py``: ``sample_info_z``
(:24-33), ``make_info_train_step`` (:36-134), ``InfoTrainer`` (:137-187)
and ``main``. D has two heads on one trunk (``models/factories.py::
info_d_output_factory``): the adversarial logit and the code. The code is
the first ``--info-cat-dims`` dimensions of z (a one-hot category) and the
next ``--info-cont-dims`` (continuous); its loss, BCE on the categorical
part plus MSE on the continuous part weighted by ``--info-w``, is added to
both D's and G's losses. The one-hot codes are drawn with the latents,
outside the step (``draw_z``).

Usage: python -m tartangan_torch.train.info DATA.npz --config 512thin
       --batch-size 64 [--info-cat-dims 10 --info-cont-dims 5 --info-w 1]
       [--dtype bf16] [--remat] [--device cuda|cpu]
"""
from __future__ import annotations

import torch

from ..models import factories as F
from ..models.layers import update_batch_stats
from ..models.losses import bce_with_logits, r1_gradient_penalty
from ..models.pluggan import Discriminator
from ..parallel.collectives import batch_mean
from .cnn import CNNTrainer
from .common import bce_labels, ema_update, normalize_batch


def sample_info_z(generator: torch.Generator, lead: tuple, latent_dims: int,
                  cat_dims: int, device=None) -> torch.Tensor:
    """z ~ N(0, 1) of shape ``lead + (latent_dims,)`` with its first
    ``cat_dims`` dimensions replaced by a uniformly drawn one-hot."""
    z = torch.randn(lead + (latent_dims,), generator=generator, device=device)
    if cat_dims:
        cats = torch.randint(0, cat_dims, lead, generator=generator,
                             device=device)
        onehot = torch.nn.functional.one_hot(cats, cat_dims).to(z.dtype)
        z = torch.cat([onehot, z[..., cat_dims:]], -1)
    return z


def make_info_train_step(*, cat_dims, cont_dims, info_w, grad_penalty,
                         ema_factor, dtype=torch.float32, iters_d: int = 1):
    """``step(state, batch_u8, z_d, z_g) -> metrics``, as
    ``make_cnn_train_step``'s with the code loss added to both towers'
    losses; R1 differentiates the real pass's logits only. Metrics:
    ``g_loss`` (with the code loss), ``g_code_loss``, ``d_loss``,
    ``d_code_loss`` and ``gp``."""

    def code_loss(p_codes, z):
        loss = torch.zeros((), device=z.device)
        if cat_dims:
            loss = loss + bce_with_logits(p_codes[..., :cat_dims],
                                          z[..., :cat_dims])
        if cont_dims:
            cont = slice(cat_dims, cat_dims + cont_dims)
            diff = p_codes[..., cont].float() - z[..., cont].float()
            loss = loss + batch_mean(diff.square())
        return loss

    def train_step(state, batch_u8, z_d, z_g):
        g, d = state.g, state.d
        batch_size = batch_u8.shape[0]
        real = normalize_batch(batch_u8, dtype)
        labels = bce_labels(batch_size, device=real.device)
        gp = torch.zeros((), device=real.device)
        for it in range(iters_d):
            # ---- D step
            with torch.no_grad(), update_batch_stats(g):
                fake = g(z_d[it], train=True)
            state.opt_d.zero_grad(set_to_none=True)
            with update_batch_stats(d):
                if grad_penalty:
                    gp, (p_real, _) = r1_gradient_penalty(
                        d, real.detach().requires_grad_())
                else:
                    p_real, _ = d(real, train=True)
                p_fake, p_codes = d(fake, train=True)
            adv = bce_with_logits(torch.cat([p_real, p_fake], 0), labels)
            d_code_loss = code_loss(p_codes, z_d[it])
            d_total = adv + info_w * d_code_loss + grad_penalty * gp
            d_total.backward()
            state.opt_d.step()

        # ---- G step
        d.requires_grad_(False)
        try:
            state.opt_g.zero_grad(set_to_none=True)
            with update_batch_stats(g, d):
                p, p_codes = d(g(z_g, train=True), train=True)
            g_code_loss = code_loss(p_codes, z_g)
            g_total = (bce_with_logits(p, torch.ones_like(p))
                       + info_w * g_code_loss)
            g_total.backward()
        finally:
            d.requires_grad_(True)
        state.opt_g.step()
        ema_update(g, state.g_target, ema_factor)
        return {"g_loss": g_total.detach(),
                "g_code_loss": g_code_loss.detach(),
                "d_loss": d_total.detach(),
                "d_code_loss": d_code_loss.detach(), "gp": gp.detach()}

    return train_step


class InfoTrainer(CNNTrainer):
    """The JAX package's ``InfoTrainer``."""

    def build_discriminator(self):
        args = self.args
        return Discriminator(
            self.gan_config,
            input_factory=F.d_input_factory(),
            block_factory=self.d_block_factory(),
            output_factory=F.info_d_output_factory(
                args.norm, args.activation,
                args.info_cat_dims + args.info_cont_dims),
            dtype=self.dtype,
        )

    def make_train_step(self):
        return make_info_train_step(
            cat_dims=self.args.info_cat_dims,
            cont_dims=self.args.info_cont_dims,
            info_w=self.args.info_w,
            grad_penalty=self.args.grad_penalty,
            ema_factor=self.args.lr_target_g,
            dtype=self.dtype,
            iters_d=self.args.iters_d,
        )

    def draw_z(self, lead: tuple) -> torch.Tensor:
        return sample_info_z(self.z_gen, lead, self.gan_config.latent_dims,
                             self.args.info_cat_dims, self.device)

    @classmethod
    def get_component_classes(cls, args):
        from .components.info_image_sampler import InfoImageSamplerComponent
        classes = super().get_component_classes(args)
        classes.append(InfoImageSamplerComponent)
        return classes

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("--info-cat-dims", type=int, default=10)
        p.add_argument("--info-cont-dims", type=int, default=5)
        p.add_argument("--info-w", type=float, default=1.0)


def main(argv=None):
    return InfoTrainer.run_cli(argv)


if __name__ == "__main__":
    main()
