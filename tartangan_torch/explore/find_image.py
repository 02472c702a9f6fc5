"""GAN inversion: optimize latent codes to reconstruct a target image.

Counterpart of ``tartangan_tpu/explore/find_image.py``: optimize z with
Adam, SGD or L-BFGS under a summed MSE or smooth-L1 reconstruction loss,
an optional L2 latent penalty (``--l2`` times mean(z^2)), and the
stochastic-clipping trick (|z| > 3 redrawn,
https://openreview.net/pdf?id=HJC88BzFl), the noise drawn from a
``torch.Generator`` on the device seeded 0.

One step: clip, G(z, train=True) in float32 (batch-statistics BatchNorm
that leaves the running statistics alone), the loss, its gradient w.r.t.
z alone (G's weights need none; through G's attention that is K1 with its
lse and K2 on the card), and the update. The optimizers follow optax's
rules: ``adam`` is ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8), ``sgd``
``optax.sgd(lr)``, and ``lbfgs`` ``optax.lbfgs(lr)`` (``explore/lbfgs.py``),
whose line search runs G forward and backward again at every trial.

``--vgg`` replaces the pixel loss by a multi-scale perceptual loss over
the port's InceptionV3 (``models/inception.py``): images are mapped to the
VGG statistics and resized to 299 as the FID path does, and the outputs of
the ``--perceptual-layers`` submodules are captured by forward hooks. The
target's features are fixed.

``run`` reads the target with Pillow (imported there) and calls ``find``,
which takes the target as an array.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.fs import maybe_makedirs
from .base import GOutputApp
from .lbfgs import LBFGS


class Adam:
    """``optax.adam(learning_rate)`` on one tensor."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params):
        return {"count": 0, "mu": torch.zeros_like(params),
                "nu": torch.zeros_like(params)}

    def update(self, grads, state, params=None):
        del params
        mu = (1 - self.b1) * grads + self.b1 * state["mu"]
        nu = (1 - self.b2) * grads.square() + self.b2 * state["nu"]
        count = state["count"] + 1

        def correction(decay):
            return 1 - torch.tensor(decay, dtype=torch.float32,
                                    device=grads.device) ** count
        mu_hat = mu / correction(self.b1)
        nu_hat = nu / correction(self.b2)
        updates = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return -self.learning_rate * updates, \
            {"count": count, "mu": mu, "nu": nu}


class SGD:
    """``optax.sgd(learning_rate)`` on one tensor."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params):
        return None

    def update(self, grads, state, params=None):
        return -self.learning_rate * grads, state


OPTIMIZERS = {"adam": Adam, "sgd": SGD, "lbfgs": LBFGS}


def _recon_fn(name: str):
    if name == "mse":
        def recon(a, b):
            return (a - b).square().sum()
    else:  # smooth-l1
        def recon(a, b):
            d = (a - b).abs()
            return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum()
    return recon


class FindImage(GOutputApp):
    app_name = "Find image"

    def run(self):
        self.load_generator()
        self.find(self.read_target())

    def read_target(self) -> np.ndarray:
        """The target image, (H, W, 3) float32 in [-1, 1] at G's size."""
        from PIL import Image
        size = self.gan_config.max_size
        img = Image.open(self.args.target_image).convert("RGB")
        img = img.resize((size, size), Image.LANCZOS)
        return np.asarray(img, np.float32) / 127.5 - 1.0

    def prepare(self, target: np.ndarray):
        """Set up the loss, the optimizer and the clipping noise for
        ``target`` ((H, W, C) tiled to ``--num-samples``, or (N, H, W, C)),
        NHWC in [-1, 1]. ``load_generator`` comes first."""
        target = np.asarray(target, np.float32)
        if target.ndim == 3:
            target = np.tile(target[None], (self.args.num_samples, 1, 1, 1))
        self.g.requires_grad_(False)
        self.target = torch.as_tensor(target, device=self.device) \
            .permute(0, 3, 1, 2).contiguous()
        self.opt = OPTIMIZERS[self.args.optimizer](self.args.lr)
        self.noise = torch.Generator(device=self.device).manual_seed(0)
        recon = _recon_fn(self.args.loss)
        if self.args.vgg:
            features = self._make_feature_extractor()
            with torch.no_grad():
                target_feats = [f.detach() for f in features(self.target)]

            def image_loss(imgs):
                # the perceptual loss replaces the pixel loss, as in the
                # reference; only the L2 code penalty is added
                return sum(recon(f, t) for f, t
                           in zip(features(imgs), target_feats))
        else:
            def image_loss(imgs):
                return recon(imgs, self.target)
        self._image_loss = image_loss

    def value_and_grad(self, z: torch.Tensor):
        """(loss, grad w.r.t. z, NCHW images) at z."""
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            imgs = self.g(z, train=True).float()
            loss = self._image_loss(imgs) \
                + z.square().mean() * self.args.l2
            (grad,) = torch.autograd.grad(loss, z)
        return loss.detach(), grad, imgs.detach()

    def step(self, z: torch.Tensor, opt_state):
        """One optimization step -> (z, opt_state, loss, NCHW images)."""
        should_clip = (z.abs() > 3.0).to(z.dtype)
        noise = torch.randn(z.shape, generator=self.noise, dtype=z.dtype,
                            device=z.device)
        z = z * (1.0 - should_clip) + noise * should_clip
        loss, grad, imgs = self.value_and_grad(z)
        if isinstance(self.opt, LBFGS):
            # the line search evaluates the objective along the direction
            updates, opt_state = self.opt.update(
                grad, opt_state, z, value=loss,
                value_and_grad_fn=lambda zz: self.value_and_grad(zz)[:2])
        else:
            updates, opt_state = self.opt.update(grad, opt_state, z)
        return z + updates, opt_state, loss, imgs

    def find(self, target: np.ndarray, z: np.ndarray | None = None):
        """Invert ``target`` (see ``prepare``) from ``z`` (default
        ``sample_z(--num-samples)``); fills ``loss_history`` (and, for
        L-BFGS, ``linesearch_steps``) and writes the PNGs every
        ``--save-freq`` steps. Returns the final z."""
        if os.path.dirname(self.args.output_prefix):
            maybe_makedirs(os.path.dirname(self.args.output_prefix))
        self.prepare(target)
        if z is None:
            z = self.sample_z(self.args.num_samples)
        z = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
        opt_state = self.opt.init(z)
        self.loss_history, self.linesearch_steps = [], []
        for i in range(self.args.max_steps):
            z, opt_state, loss, imgs = self.step(z, opt_state)
            self.loss_history.append(float(loss))
            if isinstance(self.opt, LBFGS):
                self.linesearch_steps.append(opt_state.num_linesearch_steps)
            if i % self.args.save_freq == 0 or i == self.args.max_steps - 1:
                self.save_image(imgs.permute(0, 2, 3, 1).cpu().numpy(),
                                f"{self.args.output_prefix}_{i}.png")
                print(f"step {i}: loss {float(loss):.4f} "
                      f"z range [{float(z.min()):.2f}, {float(z.max()):.2f}]")
        return z

    def _make_feature_extractor(self):
        """Multi-scale Inception features for the perceptual loss: NCHW
        images in [-1, 1] are mapped to the VGG statistics and resized to
        299 as the FID path does, and the outputs of the
        ``--perceptual-layers`` submodules are captured by forward hooks
        (flax's ``capture_intermediates`` in the JAX package)."""
        from ..eval.inception import VGG_MEAN, VGG_STD
        from ..models import inception as minc
        from ..ops.resize import resize_bilinear

        model, pretrained = minc.resolve_pretrained(
            minc.init_inception(), self.args.inception_weights)
        if not pretrained:
            print("[find_image] no pretrained Inception weights — the "
                  "perceptual loss uses random-init features "
                  "(--inception-weights sharpens it)")
        layers = tuple(self.args.perceptual_layers)
        if tuple(self.args.vgg_layers) != (9, 16, 23):
            print("[find_image] --vgg-layers indexes torchvision VGG16 "
                  "and does not apply to the Inception backbone; use "
                  "--perceptual-layers")
        model = model.to(self.device).requires_grad_(False)
        captured = {}
        for name in layers:
            getattr(model, name).register_forward_hook(
                lambda mod, inp, out, name=name: captured.__setitem__(name,
                                                                      out))
        mean = torch.as_tensor(VGG_MEAN, device=self.device).reshape(3, 1, 1)
        std = torch.as_tensor(VGG_STD, device=self.device).reshape(3, 1, 1)

        def features(imgs):
            x = (imgs.float() + 1.0) / 2.0
            x = (x - mean) / std
            x = resize_bilinear(x, 299, 299, align_corners=True)
            captured.clear()
            model(x)
            return [captured[name] for name in layers]

        return features

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("target_image", help="Path to image to be found in G")
        p.add_argument("--max-steps", default=1000, type=int)
        p.add_argument("--num-samples", default=2, type=int)
        p.add_argument("--lr", default=0.5, type=float)
        p.add_argument("--vgg", action="store_true",
                       help="Perceptual (feature-space) reconstruction loss")
        p.add_argument("--vgg-layers", default=(9, 16, 23), type=int,
                       nargs="+")
        p.add_argument("--perceptual-layers", nargs="+",
                       default=("Mixed_5b", "Mixed_6b", "Mixed_7b"),
                       help="Inception blocks whose activations define the "
                            "perceptual loss")
        p.add_argument("--inception-weights", default=None,
                       help="Ported Inception-weights npz for the "
                            "perceptual loss (see eval.port_weights)")
        p.add_argument("--optimizer", default="adam")
        p.add_argument("--l2", default=0.0, type=float)
        p.add_argument("--loss", default="mse")
        p.add_argument("--save-freq", default=100, type=int)


if __name__ == "__main__":
    FindImage.run_from_cli()
