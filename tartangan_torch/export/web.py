"""Package a trained generator for serving/web deployment.

Counterpart of ``tartangan_tpu/export/web.py`` (reference prep4web.py):
the generator is wrapped so its output layout suits an HTML canvas
(NWHC: the reference permutes NCHW -> NWHC, prep4web.py:7-20), and the
wrapped forward is written as a deployable artifact.

The JAX package writes a StableHLO program; the port writes a
``torch.export`` program (``OUT.pt2``, ``torch.export.save``) of the
canvas-layout forward for a fixed batch: z (B, latent) float32 -> images
(B, W, H, C) float32 in [-1, 1], with train-mode (batch-statistics)
BatchNorm as ``generate`` runs G. Next to it goes the same ``OUT.json``.
The program names the attention op ``torch.ops.tartangan.attention``
(``ops/attention.py``), so loading it needs ``tartangan_torch`` imported,
and on the card it launches K1. The app loads the artifact back and runs
it once as a check. ``--onnx`` also writes the ONNX artifact of the
browser demo (``export/onnx.py``) and runs it through the numpy
interpreter; ``--page`` copies ``web/index.html`` next to it.

Usage: python -m tartangan_torch.export.web CHECKPOINT_ROOT --output ttgan
       [--onnx [--page]] [--device cuda]
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..explore.base import GOutputApp, add_device_arg

PAGE = Path(__file__).resolve().parents[2] / "web" / "index.html"
FORMAT = "torch.export program (torch.export.save); load with " \
         "torch.export.load after importing tartangan_torch"


class WebForward(nn.Module):
    """z (B, latent) -> image (B, W, H, C) float32 in [-1, 1], the
    canvas-friendly NWHC of reference prep4web.py:18-19."""

    def __init__(self, g: nn.Module):
        super().__init__()
        self.g = g

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.g(z, train=True).permute(0, 3, 2, 1).float()


class WebExportApp(GOutputApp):
    app_name = "Package generator for web"

    def run(self):
        self.load_generator(target=not self.args.no_target)
        cfg = self.gan_config
        batch = self.args.batch_size
        # frozen weights: G's attention takes the custom op (no autograd),
        # which the program records by name
        self.g.requires_grad_(False)
        z = torch.zeros((batch, cfg.latent_dims), dtype=torch.float32,
                        device=self.device)
        program = torch.export.export(WebForward(self.g), (z,))

        out_base = self.args.output
        if os.path.dirname(out_base):
            os.makedirs(os.path.dirname(out_base), exist_ok=True)
        torch.export.save(program, f"{out_base}.pt2")
        meta = {
            "latent_dims": cfg.latent_dims,
            "image_size": cfg.max_size,
            "batch_size": batch,
            "layout": "NWHC",
            "value_range": [-1.0, 1.0],
            "format": FORMAT,
        }
        with open(f"{out_base}.json", "w") as f:
            json.dump(meta, f, indent=2)
        size = os.path.getsize(f"{out_base}.pt2")
        print(f"wrote {out_base}.pt2 ({size} bytes) and {out_base}.json")

        # sanity round trip: load + run
        loaded = torch.export.load(f"{out_base}.pt2").module()
        with torch.inference_mode():
            out = loaded(z)
        assert out.shape == (batch, cfg.max_size, cfg.max_size,
                             cfg.data_dims)

        if self.args.onnx:
            self._export_onnx(out_base)

    def _export_onnx(self, out_base):
        """Emit the ONNX artifact for the in-browser demo (web/index.html).

        The graph bakes eval-mode BatchNorm (running stats) into
        constants, so it matches ``g(z, train=False)``; output layout is
        NCHW (the browser page handles the canvas transpose)."""
        from .onnx import export_generator
        from .onnx_eval import evaluate

        model_bytes = export_generator(self.g,
                                       batch_size=self.args.batch_size)
        with open(f"{out_base}.onnx", "wb") as f:
            f.write(model_bytes)
        # sanity round trip through the numpy interpreter
        z = np.zeros((self.args.batch_size, self.gan_config.latent_dims),
                     np.float32)
        out = evaluate(model_bytes, {"z": z})["image"]
        assert out.shape == (self.args.batch_size,
                             self.gan_config.data_dims,
                             self.gan_config.max_size,
                             self.gan_config.max_size)
        print(f"wrote {out_base}.onnx ({len(model_bytes)} bytes)")
        if self.args.page:
            dest_dir = os.path.dirname(out_base) or "."
            shutil.copy(PAGE, os.path.join(dest_dir, "index.html"))
            print(f"wrote {dest_dir}/index.html "
                  "(serve the directory and open it)")

    @classmethod
    def add_args_to_parser(cls, p):
        p.add_argument("checkpoint_root",
                       help="Path to a checkpoint step dir or run dir.")
        p.add_argument("--trunc-norm", type=float, default=None)
        p.add_argument("--output", default="ttgan")
        p.add_argument("--batch-size", default=1, type=int)
        p.add_argument("--no-target", action="store_true",
                       help="Export the live G instead of the EMA target G")
        p.add_argument("--onnx", action="store_true",
                       help="Also emit a .onnx artifact for the in-browser "
                            "demo (self-contained emitter, no onnx package)")
        p.add_argument("--page", action="store_true",
                       help="With --onnx: copy the static demo page "
                            "(web/index.html) next to the artifact")
        add_device_arg(p)


# reference parse: prep4web exposes `package_for_web(model, filename)`
def package_for_web(generator_app: GOutputApp, filename: str,
                    batch_size: int = 1):
    """Programmatic entry mirroring reference prep4web.py:23-30."""
    generator_app.args.output = filename
    generator_app.args.batch_size = batch_size
    generator_app.run()


def main():
    WebExportApp.run_from_cli()


if __name__ == "__main__":
    main()
