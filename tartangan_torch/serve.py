"""Browser demo: serve the generator over HTTP with an interactive page.

Counterpart of ``tartangan_tpu/serve.py``, with the same endpoints, flags
and page, plus ``--device`` (default ``cuda``):

- ``GET /``               an HTML page with generate/interpolate controls
- ``GET /generate``       one PNG sample (``?seed=N&trunc=F`` optional)
- ``GET /grid``           a slerp interpolation grid PNG (``?n=5``)
- ``GET /meta``           model metadata JSON

It serves a run directory written by the JAX trainer (``config.args`` plus
``checkpoints/<step>/g.msgpack`` and ``g_target.msgpack``).

Usage: python -m tartangan_torch.serve CHECKPOINT_ROOT [--port 8000]
       [--device cuda]
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .explore.base import GOutputApp
from .utils.imaging import encode_png, make_grid, to_uint8
from .utils.slerp import slerp_grid

_PAGE = """<!doctype html>
<html><head><title>tartangan-tpu</title><style>
body {{ font-family: sans-serif; margin: 2em; background: #111; color: #eee; }}
img {{ image-rendering: pixelated; border: 1px solid #444; }}
button {{ margin: 0.3em; padding: 0.5em 1em; }}
</style></head><body>
<h2>tartangan-tpu generator (size {size}, latent {latent})</h2>
<button onclick="gen()">Generate</button>
<button onclick="grid()">Interpolation grid</button>
<label>truncation <input id="trunc" type="number" value="" step="0.5"
 style="width:4em"></label>
<div><img id="out" width="512"></div>
<script>
function q() {{
  const t = document.getElementById('trunc').value;
  const seed = Math.floor(Math.random() * 1e9);
  return 'seed=' + seed + (t ? '&trunc=' + t : '');
}}
function gen() {{ document.getElementById('out').src = '/generate?' + q(); }}
function grid() {{ document.getElementById('out').src = '/grid?n=5&' + q(); }}
gen();
</script></body></html>
"""


class _ServeApp(GOutputApp):
    app_name = "Serve generator over HTTP"

    @classmethod
    def add_args_to_parser(cls, p):
        p.add_argument("checkpoint_root")
        p.add_argument("--port", type=int, default=8000)
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--trunc-norm", type=float, default=None)
        p.add_argument("--no-target", action="store_true")
        p.add_argument("--device", default="cuda",
                       help="torch device to run the generator on")


def make_handler(app: _ServeApp):
    cfg = app.gan_config

    def sample_png(seed, trunc, n=1, grid_n=None):
        rng = np.random.default_rng(seed)
        if grid_n:
            corners = np.stack([_z(rng, trunc, cfg.latent_dims)
                                for _ in range(4)])
            zs = slerp_grid(*corners, grid_n, grid_n)
            nrow = grid_n
        else:
            zs = np.stack([_z(rng, trunc, cfg.latent_dims)
                           for _ in range(n)])
            nrow = n
        imgs = app.generate(zs.astype(np.float32))
        return encode_png(make_grid(to_uint8(imgs), nrow=nrow, padding=1))

    def _z(rng, trunc, dims):
        z = rng.standard_normal(dims)
        if trunc:
            while np.any(np.abs(z) > trunc):
                bad = np.abs(z) > trunc
                z[bad] = rng.standard_normal(int(bad.sum()))
        return z

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, body, ctype):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            qs = parse_qs(url.query)
            seed = int(qs.get("seed", ["0"])[0])
            trunc = float(qs["trunc"][0]) if "trunc" in qs else None
            if url.path == "/":
                page = _PAGE.format(size=cfg.max_size,
                                    latent=cfg.latent_dims)
                self._send(page.encode(), "text/html")
            elif url.path == "/generate":
                self._send(sample_png(seed, trunc), "image/png")
            elif url.path == "/grid":
                n = int(qs.get("n", ["5"])[0])
                self._send(sample_png(seed, trunc, grid_n=n), "image/png")
            elif url.path == "/meta":
                meta = {"latent_dims": cfg.latent_dims,
                        "image_size": cfg.max_size,
                        "data_dims": cfg.data_dims}
                self._send(json.dumps(meta).encode(), "application/json")
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def main(argv=None):
    app = _ServeApp(_ServeApp.parse_cli_args(argv))
    app.load_generator(target=not app.args.no_target)
    handler = make_handler(app)
    server = ThreadingHTTPServer((app.args.host, app.args.port), handler)
    print(f"serving on http://{app.args.host}:{app.args.port}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
