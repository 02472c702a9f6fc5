"""Write the JAX-written orbax checkpoint fixture and its msgpack twin.

The JAX ``CNNTrainer`` at ``--config`` (default '8'), step 0 (its
initial weights and optimizer states from ``--seed``; no train step is
compiled), saves its ``checkpoint_artifacts()`` as the JAX package's
``--checkpoint-format orbax`` does (``ocp.StandardCheckpointer``, one
``{name}.orbax`` directory each) and as flax msgpack
(``{name}.msgpack``). ``tests/test_torch_orbax.py`` and ``chip_smoke.py``
restore the orbax directories with the port's own reader and hold them
bit for bit against the msgpack files. Config '8', the smallest, already
has zstd frames with compressed blocks, Huffman literals in 1 and 4
streams and FSE-compressed sequence tables, which the test checks.

Run from the repo root (needs jax, flax and orbax):

    python tests/fixtures/make_orbax_fixture.py [--config 8] \
        [--out tests/fixtures/orbax_jax]
"""
import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="8")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures",
                                                 "orbax_jax"))
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp
    from flax import serialization

    sys.path.insert(0, ROOT)
    from tartangan_tpu.train.cnn import CNNTrainer

    tmp = tempfile.mkdtemp()
    try:
        data = os.path.join(tmp, "data.npz")
        size = int(args.config)
        images = np.random.default_rng(args.seed).integers(
            0, 256, (8, size, size, 3), dtype=np.uint8)
        np.savez(data, images=images)
        trainer = CNNTrainer.create_from_cli([
            data, "--config", args.config, "--batch-size", "8",
            "--output", os.path.join(tmp, "out"), "--run-id", "fixture",
            "--dtype", "f32", "--seed", str(args.seed), "--quiet-logs"])
        trainer.build_models()
        artifacts = jax.device_get(trainer.checkpoint_artifacts())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)
    with ocp.StandardCheckpointer() as ckptr:
        for name, tree in artifacts.items():
            ckptr.save(os.path.abspath(os.path.join(args.out,
                                                    f"{name}.orbax")),
                       tree, force=True)
    for name, tree in artifacts.items():
        with open(os.path.join(args.out, f"{name}.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(tree))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(args.out) for f in files)
    print(f"wrote {sorted(artifacts)} to {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
