"""Convert torchvision InceptionV3 weights to the ``--inception-weights``
npz.

Counterpart of ``tartangan_tpu/eval/port_weights.py``, writing the same npz
(the JAX package's flat variable keys and layout), so either package's
``--inception-weights`` takes it. The pretrained torchvision weights cannot
be fetched without a network; they arrive as a file saved on a machine with
torchvision (``torch.save(inception_v3(pretrained=True).state_dict(),
'w.pth')``), or from an installed torchvision's weight cache. Usage:

    python -m tartangan_torch.eval.port_weights SOURCE.pth OUT.npz
    python -m tartangan_torch.eval.port_weights torchvision OUT.npz
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.inception import (
    init_inception,
    port_torch_state_dict,
    save_weights_npz,
)
from ..utils.precision import full_float32


def load_torch_state_dict(source: str):
    """A torch state_dict from a .pth/.pt file (a raw state_dict or a
    checkpoint dict holding one under 'state_dict', 'module.' prefixes
    dropped) or from an installed torchvision."""
    if source == "torchvision":
        from torchvision.models import inception_v3
        return inception_v3(pretrained=True,
                            transform_input=False).state_dict()
    obj = torch.load(source, map_location="cpu", weights_only=True)
    if not hasattr(obj, "keys"):
        raise ValueError(f"{source} does not contain a state_dict")
    if "state_dict" in obj and hasattr(obj["state_dict"], "keys"):
        obj = obj["state_dict"]
    return {k.removeprefix("module."): v for k, v in obj.items()}


def port(source: str, destination: str):
    state_dict = load_torch_state_dict(source)
    save_weights_npz(port_torch_state_dict(init_inception(), state_dict),
                     destination)
    n = sum(int(np.prod(tuple(v.shape))) for v in state_dict.values())
    print(f"ported {n} torch weights -> {destination}")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Port torchvision inception_v3 weights to the npz "
                    "format --inception-weights consumes.")
    p.add_argument("source",
                   help="torch state_dict file (.pth/.pt), or 'torchvision' "
                        "to read an installed torchvision's weight cache")
    p.add_argument("destination", help="Output npz path")
    args = p.parse_args(argv)
    full_float32()
    port(args.source, args.destination)


if __name__ == "__main__":
    main()
