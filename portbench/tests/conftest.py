"""Shared pieces of the benchmark's tests: tiny cells on the CPU, and the
fixture that decides whether a card is here."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture
def tiny():
    """``tiny_spec``."""
    return tiny_spec


def tiny_spec(workload: str, blocks=(16, 8), attention=(), dtype="f32",
              batch_size=4, images=12):
    """Cell ``workload`` of BENCHMARK.json cut to a tiny configuration the
    program knows as 'pb-tiny' (registered in its GAN_CONFIGS for the
    test's process)."""
    from portbench import run
    from tartangan_torch import configs
    configs.GAN_CONFIGS["pb-tiny"] = configs._cfg(16, blocks,
                                                 attention=attention)
    s = run.spec(workload)
    s["config"] = dict(s["config"], program_config="pb-tiny", latent_dims=16,
                       blocks=list(blocks), attention=list(attention),
                       dtype=dtype)
    s["traffic"] = dict(s["traffic"], batch_size=batch_size, images=images,
                        trace_steps=2)
    return s
