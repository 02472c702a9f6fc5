"""``sagan-512thin-r1-b64`` reads as it did before its model had a module
of its own: the trainer's flags, the weights at one seed, the counts and
the check's numbers of a tiny CPU run, against values read on the harness
that named the SA-GAN in every layer, pinned here."""
import hashlib

import pytest
import torch

from portbench import flops, run

CELL = "sagan-512thin-r1-b64"

ARGV = [
    "DATA.npz", "--config", "512thin", "--batch-size", "64", "--dtype",
    "bf16", "--parity-blocks", "auto", "--g-base", "mlp", "--norm", "bn",
    "--activation", "relu", "--lr-g", "0.0001", "--lr-d", "0.0004",
    "--lr-target-g", "0.001", "--grad-penalty", "5.0", "--r1-interval", "1",
    "--iters-d", "1", "--steps-per-call", "1", "--ema-start", "copy",
    "--seed", "12345", "--output", "OUT", "--run-id", "portbench",
    "--quiet-logs", "--epochs", "1000000000", "--device", "cuda"]

# sha256 over each leaf's "g."/"d." name and float32 bytes, G then D
WEIGHTS = ("7ff0ca9ae5b54b060f19113cc9567cdf"
           "df8e302f223a9e9226b1cd1b04ea99d4", 202)

# at B 64, bf16: (step FLOPs, conv bound ms, K1 bound ms, K2 bound ms)
COUNTS = {True: (3179685265408, 13.82899151156573, 0.04953102541810664,
                 0.06373350730320088),
          False: (2663886487552, 11.552007116367687, 0.04953102541810664,
                  0.059742658347977)}

# ``tiny_spec``'s cell at seed 7 on the CPU, one intra-op thread
CHECK = {"loss": 1.0111788859377071e-07, "grad": 6.292802352331991e-07,
         "g_grad": 8.909913039667226e-07, "change": 1.1166124909295408e-08}


def test_trainer_argv():
    s = run.spec(CELL)
    assert s["model"].trainer_argv(s["config"], s["traffic"], "DATA.npz",
                                   "OUT", 12345, "cuda") == ARGV


def test_weights():
    s = run.spec(CELL)
    m = s["model"]
    w = m.make_weights(m.architecture(s["config"]), s["config"]["train"],
                       2 ** 31 + 5, "cpu")
    h = hashlib.sha256()
    for key in ("g", "d"):
        for name, t in w[key].items():
            h.update(f"{key}.{name}".encode())
            h.update(t.contiguous().numpy().tobytes())
    assert (h.hexdigest(), len(w["g"]) + len(w["d"])) == WEIGHTS


@pytest.mark.parametrize("r1", [True, False])
def test_counts(r1):
    s = run.spec(CELL)
    m = s["model"]
    step = flops.counts(m, m.architecture(s["config"]), 64, r1)
    item, peak = flops.PEAKS["itemsize"]["bf16"], flops.peak_flops("bf16")
    k = flops.kernel_bound_ms(step, item, peak)
    assert (flops.step_flops(step), flops.conv_bound_ms(step, item, peak),
            k["k1"], k["k2"]) == COUNTS[r1]


def test_check_numbers(tiny):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, res, _ = run.run_cell(tiny(CELL), 7, 0.0, False, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert result["correct"]
    assert res["numbers"] == CHECK
