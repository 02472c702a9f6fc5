"""The FLOP and byte counts of the SA-GAN model module against a count by
hand at a tiny configuration (base 2, latent 3, widths 4 then 2, attention
after the first block, batch 1)."""
import pytest

from portbench import flops
from portbench.models import sagan

CFG = {"base_size": 2, "latent_dims": 3, "data_dims": 3, "blocks": [4, 2],
       "attention": [0]}


def test_layers_by_hand():
    g, ga = sagan.generator_layers(CFG, 1)
    assert [(c.name, c.flops) for c in g] == [
        ("g.dense", 96), ("g.0.conv0", 4608), ("g.0.conv1", 4608),
        ("g.0.attn.theta", 128), ("g.0.attn.phi", 128), ("g.0.attn.g", 256),
        ("g.0.attn.o", 256), ("g.1.conv0", 9216), ("g.1.conv1", 4608),
        ("g.1.proj", 1024), ("g.out", 768)]
    d, da = sagan.discriminator_layers(CFG, 1)
    assert [(c.name, c.flops) for c in d] == [
        ("d.in", 768), ("d.1.conv0", 4608), ("d.1.conv1", 4608),
        ("d.0.conv0", 2304), ("d.0.conv1", 4608), ("d.0.proj", 64),
        ("d.0.attn.theta", 32), ("d.0.attn.phi", 32), ("d.0.attn.g", 64),
        ("d.0.attn.o", 64), ("d.dense", 8)]
    assert [(a.lq, a.lk, a.ck, a.cv, a.fwd_flops, a.bwd_flops)
            for a in ga + da] == [(16, 4, 1, 2, 384, 768), (4, 1, 1, 2, 24, 48)]
    # x 4*4*4, y 4*4*4, w 4*4*9, two bytes each
    assert g[1].nbytes(2) == 2 * (64 + 64 + 144)


def test_step_by_hand():
    # G: dense 3 ops, the rest 4; D with R1: input conv 9, the rest 11;
    # without R1: 6 and 8; attention G 2 fwd + 1 bwd, D 3 fwd + 6 (3) bwd
    g = 96 * 3 + 25600 * 4
    assert flops.step_flops(flops.counts(sagan, CFG, 1, True)) == \
        g + 768 * 9 + 16392 * 11 + 384 * 2 + 768 + 24 * 3 + 48 * 6
    assert flops.step_flops(flops.counts(sagan, CFG, 1, False)) == \
        g + 768 * 6 + 16392 * 8 + 384 * 2 + 768 + 24 * 3 + 48 * 3
    launches = flops.counts(sagan, CFG, 1, True).launches
    assert sum(n for *_, n in launches["k1"]) == 5
    assert sum(n for *_, n in launches["k2"]) == 5


def test_attention_bound_as_the_smoke_had_it():
    # the '512thin' G attention in float32: K1 0.3205 ms, K2 0.7051 ms
    # (operations), PERF.md's bounds from chip_smoke.attention_bound_ms
    assert flops.attention_bound_ms(64, 4096, 1024, 8, 32, 4) == \
        pytest.approx(0.32052, abs=1e-5)
    assert flops.attention_bound_ms(64, 4096, 1024, 8, 32, 4,
                                    backward=True) == \
        pytest.approx(0.70514, abs=1e-5)


def test_conv_bound_leaves_out_dense_layers():
    itemsize, peak = 2, flops.peak_flops("bf16")
    step = flops.counts(sagan, CFG, 1, True)
    whole = sum(n * flops.bound_ms(c.nbytes(itemsize), c.flops, peak)
                for c, n in step.conv_ops)
    dense = sum(n * flops.bound_ms(c.nbytes(itemsize), c.flops, peak)
                for c, n in step.conv_ops if c.dense)
    assert flops.conv_bound_ms(step, itemsize, peak) == \
        pytest.approx(whole - dense)
