"""The port's text GAN (``tartangan_torch/data/text.py``, ``models/text.py``,
the 1-D forms in ``ops/resize.py``, ``models/{layers,blocks,factories}.py``,
``train/text_cnn.py`` and ``train/components/text_sampler.py``) against the
JAX package's, on the same corpus, weights (through ``convert.py``) and
draws.

The JAX step draws its window offsets, negatives and latents from its key;
the test makes the same draws from the same key splits and hands them to
the port's step.

Tolerances (float32): the 1-D ops, blocks, SkipGram loss and its gradient
1e-5 of the reference's max-abs; the steps as ``tests/test_torch_train.py``
states them (losses and gp 1e-4 relative; Adam's moments 1e-4 of the
gradient's max-abs; parameters 2 lr; statistics 1e-5 + lr; the EMA target
1e-5), the SkipGram's loss 1e-5 relative and its tables after SGD 1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tartangan_tpu.data import text as jtext
from tartangan_tpu.models import blocks as jblocks
from tartangan_tpu.models import text as jmtext
from tartangan_tpu.ops import resize as jresize
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.text_cnn import TextCNNTrainer as JaxTextTrainer
from tartangan_tpu.train.text_cnn import make_text_train_steps as jax_steps
from tartangan_torch.convert import _to_tree, adam_to_flax, from_flax, to_flax
from tartangan_torch.data import text as ttext
from tartangan_torch.models import blocks as tblocks
from tartangan_torch.models import text as tmtext
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.ops import resize as tresize
from tartangan_torch.train import text_cnn
from tartangan_torch.train.common import make_adam

from test_torch_shared import _perturb
from test_torch_train import EMA, LR_D, LR_G, _scaled, _zip_leaves

DOCS = [
    "The quick brown fox jumps over the lazy dog .",
    "A stitch in time saves nine, they say!",
    "To be or not to be: that is the question?",
    "It's (not) all \"gold\" that glitters; <br />isn't it.",
    "The early bird catches the worm .",
    "Better late than never , better safe than sorry .",
    "Actions speak louder than words .",
    "The pen is mightier than the sword .",
] * 3
B, E, CTX = 4, 8, 2


def _close(ours, ref, tol=1e-5):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours / scale, ref / scale, rtol=0, atol=tol)


def _np(t):
    return t.detach().float().numpy()


def _ncl(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "docs.txt"
    path.write_text("\n".join(DOCS))
    return str(path)


# ----------------------------------------------------------------- the data
def test_tokenizer_vocab_and_batches_match_jax(corpus):
    """torchtext's basic_english, the frequency vocabulary (specials first,
    ties by token) and the padded, truncated id batches."""
    for doc in DOCS[:8]:
        assert ttext.basic_english_tokenizer(doc) == \
            jtext.basic_english_tokenizer(doc)
    ours = ttext.TextDataset.from_path(corpus, doc_len=8)
    theirs = jtext.TextDataset.from_path(corpus, doc_len=8)
    assert ours.vocab.itos == theirs.vocab.itos
    assert ours.vocab.itos[:2] == ["<unk>", "<pad>"]
    assert len(ours) == len(theirs) == len(DOCS)
    idx = [0, 3, 5, 23]
    np.testing.assert_array_equal(ours.batch(idx), theirs.batch(idx))
    assert ours.batch(idx).dtype == np.int32
    assert ours.vocab.encode(["fox", "zebra"]) == [
        ours.vocab.stoi["fox"], ours.vocab.unk_id]


# ------------------------------------------------------------ the 1-D parts
@pytest.mark.parametrize("op", ["up", "pool", "linear_down", "linear_up"])
def test_1d_resample_matches_jax(rng, op):
    x = rng.standard_normal((B, 12, 5)).astype(np.float32)
    jfn, tfn = {
        "up": (jresize.upsample_nearest_2x_1d, tresize.upsample_nearest_2x_1d),
        "pool": (jresize.avg_pool_2x_1d, tresize.avg_pool_2x_1d),
        "linear_down": (lambda a: jresize.resize_linear_1d(a, 6),
                        lambda a: tresize.resize_linear_1d(a, 6)),
        "linear_up": (lambda a: jresize.resize_linear_1d(a, 20, True),
                      lambda a: tresize.resize_linear_1d(a, 20, True)),
    }[op]
    _close(_np(tfn(_ncl(x)).transpose(1, 2)), jfn(jnp.asarray(x)))


BLOCKS = {
    "g_first": (lambda m: m.ResidualGeneratorBlock(8, 16, first_block=True,
                                                   ndim=1), (B, 4, 8)),
    "g_up": (lambda m: m.ResidualGeneratorBlock(16, 8, ndim=1), (B, 8, 16)),
    "g_same": (lambda m: m.ResidualGeneratorBlock(8, 8, upsample=False,
                                                  ndim=1), (B, 8, 8)),
    "d_first": (lambda m: m.ResidualDiscriminatorBlock(
        8, 16, first_block=True, ndim=1), (B, 16, 8)),
    "d": (lambda m: m.ResidualDiscriminatorBlock(16, 16, ndim=1),
          (B, 16, 16)),
    "g_out": (lambda m: m.GeneratorOutput(8, E, output_activation="id",
                                          ndim=1), (B, 16, 8)),
    "d_in": (lambda m: m.DiscriminatorInput(E, 8, ndim=1), (B, 16, E)),
    "d_out": (lambda m: m.DiscriminatorOutput(8, 1), (B, 4, 8)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_1d_block_matches_jax(rng, name):
    """The text GAN's blocks over NCL (NLC in the JAX package): output and
    batch statistics in train mode, and the gradient of every parameter
    (the 1-D convs' WIO <-> OIW through ``convert.py``)."""
    build, shape = BLOCKS[name]
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = build(jblocks)
    variables = _perturb(jax.device_get(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    out = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])[0]
    w = rng.standard_normal(out.shape).astype(np.float32)

    def jloss(params):
        out, new = jmod.apply({**variables, "params": params},
                              jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(out * w), (out, new)
    (_, (want, new)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    mod = build(tblocks)
    mod.load_state_dict(from_flax(variables))
    with update_batch_stats(mod):
        got = mod(_ncl(x))
    w_t = torch.from_numpy(w) if got.dim() == 2 else _ncl(w)
    (got * w_t).sum().backward()
    got = got if got.dim() == 2 else got.transpose(1, 2)
    _close(_np(got), want)
    grads = _to_tree((k, p.grad) for k, p in mod.named_parameters())
    # over the whole tree's max-abs: a conv bias before a train-mode
    # BatchNorm has a gradient of 0 up to rounding
    _scaled(grads["params"], jax.device_get(jgrads), 1e-5)
    for a, b in _zip_leaves(to_flax(mod).get("batch_stats", {}),
                            jax.device_get(new).get("batch_stats", {})):
        _close(a, b)


def test_mlp1d_input_matches_jax(rng):
    z = rng.standard_normal((B, 12)).astype(np.float32)
    jmod = jblocks.GeneratorInputMLP1d(12, 8, size=4)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), z))
    tmod = tblocks.GeneratorInputMLP1d(12, 8, size=4)
    tmod.load_state_dict(from_flax(variables))
    got = tmod(torch.from_numpy(z))
    assert got.shape == (B, 8, 4)
    _close(_np(got.transpose(1, 2)), jmod.apply(variables, jnp.asarray(z)))


# -------------------------------------------------------------- the SkipGram
def test_skipgram_loss_and_lookup_match_jax(rng):
    """The negative-sampling loss (the JAX negatives drawn from its key and
    handed over) and its gradient, and the nearest-vocabulary decode with
    its skipped first row."""
    v, d = 12, 6
    jm = jmtext.SkipGram(v, d)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((2, 4), jnp.int32)))
    words = rng.integers(0, v, B).astype(np.int32)
    contexts = rng.integers(0, v, (B, 2 * CTX)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    negatives = np.asarray(jax.random.randint(key, contexts.shape, 0, v))

    def jloss(params):
        return jm.apply({"params": params}, words, contexts, key,
                        method=jmtext.SkipGram.loss)
    want, jgrads = jax.value_and_grad(jloss)(variables["params"])
    tm = tmtext.SkipGram(v, d)
    tm.load_state_dict(from_flax(variables))
    got = tm.loss(*(torch.from_numpy(a) for a in (words, contexts,
                                                  negatives)))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for name in ("embedding_u", "embedding_v"):
        _close(_np(getattr(tm, name).grad), jgrads[name])
    table = variables["params"]["embedding_u"]
    zs = (rng.standard_normal((B, 5, d)) + 3 * table[
        rng.integers(0, v, (B, 5))]).astype(np.float32)
    want_ids = np.asarray(jmtext.skipgram_lookup(jnp.asarray(table),
                                                 jnp.asarray(zs)))
    got_ids = tmtext.skipgram_lookup(torch.from_numpy(table),
                                     torch.from_numpy(zs))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert got_ids.min() >= 1


# ---------------------------------------------------------------- the steps
def _step_setup(rng, corpus, out):
    """The JAX trainer's models and a port trainer on the same weights."""
    argv = [corpus, "--config", "16", "--batch-size", str(B),
            "--embedding-dims", str(E), "--context", str(CTX),
            "--output", str(out), "--run-id", "x", "--dtype", "f32"]
    jt = JaxTextTrainer.create_from_cli(argv)
    jt.build_models()
    js = jax.device_get(jt.state)
    g_vars = _perturb({"params": js.g_params, "batch_stats": js.g_stats},
                      rng)
    d_vars = _perturb({"params": js.d_params, "batch_stats": js.d_stats},
                      rng)
    js = js.replace(g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
                    target_g_params=g_vars["params"],
                    d_params=d_vars["params"], d_stats=d_vars["batch_stats"],
                    opt_g=jax_adam(LR_G).init(g_vars["params"]),
                    opt_d=jax_adam(LR_D).init(d_vars["params"]))
    tt = text_cnn.TextCNNTrainer.create_from_cli(argv + ["--device", "cpu"])
    tt.build_models()
    s = tt.state
    s.g.load_state_dict(from_flax(g_vars))
    s.g_target.load_state_dict(from_flax({"params": g_vars["params"]}),
                               strict=False)
    s.d.load_state_dict(from_flax(d_vars))
    s.embedding.load_state_dict(from_flax({"params": js.emb_params}))
    s.opt_g = make_adam(s.g.parameters(), LR_G)
    s.opt_d = make_adam(s.d.parameters(), LR_D)
    return jt, js, tt


def _emb_draws(key, n, vocab):
    """The JAX embedding update's draws from its key."""
    k_off, k_neg = jax.random.split(key)
    offsets = np.asarray(jax.random.randint(k_off, (n,), 0, 2 * CTX + 1))
    negatives = np.asarray(jax.random.randint(k_neg, (n, 2 * CTX), 0,
                                              vocab))
    return {"offsets": torch.from_numpy(offsets),
            "negatives": torch.from_numpy(negatives)}


@pytest.mark.parametrize("phase", ["embed", "full"])
def test_text_step_matches_jax(rng, corpus, tmp_path, phase):
    """``embed_step`` (SGD on the SkipGram, EMA of G) and ``full_step``
    (the embedding update, then BCE + R1 + Adam + EMA on the embedded
    documents) against the JAX steps, from one state, batch and draws:
    losses, gp, the embedding tables, gradients, statistics, Adam, EMA."""
    jt, js, tt = _step_setup(rng, corpus, tmp_path)
    vocab = len(tt.dataset.vocab)
    batch = tt.dataset.batch([0, 5, 9, 14])
    jembed, jfull = jax_steps(
        jt.g, jt.d, jt.embedding, jt.opt_g, jt.opt_d, jt.opt_emb,
        latent_dims=jt.gan_config.latent_dims, context=CTX,
        grad_penalty=5.0, ema_factor=EMA, dtype=jnp.float32)
    key = jax.random.PRNGKey(7)
    if phase == "embed":
        new_js, jm = jax.jit(jembed)(js, jnp.asarray(batch), key)
        tm = tt._embed_step(tt.state, torch.from_numpy(batch),
                            **_emb_draws(key, B, vocab))
    else:
        new_js, jm = jax.jit(jfull)(js, jnp.asarray(batch), key)
        rng_emb, rng_zg, d_key = jax.random.split(key, 3)
        latent = jt.gan_config.latent_dims
        z_d = np.asarray(jax.random.normal(d_key, (B, latent)))[None]
        z_g = np.asarray(jax.random.normal(rng_zg, (B, latent)))
        tm = tt._full_step(tt.state, torch.from_numpy(batch),
                           z_d=torch.from_numpy(z_d.copy()),
                           z_g=torch.from_numpy(z_g.copy()),
                           **_emb_draws(rng_emb, B, vocab))
    new_js = jax.device_get(new_js)
    s = tt.state
    np.testing.assert_allclose(float(tm["embedding_loss"]),
                               float(jm["embedding_loss"]), rtol=1e-5)
    for name, table in to_flax(s.embedding)["params"].items():
        np.testing.assert_allclose(table, new_js.emb_params[name], rtol=0,
                                   atol=1e-6)
    for a, b in _zip_leaves(to_flax(s.g_target)["params"],
                            new_js.target_g_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if phase == "embed":
        assert all(float(tm[k]) == 0 for k in ("g_loss", "d_loss", "gp"))
        return
    for name in ("d_loss", "g_loss", "gp"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert float(tm["gp"]) > 0
    for mod, opt, jparams, jstats, jopt, lr in (
            (s.g, s.opt_g, new_js.g_params, new_js.g_stats, new_js.opt_g,
             LR_G),
            (s.d, s.opt_d, new_js.d_params, new_js.d_stats, new_js.opt_d,
             LR_D)):
        tree = to_flax(mod)
        for a, b in _zip_leaves(tree["params"], jparams):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr)
        for a, b in _zip_leaves(tree["batch_stats"], jstats):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 + lr)
        adam = adam_to_flax(mod, opt)
        jadam = serialization.to_state_dict(jopt)
        for moment in ("mu", "nu"):
            _scaled(adam["0"][moment], jadam["0"][moment], 1e-4)


# -------------------------------------------------------------- the trainer
def _argv(corpus, out, *extra):
    return [corpus, "--config", "16", "--batch-size", "8", "--epochs", "1",
            "--output", str(out), "--gen-freq", "2", "--checkpoint-freq",
            "100", "--run-id", "text", "--dtype", "f32", "--quiet-logs",
            "--embedding-dims", str(E), "--pretrain-embedding", "2",
            "--context", str(CTX), *extra]


def test_text_entry_point_checkpoints_both_ways(corpus, tmp_path):
    """``python -m tartangan_torch.train.text_cnn ... --device cpu``: two
    embedding steps then one full step, the text samples, and a checkpoint
    (``embedding`` and ``opt_emb`` beside G's and D's) that the JAX text
    trainer's templates restore and its loader takes; the port resumes
    from a checkpoint the JAX trainer wrote, leaf for leaf."""
    out = tmp_path / "out"
    text_cnn.main(_argv(corpus, out, "--device", "cpu"))
    run = out / "text"
    sample = (run / "samples" / "sample_2.txt").read_text()
    assert sample.count("-" * 40) == 16
    ckpt = run / "checkpoints" / "3"
    trainer_json = json.loads((ckpt / "trainer.json").read_text())
    assert trainer_json["steps"] == 3

    jt = JaxTextTrainer.create_from_cli(_argv(corpus, out, "--run-id",
                                              "jax"))
    jt.build_models()
    templates = jax.device_get(jt.checkpoint_artifacts())
    assert set(templates) == {"g", "g_target", "d", "opt_g", "opt_d",
                              "embedding", "opt_emb"}
    restored = {n: serialization.from_bytes(
        t, (ckpt / f"{n}.msgpack").read_bytes())
        for n, t in templates.items()}
    jt.load_checkpoint_artifacts(restored)
    assert int(jt.state.opt_d[0].count) == 1  # one full step

    jckpt = out / "jax" / "checkpoints" / "5"
    jckpt.mkdir(parents=True)
    for n, tree in templates.items():
        (jckpt / f"{n}.msgpack").write_bytes(serialization.to_bytes(tree))
    (jckpt / "trainer.json").write_text(json.dumps({"epoch": 2, "steps": 5}))
    trainer = text_cnn.TextCNNTrainer.create_from_cli(_argv(
        corpus, out, "--device", "cpu", "--run-id", "jax",
        "--resume-training-latest", "--epochs", "0"))
    trainer.train()
    assert trainer.steps == 5
    mine = trainer.checkpoint_artifacts()
    for n, tree in templates.items():
        for a, b in _zip_leaves(mine[n], serialization.to_state_dict(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_text_trainer_refuses_chunked_calls(corpus, tmp_path):
    trainer = text_cnn.TextCNNTrainer.create_from_cli(_argv(
        corpus, tmp_path, "--device", "cpu", "--steps-per-call", "2"))
    with pytest.raises(NotImplementedError):
        trainer.build_models()


def test_text_entry_point_needs_cuda_by_default(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        text_cnn.TextCNNTrainer.create_from_cli(_argv(corpus, tmp_path))
