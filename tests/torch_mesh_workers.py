"""What the mesh tests run on each rank (``tests/test_torch_mesh.py``,
``tests/test_torch_tensor_parallel.py``): the port's trainers and steps,
on one process or on every rank of a gloo mesh that
``tartangan_torch.parallel.launch`` starts. Kept apart from the test
modules so that the spawned ranks import torch and the port only."""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from tartangan_torch.models import factories as F
from tartangan_torch.models.pluggan import Generator
from tartangan_torch.ops import parity as P
from tartangan_torch.parallel import mesh as M
from tartangan_torch.train.cnn import CNNTrainer

B = 16


class FusedGTrainer(CNNTrainer):
    """The CNN trainer with the fused G blocks (K4/K5,
    ``g_block_factory(fused=True)``), which no CLI flag selects."""

    def build_generator(self):
        a = self.args
        return Generator(
            self.gan_config,
            input_factory=F.g_input_factory(a.g_base, a.activation),
            block_factory=F.g_block_factory(
                a.norm, a.activation, fused=True,
                parity=F.resolve_parity(a.parity_blocks)),
            output_factory=F.g_output_factory(a.norm, a.activation),
            dtype=self.dtype)


@contextlib.contextmanager
def fused_g(on):
    """``ops.parity.FUSED_G`` (K3 in G's parity blocks) while training."""
    old = P.FUSED_G
    P.FUSED_G = on
    try:
        yield
    finally:
        P.FUSED_G = old

# family -> (trainer 'module:Class', extra flags)
FAMILIES = {
    "cnn": ("tartangan_torch.train.cnn:CNNTrainer", ["--config", "8"]),
    "parity": ("tartangan_torch.train.cnn:CNNTrainer",
               ["--config", "16", "--parity-blocks", "on"]),
    "iqn": ("tartangan_torch.train.iqn:IQNTrainer", ["--config", "8"]),
    "info": ("tartangan_torch.train.info:InfoTrainer",
             ["--config", "8", "--info-cat-dims", "3",
              "--info-cont-dims", "2"]),
    "scene": ("tartangan_torch.train.scene:SceneTrainer",
              ["--config", "8", "--scene-size", "8", "--num-patches", "4",
               "--patch-noise"]),
    "text": ("tartangan_torch.train.text_cnn:TextCNNTrainer",
             ["--config", "8", "--embedding-dims", "16", "--context", "1",
              "--pretrain-embedding", "0"]),
    "shared": ("tartangan_torch.train.shared.cnn:SharedCNNTrainer",
               ["--config", "8"]),
    # K4/K5's plain versions in the fused G block (config '16': its 32-wide
    # block), and K3's in G's parity blocks under FUSED_G (config '32')
    "fused": ("torch_mesh_workers:FusedGTrainer", ["--config", "16"]),
    "parity_k3": ("torch_mesh_workers:FusedGTrainer",
                  ["--config", "32", "--parity-blocks", "on"]),
}


def trainer_argv(data, out, run_id, extra, world=None, tp=1):
    argv = [data, "--batch-size", str(B), "--epochs", "1", "--output", out,
            "--run-id", run_id, "--gen-freq", "1000", "--checkpoint-freq",
            "100000", "--quiet-logs", "--device", "cpu", "--seed", "3",
            "--tp", str(tp), *extra]
    if world is not None:
        argv += ["--num-devices", str(world)]
    return argv


def _trainer_class(path):
    import importlib
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def summarize(trainer, sgd_grads=None) -> dict:
    """Every rank gathers; rank 0's summary, one-process layout: the last
    logged metrics, G's parameters, D's statistics, G's and D's gradients
    in the last step (Adam's first moments: beta1 is 0) and (text) the
    embedding and its gradients (``sgd_grads``)."""
    from tartangan_torch.utils.scalars import last_scalar
    art = trainer.checkpoint_artifacts()
    return {"logs": {k: last_scalar(v[-1]) for k, v in trainer.logs.items()
                     if v},
            "g": art["g"]["params"], "d_stats": art["d"]["batch_stats"],
            "g_grad": art["opt_g"]["0"]["mu"],
            "d_grad": art["opt_d"]["0"]["mu"],
            "emb": art.get("embedding"), "emb_grad": sgd_grads or None,
            "steps": trainer.steps}


@contextlib.contextmanager
def sgd_gradients():
    """A dict that collects the gradients every SGD optimizer steps with
    (the text GAN's embedding tables), as they are after the mesh's
    gradient sum, by the parameter's index."""
    grads = {}

    def hook(opt, _args, _kwargs):
        if isinstance(opt, torch.optim.SGD):
            for i, p in enumerate(p for g in opt.param_groups
                                  for p in g["params"]):
                grads[str(i)] = p.grad.detach().numpy().copy()
    handle = register_optimizer_step_post_hook(hook)
    try:
        yield grads
    finally:
        handle.remove()


def run_families(data, docs, out, families, world=None, tp=1,
                 extra=(), probe=None):
    """One step of each family's trainer; rank 0's summaries (with
    ``probe(trainer)``'s result, when given, under "probe")."""
    results = {}
    for fam in families:
        path, flags = FAMILIES[fam]
        source = docs if fam == "text" else data
        trainer = _trainer_class(path).create_from_cli(trainer_argv(
            source, out, f"{fam}_{world}_{tp}", [*flags, *extra], world, tp))
        with fused_g(fam == "parity_k3"), sgd_gradients() as sgd:
            trainer.train()
        results[fam] = summarize(trainer, sgd)
        if probe is not None:
            results[fam]["probe"] = probe(trainer)
    return results


# ------------------------------------------------------- the step, directly
def _cnn_state(cfg_name, dtype, trees=None):
    """CNN G, its target, D and Adams at config ``cfg_name`` in ``dtype``,
    from the given flax trees (g, g_target, d) or from seed 0."""
    import copy

    from tartangan_torch.configs import GAN_CONFIGS
    from tartangan_torch.convert import from_flax
    from tartangan_torch.models import factories as F
    from tartangan_torch.models.pluggan import Discriminator, Generator
    from tartangan_torch.ops.init import init_module_
    from tartangan_torch.train.common import make_adam
    from tartangan_torch.train.state import GANTrainState
    cfg = GAN_CONFIGS[cfg_name]
    g = Generator(cfg, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu"),
                  output_factory=F.g_output_factory("bn", "relu"),
                  dtype=dtype)
    d = Discriminator(cfg, input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu"),
                      output_factory=F.d_output_factory("bn", "relu"),
                      dtype=dtype)
    if trees is None:
        gen = torch.Generator().manual_seed(0)
        init_module_(g, gen)
        init_module_(d, gen)
        g_target = copy.deepcopy(g)
    else:
        g.load_state_dict(from_flax(trees["g"]))
        d.load_state_dict(from_flax(trees["d"]))
        g_target = copy.deepcopy(g)
        g_target.load_state_dict(from_flax(trees["g_target"]), strict=False)
    g, g_target, d = (m.to(dtype) for m in (g, g_target, d))
    return GANTrainState(g=g, g_target=g_target, d=d,
                         opt_g=make_adam(g.parameters(), 1e-4),
                         opt_d=make_adam(d.parameters(), 4e-4))


def cnn_step(data, out, cfg_name, dtype, batch, z_d, z_g, trees=None):
    """One CNN step (R1 every step) on this rank's rows of ``batch`` and
    the latents, its optimizers set up for the mesh by the CNN trainer
    (``Trainer._setup_mesh_state``; ``data`` is the archive the trainer is
    made with, the step takes ``batch``): (metrics, g tree, d tree, G's
    and D's gradients as Adam's first moments, which are the gradients
    with beta1 = 0)."""
    from tartangan_torch.convert import adam_to_flax, to_flax
    from tartangan_torch.parallel import collectives as C
    from tartangan_torch.train.cnn import make_cnn_train_step
    m = M.current()
    state = _cnn_state(cfg_name, dtype, trees)
    trainer = CNNTrainer.create_from_cli(trainer_argv(
        data, out, "step", ["--config", cfg_name],
        world=None if m is None else m.world))
    trainer.state = state
    trainer._setup_mesh_state()
    step = make_cnn_train_step(grad_penalty=5.0, ema_factor=1e-3,
                               dtype=dtype)

    def rows(a, dim=0):
        t = torch.from_numpy(np.array(a))
        return t if m is None else m.shard(t, dim)
    z_d = rows(z_d, 1).to(dtype)
    z_g = rows(z_g).to(dtype)
    metrics = C.sum_metrics(step(state, rows(batch), z_d, z_g))
    return ({k: float(v) for k, v in metrics.items()},
            to_flax(state.g), to_flax(state.d),
            adam_to_flax(state.g, state.opt_g)["0"]["mu"],
            adam_to_flax(state.d, state.opt_d)["0"]["mu"])


def mesh_worker(data, docs, out, families, steps_args):
    """A rank of the mesh test: the families, then each direct step."""
    torch.set_num_threads(2)
    res = {"families": run_families(data, docs, out, families,
                                    world=M.current().world)}
    res["steps"] = [cnn_step(data, f"{out}/steps", *a) for a in steps_args]
    res["collectives"] = collectives_check()
    return res if M.is_writer() else None


# ------------------------------------------------- FID and the other paths
def tiny_activations(feats, w):
    """``eval.inception.accumulate_activations`` over four batches of
    ``feats`` through a stand-in net (pool = x, probs = softmax(x @ w)),
    as ``test_fid_moments_match_across_mesh_sizes`` feeds the JAX one."""
    from tartangan_torch.eval.inception import accumulate_activations
    wt = torch.from_numpy(w)
    batches = iter(np.split(feats, 4))

    def sample_fn():
        return torch.from_numpy(next(batches))

    def net(x):
        return x, torch.softmax(x @ wt, -1)
    return accumulate_activations(sample_fn, net, len(feats))


def inception_probe(weights):
    """After training: Inception's softmax rows and moments over 16 of the
    trainer's G samples (two batches), as the FID component takes them."""
    def probe(trainer):
        from tartangan_torch.eval.inception import (
            InceptionWrapper,
            accumulate_activations,
        )
        net = InceptionWrapper(weights=weights, device="cpu")
        return accumulate_activations(trainer.generate, net, 16)
    return probe


def paths_worker(data, out, runs, feats, w, weights):
    """A rank of the FID/dispatch test: ``runs`` maps a name to the CNN
    trainer's extra flags ("fid" also probes Inception's moments); then
    the stand-in activations."""
    torch.set_num_threads(2)
    world = M.current().world if M.current() is not None else None
    res = {name: run_families(
        data, None, f"{out}/{name}", ["cnn"], world=world, extra=flags,
        probe=inception_probe(weights) if name == "fid" else None)["cnn"]
        for name, flags in runs.items()}
    res["activations"] = tiny_activations(feats, w)
    return res if M.is_writer() else None


def tp_worker(data, out, families):
    """A rank of the dp x tp test: the families, and how many of G's and
    D's parameters this rank holds sharded."""
    torch.set_num_threads(1)
    m = M.current()

    def probe(trainer):
        return sum(len(getattr(mod, "tp_dims", {}))
                   for model in (trainer.state.g, trainer.state.d)
                   for mod in model.modules())
    res = run_families(data, None, out, families, world=m.world, tp=m.tp,
                       probe=probe)
    return res if M.is_writer() else None


def collectives_check():
    """The autograd collectives at this rank: ``broadcast`` from rank 1
    and ``data_sum``, each with its first and second derivative, on
    x = rank + 1 (a (3,) float64 vector)."""
    from tartangan_torch.parallel import collectives as C
    r = M.current().rank
    x = torch.full((3,), r + 1.0, dtype=torch.float64, requires_grad=True)
    b = C.broadcast(x, src=1)
    (gb,) = torch.autograd.grad((b * b).sum(), x)
    s = C.data_sum(x)
    (gs,) = torch.autograd.grad((s ** 3).sum(), x, create_graph=True)
    (ggs,) = torch.autograd.grad(gs.sum(), x)
    return {"b": b.detach().numpy(), "gb": gb.numpy(),
            "s": s.detach().numpy(), "gs": gs.detach().numpy(),
            "ggs": ggs.numpy()}
