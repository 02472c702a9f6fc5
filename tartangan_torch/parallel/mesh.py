"""The device mesh behind ``--num-devices`` and ``--tp``: one process a
rank, a process group over them, and its data and model groups.

Counterpart of ``tartangan_tpu/parallel/mesh.py``. There one program runs
over a ``jax.sharding.Mesh`` and XLA inserts the collectives; here each
rank is a process (``torch.distributed``), and the collectives are
explicit (``parallel/collectives.py``): BatchNorm's moments and the losses
are taken over the global batch, the gradients are summed over the data
group before each optimizer step, and ``--tp`` shards the weights' output
channels over the model group (``parallel/tp.py``). A step on N ranks thus
equals the step on one process over the global batch.

Rank layout as the JAX package's: ``world = dp * tp`` ranks in a (dp, tp)
grid, row-major, so ranks ``r`` and ``r + 1`` share a data shard when
``tp`` is 2 (axis names ``DATA_AXIS`` and ``MODEL_AXIS``).

Backend: NCCL when every rank has a card of its own, gloo on the CPU, and
gloo for several ranks on one card (``share_device``: only the tests and
``chip_smoke.py`` ask for it). ``launch`` starts the ranks
(``torch.multiprocessing.spawn``, a file rendezvous in a temporary
directory), or joins ranks that ``torchrun`` started (``RANK`` and
``WORLD_SIZE`` in the environment). At world size 1 the trainer makes no
mesh and no process group, and runs the one-process path.

Every collective waits at most ``COLLECTIVE_TIMEOUT`` seconds (not the
backend's default of 10 to 30 minutes), so a stuck rank fails the run in
minutes: the ranks waiting on it raise, and a rank's failure ends
``launch``. ``launch(..., timeout=T)`` bounds a run more tightly: T
seconds for every collective, and for the wait for the spawned ranks,
after which they are killed and ``TimeoutError`` is raised.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
COLLECTIVE_TIMEOUT = 300  # seconds, unless make_mesh or launch is given one

_CURRENT = None
_REPLICATED = [0]


@dataclasses.dataclass
class TPGroup:
    """A rank's model group: the process group, its size and the rank's
    index in it (the slice of a sharded weight it holds)."""
    group: object
    size: int
    rank: int


@dataclasses.dataclass
class Mesh:
    world: int
    dp: int
    tp: int
    rank: int
    backend: str
    device: torch.device
    data_group: object = None      # None: the whole world (tp == 1)
    model: TPGroup | None = None   # None when tp == 1

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def axis_names(self):
        return (DATA_AXIS,) if self.tp == 1 else (DATA_AXIS, MODEL_AXIS)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.dp:
            raise ValueError(f"batch of {n} does not divide over {self.dp} "
                             "data shards")
        per = n // self.dp
        return slice(self.dp_rank * per, (self.dp_rank + 1) * per)

    def shard(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``t`` along ``dim`` (a global batch)."""
        rows = self.rows(t.shape[dim])
        return t.narrow(dim, rows.start, rows.stop - rows.start)


def current() -> Mesh | None:
    """The mesh this process runs in, or None (one process)."""
    return _CURRENT


def is_writer() -> bool:
    """Whether this process writes files and logs: rank 0, or the only
    process."""
    return _CURRENT is None or _CURRENT.rank == 0


def is_replicated() -> bool:
    return _REPLICATED[0] > 0


@contextlib.contextmanager
def replicated():
    """Within the block every rank computes on the whole batch it holds
    (sampling: each rank generates the same images), so the data-axis
    reductions are off; the model axis's gathers still run."""
    _REPLICATED[0] += 1
    try:
        yield
    finally:
        _REPLICATED[0] -= 1


def resolve_world(num_devices, tp: int, device_type: str,
                  share_device: bool = False) -> int:
    """The world size for ``--num-devices`` and ``--tp`` (None: every
    visible card on CUDA, ``tp`` on the CPU); ``ValueError`` for more ranks
    than visible cards (unless they share one), or a world that ``tp`` does
    not divide."""
    if num_devices is not None:
        world = int(num_devices)
    else:
        world = torch.cuda.device_count() if device_type == "cuda" else tp
    if world < 1:
        raise ValueError(f"--num-devices {num_devices}: no device to run on")
    if device_type == "cuda" and not share_device:
        visible = torch.cuda.device_count()
        if world > visible:
            raise ValueError(
                f"--num-devices {world} exceeds the {visible} visible CUDA "
                "device(s)")
    if tp < 1 or world % tp:
        raise ValueError(f"--tp {tp} does not divide the {world} devices")
    return world


def make_mesh(num_devices: int | None = None, tp: int = 1, *,
              device_type: str = "cpu", share_device: bool = False,
              init_method: str | None = None, rank: int | None = None,
              timeout: float | None = None) -> Mesh:
    """The mesh of this process: joins (or starts) the default process
    group and makes the data and model groups. Every rank calls it, with
    the same arguments. Without ``init_method`` the group must exist
    already (``launch``), or comes from ``torchrun``'s environment.
    ``timeout`` (seconds, default ``COLLECTIVE_TIMEOUT``) is the group's
    timeout for each collective."""
    global _CURRENT
    if not dist.is_initialized():
        world = resolve_world(num_devices, tp, device_type, share_device)
        if init_method is None:
            init_method = "env://"
            rank = int(os.environ["RANK"])
            world = int(os.environ["WORLD_SIZE"])
        backend = "nccl" if device_type == "cuda" and not share_device \
            else "gloo"
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout or COLLECTIVE_TIMEOUT))
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and int(num_devices) != world:
        raise ValueError(f"--num-devices {num_devices} but the process "
                         f"group has {world} ranks")
    if tp < 1 or world % tp:
        raise ValueError(f"--tp {tp} does not divide the {world} ranks")
    dp = world // tp
    if device_type == "cuda":
        index = 0 if share_device else int(
            os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    # every rank makes every group, in the same order
    data_group = model = None
    if tp > 1:
        for j in range(tp):
            g = dist.new_group([i * tp + j for i in range(dp)])
            if rank % tp == j:
                data_group = g
        for i in range(dp):
            ranks = list(range(i * tp, (i + 1) * tp))
            g = dist.new_group(ranks)
            if rank in ranks:
                model = TPGroup(g, tp, rank - i * tp)
    _CURRENT = Mesh(world=world, dp=dp, tp=tp, rank=rank,
                    backend=dist.get_backend(), device=device,
                    data_group=data_group, model=model)
    if rank == 0:
        print(f"[mesh] {world} rank(s), {_CURRENT.axis_names} = "
              f"({dp}, {tp}), backend {_CURRENT.backend}, {device.type}"
              + (" (ranks share one card)" if share_device else ""))
    return _CURRENT


def teardown() -> None:
    """Leave the mesh and destroy the process group."""
    global _CURRENT
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------------- launch
def _rank_entry(rank, fn, args, world, tp, device_type, share_device,
                init_file, result_path, timeout, threads):
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    if device_type == "cpu":
        # the ranks share the launching process's threads
        torch.set_num_threads(threads)
    make_mesh(world, tp, device_type=device_type, share_device=share_device,
              init_method=f"file://{init_file}", rank=rank, timeout=timeout)
    try:
        result = fn(*args)
        if rank == 0 and result_path is not None:
            with open(result_path, "wb") as out:
                pickle.dump(result, out)
    finally:
        teardown()


def launch(fn, world: int, args: tuple = (), *, tp: int = 1,
           device_type: str = "cpu", share_device: bool = False,
           timeout: float | None = None):
    """Run ``fn(*args)`` on every rank of a ``world``-rank mesh and return
    rank 0's result. Under ``torchrun`` (``RANK``/``WORLD_SIZE`` set and no
    group yet) this process is one rank: it joins the group, runs ``fn``
    and returns its own result. Otherwise it spawns ``world`` processes
    (``fn`` and ``args`` must pickle), which meet through a file in a
    temporary directory; every rank but 0 prints nothing. A rank's
    failure raises here, and so does a run that outlasts ``timeout``
    seconds (default: no bound on the run; ``COLLECTIVE_TIMEOUT`` on each
    collective): its ranks are killed."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and not dist.is_initialized():
        make_mesh(int(os.environ["WORLD_SIZE"]), tp, device_type=device_type,
                  share_device=share_device, timeout=timeout)
        try:
            return fn(*args)
        finally:
            teardown()
    tmp = tempfile.mkdtemp(prefix="tt_mesh_")
    try:
        result_path = os.path.join(tmp, "result.pkl")
        ctx = torch.multiprocessing.spawn(
            _rank_entry, args=(fn, args, world, tp, device_type,
                               share_device, os.path.join(tmp, "rdzv"),
                               result_path, timeout,
                               max(1, torch.get_num_threads() // world)),
            nprocs=world, join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None else
                               max(0.0, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"the {world} ranks did not finish "
                                       f"within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        if not os.path.exists(result_path):
            return None
        with open(result_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
