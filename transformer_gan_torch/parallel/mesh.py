"""Data parallelism over processes, one device each (counterpart of
``transformer_gan_tpu/parallel/mesh.py``).

The JAX package drives a 1-D ``data`` mesh from one process and lets GSPMD
insert the gradient all-reduce. The port runs one process per card, as the
reference's DDP does: ``torchrun --nproc_per_node N -m
transformer_gan_torch.cli.train ...`` starts N ranks, each reading
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. Weights stay replicated, each
rank takes its own rows, and the callers all-reduce what GSPMD would:
the flat gradient, the token counts that divide a loss, and the host-side
scalars of the log and the evaluation.

The backend is NCCL for the card and gloo for the CPU (or when the caller
asks for it: two ranks sharing one card, which NCCL refuses). The host
reductions (:func:`host_allreduce_sum`) run on CPU float64 tensors over a
gloo group, since NCCL reduces only CUDA tensors.

A single process without ``WORLD_SIZE`` is world 1 and calls no collective:
every helper here is then the identity. Nothing falls back: a failed
``init_process_group``, NCCL without a card, a device other than the one
the rank was given and a ``TPU.mesh_shape`` that disagrees with the world
all raise.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .._native import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world. ``backend`` None:
    one process, no collective."""

    rank: int = 0
    world: int = 1
    device: torch.device | None = None
    backend: str | None = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None


_MESH = Mesh()
_HOST_GROUP = None


def current() -> Mesh:
    """The mesh :func:`initialize_distributed` set up (world 1 before)."""
    return _MESH


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    return int(os.environ[name]) if name in os.environ else None


def initialize_distributed(device=None, init_method: str | None = None,
                           rank: int | None = None,
                           world_size: int | None = None,
                           local_rank: int | None = None,
                           backend: str | None = None) -> Mesh:
    """Join the process group (replaces the reference's
    ``init_process_group("nccl")``). Rank, world and local rank come from the
    arguments or from torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``;
    ``init_method`` defaults to ``env://`` (torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``; the CPU tests give ``file://``). ``device``: None or
    ``"cuda"`` is ``cuda:LOCAL_RANK``; an explicit ``cuda:k`` must be that
    card; ``"cpu"`` takes gloo. ``backend``: nccl on a card, gloo on the
    CPU, unless given. Without a world size (no argument, no
    ``WORLD_SIZE``) the process stays world 1 on ``device`` (the card
    unless ``"cpu"``) and joins nothing. A second call returns the mesh of
    the first. The process leaves the group at exit (:func:`shutdown`)."""
    global _MESH, _HOST_GROUP
    if _MESH.distributed:
        return _MESH
    world = _env_int("WORLD_SIZE", world_size)
    if world is None:
        _MESH = Mesh(device=resolve_device(device))
        return _MESH
    rank = _env_int("RANK", rank)
    if rank is None:
        raise ValueError("WORLD_SIZE is set but RANK is not")
    local = _env_int("LOCAL_RANK", local_rank)
    local = rank if local is None else local
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA device: pass device "
                           "'cpu' (--device cpu) to train on gloo ranks")
    if on_cpu:
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"device {dev}: a rank runs on a card or on "
                             "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local)
        if dev.index != local:
            raise ValueError(
                f"rank {rank} was given card {local} (LOCAL_RANK) but asked "
                f"for {dev}")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: no card {dev} "
                               f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    _HOST_GROUP = (dist.new_group(backend="gloo") if backend != "gloo"
                   else None)
    _MESH = Mesh(rank=rank, world=world, device=dev, backend=backend)
    # a group still alive at interpreter exit aborts the process
    atexit.register(shutdown)
    return _MESH


def shutdown() -> None:
    """Leave the process group (the process is world 1 again)."""
    global _MESH, _HOST_GROUP
    if _MESH.distributed:
        dist.destroy_process_group()
    _MESH, _HOST_GROUP = Mesh(), None


def make_mesh_from_cfg(cfg) -> Mesh:
    """Check ``TPU.mesh_shape`` / ``TPU.mesh_axes`` against the process's
    world, as the JAX package reads them: a 1-D ``data`` axis is the only
    layout; ``-1`` spans every rank, a positive N must be the world size.
    Returns the mesh."""
    mesh = current()
    axes = list(cfg.TPU.get("mesh_axes", ["data"]))
    shape = list(cfg.TPU.get("mesh_shape", [-1]))
    if axes != ["data"] or len(shape) != 1:
        raise NotImplementedError(
            f"TPU.mesh_axes={axes} / mesh_shape={shape}: only the 1-D "
            "['data'] mesh is implemented")
    n = int(shape[0])
    if n > 0 and n != mesh.world:
        raise ValueError(f"TPU.mesh_shape [{n}] but the world has "
                         f"{mesh.world} rank(s)")
    return mesh


def rank_seed(seed: int) -> int:
    """This rank's seed for a stream every rank is given ``seed`` for:
    ``seed`` itself on rank 0 (so rank 0 draws what one process draws),
    ``seed`` folded with the rank on the others."""
    rank = _MESH.rank
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence((int(seed) % 2 ** 64, rank))
               .generate_state(1, np.uint64)[0] >> 1)


def sync_global_devices(name: str = "") -> None:
    """Barrier across ranks (replaces dist.barrier)."""
    if _MESH.distributed:
        dist.barrier(group=_HOST_GROUP)


def host_allreduce_sum(values) -> np.ndarray:
    """Sum host scalars across ranks in float64 (the reference's
    all_reduce of logging and eval scalars)."""
    values = np.asarray(values, np.float64)
    if not _MESH.distributed:
        return values
    t = torch.from_numpy(values.copy())
    dist.all_reduce(t, group=_HOST_GROUP)
    return t.numpy()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum of a device tensor across ranks; returns it."""
    if _MESH.distributed:
        dist.all_reduce(t)
    return t


def all_reduce_mean_(t: torch.Tensor) -> torch.Tensor:
    """In-place mean of a device tensor across ranks (the gradient of a
    loss that is a mean over each rank's equal share of rows)."""
    if _MESH.distributed:
        dist.all_reduce(t)
        t.div_(_MESH.world)
    return t


def all_reduce_max_(t: torch.Tensor) -> torch.Tensor:
    if _MESH.distributed:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def broadcast_(*tensors: torch.Tensor) -> None:
    """Rank 0's values into every rank's tensors, in place."""
    if _MESH.distributed:
        for t in tensors:
            dist.broadcast(t, 0)


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if not _MESH.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0, group=_HOST_GROUP)
    return box[0]


# ---------------------------------------------------------------------------
# Ranks in this machine's processes (the CPU tests, the dry run, two ranks
# sharing one card)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn, world: int, tmp: str, args, device,
               backend) -> None:
    torch.set_num_threads(1)
    mesh = initialize_distributed(
        device=device, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        local_rank=rank if device == "cuda" else 0, backend=backend)
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        shutdown()


def spawn(fn, world: int, *args, device="cpu", backend: str = "gloo") -> list:
    """Run ``fn(mesh, *args)`` in ``world`` fresh processes joined as ranks
    on a ``file://`` store (no port to collide with other runs), ``mesh``
    being the rank's :func:`current`; returns each rank's return value, in
    rank order. ``fn`` must be a module-level function. ``device``:
    ``"cuda"`` puts rank r on card r, an explicit card (``cuda:0``) or the
    CPU takes every rank. Raises when a rank fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, world, tmp, args, device,
                                             backend),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
