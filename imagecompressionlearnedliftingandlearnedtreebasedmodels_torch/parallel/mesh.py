"""A one-axis device mesh over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. There a mesh is a
set of devices that one program shards over; here it is the process
group of ``n`` ranks, each a process with its own device, and the
sharding is explicit: :func:`shard_batch` takes this rank's slice of a
batch, :func:`row_block` its block of rows (the JAX package's
``spatial_sharding``), :func:`replicate` broadcasts rank 0's tensors, and
:func:`neighbour_rows` brings the rows a rank needs from its neighbours.

The backend is chosen, never defaulted: NCCL when every rank has a GPU of
its own, gloo when the ranks run on the CPU or share one card (NCCL
refuses two ranks on one GPU; gloo runs its collectives on the CUDA
tensors themselves). Neighbour exchanges are built from ``all_gather``,
which gloo takes on CUDA tensors (its point-to-point send and receive
take only CPU tensors).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """The ranks of one data axis: the process group, this process's rank,
    the world size, this rank's device and the axis name."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = "data"


def choose_backend(world: int, device_type: str) -> str:
    """NCCL when each of ``world`` ranks gets a GPU of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, world: int, device_type: str) -> torch.device:
    """``cuda:rank`` when every rank has a card, ``cuda:0`` when they share
    one, the CPU otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return torch.device("cuda", rank if n >= world else 0)


def init_mesh(rank: int, world: int, init_method: str,
              device_type: str = "cuda", axis_name: str = "data") -> Mesh:
    """Join the process group (``init_method`` is a ``file://`` or
    ``tcp://`` rendezvous that every rank is given) and return the mesh."""
    backend = choose_backend(world, device_type)
    device = rank_device(rank, world, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    return Mesh(None, rank, world, device, backend, axis_name)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> Mesh:
    """The mesh of this process's (initialized) default group, on
    ``device`` (the card unless the caller names the CPU); ``n_devices``
    must equal the group's size, as the JAX package asserts it has them."""
    from ..config import resolve_device

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(init_mesh, or the CLI's launcher, does it)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"need a mesh of {n_devices} ranks, the process "
                         f"group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(None, dist.get_rank(), world, dev, dist.get_backend(),
                axis_name)


def shard_batch(mesh: Mesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of the batch (dim 0), which must divide
    by the mesh."""
    b = batch.shape[0]
    if b % mesh.size:
        raise ValueError(f"batch {b} does not divide over {mesh.size} ranks")
    n = b // mesh.size
    return batch[mesh.rank * n:(mesh.rank + 1) * n]


def row_block(mesh: Mesh, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's block of rows of ``x`` along ``dim`` (H of NCHW)."""
    h = x.shape[dim]
    if h % mesh.size:
        raise ValueError(f"{h} rows do not divide over {mesh.size} ranks")
    n = h // mesh.size
    return x.narrow(dim, mesh.rank * n, n)


@torch.no_grad()
def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast rank 0's values into every rank's ``tensors``, in place."""
    for t in tensors:
        dist.broadcast(t.data, 0, group=mesh.group)


def all_gather(mesh: Mesh, t: torch.Tensor):
    """Every rank's ``t`` (same shape on all), in rank order."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return parts


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t`` (a new tensor)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def neighbour_rows(mesh: Mesh, t: torch.Tensor, r: int, dim: int,
                   wrap: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(the previous rank's last r rows, the next rank's first r rows)``
    of the row-sharded ``t`` along ``dim``, by one ``all_gather``. With
    ``wrap`` the ring closes (rank 0's previous is the last rank); without
    it the global first and last blocks get zeros there. ``r`` must not
    exceed a block's rows."""
    n = t.shape[dim]
    if r > n:
        raise ValueError(f"a neighbour exchange of {r} rows needs blocks of "
                         f"at least {r} rows, got {n}")
    both = torch.cat([t.narrow(dim, 0, r), t.narrow(dim, n - r, r)], dim)
    parts = all_gather(mesh, both)
    prev = parts[(mesh.rank - 1) % mesh.size].narrow(dim, r, r)
    nxt = parts[(mesh.rank + 1) % mesh.size].narrow(dim, 0, r)
    if not wrap:
        if mesh.rank == 0:
            prev = torch.zeros_like(prev)
        if mesh.rank == mesh.size - 1:
            nxt = torch.zeros_like(nxt)
    return prev, nxt


def _rank_main(rank: int, fn, world: int, init_method: str, device_type: str,
               threads: int, args) -> None:
    torch.set_num_threads(threads)
    mesh = init_mesh(rank, world, init_method, device_type)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device_type: str = "cuda", args: tuple = (),
          rendezvous_dir: Optional[str] = None) -> None:
    """Run ``fn(mesh, *args)`` in ``world`` new processes, one rank each
    (``spawn`` start method: ``fn`` and ``args`` are pickled, so ``fn`` is
    a module-level function), joined over a ``FileStore`` in
    ``rendezvous_dir`` (a new temporary directory by default). CPU ranks
    share this process's PyTorch threads out among them. Returns when every
    rank has finished; raises if one failed."""
    import tempfile

    import torch.multiprocessing as mp

    threads = torch.get_num_threads()
    if device_type != "cuda":
        threads = max(1, threads // world)
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as d:
        init_method = "file://" + os.path.join(d, "rendezvous")
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(fn, world, init_method, device_type, threads,
                                 args))
