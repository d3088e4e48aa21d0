"""Rank grid and placement helpers for rollout BO on several GPUs.

Port of `rollout_bo_tpu/parallel/mesh.py`. The JAX package lays a
('restarts', 'mc') `jax.sharding.Mesh` over its devices and lets GSPMD
insert the collectives. Here each rank is one process with one device
(`torch.distributed`); the mesh is the same 2-D grid of ranks, rank r at
(r // mc, r % mc), and the collectives are explicit:

- the MC statistics of an acquisition estimate reduce over the ranks of one
  restarts-row (`Mesh.group("mc")`);
- the winner selection gathers (x, value) over the ranks of one mc-column
  (`gather_leading(..., "restarts")`), which holds one rank per row;
- the all-stopped early exit of the outer SGA sums the active restarts over
  every rank.

Only `all_reduce` and `broadcast` are used. They are the two collectives
that gloo supports on CUDA tensors, so one code path serves NCCL (one card
per rank), gloo on the card (ranks that share one) and gloo on the CPU. A
gather is an all-reduce (SUM) into a zero buffer in which each rank fills
its own rows; a flag travels as a count, never as a bool (gloo does not
reduce bools). None of them reads a tensor on the host, so a CUDA graph can
hold them where the backend's collectives run on the card: NCCL's do,
gloo's run on the host and cannot be captured (`Mesh.capturable`,
`programs_run_on`).
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os

import torch
import torch.distributed as dist

from rollout_bo_tpu_torch.utils import graphs

__all__ = [
    "AXES",
    "Mesh",
    "check_backend",
    "initialize_distributed",
    "finalize_distributed",
    "rank_device",
    "make_mesh",
    "programs_run_on",
    "shard_leading",
    "gather_leading",
    "all_reduce_sum",
    "broadcast",
    "replicate",
]

AXES = ("restarts", "mc")
# A rank that raises leaves its peers waiting in a collective: they give up
# after this long instead of hanging.
TIMEOUT = datetime.timedelta(seconds=120)


def check_backend(backend: str, local_ranks: int, device_type: str = "cuda") -> None:
    """Raise unless `backend` can join `local_ranks` ranks of this host that
    hold their tensors on `device_type`: nccl needs CUDA tensors and one
    card per rank (gloo takes CPU and CUDA tensors, and ranks that share a
    card)."""
    if backend != "nccl":
        return
    if device_type != "cuda" or not (torch.cuda.is_available() and dist.is_nccl_available()):
        raise RuntimeError("backend nccl needs CUDA tensors on a CUDA device and a PyTorch "
                           "built with NCCL; on the CPU pass --backend gloo")
    if local_ranks > torch.cuda.device_count():
        raise RuntimeError(
            f"backend nccl runs one rank per card: {local_ranks} ranks on this host, "
            f"{torch.cuda.device_count()} card(s); ranks that share a card run with "
            "--backend gloo")


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, *, backend: str = "nccl") -> int:
    """Join the default process group; returns the world size.

    With no arguments and no `WORLD_SIZE` in the environment this is one
    process with no group (world size 1), as the JAX package's call is a
    no-op without a cluster. Otherwise the rendezvous is `init_method`
    (default `env://`, which reads `MASTER_ADDR`, `MASTER_PORT`, `RANK` and
    `WORLD_SIZE`), and a rendezvous that fails raises.

    `backend`: "nccl" for CUDA tensors, one card per rank (`check_backend`
    raises otherwise); "gloo" for CPU tensors and for ranks that share a
    card. Each rank first makes card `rank % device_count` its current
    device.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if (init_method is None and world_size is None and rank is None
            and "WORLD_SIZE" not in os.environ):
        return 1
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(os.environ["RANK"] if rank is None else rank)
    check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    return dist.get_world_size()


def finalize_distributed() -> None:
    """Leave the default process group, the counterpart of
    `initialize_distributed`. The graphs that hold its collectives are
    reset first (`utils.graphs.release_collectives`): NCCL does not
    destroy a communicator while such a graph lives, so a rank that kept
    one, in a cache, a caller's variable or a traceback, would wait here
    for ever. The cached programs are dropped too: a mesh program holds
    its `Mesh`, and so the mesh's groups, whose gloo threads
    `destroy_process_group` leaves running while the group lives; a rank
    that exits with them running can abort in the interpreter's teardown
    ("terminate called without an active exception")."""
    graphs.release_collectives()
    graphs.PROGRAM_CACHE.clear()
    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device) -> torch.device:
    """`device` as this rank names it: "cuda" is the card that
    `initialize_distributed` made current; any other device is itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (restarts, mc) grid of the ranks of the default process group;
    rank r sits at (r // mc, r % mc). Build it with `make_mesh`.

    `backend` is the group's ("nccl" or "gloo"; None with no process
    group). `groups` maps "mc" to the group of this rank's restarts-row,
    "restarts" to that of its mc-column (each only where that axis has more
    than one rank), and AXES to the whole world (whenever there is a
    process group). Two meshes are equal where shape, rank and backend are:
    their groups join the same ranks the same way.
    """

    restarts: int
    mc: int
    rank: int
    backend: str | None = None
    groups: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: NCCL runs
        them on the card; gloo runs them on the host, which a capture does
        not record. A mesh with no process group has none."""
        return self.backend in (None, "nccl")

    @property
    def size(self) -> int:
        return self.restarts * self.mc

    def coordinate(self, axis) -> tuple[int, int]:
        """(this rank's index along `axis`, the ranks along it); `axis` is
        "restarts", "mc" or AXES (both, flattened row-major: the rank)."""
        if axis == "restarts":
            return self.rank // self.mc, self.restarts
        if axis == "mc":
            return self.rank % self.mc, self.mc
        if tuple(axis) == AXES:
            return self.rank, self.size
        raise ValueError(f"unknown mesh axis {axis!r}")

    def group(self, axis):
        """The process group of the ranks that differ from this one only
        along `axis`, or None where they are this rank alone (a reduction
        over them is then the identity)."""
        self.coordinate(axis)
        return self.groups.get(axis if isinstance(axis, str) else tuple(axis))


def make_mesh(restarts: int = 1, mc: int | None = None) -> Mesh:
    """A ('restarts', 'mc') mesh over every rank of the default group (one
    rank, no group, when none was initialized). `restarts` x `mc` must equal
    the world size; `mc=None` infers it. Every rank must call this, in the
    same order as its other group creations: it creates one group per row
    and one per column."""
    distributed = dist.is_available() and dist.is_initialized()
    backend = str(dist.get_backend()) if distributed else None
    n = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if mc is None:
        if n % restarts != 0:
            raise ValueError(f"{n} ranks not divisible by restarts={restarts}")
        mc = n // restarts
    if restarts * mc != n:
        raise ValueError(f"mesh {restarts}x{mc} != {n} ranks")
    groups = {}
    if distributed:
        groups[AXES] = dist.group.WORLD
        rows = [[r * mc + c for c in range(mc)] for r in range(restarts)]
        cols = [[r * mc + c for r in range(restarts)] for c in range(mc)]
        for axis, sets in (("mc", rows), ("restarts", cols)):
            if len(sets[0]) == 1:
                continue
            for ranks in sets:
                g = dist.group.WORLD if len(ranks) == n else dist.new_group(ranks,
                                                                            timeout=TIMEOUT)
                if rank in ranks:
                    groups[axis] = g
    return Mesh(restarts, mc, rank, backend, groups)


def programs_run_on(mesh: Mesh | None, device) -> bool:
    """Whether the solves' programs (`utils.graphs.GraphProgram`) can run on
    `device` with `mesh`: off CUDA they call their functions eagerly, and on
    CUDA a graph holds the mesh's collectives only where they are NCCL's.
    On a gloo mesh with CUDA tensors the solves take the eager mesh route
    instead, by this rule: a capture of a gloo collective is not possible."""
    return mesh is None or torch.device(device).type != "cuda" or mesh.capturable


def shard_leading(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of x, split over
    the ranks along `axis` (a NamedSharding of P(axis, None, ...)). Raises
    when the ranks do not divide the axis."""
    i, count = mesh.coordinate(axis)
    n = x.shape[0]
    if n % count != 0:
        raise ValueError(f"a leading axis of {n} does not divide over the {count} ranks "
                         f"of mesh axis {axis!r}")
    block = n // count
    return x[i * block:(i + 1) * block]


def gather_leading(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The blocks that `shard_leading` gave the ranks along `axis`, joined
    in order on every one of them (one all-reduce of a zero buffer in which
    this rank fills its own rows)."""
    group = mesh.group(axis)
    if group is None:
        return x
    i, count = mesh.coordinate(axis)
    block = x.shape[0]
    full = x.new_zeros((block * count,) + tuple(x.shape[1:]))
    full[i * block:(i + 1) * block] = x
    dist.all_reduce(full, group=group)
    return full


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t summed over every rank of the mesh."""
    group = mesh.group(AXES)
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's t on every rank."""
    if mesh.group(AXES) is None:
        return t
    t = t.detach().clone().contiguous()
    dist.broadcast(t, src=0)
    return t


def replicate(x, mesh: Mesh):
    """Rank 0's copy of every tensor in x (a tensor, a NamedTuple such as
    `SurrogateState`, or a dataclass such as the kernel with its theta),
    on every rank; other leaves are kept. Every rank visits the leaves in
    the same order, one broadcast each."""
    if torch.is_tensor(x):
        return broadcast(x, mesh)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(replicate(v, mesh) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: replicate(getattr(x, f.name), mesh)
                                         for f in dataclasses.fields(x) if f.init})
    return x
