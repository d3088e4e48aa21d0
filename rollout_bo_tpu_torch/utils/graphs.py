"""CUDA-graph programs: the port's counterpart of `jax.jit` for a function
of fixed-shape device tensors.

`GraphProgram(fn, device=...)` is called as fn would be, with tensors in
tuples, lists, NamedTuples and dataclasses (a `SurrogateState` and its
`RBFKernel`, a `TrajectoryParams`, an SGA carry); anything else in the
arguments (a string, a number) is a constant of the program. On a CUDA
device:

- the first call with a new signature (the structure, the constants and
  every tensor's shape, dtype and device), as `jit` traces once per
  signature, copies the arguments into static buffers, runs fn on them
  `WARMUP` (3) times on a side stream (as `torch.cuda.graphs` documents
  for work that runs autograd) and captures one `torch.cuda.CUDAGraph` of
  fn on them, on another side stream and without emptying the
  allocator's cache first (`torch.cuda.graph` does: see `_capture`). The
  capture runs under `torch.cuda.set_sync_debug_mode("error")`: a host
  synchronization in fn raises there;
- every call copies the arguments into that signature's static buffers
  (`copy_`), replays the graph and returns clones of its outputs, which
  the next replay would overwrite (JAX returns fresh arrays);
- a capture or replay error raises: nothing runs fn eagerly in place of
  a replay after the warm-up;
- while a BO iteration's trace record is open (`utils.profiling`), a pair
  of timing events brackets each call's replay and clones, for the
  record's device time (`profiling.replay_start`, `profiling.replay_end`).

A program whose fn issues NCCL collectives (the mesh programs of
`rollout.outer`, built with `collectives=True`) is captured like any
other: the warm-up runs create the communicator, which NCCL makes at a
group's first collective, and the graph records the collectives, which
every rank then replays together. Every capture runs in the
"thread_local" mode of `cudaStreamBeginCapture`: it checks the capturing
thread only, so the process group's watchdog thread can query the events
of earlier collectives meanwhile (two NCCL ranks on two cards were
captured in this mode). A communicator is not destroyed while a graph
that holds its collectives lives, so `release_collectives()` resets every
such graph (`parallel.mesh.finalize_distributed` calls it before it
destroys the group), whoever still holds the program.

`cached_program(key, builder)` keeps the programs of the BO loops and the
sharded functions across calls (`PROGRAM_CACHE`, an LRU of
`PROGRAM_CACHE_MAX`), as the JAX package keeps its jitted programs.

On any other device the program calls fn eagerly: the CPU tests' route,
as the kernels' plain versions are.

Kernel launches: `ops.newton_lanes.LAUNCHES` counts every lane-kernel
launch the device runs. The warm-up runs launch the kernel and are counted
there like any other launch; `WARMUP_LAUNCHES` adds up how many they were,
so that a check of the launches a result needed can take them off. A
capture runs nothing: the launches it records go to
`newton_lanes.RECORDED`, and every replay adds their number to
`LAUNCHES` (those of the lane-block design likewise from
`LANE_BLOCK_RECORDED` to `LANE_BLOCK_LAUNCHES`, and the MLE kernel's from
`gp_mle.RECORDED` to `gp_mle.LAUNCHES`). `CAPTURES` counts the captures of
every program; each program keeps its own `captures`, `capture_seconds`
and `pool_bytes` (the rise of `torch.cuda.memory_reserved` across its
captures: the graphs' private memory pools).
"""

from __future__ import annotations

import dataclasses
import gc
import time
import weakref
from collections import OrderedDict

import torch

from rollout_bo_tpu_torch.ops import gp_mle, newton_lanes
from rollout_bo_tpu_torch.utils import profiling

__all__ = ["GraphProgram", "CAPTURES", "WARMUP", "WARMUP_LAUNCHES", "PROGRAM_CACHE",
           "PROGRAM_CACHE_MAX", "cached_program", "release_collectives"]

WARMUP = 3              # eager runs on a side stream before a capture
CAPTURES = 0
WARMUP_LAUNCHES = 0
PROGRAM_CACHE: OrderedDict = OrderedDict()
PROGRAM_CACHE_MAX = 64  # LRU bound: entries pin CUDA graphs, their memory
# pools and the tensors their closures hold
_COLLECTIVE_GRAPHS: weakref.WeakSet = weakref.WeakSet()   # graphs that hold collectives


def _flatten(tree, leaves: list):
    """A hashable description of `tree` with its tensors appended to
    `leaves` in order; `_unflatten` rebuilds it from any tensors."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor",)
    if isinstance(tree, (tuple, list)):
        kind = type(tree) if hasattr(tree, "_fields") else type(tree).__name__
        return ("seq", kind, tuple(_flatten(t, leaves) for t in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return ("dataclass", type(tree),
                tuple((f.name, _flatten(getattr(tree, f.name), leaves))
                      for f in dataclasses.fields(tree)))
    hash(tree)                  # a constant must be hashable: it keys the capture
    return ("const", tree)


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "tensor":
        return next(leaves)
    if kind == "seq":
        items = [_unflatten(s, leaves) for s in spec[2]]
        if spec[1] == "list":
            return items
        return tuple(items) if spec[1] == "tuple" else spec[1](*items)
    if kind == "dataclass":
        return spec[1](**{name: _unflatten(s, leaves) for name, s in spec[2]})
    return spec[1]


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: list            # the static input buffers, in leaf order
    out_spec: tuple
    outputs: list           # the graph's own output tensors
    launches: int           # lane-kernel launches per replay
    lane_block_launches: int  # of them, the lane block's
    mle_launches: int       # MLE-kernel launches per replay


class GraphProgram:
    """fn(*args) as CUDA graphs on `device`, one per signature of args;
    eager off CUDA. See the module docstring."""

    def __init__(self, fn, *, device, collectives: bool = False):
        self.fn = fn
        self.device = torch.device(device)
        self.collectives = collectives
        self.captures = 0
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._graphs: dict = {}

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.fn(*args)
        leaves: list = []
        spec = _flatten(args, leaves)
        if self.device.index is None and all(t.device.type == "cuda" for t in leaves):
            self.device = torch.device("cuda", torch.cuda.current_device())
        for t in leaves:
            if t.device != self.device:
                raise ValueError(f"GraphProgram on {self.device} got a tensor on {t.device}")
        key = (spec, tuple((tuple(t.shape), t.dtype) for t in leaves))
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(spec, leaves)
        for buf, t in zip(cap.inputs, leaves):
            buf.copy_(t)
        mark = profiling.replay_start(self.device)
        cap.graph.replay()
        newton_lanes.LAUNCHES += cap.launches
        newton_lanes.LANE_BLOCK_LAUNCHES += cap.lane_block_launches
        gp_mle.LAUNCHES += cap.mle_launches
        out = _unflatten(cap.out_spec, (t.clone() for t in cap.outputs))
        profiling.replay_end(mark)
        return out

    def _capture(self, spec, leaves) -> _Captured:
        global CAPTURES, WARMUP_LAUNCHES
        dev = self.device
        t0 = time.perf_counter()
        inputs = [t.detach().clone() for t in leaves]
        args = _unflatten(spec, iter(inputs))
        before = newton_lanes.LAUNCHES
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        WARMUP_LAUNCHES += newton_lanes.LAUNCHES - before
        recorded = newton_lanes.RECORDED
        lane_block = newton_lanes.LANE_BLOCK_RECORDED
        mle = gp_mle.RECORDED
        torch.cuda.synchronize(dev)
        gc.collect()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # `torch.cuda.graph` is not used: it first empties the allocator's
        # cache, and cudaFree waits for the peers of an NCCL group, one of
        # which may be replaying a graph whose collective waits for this rank
        with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
            mode = torch.cuda.get_sync_debug_mode()
            graph.capture_begin(capture_error_mode="thread_local")
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                graph.capture_end()
        outputs: list = []
        out_spec = _flatten(out, outputs)
        launches = newton_lanes.RECORDED - recorded
        lane_block = newton_lanes.LANE_BLOCK_RECORDED - lane_block
        mle = gp_mle.RECORDED - mle
        torch.cuda.synchronize(dev)
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.captures += 1
        CAPTURES += 1
        self.capture_seconds += time.perf_counter() - t0
        if self.collectives:
            _COLLECTIVE_GRAPHS.add(graph)
        return _Captured(graph, inputs, out_spec, outputs, launches, lane_block, mle)


def cached_program(key, builder):
    """The program under `key`, built by `builder()` on a miss (the JAX
    package's cache of jitted programs across runner calls, e.g. the trials
    of a CLI sweep). The key covers everything the program bakes in as a
    constant: rule and theta, solver settings, shapes, dtype, kernel kind,
    box, mesh and device. LRU-bounded, so that a long-lived process that
    sweeps many configurations cannot pile up captured graphs without
    limit."""
    fn = PROGRAM_CACHE.get(key)
    if fn is None:
        fn = builder()
        PROGRAM_CACHE[key] = fn
        while len(PROGRAM_CACHE) > PROGRAM_CACHE_MAX:
            PROGRAM_CACHE.popitem(last=False)
    else:
        PROGRAM_CACHE.move_to_end(key)
    return fn


def release_collectives() -> None:
    """Reset every live graph that holds a process group's collectives (the
    programs built with `collectives=True`), so that the group can be
    destroyed: NCCL keeps a communicator while a graph that launches its
    kernels lives. No wait for the card: CUDA frees a graph that is still
    running when it ends. A program whose graphs were reset raises if
    called again. The graphs of programs without collectives are kept."""
    for graph in list(_COLLECTIVE_GRAPHS):
        graph.reset()
    _COLLECTIVE_GRAPHS.clear()
