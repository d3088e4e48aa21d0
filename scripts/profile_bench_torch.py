"""Profile the headline benchmark's SGA step in the PyTorch port.

The port's counterpart of scripts/profile_bench.py. On bench.py's problem
(`bench_torch.bench_problem`: trid10d, h 3, 8 restarts x 200 QMC
trajectories, 8 + 2 inner starts, float32) it runs `--steps` SGA steps
with no early exit, each what one pass of `rollout.outer._sga` does: one
`simulate_trajectory_mc(with_gradients=True)` over every restart x
trajectory lane, the eswavs freeze, and an Adam step clipped to the box.
The steps are replays of `outer.make_batched_sga_step` (one CUDA graph on
the card), as scripts/profile_bench.py:67-80 profiles the jitted step;
the same steps run eagerly first (`sga_steps`), measured the same way and
printed on a line of their own (their trace in `--outdir`/eager). For
each route, after a warm-up step (the program's capture) it times the
steps untraced, then again under `utils.profiling.trace` (torch.profiler;
`trace.json` in `--outdir`), and parses that trace (`summarize`) into:
- the top CUDA kernels by total device time, with their counts;
- the total device time;
- the device-busy share: the union of the kernel intervals over the traced
  window, from the first host event to the end of the final synchronize;
  the profiler slows the host, so beside it the kernels' total time over
  the untraced steps' wall.
On the CPU (no kernels) it lists the top host ops (`cpu_op`, inclusive
times) instead and gives no busy share. A trace taken on the card that
holds no kernel raises: the profiler saw no CUDA activity there.

The last line is one JSON object with these numbers, of the program.

Run:  python scripts/profile_bench_torch.py [--steps 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402  (bench.py's problem)

# host-side event categories of a torch.profiler Chrome trace (the ops, the
# CUDA runtime calls, Python frames and named regions)
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "python_function", "user_annotation")


def sga_steps(state, tp, xstarts, restarts, steps, *, lr=0.01, inner_iterations=10):
    """`steps` passes of the SGA loop of `outer._sga` from `restarts`, with
    no test for "every restart has stopped"; returns the points."""
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.rollout import mc as mc_mod
    from rollout_bo_tpu_torch.rollout import outer

    xs, opt = restarts, outer.adam_init(restarts)
    done = torch.zeros(xs.shape[:-1], dtype=torch.bool, device=xs.device)
    for _ in range(steps):
        eto = mc_mod.simulate_trajectory_mc(state, tp._replace(x0=xs), EI(), xstarts,
                                            with_gradients=True, iterations=inner_iterations)
        done = done | outer.eswavs(eto.grad_x, eto.std_grad_x**2, tp.mc_iters)
        opt, xs_new = outer.adam_update(opt, xs, eto.grad_x, lr=lr)
        xs = torch.where(done[..., None], xs, torch.clamp(xs_new, tp.lbs, tp.ubs))
    return xs


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarize(trace_json: dict, top: int) -> dict:
    """The numbers of a torch.profiler Chrome trace (times in ms).

    With kernel events (cat "kernel"): `kernels`, the `top` kernels by
    total device time as (name, ms, count); `launches` and `device_ms`,
    the count and total time of all kernel events;
    `window_ms`, from the first host event to the end of the last
    `cudaDeviceSynchronize` (or of the last event, where there is none);
    `busy_share`, the union of the kernel intervals inside that window over
    its length. Without: `kernels` is empty, `busy_share` None, and
    `host_ops` lists the `top` host ops (cat "cpu_op") by total inclusive
    time as (name, ms, count)."""
    events = [e for e in trace_json.get("traceEvents", []) if e.get("ph") == "X"]
    span = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES]

    def ranked(evs):
        dur, cnt = defaultdict(float), defaultdict(int)
        for e in evs:
            dur[e["name"]] += float(e.get("dur", 0.0))
            cnt[e["name"]] += 1
        return [(k, v / 1e3, cnt[k]) for k, v in
                sorted(dur.items(), key=lambda kv: -kv[1])[:top]]

    out = dict(kernels=ranked(kernels), launches=len(kernels),
               device_ms=sum(span(e)[1] - span(e)[0] for e in kernels) / 1e3,
               busy_share=None, window_ms=None, host_ops=[])
    if not kernels:
        out["host_ops"] = ranked([e for e in host if e.get("cat") == "cpu_op"])
        return out
    start = min(span(e)[0] for e in host) if host else min(span(e)[0] for e in events)
    syncs = [span(e)[1] for e in host if e.get("name") == "cudaDeviceSynchronize"]
    end = max(syncs) if syncs else max(span(e)[1] for e in events)
    busy = _union_us((max(a, start), min(b, end)) for a, b in map(span, kernels)
                     if min(b, end) > max(a, start))
    out.update(window_ms=(end - start) / 1e3, busy_share=busy / (end - start))
    return out


def program_steps(step, state, tp, restarts, steps):
    """`steps` calls of a `make_batched_sga_step` program from `restarts`;
    returns the points."""
    from rollout_bo_tpu_torch.rollout import outer

    carry = (restarts, outer.adam_init(restarts),
             torch.zeros(restarts.shape[:-1], dtype=torch.bool, device=restarts.device),
             torch.zeros(restarts.shape[:-1], dtype=restarts.dtype, device=restarts.device))
    for _ in range(steps):
        carry = step(state, tp.rnstream, carry)
    return carry[0]


def profile_route(run, steps, outdir, top, cuda):
    """One route: a warm-up step, `steps` steps untraced, then traced into
    `outdir`; (the JSON object of its numbers, the trace's summary)."""
    from rollout_bo_tpu_torch.utils import profiling

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run(1)                                                     # warm-up
    sync()
    t0 = time.perf_counter()
    run(steps)
    sync()
    wall = time.perf_counter() - t0
    with profiling.trace(outdir):
        t0 = time.perf_counter()
        run(steps)
        sync()
        traced = time.perf_counter() - t0
    with open(os.path.join(outdir, "trace.json")) as fh:
        s = summarize(json.load(fh), top)
    if cuda and not s["kernels"]:
        raise RuntimeError("the trace holds no CUDA kernel: the profiler recorded no "
                           "CUDA activity on this card")
    rows = s["kernels"] or s["host_ops"]
    return {"steps": steps, "ms_per_step": wall / steps * 1e3,
            "traced_ms_per_step": traced / steps * 1e3,
            "launches": s["launches"], "device_ms": s["device_ms"],
            "window_ms": s["window_ms"],
            "busy_share": s["busy_share"],
            "device_ms_over_untraced_wall": s["device_ms"] / (wall * 1e3),
            "top": [dict(name=n, ms=ms, count=c) for n, ms, c in rows]}, s


def main(argv=None):
    from rollout_bo_tpu_torch.experiments.myopic import add_device_argument, resolve_device
    from rollout_bo_tpu_torch.models.decision_rules import EI
    from rollout_bo_tpu_torch.rollout import outer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                    "rollout_trace_torch"))
    p.add_argument("--top", type=int, default=30)
    add_device_argument(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    print(bench_torch.card_line(device))

    state, tp, xstarts, restarts = bench_torch.bench_problem(device, torch.float32)
    eager, _ = profile_route(lambda n: sga_steps(state, tp, xstarts, restarts, n),
                             args.steps, os.path.join(args.outdir, "eager"), args.top, cuda)
    eager["top"] = eager["top"][:8]
    print(f"eager route: {json.dumps(eager)}")
    step = outer.make_batched_sga_step(state, tp, EI(), xstarts, lr=0.01, inner_iterations=10)
    out, s = profile_route(lambda n: program_steps(step, state, tp, restarts, n),
                           args.steps, args.outdir, args.top, cuda)
    print(f"program: capture {step.capture_seconds} s, memory pool {step.pool_bytes} B; "
          f"{args.steps} steps = {out['ms_per_step']:.1f} ms/step "
          f"({out['traced_ms_per_step']:.1f} ms/step under the profiler)")
    if s["kernels"]:
        print(f"\ntop CUDA kernels by device time ({s['launches']} launches, "
              f"{s['device_ms']:.1f} ms in all; "
              f"device busy {s['busy_share']:.4f} of the {s['window_ms']:.1f} ms window):")
    else:
        print("\ntop host ops by inclusive time (no CUDA kernels in this trace):")
    for row in out["top"]:
        print(f"  {row['ms']:9.2f} ms  {row['count']:7d}x  {row['name'][:120]}")
    if s["kernels"]:
        print(f"kernel time of the traced steps over the untraced steps' wall: "
              f"{out['device_ms_over_untraced_wall']:.4f} (the busy share without the "
              f"profiler's host overhead, if the kernels take as long untraced)")
    print(json.dumps(out))
    return s


if __name__ == "__main__":
    main()
