"""PyTorch port, the measurement entry points (bench_torch.py,
scripts/throughput_torch.py, scripts/profile_bench_torch.py) against the
JAX package's bench.py / scripts/throughput.py on the CPU.

Tolerances:
- bench.py's problem: the same numbers to rtol 1e-6. X, the starts, the
  restarts and the stream come from the same numpy code; y is trid10d in
  float64 in both, cast to float32; the state's L / Li / c are two float32
  factorizations of the same (nearly diagonal: lengthscale 1 in a box of
  width 200) matrix;
- the reduced acquisition in float64: tests/test_torch_rollout.py's
  tolerances for the fused solve (atol 1e-6 on x, rtol 1e-6 on the value);
- throughput.py's estimate in float32: mu to rtol 1e-5. Both run float32
  products, the port's lane solver in the W form (the TPU kernel's), the
  JAX CPU route in the Li form; a float32 ulp is 1.2e-7 relative.
"""

import concurrent.futures
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (REPO, os.path.join(REPO, "scripts")):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import bench_torch  # noqa: E402
import profile_bench_torch  # noqa: E402
import throughput_torch  # noqa: E402
from rollout_bo_tpu.models import decision_rules as jdr  # noqa: E402
from rollout_bo_tpu.models import surrogate as jsg  # noqa: E402
from rollout_bo_tpu.models import testfns as jtf  # noqa: E402
from rollout_bo_tpu.ops import kernels as jK  # noqa: E402
from rollout_bo_tpu.ops import qmc as jqmc  # noqa: E402
from rollout_bo_tpu.rollout import mc as jmc  # noqa: E402
from rollout_bo_tpu.rollout import outer as jouter  # noqa: E402
from rollout_bo_tpu.rollout.trajectory import TrajectoryParams as JTP  # noqa: E402

# The tensors here are small: one intra-op thread (several test workers
# share the cores).
torch.set_num_threads(1)

CPU = torch.device("cpu")
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
# the reduced acquisition: trid10d, 8 trajectories, horizon 2, 2 restarts
SMALL = dict(mc=8, horizon=2, restarts=2)


def _jax_bench_problem(dtype, *, name="trid10d", n_obs=12, capacity=20, mc=200, horizon=3,
                       starts=8, restarts=8):
    """bench.py:39-62's construction (built there inside `main`)."""
    f = jtf.get_function(name)
    d = f.dim
    rng = np.random.default_rng(1906)
    X0 = jqmc.randsample(n_obs, d, f.lbs, f.ubs, rng)
    y0 = np.asarray(f.batch(X0))
    state = jsg.fit(jK.matern52((1.0,)), X0, y0, capacity=capacity, noise=1e-5, dtype=dtype)
    xstarts = jnp.asarray(jqmc.generate_initial_guesses(starts, f.lbs, f.ubs), dtype)
    z = jqmc.gen_low_discrepancy_sequence(mc, d, horizon + 1)
    tp = JTP(x0=jnp.zeros((d,), dtype), theta=jnp.asarray([0.0], dtype),
             lbs=jnp.asarray(f.lbs, dtype), ubs=jnp.asarray(f.ubs, dtype),
             rnstream=jnp.asarray(z, dtype))
    rs = jnp.asarray(jqmc.generate_batch(restarts, f.lbs, f.ubs)[:restarts], dtype)
    return state, tp, xstarts, rs


def test_bench_problem_matches_bench_py():
    js, jtp, jxs, jrs = _jax_bench_problem(jnp.float32)
    st, tp, xs, rs = bench_torch.bench_problem(CPU, torch.float32)
    pairs = dict(X=(st.X, js.X), y=(st.y, js.y), L=(st.L, js.L), Li=(st.Li, js.Li),
                 c=(st.c, js.c), theta=(st.kernel.theta, js.kernel.theta),
                 xstarts=(xs, jxs), restarts=(rs, jrs), rnstream=(tp.rnstream, jtp.rnstream),
                 lbs=(tp.lbs, jtp.lbs), ubs=(tp.ubs, jtp.ubs), x0=(tp.x0, jtp.x0))
    for name, (ours, theirs) in pairs.items():
        assert ours.dtype == torch.float32, name
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=0.0,
                                   err_msg=name)
    assert int(st.n) == int(js.n) == 12
    assert (tp.mc_iters, tp.horizon, xs.shape[0], rs.shape[0]) == (200, 3, 10, 8)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX programs of the two tests below: bench.py's fused SGA program
    at reduced width in float64, and throughput.py's estimate in float32.
    Their traces take most of this file's time; each is traced in turn and
    XLA compiles the first in a thread (the compile releases the GIL) while
    the second is traced."""
    js, jtp, jxs, jrs = _jax_bench_problem(jnp.float64, **SMALL)
    fused = jouter.make_fused_sga_program(js, jtp, jdr.EI(), jxs, max_iters=3, lr=0.01,
                                          inner_iterations=10, select_best=True)
    lowered = fused.lower(js, jtp.rnstream, jrs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(lowered.compile)
        tput = _jax_bench_problem(jnp.float32, mc=8, horizon=1)
        # mu alone: the value-only estimate is the same mean, and its trace
        # skips the reverse pass
        estimate = jax.jit(lambda s, t: jmc.simulate_trajectory_mc(
            s, t, jdr.EI(), tput[2], with_gradients=False, iterations=10))
        mu = float(estimate(tput[0], tput[1]).mu)
        jx, jv = compiling.result()(js, jtp.rnstream, jrs)
    return dict(fused=(np.asarray(jx), float(jv)), throughput_mu=mu)


def test_reduced_acquisition_matches_fused_sga_program(jax_side):
    jx, jv = jax_side["fused"]
    res = bench_torch.acquire(*bench_torch.bench_problem(CPU, torch.float64, **SMALL),
                              max_iters=3)
    assert 1 <= res.iterations <= 3
    np.testing.assert_allclose(res.x.numpy(), jx, rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(float(res.value), jv, rtol=1e-6)


def test_throughput_call_matches_jax_estimate(jax_side):
    args = throughput_torch.parse_args(["--mc", "8", "--horizon", "1", "--reps", "1",
                                        "--device", "cpu"])
    results, eto = throughput_torch.single_card(args, CPU)
    np.testing.assert_allclose(float(eto.mu), jax_side["throughput_mu"], rtol=1e-5)
    assert eto.grad_x.shape == (10,) and bool(torch.all(torch.isfinite(eto.grad_x)))
    assert results["mode"] == "single_chip" and results["backend"] == "cpu"
    assert results["unit"] == "trajectories/s/chip" and results["mc_per_call"] == 8
    assert math.isclose(results["value"], 8 / results["seconds_per_call"])
    assert results["lane_kernel_launches_per_call"] == 0   # the plain version on the CPU


@pytest.fixture(scope="module", autouse=True)
def ranks_run():
    """scripts/throughput_torch.py with two gloo ranks on the CPU, started
    when the module is set up so that its processes run beside the JAX
    traces of the other tests; the test of it waits for it."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "throughput_torch.py"),
         "--nworkers", "2", "--backend", "gloo", "--device", "cpu", "--mc", "8",
         "--horizon", "1", "--reps", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_throughput_rank_weak_scaling_on_gloo(ranks_run):
    stdout, stderr = ranks_run.communicate(timeout=300)
    assert ranks_run.returncode == 0, stderr[-3000:]
    res = json.loads(stdout.strip().splitlines()[-1])
    assert res["mode"] == "ranks_weak_scaling" and res["dist_backend"] == "gloo"
    assert [r["devices"] for r in res["rows"]] == [1, 2]
    assert [r["trajectories"] for r in res["rows"]] == [8, 16]
    assert res["rows"][0]["weak_scaling_efficiency"] == 1.0
    assert all(math.isfinite(r["weak_scaling_efficiency"]) and r["seconds"] > 0
               for r in res["rows"])


def test_profile_summary_of_a_hand_made_trace():
    """Three kernels, two of them overlapping ([10, 30] and [20, 40] us),
    then a gap, then [60, 70]; the window runs from the first host event
    (ts 0) to the end of the last cudaDeviceSynchronize (100): busy 40 of
    100 us. Events of other categories and phases are ignored."""
    ev = lambda cat, name, ts, dur, ph="X": dict(ph=ph, cat=cat, name=name, ts=ts, dur=dur)
    trace = {"traceEvents": [
        ev("cpu_op", "aten::mul", 0, 5),
        ev("kernel", "elementwise", 10, 20),
        ev("kernel", "newton_lanes_kernel<float, false>", 20, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 8, 1),
        ev("kernel", "elementwise", 60, 10),
        ev("cuda_runtime", "cudaDeviceSynchronize", 70, 30),
        ev("gpu_memcpy", "Memcpy DtoH", 75, 2),
        ev("kernel", "flow", 12, 0, ph="s"),
        ev("Trace", "PyTorch Profiler (0)", -50, 500),
    ]}
    s = profile_bench_torch.summarize(trace, top=5)
    assert s["busy_share"] == pytest.approx(0.4, abs=1e-15)
    assert s["window_ms"] == pytest.approx(0.1, abs=1e-15)
    assert s["device_ms"] == pytest.approx(0.05, abs=1e-15) and s["launches"] == 3
    assert s["kernels"] == [("elementwise", 0.03, 2),
                            ("newton_lanes_kernel<float, false>", 0.02, 1)]
    assert s["host_ops"] == []
    # no kernel events: the host ops instead, and no share
    cpu = profile_bench_torch.summarize({"traceEvents": [
        ev("cpu_op", "aten::mm", 0, 4), ev("cpu_op", "aten::add", 5, 1),
        ev("cpu_op", "aten::mm", 7, 4)]}, top=1)
    assert cpu["kernels"] == [] and cpu["busy_share"] is None and cpu["launches"] == 0
    assert cpu["host_ops"] == [("aten::mm", 0.008, 2)]


def test_bench_main_prints_bench_py_line(monkeypatch, capsys):
    """bench_torch.main on the CPU at reduced widths (the module's defaults
    patched): bench.py's last line, and no lane-kernel launch."""
    monkeypatch.setitem(bench_torch.bench_problem.__kwdefaults__, "mc", 8)
    monkeypatch.setitem(bench_torch.bench_problem.__kwdefaults__, "horizon", 1)
    monkeypatch.setitem(bench_torch.bench_problem.__kwdefaults__, "restarts", 2)
    monkeypatch.setitem(bench_torch.acquire.__kwdefaults__, "max_iters", 2)
    bench_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert list(last) == BENCH_KEYS
    assert last["metric"] == "trid10d_h3_rollout_acq_opt_seconds_per_iter"
    assert last["unit"] == "s" and last["value"] > 0
    assert last["vs_baseline"] == pytest.approx(309.4 / last["value"])
    assert any(line.startswith("lane-kernel launches per acquisition: [0, 0, 0, 0]")
               for line in lines)


def test_bench_main_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])
