"""PyTorch port: the CUDA MLE kernel `csrc/gp_mle.cu`, built by g++ and run on
the CPU.

There is no CUDA compiler or card where the CPU tests run, so
`tests/cuda_emulation/cuda_emu.h` maps the CUDA features the source uses
onto OS threads and barriers, g++ builds the source with its launch
replaced by a loop over blocks, and the C entry points run on CPU tensors
with the wrapper's layout (`ops/gp_mle.py::_layout`) at a block of a few
warps. Each case holds the kernel's theta after the 60 Adam steps to the
plain version, `gp_mle_ref`: rtol 1e-12 in float64 (the two factor K in
another order, ~1e-16 in each gradient, through 60 normalised Adam steps),
1e-5 in float32. The float32 GPs get noise 1e-3, as the lane kernel's
float32 tests do: at 1e-5 the periodic K on these points is conditioned
beyond what float32 resolves, and the plain version's own float32 theta
then lies 4e-5 from its float64 one (the kernel's 2e-5).

Cases: matern52, squared_exponential and periodic at capacity 14 with n
9; n equal to the capacity; a K that is positive definite at no theta
(negative noise: theta stays where it started); the matrices in the
device-memory scratch buffer, as a capacity beyond the shared memory puts
them, forced here by a small shared-memory limit; and two GPs in one
launch (the grid over lanes).

This checks the arithmetic and the indexing, not the compiler or the card:
tests/test_torch_cuda.py and chip_smoke.py do that. Skipped without g++.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from rollout_bo_tpu_torch.ops import gp_mle

# The tensors here are tiny: one intra-op thread. More threads per process only
# oversubscribe the cores when the suite runs several workers.
torch.set_num_threads(1)

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE.parent / "rollout_bo_tpu_torch" / "csrc" / "gp_mle.cu"
# what the emulation replaces in the source, with what, and how often
_PATCHES = (
    ("#include <cuda_runtime.h>", '#include "cuda_emu.h"', 1),
    ("extern __shared__ __align__(16) unsigned char smem_raw[];",
     "unsigned char* smem_raw = emu_smem;", 1),
)
_THREADS = 64                  # two warps: the block's loops over warps and lanes
CAP = 14
THETAS = {"matern52": (0.7,), "squared_exponential": (0.9,), "periodic": (0.8, 2.5)}
_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's C entry points, built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation of the kernel")
    text = _SOURCE.read_text()
    for old, new, count in _PATCHES:
        assert text.count(old) == count, f"the emulation expects {count} {old!r} in the source"
        text = text.replace(old, new)
    out = tmp_path_factory.mktemp("mle_emulation")
    (out / "gp_mle_emu.cpp").write_text(text)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{_HERE / 'cuda_emulation'}", "-o", str(out / "emu.so"),
         str(out / "gp_mle_emu.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "emu.so"))
    for name in gp_mle._ENTRY.values():
        getattr(lib, name).argtypes = gp_mle._ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _problem(kind, ns, dtype, cap=CAP, noise=None, seed=4):
    """One GP per entry of ns (its active count) in a (len(ns), cap) buffer;
    periodic on the line (its profile of the distance is PD in 1-D only);
    noise 1e-5 in float64, 1e-3 in float32 unless given."""
    if noise is None:
        noise = 1e-5 if dtype == torch.float64 else 1e-3
    d = 1 if kind == "periodic" else 3
    rng = np.random.default_rng(seed)
    X = np.zeros((len(ns), cap, d))
    y = np.zeros((len(ns), cap))
    for g, n in enumerate(ns):
        X[g, :n] = rng.uniform(-1.0, 1.0, (n, d))
        y[g, :n] = np.sin(2.0 * X[g, :n, 0]) + 0.3 * X[g, :n].sum(axis=1) ** 2
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    P = gp_mle.hypers(kind)
    return dict(X=t(X), y=t(y), n=torch.tensor(ns, dtype=torch.int64), noise=t(noise),
                theta=t(THETAS[kind]), lb=t((0.1,) * P), ub=t((5.0,) * P))


def _emulated(lib, kind, p, *, smem_limit=gp_mle._SMEM_LIMIT, threads=_THREADS,
              iterations=60, lr=0.1):
    """The wrapper's launch on CPU pointers: theta (GPs, P) and the layout."""
    X = p["X"]
    B, cap, d = X.shape
    P = gp_mle.hypers(kind)
    layout = gp_mle._layout(cap, d, X.element_size(), iterations, threads, smem_limit)
    theta0 = p["theta"].expand(B, P).contiguous()
    out = torch.full((B, P), float("nan"), dtype=X.dtype)
    scratch = (None if layout.staged
               else torch.full((B * layout.scratch,), float("nan"), dtype=X.dtype))
    err = getattr(lib, gp_mle._ENTRY[X.dtype])(
        X.data_ptr(), p["y"].data_ptr(), p["n"].data_ptr(), p["noise"].data_ptr(),
        theta0.data_ptr(), p["lb"].data_ptr(), p["ub"].data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, cap, d, gp_mle.KINDS.index(kind),
        iterations, lr, int(layout.staged), threads, layout.smem, None)
    assert err == 0
    return out, layout


def _plain(kind, p):
    return gp_mle.gp_mle_ref(kind, p["X"], p["y"], p["n"], p["noise"], p["theta"],
                             p["lb"], p["ub"])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=_RTOL[dtype], atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", sorted(THETAS))
def test_kernel_matches_plain_version(emulated, kind, dtype):
    p = _problem(kind, [9], dtype)
    got, layout = _emulated(emulated, kind, p)
    assert layout.staged
    want = _plain(kind, p)
    assert not torch.allclose(want, p["theta"].expand_as(want), rtol=1e-2)   # it moved
    _close(got, want, dtype)


def test_full_buffer_and_two_gps_in_one_launch(emulated):
    """n = capacity, and a grid of two GPs (n 9 and n = capacity) whose
    thetas each equal their own plain run; at four warps, more than the
    rows need."""
    p = _problem("matern52", [CAP, 9], torch.float64)
    got, _ = _emulated(emulated, "matern52", p, threads=128)
    _close(got, _plain("matern52", p), torch.float64)
    one = {k: (v[:1] if k in ("X", "y", "n") else v) for k, v in p.items()}
    _close(_emulated(emulated, "matern52", one, threads=128)[0], got[:1], torch.float64)


def test_not_pd_at_any_theta_keeps_theta(emulated):
    """Negative noise: the first pivot is below 0 at every theta, every
    step's gradient is 0 and theta comes back where it started (inside the
    box), as the plain version's does."""
    p = _problem("matern52", [9], torch.float64, noise=-5.0)
    got, _ = _emulated(emulated, "matern52", p)
    assert torch.equal(got, p["theta"][None])
    assert torch.equal(_plain("matern52", p), got)


@pytest.mark.parametrize("kind", ["matern52", "periodic"])
def test_matrices_in_device_memory(emulated, kind):
    """A shared-memory limit below what the matrices need puts them in the
    scratch buffer: the same theta as the plain version, and bit for bit
    the staged launch's."""
    p = _problem(kind, [9, 13], torch.float64)
    got, layout = _emulated(emulated, kind, p, smem_limit=2048)
    assert not layout.staged and layout.scratch > 0
    _close(got, _plain(kind, p), torch.float64)
    staged, layout = _emulated(emulated, kind, p)
    assert layout.staged and torch.equal(got, staged)



def test_rows_longer_than_a_warp(emulated):
    """Capacity 40, n 37 and 40: every row loop takes its lanes past 32;
    10 Adam steps against the plain version's 10."""
    p = _problem("matern52", [37, 40], torch.float64, cap=40)
    got, _ = _emulated(emulated, "matern52", p, iterations=10)
    want = gp_mle.gp_mle_ref("matern52", p["X"], p["y"], p["n"], p["noise"], p["theta"],
                             p["lb"], p["ub"], iterations=10)
    _close(got, want, torch.float64)
