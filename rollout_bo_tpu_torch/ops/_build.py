"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so one
nvcc call builds it in seconds. The shared library goes to `build/kernels/`
at the repository root, named by a hash of the source and the flags: a
changed source rebuilds, an unchanged one loads the existing library.
Nothing is downloaded and no prebuilt kernel is used. Builds happen on
first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "load", "build_log", "build_seconds"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = SRC_DIR / f"{name}.cu"
    flags = " ".join(NVCC_FLAGS + tuple(defines))
    key = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build_log(name: str, defines: tuple[str, ...] = ()) -> str:
    """nvcc's output (registers, shared memory, spills) for `name`."""
    log = _target(name, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and load it (cached per process).
    `defines` are extra `-DNAME=value` flags: a variant for measurement."""
    if (name, defines) in _LOADED:
        return _LOADED[name, defines]
    out = _target(name, defines)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _BUILD_SECONDS[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    _LOADED[name, defines] = ctypes.CDLL(str(out))
    return _LOADED[name, defines]


def build_seconds(name: str) -> float | None:
    """Seconds nvcc took for `name` in this process (None if it was cached)."""
    return _BUILD_SECONDS.get(name)
