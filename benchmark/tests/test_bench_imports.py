"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from benchmark import core

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
PROGRAM = "rollout_bo_tpu_torch"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in harness_files():
        assert not imported_tops(path) & set(core.FORBIDDEN), path


def test_the_reference_and_yardsticks_import_nothing_of_the_program():
    for folder in ("reference", "yardstick"):
        for path in (BENCH / folder).glob("*.py"):
            assert PROGRAM not in imported_tops(path), path
    assert PROGRAM not in imported_tops(BENCH / "trace.py")


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rollout_bo_tpu_torch_fake", object())
    assert core.forbidden_modules() == [n for n in core.forbidden_modules()
                                        if n.split(".")[0] in core.FORBIDDEN]
    assert "rollout_bo_tpu_torch_fake" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rollout_bo_tpu.fake", object())
    assert "rollout_bo_tpu.fake" in core.forbidden_modules()


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    last = _run(
        "import sys, torch; torch.set_num_threads(1);"
        "from pathlib import Path; from benchmark import core; from benchmark.tests import tiny;"
        f"tiny.run(Path({str(tmp_path)!r}), 'hartmann6d-f64.tiny-bo', seconds=1e-3, trace=True);"
        "print(core.forbidden_modules())")
    assert last == "[]"


def test_the_reference_alone_loads_nothing_of_the_program():
    last = _run(
        "import sys; import benchmark.reference.gp, benchmark.reference.rollout,"
        " benchmark.reference.testfns, benchmark.yardstick.qmc, benchmark.yardstick.lane_work,"
        " benchmark.trace;"
        f"print(sorted(n for n in sys.modules if n.split('.')[0] in ({PROGRAM!r}, 'jax')))")
    assert last == "[]"
