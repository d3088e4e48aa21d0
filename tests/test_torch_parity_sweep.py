"""PyTorch port, the regret-parity sweep and its report against the JAX
package's scripts.

- `scripts/parity_report_torch.py`: its statistics on hand-made CSV trees
  against hand-computed numbers (mean, ddof=1 standard errors, |z|, the
  zero-variance rule), its cost-aware table against
  `scripts/cost_aware_summary.py`'s output on `results/cost_aware/`, and
  the JAX record held against itself (|z| = 0, the record's n);
- `scripts/parity_sweep_torch.py`: every argv that each plan builds
  parses, with the port's CLI parser and the JAX CLI's, to what the shell
  script's command line parses to (`--device`, `--backend` and
  `--init-method` left out, which the JAX CLIs lack); one tiny myopic cell
  and one tiny ladder cell run through the sweep on the CPU give the
  JAX CLI's file set, CSV schema and numbers on the same argv, to the
  tolerances of tests/test_torch_experiments.py (rtol 1e-5, atol 1e-7); a
  second run on the same directory runs no cell, and a call for more
  trials runs only the missing one, as an uninterrupted run would.
"""

import dataclasses
import json
import os
import shlex
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rollout_bo_tpu.experiments import myopic as jmyopic
from rollout_bo_tpu.experiments import nonmyopic as jnonmyopic
from rollout_bo_tpu_torch.experiments import myopic, nonmyopic
from test_torch_experiments import _assert_same_outputs, _files

# The tensors here are tiny: one intra-op thread (the cells' processes
# take the same).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import parity_report_torch as report  # noqa: E402
import parity_sweep_torch as sweep  # noqa: E402

PARSERS = {"myopic": (myopic.parse_args, jmyopic.parse_args),
           "nonmyopic": (nonmyopic.parse_args, jnonmyopic.parse_args)}
PORT_ONLY = ("device", "backend", "init_method")


def _write_gaps(path, finals, budget=2):
    """A CSV in the CLIs' schema whose rows end in `finals`."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(",".join(["trial"] + [str(i) for i in range(1, budget + 1)]) + "\n")
        fh.write(",".join(["-1.0"] * (budget + 1)) + "\n")
        for g in finals:
            fh.write(",".join(str(float(v)) for v in [0.0] * (budget - 1) + [g]) + "\n")


def test_report_statistics_on_hand_made_trees(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    cases = {  # (port finals, JAX finals)
        ("myopic", "sixhump", "ei"): ([0.1, 0.3, 0.5], [0.6, 0.8]),
        ("myopic", "braninhoo", "poi"): ([0.1, 0.2, 0.3], [0.9, 1.0, 0.8]),
        ("myopic", "griewank3d", "lcb"): ([1.0] * 3, [0.995] * 4),
        ("myopic", "ackley5d", "ei"): ([1.0] * 2, [1.0] * 5),
        ("ladder", "gramacylee", "h1"): ([0.5, 0.7], [0.4, 0.6, 0.8]),
    }
    for (block, fn, label), (ours, theirs) in cases.items():
        if block == "myopic":
            _write_gaps(os.path.join(port, "myopic", fn, f"{label}_gaps.csv"), ours)
            _write_gaps(os.path.join(ref, "myopic", fn, f"{label}_gaps.csv"), theirs)
        else:
            _write_gaps(os.path.join(port, "nonmyopic", fn, f"rollout_{label}_gaps.csv"), ours)
            _write_gaps(os.path.join(ref, "nonmyopic_noflag", fn, f"rollout_{label}_gaps.csv"),
                        theirs)
    # a cell the JAX record lacks is not reported
    _write_gaps(os.path.join(port, "myopic", "levy10d", "ei_gaps.csv"), [0.5])
    rows, text = report.report(port, ref)
    got = {(r["function"], r["cell"]): r for r in rows}
    assert sorted(got) == sorted((fn, label) for _, fn, label in cases)
    # hand numbers: z = |mean_a - mean_b| / sqrt(s_a^2 / n_a + s_b^2 / n_b), ddof = 1
    hand = {("sixhump", "ei"): (0.3, 3, 0.7, 2, 0.4 / np.sqrt(0.04 / 3 + 0.02 / 2), True),
            ("braninhoo", "poi"): (0.2, 3, 0.9, 3, 0.7 / np.sqrt(0.01 / 3 + 0.01 / 3), False),
            ("griewank3d", "lcb"): (1.0, 3, 0.995, 4, np.inf, True),   # means within 0.01
            ("ackley5d", "ei"): (1.0, 2, 1.0, 5, 0.0, True),
            ("gramacylee", "h1"): (0.6, 2, 0.6, 3, 0.0, True)}
    for key, (pm, n, jm, nj, z, agrees) in hand.items():
        r = got[key]
        np.testing.assert_allclose((r["port"], r["jax"]), (pm, jm), rtol=1e-12)
        assert (r["n"], r["n_jax"], r["agrees"]) == (n, nj, agrees), key
        np.testing.assert_allclose(r["z"], z, rtol=1e-12)
    np.testing.assert_allclose(got["sixhump", "ei"]["z"], 2.618614682831909, rtol=1e-12)
    assert "means within 0.01" in text and "OUTSIDE |z| <= 3" in text
    assert text.rstrip().endswith("5 cells, 1 outside |z| <= 3: braninhoo:poi")
    assert report.verdict(np.array([0.0, 0.2]), np.array([0.1, 0.3]))[2]

    # the timing table: each trial's first iteration dropped, launches from the sweep
    times = os.path.join(port, "nonmyopic", "gramacylee", "rollout_h1_times.csv")
    with open(times, "w") as fh:
        fh.write("trial,1,2,3\n-1.0,-1.0,-1.0,-1.0\n5.0,1.0,3.0\n6.0,2.0,4.0\n")
    with open(times.replace("_times.csv", "_sweep.json"), "w") as fh:
        fh.write('{"runs": [{"trials": 1, "iterations": 3, "seconds": 9.0, "launches": 9, '
                 '"device": "cpu", "card": null}, {"trials": 1, "iterations": 3, '
                 '"seconds": 7.0, "launches": 9, "device": "cpu", "card": null}]}')
    (trow,), _ = report.timing_table(port)
    assert (trow["s_per_iter"], trow["launches_per_iter"], trow["sga_per_acq"],
            trow["cell_seconds"]) == (2.5, 3.0, 2.0, 16.0)

    assert report.main(["--dir", port, "--ref", ref]) == 1
    with open(os.path.join(port, "parity_report.txt")) as fh:
        assert fh.read() == report.report(port, ref)[1]


def test_report_reads_the_cost_aware_schema():
    """The cost-aware table over results/cost_aware is, row for row,
    scripts/cost_aware_summary.py's."""
    found, lines = report.cost_aware_lines(os.path.join(REPO, "results", "cost_aware"))
    assert [m for m, _, _ in found] == ["uniform", "nonuniform", "gp"]
    theirs = subprocess.run([sys.executable, "scripts/cost_aware_summary.py", "--dir",
                             "results/cost_aware"], cwd=REPO, capture_output=True, text=True,
                            check=True).stdout.splitlines()
    assert lines[2:6] == theirs[:4]
    assert [ln.split(":")[0] for ln in lines[6:]] == [ln.split(":")[0] for ln in theirs[4:]]


def test_report_holds_the_jax_record_against_itself(tmp_path):
    port = tmp_path / "port"
    port.mkdir()
    (port / "myopic").symlink_to(os.path.join(REPO, "results", "myopic"))
    (port / "nonmyopic").symlink_to(os.path.join(REPO, "results", "nonmyopic_noflag"))
    rows, text = report.report(str(port), os.path.join(REPO, "results"))
    assert len(rows) == 7 * 4 + 2 * 4
    for r in rows:
        sub = ("myopic", r["function"], f"{r['cell']}_gaps.csv") if r["block"] == "myopic" else \
            ("nonmyopic_noflag", r["function"], f"rollout_{r['cell']}_gaps.csv")
        with open(os.path.join(REPO, "results", *sub)) as fh:
            n = len(fh.read().splitlines()) - 2
        assert (r["z"], r["n"], r["n_jax"], r["agrees"]) == (0.0, n, n, True)
    assert {r["n"] for r in rows if r["block"] == "ladder"} == {30}


def _script_argvs(name, subs):
    """The CLI argvs of a shell script's command lines, with `subs` for
    its variables and the module's name as the first element."""
    with open(os.path.join(REPO, "scripts", name)) as fh:
        text = fh.read().replace("\\\n", " ")
    for var, value in subs.items():
        text = text.replace(f'"${var}"', value).replace(f"${var}", value)
    out = []
    if "_configurations=(" in text:         # run_myopic.sh, run_nonmyopic.sh
        configs = text.split("_configurations=(")[1].split(")")[0]
        command = text.split("python -m ")[1].split("\n")[0]
        module, rest = command.split(" ", 1)
        for line in configs.strip().splitlines():
            out.append([module.rsplit(".", 1)[1]] + shlex.split(line.strip().strip('"')) +
                       shlex.split(rest.replace("$config", "")))
        return out
    for line in text.splitlines():          # run_parity_sweep.sh: loops over fn and h
        if "python -m" in line:
            words = shlex.split(line.split("||")[0])
            out.append([words[2].rsplit(".", 1)[1]] + words[3:])
    return out


def _parsed(cli, argv, which):
    ns = vars(PARSERS[cli][which](argv))
    for k in PORT_ONLY:
        ns.pop(k, None)
    return ns


@pytest.mark.parametrize("plan", sweep.PLANS)
def test_every_plan_argv_parses_as_the_shell_script_does(plan):
    cells = sweep.plan_cells(plan, horizon=2)
    assert len(set(cells)) == len(cells)
    if plan == "parity":
        scripted = []
        for template in _script_argvs("run_parity_sweep.sh", {"NOUT": "results/nonmyopic",
                                                              "OUT": "results/myopic",
                                                              "NTRIALS": "10", "TRIALS": "5",
                                                              "BUDGET": "100"}):
            fns = sweep.LADDER_FUNCTIONS if template[0] == "nonmyopic" else \
                sweep.MYOPIC_FUNCTIONS
            for fn in fns:
                for h in (sweep.HORIZONS if template[0] == "nonmyopic" else [None]):
                    scripted.append([w.replace("$fn", fn).replace("$h", str(h)) for w in template])
    elif plan == "myopic":
        scripted = _script_argvs("run_myopic.sh", {"OUT": "results/myopic"})
    else:
        scripted = _script_argvs("run_nonmyopic.sh", {"OUT": "results/nonmyopic",
                                                      "HORIZON": "2"})
    want = {}
    for argv in scripted:
        cli, argv = argv[0], argv[1:]
        ns = _parsed(cli, argv, 1)
        want[cli, ns["function_name"], ns.get("horizon")] = ns
    got = {}
    for cell in cells:
        out = os.path.join("results", "x")
        mine = _parsed(cell.cli, cell.argv(out, "cuda"), 0)
        theirs = _parsed(cell.cli, cell.argv(out), 1)
        assert mine == theirs, cell
        assert mine["output_dir"] == os.path.join(out, cell.cli)
        key = (cell.cli, cell.function, mine.get("horizon"))
        if cell.cli == "myopic":            # one cell per rule, the script's four at once
            assert mine.pop("acquisitions") == [cell.label]
            got.setdefault(key, []).append(cell.label)
        else:
            got[key] = [cell.label]
        expect = dict(want[key], output_dir=mine["output_dir"])
        if cell.cli == "myopic":
            expect.pop("acquisitions")
        assert mine == expect, cell
    assert sorted(got) == sorted(want)
    with pytest.raises(ValueError, match="not in this plan"):
        sweep.select(cells, ["sixhump:h9"])
    for (cli, _, _), labels in got.items():
        if cli == "myopic":
            assert labels == list(sweep.RULES) == jmyopic.parse_args(
                ["--function-name", "f"]).acquisitions


def _tiny(cells, name, **flags):
    """`name`'s cell of `cells`, its flags replaced by `flags`."""
    cell = sweep.select(cells, [name])[0]
    words = list(cell.flags)
    for flag, value in flags.items():
        opt = "--" + flag.replace("_", "-")
        words[words.index(opt) + 1] = str(value)
    return dataclasses.replace(cell, flags=tuple(words), budget=int(flags["budget"]))


def test_select_names_functions_and_cells():
    cells = sweep.plan_cells("parity")
    assert [c.label for c in sweep.select(cells, ["ackley2d:h3", "levy10d"])] == \
        ["h3", "ei", "poi", "lcb", "random"]
    assert sweep.select(cells, None) == cells and len(cells) == 2 * 4 + 7 * 4
    with pytest.raises(ValueError, match="not in this plan"):
        sweep.select(cells, ["sixhump:h1"])


def test_dtype_reaches_the_myopic_cells_only():
    """`--dtype float32` adds the flag to each myopic cell (the dtype the JAX
    record's myopic cells were run in), and the myopic CLI of both packages
    parses it; the ladder's cells keep run_parity_sweep.sh's float32."""
    cells = sweep.select(sweep.plan_cells("parity", trials=10), ["levy10d:ei", "ackley2d:h3"])
    assert sweep.with_dtype(cells, None) == cells
    args = sweep.parse_args(["--functions", "levy10d:ei", "ackley2d:h3", "--dtype", "float32"])
    ladder, myopic = sweep.with_dtype(cells, args.dtype)
    assert ladder == cells[0] and ladder.flags.count("--dtype") == 1
    assert myopic.flags == cells[1].flags + ("--dtype", "float32")
    out = os.path.join("results", "x")
    assert _parsed("myopic", myopic.argv(out, "cuda"), 0)["dtype"] == "float32"
    assert _parsed("myopic", myopic.argv(out), 1)["dtype"] == "float32"


def test_tiny_cells_through_the_sweep_match_the_jax_clis(tmp_path, monkeypatch, capsys):
    cells = sweep.plan_cells("parity", trials=1)
    cells = [_tiny(cells, "sixhump:ei", budget=3, starts=4),
             _tiny(cells, "gramacylee:h1", budget=3, starts=4, mc_samples=4, batch_size=2,
                   sgd_iterations=3)]
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    assert sweep.run(cells, out, "cpu") == 0
    printed = capsys.readouterr().out
    assert printed.count("launches per BO iteration") == 2
    for cell in cells:
        with open(os.path.join(cell.directory(out), f"{cell.prefix}_sweep.json")) as fh:
            (rec,) = json.load(fh)["runs"]
        assert (rec["trials"], rec["iterations"], rec["launches"], rec["device"]) == \
            (1, 3, 0, "cpu")                        # the CPU route launches no kernel
        assert rec["seconds"] > 0 and rec["argv"] == cell.argv()
        os.rename(os.path.join(cell.directory(out), f"{cell.prefix}_sweep.json"),
                  str(tmp_path / f"{cell.cli}.json"))
        argv = cell.argv(os.path.join(jout)) + (["--nworkers", "1"]
                                               if cell.cli == "nonmyopic" else [])
        (jmyopic if cell.cli == "myopic" else jnonmyopic).main(argv)
    for sub in ("myopic", "nonmyopic"):
        _assert_same_outputs(os.path.join(out, sub), os.path.join(jout, sub), budget=3,
                             trials=1)
    assert _files(os.path.join(out, "nonmyopic")) == [
        "gramacylee/rollout_h1_gaps.csv", "gramacylee/rollout_h1_observations.csv",
        "gramacylee/rollout_h1_times.csv", "metadata.txt"]
    assert len(_files(os.path.join(out, "myopic"))) == len(myopic.METRICS) + 1

    # a second run on the same directory runs no cell
    def no_cell(*args, **kw):
        raise AssertionError("a complete cell ran again")

    monkeypatch.setattr(sweep, "run_in_process", no_cell)
    assert sweep.run(cells, out, "cpu") == 0
    assert capsys.readouterr().out.count("trials on disk, skipped") == 2
    monkeypatch.undo()

    # a call for two trials runs the second only, as an uninterrupted run of
    # two trials does; a cell that fails before it is reported, and the sweep
    # goes on
    two = dataclasses.replace(cells[0], trials=2)
    bad = dataclasses.replace(cells[1], function="sixhump", flags=("--budget", "1", "--nope"))
    shutil.copy(str(tmp_path / "myopic.json"), os.path.join(two.directory(out), "ei_sweep.json"))
    assert sweep.run([bad, two], out, "cpu") == 1
    printed = capsys.readouterr().out
    assert "nonmyopic sixhump h1 FAILED (continuing)" in printed and "SystemExit: 2" in printed
    assert os.path.exists(os.path.join(out, "nonmyopic", "sixhump", "rollout_h1_failed.txt"))
    shutil.rmtree(os.path.join(out, "nonmyopic", "sixhump"))
    with open(os.path.join(two.directory(out), "ei_sweep.json")) as fh:
        assert [r["trials"] for r in json.load(fh)["runs"]] == [1, 1]
    myopic.main(two.argv(str(tmp_path / "whole"), "cpu"))
    os.remove(os.path.join(two.directory(out), "ei_sweep.json"))
    _assert_same_outputs(os.path.join(out, "myopic"), str(tmp_path / "whole" / "myopic"),
                         budget=3, trials=2)
