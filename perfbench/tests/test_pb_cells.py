"""Each cell rehearsed at tiny size on the CPU, end to end; the faults that
each cell can have make ``correct`` false; the control reads worse than
the program. The same cells at their own sizes run on the card only."""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import types

import pytest

from perfbench import control, harness, program, run
from perfbench.tests.conftest import ROOT

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
KINDS = sorted({harness.load_cell(c)["spec"]["kind"] for c in CELLS})


def declared_faults(module) -> list:
    """The ``FAULTS`` list a kind's module declares, or [] where it
    declares none (``test_kind_declares_faults`` then fails for it)."""
    return list(getattr(module, "FAULTS", None) or [])


def _run(argv):
    out = subprocess.run([sys.executable, "perfbench/run.py"] + argv,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell, trace):
    line, err = _run(["--workload", cell, "--seed", str(2 ** 31 + 17),
                      "--seconds", "1", "--trace", str(trace),
                      "--rehearse"])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    # a CPU run writes no device metric
    assert line["metrics"] == {} and line["device"]["platform"] != "gpu"
    assert list(line)[-1] == "checks"
    limits = harness.load_cell(cell)["spec"]["limits"]
    assert set(line["checks"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("kind", KINDS)
def test_kind_declares_faults(kind):
    """Each kind names the faults its cells can have, from
    ``program.FAULTS``."""
    faults = declared_faults(harness.traffic(kind))
    assert faults, f"perfbench/traffic/{kind}.py declares no FAULTS list"
    assert set(faults) <= set(program.FAULTS), faults


def test_kind_without_faults_fails_by_name(monkeypatch):
    """A kind without the list fails ``test_kind_declares_faults``, which
    names its file, and gives no fault case instead of an error."""
    monkeypatch.setattr(harness, "traffic", types.ModuleType)
    with pytest.raises(AssertionError, match="traffic/bare.py"):
        test_kind_declares_faults("bare")
    assert list(_fault_cases()) == []


def _fault_cases():
    for cell in CELLS:
        kind = harness.load_cell(cell)["spec"]["kind"]
        for fault in declared_faults(harness.traffic(kind)):
            yield cell, fault


@pytest.mark.parametrize("cell,fault", list(_fault_cases()))
def test_fault_makes_correct_false(cell, fault):
    """The run with the timed path broken underneath: the harness's look
    for a chip skipped (``--rehearse``), the rest of the run as it is."""
    buf = io.StringIO()
    with program.FAULTS[fault](), contextlib.redirect_stdout(buf):
        assert run.main(["--workload", cell, "--seed", "4242", "--seconds",
                         "1", "--rehearse"]) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_worse(cell):
    """The float8 control reads worse than the program on the same seeds,
    at the rehearsal's size (on the card, at the cell's own size, it
    fails the limits: ``test_control_fails_on_card``)."""
    prog, ctrl = [], []
    for seed in (11, 12, 13):
        got = control.readings(cell, seed, 0.5, control=True, rehearse=True)
        prog.append(max(got["program"].values()))
        ctrl.append(max(got["control"].values()))
    assert max(ctrl) > max(prog), (prog, ctrl)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, cell):
    line, _ = _run(["--workload", cell, "--seed", "77", "--seconds", "3",
                    "--trace", "0"])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(card, cell):
    for seed in (21, 22, 23):
        got = control.readings(cell, seed, 2.0, control=True)
        limits = harness.load_cell(cell)["spec"]["limits"]
        checks = [{"name": k, "value": float(v), "limit": limits[k]}
                  for k, v in got["control"].items()]
        assert not harness.judge(checks), checks

