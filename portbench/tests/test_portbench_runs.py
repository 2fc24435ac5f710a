"""Whole runs of every cell at a small size on the CPU (the port's plain
routes): correct as they stand, not correct with the timed path broken
underneath, once for each fault the cell can have; and the command
itself without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from _portbench_small import run_small, small_cell

torch.set_num_threads(1)
CELLS = [w["name"] for w in harness.catalog()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = run_small(small_cell(name))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in harness.for_cell(harness.catalog()["end_to_end"], name)}
    assert set(line["metrics"]) == e2e
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in harness.driver(harness.load_cell(name, 1, 1, False)).FAULTS])
def test_fault_is_caught(name, fault):
    line = run_small(small_cell(name, fault=fault))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_is_caught(name):
    """The program's own lower precision (`model.compute_dtype=bfloat16`)
    fails the cell's limits: the control of the configuration's float32."""
    line = run_small(small_cell(name, dtype="bfloat16"))
    assert not line["correct"], line["checks"]


def _run_py(*args, env=None):
    return subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), *args],
                          capture_output=True, text=True, cwd=harness.ROOT, timeout=120,
                          env=env)


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for name in CELLS:
        proc = _run_py("--workload", name, "--seed", "5", "--seconds", "1", env=env)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""


def test_nothing_loaded_is_jax():
    """Everything a run loads (harness, drivers, readers, the reference and
    the port's modules they import), then the top-level names compared
    whole."""
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness; "
            "harness.load_all(); import portbench.control, portbench.run; "
            "print(harness.forbidden_modules()); "
            "print(sorted({n.split('.')[0] for n in sys.modules}))" % harness.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    found, tops = proc.stdout.splitlines()[:2]
    assert found == "[]"
    assert "weatherforecast_stgcn_maml_tpu_torch" in tops
    for name in harness.FORBIDDEN:
        assert f"'{name}'" not in tops


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "weatherforecast_stgcn_maml_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """One short run of each cell as the driver runs it (card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = _run_py("--workload", name, "--seed", "3000000077", "--seconds", "2")
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_on_the_card(name):
    """At a small size on the card: a sound run within the cell's limits;
    the control (the reference in TF32 in the program's place), the
    program in bfloat16 and the half batch each outside one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = small_cell(name)
    cell.device = torch.device("cuda", 0)
    gen = harness.driver(cell).readings(cell, True, 8)
    readings = {what: {k: v for k, v in r.items() if k in cell.limits} for what, r, _ in gen}
    assert all(v <= cell.limits[k] for k, v in readings.pop("sound").items())
    for what, r in readings.items():
        assert any(v > cell.limits[k] for k, v in r.items()), (what, r)


def test_a_failed_attempt_makes_the_run_not_correct():
    """A request or step that failed fails the run, whatever the checks read."""
    cell = small_cell(CELLS[0])
    out = harness.Outcome(attempted=10, failed=0, end_to_end={},
                          checks={k: 0.0 for k in cell.limits}, memory_peak_bytes=0,
                          layer={})
    device = {"platform": "cpu", "kind": "cpu", "count": 1}
    assert harness.result(cell, out, 0.0, device)["correct"]
    out.failed = 1
    assert not harness.result(cell, out, 0.0, device)["correct"]


def test_a_request_that_raises_ends_the_scoring_run(monkeypatch):
    from portbench.drivers import score

    name = next(n for n in CELLS if harness.driver(harness.load_cell(n, 1, 1, False))
                is score)
    calls = []

    def request(self, box, anchors):
        calls.append(box)
        if len(calls) > 3:  # past the warm-up
            raise RuntimeError("planted")
        return real(self, box, anchors)

    real = score.Program.request
    monkeypatch.setattr(score.Program, "request", request)
    with pytest.raises(RuntimeError, match="planted"):
        run_small(small_cell(name))


@pytest.mark.parametrize("other_pct,unmatched,reported", [
    (0.5, 0, True), (9.9, 0, True), (10.1, 0, False), (0.5, 1, False)])
def test_rooflines_withheld_where_attribution_leaks(other_pct, unmatched, reported):
    """A family's roofline is read only where every launch was found and
    little of the busy time lies in no family; the line says which."""
    from portbench.trace import Trace

    trace = Trace(window_s=1.0, busy_s=0.9, launches=10,
                  family_s={"gcn": 0.4, "lstm": 0.4, "other": other_pct / 100 * 0.9},
                  unmatched=unmatched, other_pct=other_pct)
    ctx = {"kind": "predict", "model": small_cell(CELLS[0]).model, "nodes": 36, "k": 4,
           "windows_per_request": 3, "trace": trace, "stretch": {"requests": 10},
           "untraced": {"seconds": 1.0, "requests": 100}}
    for metric in ("gcn_eval_roofline", "lstm_eval_roofline"):
        value = harness.metric_reader(metric).read(ctx)
        assert (value is not None) == reported
    name = next(n for n in CELLS if any(m["name"] == "gcn_eval_roofline"
                                        for m in harness.load_cell(n, 1, 1, True).per_layer))
    cell = small_cell(name)
    cell.trace = True
    out = harness.Outcome(attempted=1, failed=0, end_to_end={}, checks={},
                          memory_peak_bytes=0, layer=dict(ctx))
    line = harness.result(cell, out, 0.0, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert line["attribution"]["rooflines_reported"] == reported
    assert line["attribution"]["other_pct"] == other_pct
    assert ("gcn_eval_roofline" in line["metrics"]) == reported
    assert list(line)[-1] == "checks"
