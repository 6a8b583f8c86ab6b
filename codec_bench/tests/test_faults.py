"""The rest of a run, the chip check skipped, on the CPU at a small
configuration: sound, each cell's run comes out correct; with the timed
path broken underneath (an answer altered where it is produced, a train
step that leaves its state unchanged, half of each batch left out) it
comes out not correct. The result line has the contract's keys."""

import pytest

from codec_bench import harness
from codec_bench.tests.helpers import cell_run

CELLS = {w["name"]: harness.read_json("traffic", w["traffic"])["driver"]
         for w in harness.spec()["workloads"]}
FAULTS = {"oneshot": ["alter_codes", "alter_audio"],
          "live": ["alter_codes", "alter_audio"],
          "train": ["unchanged_state", "half_batch"]}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    run = cell_run(workload)
    assert run.correct, run.checks
    out = harness.result(run, harness.spec())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["correct"] is True
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("workload,fault", [(w, f) for w in sorted(CELLS)
                                            for f in FAULTS[CELLS[w]]])
def test_broken_path_is_not_correct(workload, fault):
    run = cell_run(workload, fault=fault)
    assert not run.correct, run.checks


@pytest.mark.parametrize("workload", [w for w in sorted(CELLS) if CELLS[w] == "train"])
def test_half_batch_stand_in_is_not_correct(workload):
    assert not cell_run(workload, impl="half_batch").correct


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_run_reports_per_layer_metrics(workload):
    run = cell_run(workload, trace=True, seconds=1.2)
    out = harness.result(run, harness.spec())
    assert "breakdown" in out and set(out["device"]) >= {"busy_s", "window_s"}
    names = {m["name"] for m in harness.metrics_of(harness.spec(), workload, "per_layer")}
    assert set(out["metrics"]) <= names
