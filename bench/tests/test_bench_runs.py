"""Whole runs of every workload on the CPU at small widths (the port's plain
versions stand in for its kernels): the result line as the contract fixes
it for every cell of ``BENCHMARK.json``, ``correct`` true for the program,
and false for each fault the workload can have, planted under the timed
path from its first call, and again only past the set-up's calls (the
warm-up passes, the checked training steps), so that it breaks the window
alone."""
import json

import pytest
import torch

from bench.harness import faults, runner, spec
from bench.harness.systems import Port

XDEEPFM = {"n_tables": 6, "vocab": 100, "embed_dim": 8, "cin_layers": [16, 16],
           "dnn_widths": [32]}
RMC2 = {"n_tables": 4, "vocab": 100, "embed_dim": 8, "hotness": 4, "n_dense": 16,
        "dense_fc": [16, 8], "predict_fc": [16, 1]}
SMALL = {
    "dlrm-rmc2.bulk": {"model": RMC2, "params": {"batch": 256}},
    "xdeepfm.bulk": {"model": XDEEPFM, "params": {"batch": 256}},
    "xdeepfm.train": {"model": XDEEPFM, "params": {"batch": 128}},
}
SECONDS = 0.6
SEED = 2 ** 31 + 977
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
WORKLOADS = sorted(p.stem for p in (spec.ROOT / "bench" / "workloads").glob("*.json"))
FAULTS = {"dlrm-rmc2.bulk": ("half_batch", "answer_altered"),
          "xdeepfm.bulk": ("half_batch", "answer_altered"),
          "xdeepfm.train": ("half_batch", "state_unchanged", "nan_loss")}
SET_UP_CALLS = {"dlrm-rmc2.bulk": 2, "xdeepfm.bulk": 2, "xdeepfm.train": 3}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kw(name, trace=False, system=None):
    return dict(seed=SEED, seconds=SECONDS, trace=trace, device="cpu", system=system,
                overrides=SMALL[name])


def _run(cell, trace=False, system=None):
    return runner.run_cell(cell, **_kw(cell, trace, system))


def test_every_workload_has_a_small_size():
    assert sorted(SMALL) == WORKLOADS == sorted(FAULTS) == sorted(SET_UP_CALLS)
    assert set(CELLS) <= set(WORKLOADS)


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "per_layer"])
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_and_line_is_whole(cell, trace):
    result, outcome = _run(cell, trace)
    assert result["correct"] is True, result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}
    bench = spec.benchmark()
    if trace:
        want = {m["name"] for m in spec.per_layer(bench, cell)}
        # without a card only the host's readings exist; no share is reported
        assert set(result["metrics"]) <= want
        assert not any("roofline" in k or "mfu" in k or "idle" in k for k in result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end(bench, cell)}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    line = runner.dumps(result)
    assert "\n" not in line and json.loads(line) == json.loads(line)
    assert all(c.ok for c in outcome.checks)
    assert len(runner.checks_text(result)) == len(result["checks"])


@pytest.mark.parametrize("spared", [False, True], ids=["from_start", "window_only"])
@pytest.mark.parametrize("name,fault", [(w, f) for w in WORKLOADS for f in FAULTS[w]])
def test_planted_fault_is_not_correct(name, fault, spared):
    after = SET_UP_CALLS[name] if spared else 0
    _, outcome = runner.execute(name, **_kw(name, system=faults.Faulty(Port(), fault, after)))
    assert outcome.correct is False, outcome.checks


def test_window_steps_that_are_not_finite_fail():
    system = faults.Faulty(Port(), "nan_loss", SET_UP_CALLS["xdeepfm.train"])
    result, outcome = _run("xdeepfm.train", system=system)
    assert outcome.failed == outcome.attempted > 0
    assert result["failed"] == outcome.failed
    assert result["checks"]["nonfinite_steps"] == {"value": float(outcome.failed), "limit": 0.0}
    assert result["correct"] is False


def test_the_step_after_the_window_is_compared():
    # a state left unchanged in the window only: the checked steps of the
    # set-up pass, the step after the window does not
    system = faults.Faulty(Port(), "state_unchanged", SET_UP_CALLS["xdeepfm.train"])
    _, outcome = runner.execute("xdeepfm.train", **_kw("xdeepfm.train", system=system))
    by = {c.name: c for c in outcome.checks}
    assert all(by[k].ok for k in ("loss_gap", "grad_norm_gap", "change_gap", "nonfinite_steps"))
    assert not by["late_change_gap"].ok and by["late_change_gap"].value > 0.5


def test_non_finite_check_is_written_as_a_string():
    line = runner.dumps({"checks": {"x": {"value": float("nan"), "limit": 1.0}}})
    assert json.loads(line)["checks"]["x"]["value"] == "nan"
