"""The port's twins of the JAX package's two datacenter examples,
``examples/datacenter_sim_torch.py`` and ``examples/datacenter_fleet_torch.py``
(their scenarios in ``repro_torch.cluster.datacenter``), held number for number against ``examples/datacenter_sim.py`` and
``examples/datacenter_fleet.py`` on the same curves and constants: the JAX
examples run unedited (loaded from their paths, their curve source and
day length set at test time), their stdout captured and the results of
their simulator calls recorded.  Both packages' schedulers and simulators
are numpy, so every number must be equal, not close.  Then the port's
fleet on the recorded H100 curve, from a temporary copy of the curve
files, and its refusal to run without the card's curve."""
import contextlib
import importlib.util
import io
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
ARTIFACTS = os.path.join(REPO, "artifacts")
sys.path.insert(0, EXAMPLES)
import datacenter_fleet_torch as port_fleet  # noqa: E402
import datacenter_sim_torch as port_sim  # noqa: E402
from repro_torch.cluster import datacenter as dc  # noqa: E402

# the JAX package's measured CPU curve of RMC1, given to both packages
JAX_CURVES = os.path.join(ARTIFACTS, "cpu_latency_curves.json")
SIM_ARCH = "dlrm-rmc1"
# a short synthetic day; the reference's window and boot set as the port
# derives them from the day (its 60 s day has 2 s windows and 6 s of boot)
DAY_S = 1.0
WINDOW_S, BOOT_S = DAY_S / 30, DAY_S / 10


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(mod, argv: list[str]) -> list[str]:
    """``mod.main()`` under ``argv``; its stdout's lines."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(sys, "argv", ["prog", *argv])
        mod.main()
    return buf.getvalue().rstrip("\n").split("\n")


def _recording(mp, mod, name: str, calls: list) -> None:
    """Wrap ``mod.name`` so that each call's result is appended to ``calls``."""
    fn = getattr(mod, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out
    mp.setattr(mod, name, wrapped)


# ----------------------------------------------------------- datacenter_sim


@pytest.fixture(scope="module")
def sim_pair():
    from repro.core import infra as jax_infra
    from repro.core import latency_model as jax_lat
    from repro_torch.core import infra as port_infra
    from repro_torch.core import latency_model as port_lat

    jax_curve = jax_lat.load_curves(JAX_CURVES)[SIM_ARCH]
    port_curve = port_lat.load_curves(JAX_CURVES)[SIM_ARCH]
    ref = _load(os.path.join(EXAMPLES, "datacenter_sim.py"), "jax_datacenter_sim")
    calls = {"max_qps_under_sla": [], "tune": [], "simulate": []}
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_infra, "cpu_curves", lambda archs, **kw: {SIM_ARCH: jax_curve})
        mp.setattr(port_infra, "cpu_curves", lambda archs: {SIM_ARCH: port_curve})
        for name, got in calls.items():
            _recording(mp, ref, name, got)
        run = dc.sim_rows
        mp.setattr(dc, "sim_rows", lambda *a, **kw: rows.extend(run(*a, **kw)) or rows)
        ref_out = _main(ref, ["--models", SIM_ARCH])
        port_out = _main(port_sim, ["--models", SIM_ARCH])
    return {"ref_out": ref_out, "port_out": port_out, "calls": calls, "rows": rows}


def test_sim_prints_the_reference_table(sim_pair):
    assert sim_pair["port_out"] == sim_pair["ref_out"]
    assert len(sim_pair["ref_out"]) == 2 and "OK" in sim_pair["ref_out"][1]


def test_sim_main_prints_what_run_returns(sim_pair):
    (row,) = sim_pair["rows"]
    assert sim_pair["port_out"][1:] == port_sim.format_row(row)
    assert row["arch"] == SIM_ARCH and row["sla_ms"] == 100.0 and row["static_batch"] == 25


@pytest.mark.parametrize("key,call,attr", [
    ("static", "max_qps_under_sla", None),
    ("tuned", "tune", "qps"),
    ("batch", "tune", "batch_size"),
    ("p95_ms", "simulate", "p95_ms"),
    ("hedges", "simulate", "hedges"),
    ("requeued", "simulate", "requeued"),
    ("n_queries", "simulate", "n_queries"),
    ("dropped", "simulate", "dropped"),
])
def test_sim_row_equals_the_reference_calls(sim_pair, key, call, attr):
    """Each number of the port's row equals, to the bit, what the JAX
    example's own call returned."""
    (got,) = sim_pair["calls"][call]
    want = got if attr is None else getattr(got, attr)
    (row,) = sim_pair["rows"]
    assert row[key] == want
    if key == "tuned":
        assert row["x"] == want / max(sim_pair["calls"]["max_qps_under_sla"][0], 1e-9)


# --------------------------------------------------------- datacenter_fleet


@pytest.fixture(scope="module")
def fleet_pair():
    ref = _load(os.path.join(EXAMPLES, "datacenter_fleet.py"), "jax_datacenter_fleet")
    results, fleets = [], []
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("DAY_S", DAY_S), ("WINDOW_S", WINDOW_S), ("BOOT_S", BOOT_S)):
            mp.setattr(ref, name, value)
        _recording(mp, ref, "simulate_fleet", results)
        _recording(mp, ref, "build_fleet", fleets)
        ref_out = _main(ref, ["--synthetic"])
    res = dc.fleet_day(dc.build_fleet(True), day_s=DAY_S)
    (fleet,) = fleets
    names = ("static", "autoscaled", *dc.ROUTERS, "predictive", "reactive", "kill",
             "no_reroute")
    assert len(results) == len(names)
    return {"ref_out": ref_out, "res": res, "ref": dict(zip(names, results)),
            "fleet": fleet}


def test_fleet_prints_the_reference_report(fleet_pair):
    assert port_fleet.report(fleet_pair["res"]) == fleet_pair["ref_out"]


def test_fleet_pools_are_tuned_alike(fleet_pair):
    got = fleet_pair["res"]["pools"]
    want = [{"name": p.name, "count": p.count, "batch": p.spec.batch_size,
             "threshold": p.spec.offload_threshold, "node_qps": p.qps_capacity}
            for p in fleet_pair["fleet"].pools]
    assert got == want
    assert [p["name"] for p in got] == ["skylake", "broadwell", "gpu"]


@pytest.mark.parametrize("part", ["static", "autoscaled"])
def test_fleet_static_and_autoscaled_days_are_equal(fleet_pair, part):
    got, want = fleet_pair["res"][part], fleet_pair["ref"][part]
    assert (got["p95_ms"], got["node_hours"], got["served"], got["dropped"]) == (
        want.p95_ms, want.node_hours, want.n_queries, want.dropped)
    assert got["served"] == fleet_pair["res"]["queries"]
    if part == "autoscaled":
        assert (got["events"], got["final_nodes"], got["meets_sla"]) == (
            len(want.events), want.n_nodes, want.meets(dc.SLA_MS))
        assert fleet_pair["res"]["timeline"] == [tuple(r[:4]) for r in want.timeline[::3]]
        assert got["events"] >= 1


@pytest.mark.parametrize("router", dc.ROUTERS)
def test_fleet_routers_are_equal(fleet_pair, router):
    got, want = fleet_pair["res"]["routers"][router], fleet_pair["ref"][router]
    assert (got["p95_ms"], got["meets_sla"]) == (want.p95_ms, want.meets(dc.SLA_MS))


@pytest.mark.parametrize("scaler", ["reactive", "predictive"])
def test_fleet_boot_latency_scalers_are_equal(fleet_pair, scaler):
    got, want = fleet_pair["res"]["boot"][scaler], fleet_pair["ref"][scaler]
    sla = dc.SLA_MS
    assert got == {"sla_violation_minutes": want.sla_violation_minutes(sla),
                   "node_hours": want.node_hours,
                   "triggers": sorted({e.reason for e in want.events})}
    if scaler == "predictive":
        assert "forecast" in got["triggers"]


def test_fleet_kill_with_and_without_reroute_is_equal(fleet_pair):
    kill, ref = fleet_pair["res"]["kill"], fleet_pair["ref"]
    assert kill["reroute"] == {"rerouted": ref["kill"].rerouted, "dropped": ref["kill"].dropped,
                               "served": ref["kill"].n_queries, "p95_ms": ref["kill"].p95_ms}
    assert kill["no_reroute"] == {"rerouted": ref["no_reroute"].rerouted,
                                  "dropped": ref["no_reroute"].dropped,
                                  "served": ref["no_reroute"].n_queries}
    assert kill["reroute"]["rerouted"] >= 1 and kill["reroute"]["dropped"] == 0
    assert kill["no_reroute"]["dropped"] == kill["reroute"]["rerouted"]
    assert kill["killed"] == 2 and kill["at_s"] == DAY_S / 2


# --------------------------------------------- the port's fleet on the card


@pytest.fixture
def artifacts_copy(tmp_path, monkeypatch):
    """``$REPRO_ARTIFACTS`` pointed at a copy of the port's two curve files."""
    from repro_torch.core import infra
    for name in (infra.CPU_CURVES, infra.CARD_CURVES):
        shutil.copy(os.path.join(ARTIFACTS, name), tmp_path / name)
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    return tmp_path


def test_fleet_runs_on_the_recorded_h100_curve(artifacts_copy):
    from repro_torch.core import latency_model as lat
    fleet = dc.build_fleet(False)
    card = fleet.pool("h100").spec.accel
    want = lat.load_curves(os.path.join(ARTIFACTS, "h100_latency_curves.json"))["dlrm-rmc1"]
    assert np.array_equal(card.seconds, want.seconds)
    day = 0.5
    res = dc.fleet_day(fleet, day_s=day)
    assert [p["name"] for p in res["pools"]] == ["skylake", "broadwell", "h100"]
    assert res["pools"][2]["threshold"] is not None           # work leaves the CPU
    for r in (res["static"], res["autoscaled"], res["kill"]["reroute"],
              res["kill"]["no_reroute"]):
        assert r["served"] + r["dropped"] == res["queries"] > 0
    assert res["kill"]["reroute"]["dropped"] == 0 < res["kill"]["reroute"]["rerouted"]
    assert res["kill"]["no_reroute"]["dropped"] >= 1
    assert all(math.isfinite(r["p95_ms"]) for r in res["routers"].values())
    assert sorted(os.listdir(artifacts_copy)) == ["h100_latency_curves.json",
                                                  "torch_cpu_latency_curves.json"]


def test_without_the_card_curve_both_twins_raise(artifacts_copy):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card's curve would be measured")
    os.remove(artifacts_copy / "h100_latency_curves.json")
    with pytest.raises(RuntimeError, match="no measured card curve"):
        dc.build_fleet(False)
    with pytest.raises(RuntimeError, match="no measured card curve"):
        _main(port_sim, ["--models", SIM_ARCH, "--card"])
    assert dc.build_fleet(True).pool("gpu").spec.accel is not None
