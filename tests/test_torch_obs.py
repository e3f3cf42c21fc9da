"""The observability tier in the port against the JAX package's on the same
inputs: quantile sketches and their merges equal to the bit, registry
windows and captures, span attribution and its closure, burn-rate paging
and breach verdicts, the Prometheus text byte for byte and the JSON-lines
artifact."""
import dataclasses
import enum
import json

import numpy as np
import pytest

import repro.cluster as jax_cluster
import repro.core.latency_model as jax_lat
import repro.core.query_gen as jax_qg
import repro.obs as jax_obs
import repro_torch.cluster as cluster
import repro_torch.core.latency_model as lat
import repro_torch.core.query_gen as qg
import repro_torch.obs as obs

pytestmark = pytest.mark.cluster

QS = [0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0]


def _values(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(0.0, 1.5, 2000)
    if kind == "with_zeros":
        v = rng.exponential(3.0, 500)
        v[::7] = 0.0
        return v
    if kind == "wide":
        return 10.0 ** rng.uniform(-4, 5, 800)
    return np.full(50, 4.0)


def _sketch_state(s) -> tuple:
    return (s.counts, s.n, s.n_zero, s.vmin, s.vmax, s.total)


@pytest.mark.parametrize("kind", ["lognormal", "with_zeros", "wide", "constant"])
def test_sketch_quantiles_and_merges_equal_the_reference(kind):
    v = _values(kind)
    parts = np.array_split(v, 3)
    got, want = [], []
    for O, out in ((obs, got), (jax_obs, want)):
        one = O.QuantileSketch(0.02)
        one.observe_many(v)
        scalar = O.QuantileSketch(0.01)
        for x in v[:200]:
            scalar.observe(float(x))
        a, b, c = (O.QuantileSketch(0.02) for _ in range(3))
        for s, p in zip((a, b, c), parts):
            s.observe_many(p)
        merged = a.copy().merge(b).merge(c)
        out += [one.quantiles(QS), scalar.quantiles(QS), merged.quantiles(QS),
                _sketch_state(one), _sketch_state(merged), one.mean,
                [one.count_above(x) for x in (0.0, 1.0, float(np.median(v)), 1e9)]]
    assert got == want                                     # to the bit


def _fill_registry(O):
    rng = np.random.default_rng(3)
    reg, tl = O.MetricsRegistry(), O.FleetTimeline()
    for w in range(4):
        reg.counter("queries_completed").inc(40 + w)
        reg.counter("node_errors", node=f"cpu[{w % 2}]").inc(w)
        reg.gauge("serving_nodes").set(2 + w)
        reg.histogram("fleet_latency_ms").observe_many(rng.lognormal(1.0, 0.7, 100))
        reg.observe_grouped("node_latency_ms", "node", rng.integers(0, 3, 100),
                            rng.lognormal(1.0, 0.5, 100))
        h1, h2 = reg.histogram("span_queueing_ms"), reg.histogram("span_service_ms")
        O.observe_fanout(rng.exponential(2.0, 60), h1, h2)
        tl.snapshot(reg, 0.5 * w, 0.5, extra={"offered_qps": 80.0 + w})
    return reg, tl


def test_registry_windows_and_captures_equal_the_reference():
    (reg, tl), (jreg, jtl) = _fill_registry(obs), _fill_registry(jax_obs)
    assert len(tl) == len(jtl) == 4
    for w, jw in zip(tl.windows, jtl.windows):
        assert w.metrics == jw.metrics and w.extra == jw.extra
        assert (w.t_s, w.width_s) == (jw.t_s, jw.width_s)
        assert w.sketch("fleet_latency_ms").quantiles(QS) == \
            jw.sketch("fleet_latency_ms").quantiles(QS)
    for key in ("fleet_latency_ms.p95", "queries_completed", "serving_nodes",
                'node_latency_ms{node="1"}.count'):
        assert tl.series(key) == jtl.series(key)
    assert reg.merged_histogram("node_latency_ms").quantiles(QS) == \
        jreg.merged_histogram("node_latency_ms").quantiles(QS)
    assert reg.snapshot() == jreg.snapshot()               # window now empty
    cap, jcap = reg.capture(reset_window=False), jreg.capture(reset_window=False)
    assert cap.render() == jcap.render()
    assert cap.scalar_items() == jcap.scalar_items()


def test_prometheus_text_equals_the_reference_byte_for_byte():
    texts = []
    for O in (obs, jax_obs):
        reg, _ = _fill_registry(O)
        reg.histogram("fleet_latency_ms", zone='eu"1"', arch="dlrm\\x").observe(4.0)
        reg.counter("queries_shed").inc(7)
        texts.append(O.to_prometheus(reg))
    assert texts[0] == texts[1]
    assert texts[0].count("# TYPE fleet_latency_ms summary") == 1


def _run(C, L, Q, kill: bool):
    """A small telemetry run of one package: three nodes, a kill with
    re-route, a cache on Zipf keys and an SLO engine."""
    O = obs if C is cluster else jax_obs
    cpu = L.TableDeviceModel(np.array([1., 4, 16, 64, 256, 1024]),
                             np.array([.0008, .001, .0018, .0045, .015, .058]))
    fleet = C.Fleet([C.Pool("sky", C.NodeSpec(cpu=cpu, batch_size=8, n_executors=4),
                            count=3)])
    traffic = C.StationaryTraffic(900.0)
    times, sizes, keys = traffic.generate_keyed(
        np.random.default_rng(5), 1.0, popularity=Q.PopularityDist(kind="zipf", catalog=300))
    faults = C.FleetFaults(kills=(C.NodeKill(0.3, "sky", 0),)) if kill else None
    return C.drive_fleet(times, sizes, None, C.make_router("least_outstanding"),
                         fleet=fleet, factory=C.SimNodeBackend, window_s=0.1,
                         fleet_faults=faults, cache=C.FleetCache(C.CacheConfig(capacity=64)),
                         query_keys=keys,
                         slo=O.SloEngine(O.SloObjective("p95", latency_ms=20.0),
                                         rules=(O.BurnRateRule(2, 1, 1.0),)))


def _plain(x):
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, [_plain(getattr(x, f.name)) for f in dataclasses.fields(x)])
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return [(k, _plain(v)) for k, v in x.items()]
    if isinstance(x, float) and x != x:
        return "nan"
    return x


@pytest.mark.parametrize("kill", [False, True])
def test_attribution_and_its_closure_equal_the_reference(kill):
    got = _run(cluster, lat, qg, kill).telemetry
    want = _run(jax_cluster, jax_lat, jax_qg, kill).telemetry
    for name in ("t_enqueued", "t_routed", "t_released", "t_exec_start", "t_done"):
        np.testing.assert_array_equal(getattr(got.spans, name), getattr(want.spans, name))
    assert got.spans.stage_totals() == want.spans.stage_totals()
    for pcts, band in (((50.0, 95.0, 99.0), 0.02), ((90.0, 99.9), 0.05)):
        rep, jrep = got.attribution(pcts, band), want.attribution(pcts, band)
        assert _plain(rep) == _plain(jrep)
        assert rep.reconciles(0.05) and rep.table() == jrep.table()
    if kill:
        assert got.spans.components()["reroute"].max() > 0


def _window_stream(O):
    """The same snapshot stream for one package: calm windows, then a
    queueing breach, a retry/re-route breach, a cold one with nodes
    booting, a cache that stops hitting, and a service regression."""
    reg, tl = O.MetricsRegistry(), O.FleetTimeline()
    script = ([("calm", {"service": 4.0, "queueing": 1.0}, 0.6, 0)] * 6
              + [("hot", {"service": 4.0, "queueing": 300.0}, 0.6, 0)] * 3
              + [("calm", {"service": 4.0, "queueing": 1.0}, 0.6, 0)] * 2
              + [("hot", {"service": 4.0, "reroute": 250.0, "retry": 60.0}, 0.6, 0)] * 2
              + [("hot", {"service": 4.0, "boot_wait": 300.0}, 0.6, 2)] * 2
              + [("hot", {"service": 300.0}, 0.05, 0)] * 2
              + [("hot", {"service": 350.0}, 0.6, 0)] * 2)
    snaps = []
    for w, (kind, comps, hit, booting) in enumerate(script):
        n = 40
        lat_ms = np.full(n, 5.0) if kind == "calm" else np.where(np.arange(n) < 20, 400.0, 5.0)
        reg.histogram("fleet_latency_ms").observe_many(lat_ms)
        for c, per_q in comps.items():
            reg.histogram(f"span_{c}_ms").observe_many(np.full(n, per_q))
        reg.gauge("cache_hit_rate").set(hit)
        reg.gauge("booting_nodes").set(booting)
        if w == 12:
            reg.counter("queries_shed").inc(5)
        snaps.append(tl.snapshot(reg, 0.5 * w, 0.5))
    return snaps


def test_burn_rate_paging_and_breach_verdicts_equal_the_reference():
    engines = []
    for O in (obs, jax_obs):
        eng = O.SloEngine((O.SloObjective("p95", latency_ms=100.0),
                           O.SloObjective("p99", latency_ms=100.0, percentile=99.0,
                                          error_rate=0.01)),
                          rules=(O.BurnRateRule(4, 2, 2.0), O.BurnRateRule(2, 1, 5.0)))
        for snap in _window_stream(O):
            eng.on_window(snap)
        engines.append(eng)
    got, want = engines
    assert _plain(got.alerts) == _plain(want.alerts)
    assert _plain(got.diagnoses) == _plain(want.diagnoses)
    assert _plain(got.incidents) == _plain(want.incidents)
    assert got.violation_minutes() == want.violation_minutes()
    verdicts = {d.verdict.name for d in got.diagnoses}
    assert {"QUEUEING_SATURATION", "FAULT_RECOVERY", "COLD_CAPACITY"} <= verdicts
    assert any(a.kind == "fire" for a in got.alerts)


def test_write_jsonl_round_trip_equals_the_reference(tmp_path):
    got = _run(cluster, lat, qg, kill=True)
    want = _run(jax_cluster, jax_lat, jax_qg, kill=True)
    p, jp = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    n = obs.write_jsonl(got, str(p))
    assert n == jax_obs.write_jsonl(want, str(jp))
    lines = [json.loads(line) for line in p.read_text().splitlines()]
    jlines = [json.loads(line) for line in jp.read_text().splitlines()]
    assert len(lines) == n == sum(1 for _ in obs.run_lines(got))
    for rec in lines + jlines:          # the driver's wall-clock seconds a window
        rec.get("extra", {}).pop("ctl_s", None)
    assert lines == jlines
    kinds = {rec["kind"] for rec in lines}
    assert {"run", "window", "attribution", "slo_objective", "alert", "diagnosis"} <= kinds
    run = next(rec for rec in lines if rec["kind"] == "run")
    assert run["p95_ms"] == got.p95_ms and run["n_queries"] == got.n_queries
    assert got.telemetry.prometheus() == want.telemetry.prometheus()


@pytest.mark.parametrize("argv", [[], ["--windows"], ["--window", "0.2:0.5"], ["--window", ":0.3"],
                                  ["--node", "sky[1]", "--windows"],
                                  ["--node", "sky[0]", "--window", "0.4:"]])
def test_dump_cli_prints_the_reference_bytes(tmp_path, capsys, argv):
    """One artifact (a port run with a kill, a cache and an SLO engine)
    through the reference's ``python -m repro.obs.dump`` and the port's:
    the same stdout, byte for byte, and the same exit code."""
    from repro.obs import dump as jax_dump
    from repro_torch.obs import dump

    path = tmp_path / "run.jsonl"
    obs.write_jsonl(_run(cluster, lat, qg, kill=True), str(path))
    outs = []
    for main in (jax_dump.main, dump.main):
        assert main([str(path)] + argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[1].startswith("run: qps=") and "attribution (ms):" in outs[1]
    if argv:
        assert "  t=" in outs[1]
    if "--node" in argv:
        assert '    node_latency_ms{node="sky[' in outs[1]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert jax_dump.main([str(empty)]) == dump.main([str(empty)]) == 1


def test_report_cli_prints_the_reference_bytes(tmp_path, capsys):
    """The incident postmortems of one artifact through both packages'
    ``report`` CLIs: the same stdout, byte for byte; an artifact without
    SLO records is refused by both."""
    from repro.obs import report as jax_report
    from repro_torch.obs import report

    path = tmp_path / "run.jsonl"
    obs.write_jsonl(_run(cluster, lat, qg, kill=True), str(path))
    outs = []
    for main in (jax_report.main, report.main):
        assert main([str(path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[1].startswith("objective p95:") and "incident #1" in outs[1]
    bare = tmp_path / "bare.jsonl"
    bare.write_text("\n".join(line for line in path.read_text().splitlines()
                              if '"kind": "slo_objective"' not in line
                              and '"kind":"slo_objective"' not in line) + "\n")
    assert jax_report.main([str(bare)]) == report.main([str(bare)]) == 1
