"""The cluster tier in the port against the JAX package's: the same trace,
the same node specs and the same knobs through ``drive_fleet``,
``simulate_fleet`` and ``cluster_max_qps`` of both packages give equal
results (numpy on both sides, so equal means equal: completion times,
pool and tenant stats, re-routes, lifecycle and scaling events,
node-hours, cache counters, the telemetry and the SLO engine's record).
Then the live backend on the CPU with a tiny torch model, as
``tests/test_backend.py`` drives the reference's, and the calibration
curve against the reference's."""
import dataclasses
import enum
import types

import numpy as np
import pytest
import torch

import repro.cluster as jax_cluster
import repro.core.latency_model as jax_lat
import repro.core.query_gen as jax_qg
import repro.obs as jax_obs
import repro_torch.cluster as cluster
import repro_torch.core.latency_model as lat
import repro_torch.core.query_gen as qg
import repro_torch.obs as obs
from repro_torch.cluster.fleet import NodeView
from repro_torch.serve.runtime import ServingRuntime

pytestmark = pytest.mark.cluster

PORT = types.SimpleNamespace(cluster=cluster, obs=obs, qg=qg, lat=lat)
REF = types.SimpleNamespace(cluster=jax_cluster, obs=jax_obs, qg=jax_qg, lat=jax_lat)
BATCHES = [1., 4, 16, 64, 256, 1024]
CPU_S = [.0008, .001, .0018, .0045, .015, .058]
ACC_S = [.002, .0021, .0023, .0026, .004, .009]


def _plain(x, path=()):
    """A value of either package as nested builtins, for ``==``: dataclasses
    and plain objects by class name and fields, enums by name, arrays by
    dtype, shape and values, NaN as a string.  The driver's wall-clock
    seconds of control work (``ctl_s``) are left out: they are the one
    field that is not a function of the inputs."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return "nan" if x != x else float(x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, _plain(x.tolist(), path))
    if id(x) in path:
        return "<cycle>"
    path = path + (id(x),)
    if isinstance(x, dict):
        return [(_plain(k, path), _plain(v, path)) for k, v in x.items() if k != "ctl_s"]
    if isinstance(x, (list, tuple)) or type(x).__name__ == "deque":
        return [_plain(v, path) for v in x]
    if isinstance(x, np.random.Generator):
        return x.bit_generator.state
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name), path)
                                   for f in dataclasses.fields(x)})
    if callable(x) and not hasattr(x, "__dict__"):
        return getattr(x, "__qualname__", type(x).__name__)
    if hasattr(x, "__dict__"):
        return (type(x).__name__, {k: _plain(v, path) for k, v in vars(x).items()})
    slots = [s for c in type(x).__mro__ for s in getattr(c, "__slots__", ())]
    if slots:
        return (type(x).__name__, {s: _plain(getattr(x, s), path) for s in slots
                                   if hasattr(x, s)})
    raise TypeError(f"cannot compare a {type(x).__name__}")


def _result(r) -> object:
    """A ``ClusterResult`` without the timeline's wall-clock column."""
    r = dataclasses.replace(r, timeline=[row[:5] for row in r.timeline])
    return _plain(r)


def _trace(P, n=400, qps=600.0, seed=3):
    unit, sizes = P.qg.sample_trace(np.random.default_rng(seed), n)
    return unit / qps, sizes


def _cpu(P):
    return P.lat.TableDeviceModel(np.array(BATCHES), np.array(CPU_S))


def _acc(P):
    return P.lat.TableDeviceModel(np.array(BATCHES), np.array(ACC_S))


def _fleet(P, n=3, boot_s=0.0, max_count=None, accel=False):
    spec = P.cluster.NodeSpec(cpu=_cpu(P), accel=_acc(P) if accel else None,
                              batch_size=8, n_executors=4, boot_s=boot_s,
                              offload_threshold=150 if accel else None)
    return P.cluster.Fleet([P.cluster.Pool("sky", spec, count=n, min_count=1,
                                           max_count=max_count)])


def _views(P, n=3):
    """A heterogeneous node list: two fast nodes and a slow one."""
    fast = P.cluster.NodeSpec(cpu=_cpu(P), batch_size=8, n_executors=4)
    slow = P.cluster.NodeSpec(cpu=P.cluster.ScaledDeviceModel(_cpu(P), 3.0),
                              batch_size=8, n_executors=4)
    mod = P.cluster.fleet
    return ([mod.NodeView("fast", i, fast, 300.0) for i in range(n - 1)]
            + [mod.NodeView("slow", 0, slow, 100.0)])


def _drive(P, times, sizes, fleet, router="round_robin", **kw):
    """``drive_fleet`` over ``fleet`` with a factory that keeps every backend
    it makes, so their completion records can be compared too."""
    made = []

    def factory(view, t0):
        b = P.cluster.SimNodeBackend(view, t0)
        made.append(b)
        return b

    r = P.cluster.drive_fleet(times, sizes, None, P.cluster.make_router(router),
                              fleet=fleet, factory=factory, **kw)
    return r, made


def _records(backends):
    return _plain(sorted((rec for b in backends for rec in b.completed_records()),
                         key=lambda rec: (rec.index, rec.t_done)))


def _case_router(name):
    def run(P):
        times, sizes = _trace(P)
        nodes = P.cluster.sim_backends(_views(P))
        return P.cluster.drive_fleet(times, sizes, nodes, P.cluster.make_router(name),
                                     window_s=0.1), nodes
    return run


def _case_hetero_affinity(P):
    times, sizes = _trace(P, n=300, qps=400.0)
    mids = (np.arange(len(times)) % 2).astype(np.int64)
    router = P.cluster.make_router("hetero")
    router.affinity = {1: {"slow"}}
    nodes = P.cluster.sim_backends(_views(P))
    return P.cluster.drive_fleet(times, sizes, nodes, router, window_s=0.1,
                                 model_ids=mids), nodes


def _case_traffic(kind):
    def run(P):
        T = P.cluster
        rng = np.random.default_rng(7)
        mids = None
        if kind == "stationary":
            times, sizes = T.StationaryTraffic(500.0).generate(rng, 1.0)
        elif kind == "diurnal":
            times, sizes = T.DiurnalTraffic(base_qps=500.0, amplitude=0.6,
                                            period_s=1.0).generate(rng, 1.0)
        elif kind == "bursty":
            times, sizes = T.BurstyTraffic(base_qps=300.0, burst_mult=4.0,
                                           bursts=((0.3, 0.2),)).generate(rng, 1.0)
        else:
            mt = T.MultiTenantTraffic(tenants=(
                ("rmc", T.StationaryTraffic(300.0), P.qg.PRODUCTION),
                ("ncf", T.StationaryTraffic(200.0), P.qg.SizeDist("fixed", mean=4.0))))
            times, sizes, mids = mt.generate_labeled(rng, 1.0)
        return _drive(P, times, sizes, _fleet(P), "least_outstanding", window_s=0.1,
                      model_ids=mids)
    return run


def _case_kill(reroute):
    def run(P):
        times, sizes = _trace(P, n=400, qps=800.0)
        faults = P.cluster.FleetFaults(kills=(P.cluster.NodeKill(0.1, "sky", 0),),
                                       reroute=reroute)
        return _drive(P, times, sizes, _fleet(P), window_s=0.05, fleet_faults=faults)
    return run


def _case_autoscaler(predictive):
    def run(P):
        fleet = _fleet(P, n=2, boot_s=0.2, max_count=8)
        fleet.estimate_capacity(50.0, n_queries=200)
        # a peak above the fleet's capacity and a trough well below it:
        # scale-outs on utilization and p95, scale-ins on utilization
        tr = P.cluster.DiurnalTraffic(base_qps=0.7 * fleet.total_capacity(), amplitude=0.8,
                                      period_s=2.0)
        times, sizes = tr.generate(np.random.default_rng(3), 2.0)
        scaler = (P.cluster.PredictiveAutoscaler(sla_ms=50.0, cooldown_windows=0,
                                                 traffic=tr, lead_s=0.4)
                  if predictive else P.cluster.Autoscaler(sla_ms=50.0, cooldown_windows=0))
        return _drive(P, times, sizes, fleet, "least_outstanding", window_s=0.2,
                      autoscaler=scaler)
    return run


def _case_self_heal(P):
    times, sizes = _trace(P, n=300, qps=800.0)
    faults = P.cluster.FleetFaults(kills=(P.cluster.NodeKill(0.1, "sky", 0),))
    return _drive(P, times, sizes, _fleet(P, n=2, boot_s=0.1), window_s=0.05,
                  fleet_faults=faults,
                  self_heal=P.cluster.SelfHealPolicy(backoff_s=0.0, terminate_idle=True))


def _case_cache(P):
    rng = np.random.default_rng(5)
    pop = P.qg.PopularityDist(kind="zipf", alpha=1.1, catalog=200)
    traffic = P.cluster.StationaryTraffic(600.0)
    times, sizes, keys = traffic.generate_keyed(rng, 1.0, popularity=pop)
    cache = P.cluster.FleetCache(P.cluster.CacheConfig(capacity=64, ttl_s=100.0,
                                                       hit_latency_s=1e-3))
    return _drive(P, times, sizes, _fleet(P), window_s=0.1, cache=cache, query_keys=keys,
                  telemetry=True)


def _case_offload(P):
    times, sizes = _trace(P, n=600, qps=3000.0, seed=4)
    return _drive(P, times, sizes, _fleet(P, n=2, accel=True),
                  window_s=float(times[-1]) / 10, telemetry=True,
                  offload_tuning=P.cluster.OffloadTuning(sla_ms=1.0))


def _case_slo(P):
    fleet = _fleet(P, n=2, max_count=8)
    fleet.estimate_capacity(50.0, n_queries=200)
    tr = P.cluster.BurstyTraffic(base_qps=500.0, burst_mult=4.0, bursts=((0.6, 0.4),))
    times, sizes = tr.generate(np.random.default_rng(11), 1.6)
    slo = P.obs.SloEngine(P.obs.SloObjective("p95", latency_ms=30.0),
                          rules=(P.obs.BurnRateRule(2, 1, 1.0),))
    pol = P.cluster.DiagnosisPolicy(P.cluster.Autoscaler(
        sla_ms=30.0, cooldown_windows=0, signal=P.cluster.TelemetrySignal()))
    return _drive(P, times, sizes, fleet, "least_outstanding", window_s=0.2,
                  telemetry=True, slo=slo, autoscaler=pol)


def _case_grouped(grouped):
    def run(P):
        times, sizes = _trace(P, n=500, qps=1200.0, seed=9)
        return _drive(P, times, sizes, _fleet(P, n=4), "hetero", window_s=0.05,
                      telemetry=True, grouped=grouped)
    return run


CASES = {
    **{f"router_{n}": _case_router(n)
       for n in ("round_robin", "least_outstanding", "size_aware", "hetero")},
    "hetero_affinity": _case_hetero_affinity,
    **{f"traffic_{k}": _case_traffic(k)
       for k in ("stationary", "diurnal", "bursty", "multitenant")},
    "kill_reroute": _case_kill(True),
    "kill_drop": _case_kill(False),
    "autoscaler_reactive": _case_autoscaler(False),
    "autoscaler_predictive": _case_autoscaler(True),
    "self_heal": _case_self_heal,
    "cache_zipf": _case_cache,
    "offload_tuning": _case_offload,
    "telemetry_slo_diagnosis": _case_slo,
    "grouped": _case_grouped(None),
    "per_node_windows": _case_grouped(False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_drive_fleet_equals_the_reference(case):
    got, got_nodes = CASES[case](PORT)
    want, want_nodes = CASES[case](REF)
    assert _result(got) == _result(want)
    assert _records(got_nodes) == _records(want_nodes)
    assert got.n_queries > 0


def test_every_case_exercises_what_it_names():
    """The cases are not vacuous: kills re-route or drop, scalers scale,
    the cache hits, the controller moves the threshold, the SLO engine
    diagnoses, self-healing restarts the node."""
    res = {c: CASES[c](PORT)[0] for c in ("kill_reroute", "kill_drop", "autoscaler_reactive",
                                          "autoscaler_predictive", "self_heal", "cache_zipf",
                                          "offload_tuning", "telemetry_slo_diagnosis")}
    assert res["kill_reroute"].rerouted > 0 and res["kill_drop"].dropped > 0
    assert {(e.reason, e.delta > 0) for e in res["autoscaler_reactive"].events} >= \
        {("util", True), ("util", False), ("p95", True)}
    assert any(e.reason == "forecast" for e in res["autoscaler_predictive"].events)
    states = [e.state.name for e in res["self_heal"].lifecycle if e.index_in_pool == 0]
    assert states[states.index("DEAD") + 1:][:2] == ["BOOTING", "SERVING"]
    assert res["cache_zipf"].cache_hits > 0
    moved = {int(w.metrics[k]) for w in res["offload_tuning"].telemetry.timeline.windows
             for k in w.metrics if k.startswith("offload_threshold")}
    assert moved - {150}
    slo = res["telemetry_slo_diagnosis"].slo
    assert slo.alerts and slo.diagnoses


def test_simulate_fleet_and_cluster_max_qps_equal_the_reference():
    for P in (PORT, REF):
        P.fleet = _fleet(P, n=2)
        P.times, P.sizes = _trace(P, n=300, qps=500.0)
    for kw in ({}, {"window_s": 0.1}, {"window_s": 0.1, "telemetry": True}):
        got = cluster.simulate_fleet(PORT.times, PORT.sizes, PORT.fleet,
                                     cluster.make_router("size_aware"), **kw)
        want = jax_cluster.simulate_fleet(REF.times, REF.sizes, REF.fleet,
                                          jax_cluster.make_router("size_aware"), **kw)
        assert _result(got) == _result(want)
    got = cluster.cluster_max_qps(PORT.fleet, cluster.make_router("hetero"), 50.0,
                                  n_queries=300, iters=5)
    want = jax_cluster.cluster_max_qps(REF.fleet, jax_cluster.make_router("hetero"), 50.0,
                                       n_queries=300, iters=5)
    assert got == want and got > 0
    est = [[p.qps_capacity for p in P.fleet.estimate_capacity(50.0, n_queries=200).pools]
           for P in (PORT, REF)]
    assert est[0] == est[1]


# ------------------------------------------------------------ live, CPU


def _tiny_apply(batch):
    return batch["x"] @ torch.full((4, 2), 0.5)


def _make_batch(size, model_id):
    return {"x": np.ones((size, 4), np.float32)}


def _canned(pkg=cluster):
    return pkg.BucketedDeviceModel(np.array([1, 2, 4, 8, 16, 32, 64]), np.full(7, 2e-4))


def _live_backend(clock, index_in_pool=0):
    rt = ServingRuntime(_tiny_apply, n_workers=1, batch_size=16, max_bucket=64, device="cpu")
    spec = cluster.NodeSpec(cpu=_canned(), n_executors=1, batch_size=16,
                            request_overhead_s=0.0)
    return cluster.LiveNodeBackend(rt, _make_batch, spec=spec, pool="live",
                                   index_in_pool=index_in_pool, weight=100.0,
                                   clock=clock, own_runtime=True)


def test_live_backend_completes_trace_in_trace_time():
    times = np.linspace(0.0, 0.3, 30)
    sizes = np.full(30, 20, np.int64)              # 2 requests each
    mids = (np.arange(30) % 2).astype(np.int64)
    clock = cluster.WallClock()
    backends = [_live_backend(clock, index_in_pool=i) for i in range(2)]
    try:
        r = cluster.drive_fleet(times, sizes, backends, cluster.make_router("round_robin"),
                                model_ids=mids, telemetry=True)
        assert r.n_queries == 30 and r.dropped == 0 and r.errors == 0
        assert r.p95_ms > 0 and set(r.per_model) == {0, 1}
        recs = [rec for b in backends for rec in b.completed_records()]
        assert sorted(rec.index for rec in recs) == list(range(30))
        for rec in recs:                           # trace-time coordinates
            assert 0.0 <= rec.t_arrival <= rec.t_exec_start <= rec.t_done < 30.0
        rep = r.telemetry.attribution()
        assert all(p.reconciles(0.05) for p in rep.percentiles)
    finally:
        for b in backends:
            b.close()


def test_routers_decide_alike_on_sim_and_live_backends():
    times, sizes = _trace(PORT, n=150, qps=300.0)
    spec = cluster.NodeSpec(cpu=_canned(), n_executors=1, batch_size=16,
                            request_overhead_s=0.0)
    sim_nodes = [cluster.SimNodeBackend(NodeView("live", i, spec, 100.0)) for i in range(2)]
    clock = cluster.WallClock()
    live_nodes = [_live_backend(clock, index_in_pool=i) for i in range(2)]
    try:
        for name in ("round_robin", "least_outstanding", "size_aware", "hetero"):
            np.testing.assert_array_equal(cluster.make_router(name).assign(times, sizes, sim_nodes),
                                          cluster.make_router(name).assign(times, sizes, live_nodes))
    finally:
        for b in live_nodes:
            b.close()


def test_errored_live_queries_count_as_dropped():
    def apply_fn(batch):
        if batch["x"].shape[0] >= 16:              # the bucket of the size-12 query
            raise RuntimeError("boom")
        return batch["x"].sum()

    rt = ServingRuntime(apply_fn, n_workers=1, batch_size=16, max_bucket=64, device="cpu")
    spec = cluster.NodeSpec(cpu=_canned(), n_executors=1, batch_size=16, request_overhead_s=0.0)
    b = cluster.LiveNodeBackend(rt, _make_batch, spec=spec, clock=cluster.WallClock(),
                                own_runtime=True)
    try:
        r = cluster.drive_fleet(np.linspace(0.0, 0.1, 6), np.array([4, 4, 12, 4, 4, 4]),
                                [b], cluster.make_router("round_robin"))
        assert (r.errors, r.dropped, r.n_queries) == (1, 1, 5)
        assert not r.meets(1e9)
    finally:
        b.close()


def test_live_node_on_the_cpu_with_a_canned_curve_serves_a_trace():
    node = cluster.live_node(_tiny_apply, _make_batch, pool="cpu", device=_canned(),
                             batch_size=16, max_bucket=64, torch_device="cpu")
    try:
        assert node.rt.device == torch.device("cpu")
        assert node.spec.request_overhead_s == 0.0 and node.spec.batch_size == 16
        times, sizes = _trace(PORT, n=40, qps=200.0)
        r = cluster.drive_fleet(times, np.minimum(sizes, 64), [node],
                                cluster.make_router("round_robin"))
        assert r.n_queries == 40 and r.errors == 0 and r.dropped == 0
    finally:
        node.close()


def test_calibrate_device_on_the_cpu_is_positive_and_monotone():
    w = torch.randn(32, 32, generator=torch.Generator().manual_seed(0))

    def apply_fn(batch):
        return torch.tanh(batch["x"] @ w) @ w

    def make_batch(size, model_id):
        return {"x": np.ones((size, 32), np.float32)}

    curve = cluster.calibrate_device(apply_fn, make_batch, max_bucket=16, burst=4, reps=2,
                                     torch_device="cpu")
    assert curve.buckets.tolist() == [1, 2, 4, 8, 16]
    assert np.all(curve.seconds > 0) and np.all(np.diff(curve.seconds) >= 0)


def test_bucketed_device_model_equals_the_reference():
    buckets = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
    secs = [1e-3 * (1 + 0.01 * b) for b in buckets]
    port = cluster.BucketedDeviceModel(buckets, secs)
    ref = jax_cluster.BucketedDeviceModel(buckets, secs)
    probe = np.array([0, 1, 2, 3, 5, 64, 65, 257, 700, 1000, 1024, 1025, 4096])
    assert [port.latency(int(b)) for b in probe] == [ref.latency(int(b)) for b in probe]
    assert np.array_equal(port.latency_batch(probe), ref.latency_batch(probe))
    assert port.latency(700) == secs[-1]               # 700 items pad to the 1,024 step
    assert port.latency(4096) == secs[-1]              # past the ladder: clamped


def test_live_entry_points_raise_without_cuda_when_no_device_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cluster.calibrate_device(_tiny_apply, _make_batch, max_bucket=4)
    with pytest.raises(RuntimeError):
        cluster.live_node(_tiny_apply, _make_batch, pool="card", device=_canned(),
                          max_bucket=64)
