"""Fleet-level serving on a shared timeline, generic over node backends.

The windowed driver ``drive_fleet`` advances every node through the same
trace via the ``NodeBackend`` contract (``cluster.backend``): routers
assign each traffic window across the node list, each node accepts its
queries with ``submit``, and the driver folds completions into fleet-wide
latencies.  The driver is engine-agnostic — the same loop runs

  * ``SimNodeBackend``s (the numpy fast engine: ``core.simulator
    .node_pass`` carrying executor free-times across windows — and, when
    every active node is simulated, the fleet-vectorized grouped path:
    ONE ``submit_grouped``/``node_pass_many`` advance per window instead
    of N per-node calls, which is what keeps 1k-node fleets and
    ``cluster_max_qps`` searches interactive), and
  * ``LiveNodeBackend``s (``cluster.live``: real ``ServingRuntime``
    instances executing PyTorch models, on the card or the host CPU, paced
    on the wall clock) —

which is what lets ``chip_smoke.py``'s ``live`` phase push one trace
through both and compare simulated against measured tail latency.  When
faults/contention are enabled ``simulate_fleet`` falls back to the
event-driven reference per node (``event_done_times``) and merges
per-query latencies — node-local percentiles don't compose, latencies do.

Node *membership* — who exists, who is booting, who is draining, who
died — is owned by ``cluster.lifecycle.FleetController``; the driver only
routes windows across the controller's SERVING nodes and re-routes the
queries a killed node surrenders (``NodeBackend.cancel_pending``).

Entry points:
  * ``drive_fleet(times, sizes, backends, router, ...)`` — the shared
    windowed loop over any backend kind; optional ``window_s`` +
    ``Autoscaler`` (with a fleet ledger + backend factory) turn it into a
    resizing loop billed in node-hours, and ``fleet_faults`` kills whole
    nodes mid-run.
  * ``simulate_fleet(times, sizes, fleet, router, ...)`` — the simulated
    fleet: builds ``SimNodeBackend``s from the fleet and runs
    ``drive_fleet`` (or the event engine when faults/contention are on).
  * ``cluster_max_qps(fleet, router, sla_ms, ...)`` — the paper's y-axis
    lifted to the cluster: largest stationary arrival rate whose fleet-wide
    p95 meets the SLA (same trace-rescaling bracket + bisection as the
    per-node search).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.cluster.autoscaler import Autoscaler, ScalingEvent
from repro_torch.cluster.backend import (BackendDied, NodeBackend, SimNodeBackend,
                                         grouped_eligible, submit_grouped)
from repro_torch.cluster.cache import CacheConfig, FleetCache
from repro_torch.cluster.fleet import Fleet
from repro_torch.cluster.lifecycle import (FleetController, FleetFaults,
                                           LifecycleEvent, NodeState,
                                           SelfHealPolicy)
from repro_torch.cluster.router import Router
from repro_torch.core.latency_model import ContentionModel
from repro_torch.core.query_gen import (PRODUCTION, PopularityDist, SizeDist,
                                        keyed_sizes, queries_from_arrays,
                                        rescale_trace, sample_trace)
from repro_torch.core.scheduler import THRESHOLD_LADDER
from repro_torch.core.simulator import (SUSTAIN_FRACTION, FaultConfig,
                                        _fast_eligible, bracket_bisect,
                                        event_done_times, latency_percentiles_ms,
                                        warm_bracket)
from repro_torch.obs import (FleetTimeline, MetricsRegistry, RunTelemetry,
                             SpanTable, observe_fanout)
from repro_torch.serve.runtime import OffloadController


@dataclasses.dataclass(frozen=True)
class OffloadTuning:
    """Enable the per-node online offload-threshold controller in
    ``drive_fleet``: each accelerator node gets an
    :class:`~repro_torch.serve.runtime.OffloadController` stepped once per
    window from the telemetry registry's p99-by-component — the node's
    window e2e p99 plus the CPU-path vs accel-path queueing p99s
    (``node_queue_cpu_ms``/``node_queue_acc_ms``, folded by the driver
    from span exec-starts split at the node's *current* threshold).
    Requires ``telemetry=True`` and ``window_s``; threshold writes go
    through ``NodeBackend.set_offload_threshold`` so they take effect on
    the next submitted window in every engine."""
    sla_ms: float
    ladder: tuple = THRESHOLD_LADDER
    relax_frac: float = 0.6


@dataclasses.dataclass
class PoolStats:
    n_nodes: int
    n_queries: int
    p95_ms: float


@dataclasses.dataclass
class ModelStats:
    """Per-tenant latency summary (``model_ids`` labeled traffic)."""
    n_queries: int
    p95_ms: float


@dataclasses.dataclass
class ClusterResult:
    qps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    n_queries: int
    dropped: int
    n_nodes: int                      # fleet size at the end of the run
    node_hours: float
    per_pool: dict[str, PoolStats]
    events: list[ScalingEvent] = dataclasses.field(default_factory=list)
    # fast path: one row per window, (t_start_s, offered_qps, n_nodes,
    # p95_ms, width_s, ctl_s) — the last window's width is the truncated
    # remainder, not window_s; ctl_s is the *wall* seconds the driver
    # spent in control work (lifecycle + routing + submits) before
    # releasing the window, the driver-stall metric a synchronous node
    # spawn or an unbounded RPC would inflate; empty in events mode
    # (faults/contention), which is unwindowed
    timeline: list[tuple] = dataclasses.field(default_factory=list)
    # per-model-id latency breakdown when the trace carries tenant labels
    per_model: dict[int, ModelStats] = dataclasses.field(default_factory=dict)
    # live only: apply_fn failures; errored queries also count as dropped
    # (they were not actually served)
    errors: int = 0
    # fleet-fault accounting: queries a killed node surrendered that were
    # re-submitted to survivors (with reroute=False they count as dropped)
    rerouted: int = 0
    # node state transitions (BOOTING/SERVING/DRAINING/DEAD) on the trace
    # timeline, from the lifecycle controller
    lifecycle: list[LifecycleEvent] = dataclasses.field(default_factory=list)
    # per-node apply_fn failure counts ("pool[idx]" → count), first-class
    # regardless of the telemetry switch — `errors` is their sum
    errors_by_node: dict[str, int] = dataclasses.field(default_factory=dict)
    # drive_fleet(telemetry=True): spans + metrics registry + per-window
    # timeline (repro_torch.obs.RunTelemetry); None with the kill switch off
    telemetry: RunTelemetry | None = None
    # fleet-front result cache accounting (drive_fleet(cache=...)); hits
    # complete without touching a node and count toward qps/percentiles
    # under the "cache" pool label
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    # drive_fleet(slo=...): the run's SloEngine, carrying alerts,
    # diagnoses, control actions and stitched incidents (repro_torch.obs.slo);
    # repro_torch.obs.export serializes it
    slo: object | None = None

    @property
    def cache_hit_rate(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 0.0

    @property
    def error_rate(self) -> float:
        """Errored fraction of the offered trace (errors also count as
        dropped — an errored query was never actually served)."""
        total = self.n_queries + self.dropped
        return self.errors / total if total else 0.0

    def meets(self, sla_ms: float) -> bool:
        return self.p95_ms <= sla_ms and self.dropped == 0

    def sla_violation_minutes(self, sla_ms: float) -> float:
        """Window-minutes the fleet spent above the SLA — the per-window
        p95 rows of ``timeline`` weighted by each window's width.  The
        resilience benchmark's comparison axis for predictive-vs-reactive
        scaling (a run-wide p95 hides *when* the fleet was late)."""
        return sum(row[4] for row in self.timeline
                   if row[3] > sla_ms) / 60.0

    def driver_stall_s(self) -> list[float]:
        """Per-window wall-clock seconds of driver control work (the
        ``ctl_s`` timeline column) — the chaos benchmark's zero-stall
        gate reads its max/p95 against the window width."""
        return [row[5] for row in self.timeline if len(row) > 5]


def _result(times: np.ndarray, done: np.ndarray, pool_of: np.ndarray,
            pool_counts: dict[str, int], n_nodes: int, node_hours: float,
            events: list, timeline: list,
            model_ids: np.ndarray | None = None,
            errors: int = 0, rerouted: int = 0,
            lifecycle: list | None = None,
            errors_by_node: dict[str, int] | None = None,
            telemetry: RunTelemetry | None = None,
            cache_stats: dict[str, int] | None = None,
            slo=None) -> ClusterResult:
    cs = cache_stats or {}
    completed = ~np.isnan(done)
    n_done = int(completed.sum())
    per_pool = {}
    for name, count in pool_counts.items():
        sel = (pool_of == name) & completed
        per_pool[name] = PoolStats(
            n_nodes=count, n_queries=int((pool_of == name).sum()),
            p95_ms=float(np.percentile(done[sel] - times[sel], 95) * 1e3)
            if sel.any() else 0.0)
    per_model: dict[int, ModelStats] = {}
    if model_ids is not None and len(times):
        for m in np.unique(model_ids):
            sel = (model_ids == m) & completed
            per_model[int(m)] = ModelStats(
                n_queries=int((model_ids == m).sum()),
                p95_ms=float(np.percentile(done[sel] - times[sel], 95) * 1e3)
                if sel.any() else 0.0)
    if n_done == 0:
        return ClusterResult(0, 0, 0, 0, 0, 0, len(times), n_nodes,
                             node_hours, per_pool, events, timeline,
                             per_model, errors, rerouted, lifecycle or [],
                             errors_by_node or {}, telemetry,
                             cs.get("hits", 0), cs.get("misses", 0),
                             cs.get("evictions", 0), slo)
    lats = done[completed] - times[completed]
    dur = float(done[completed].max()) - float(times[0])
    p50, p95, p99, mean = latency_percentiles_ms(lats)
    return ClusterResult(
        qps=n_done / max(dur, 1e-12),
        p50_ms=p50, p95_ms=p95, p99_ms=p99, mean_ms=mean,
        n_queries=n_done, dropped=len(times) - n_done,
        n_nodes=n_nodes, node_hours=node_hours,
        per_pool=per_pool, events=events, timeline=timeline,
        per_model=per_model, errors=errors, rerouted=rerouted,
        lifecycle=lifecycle or [], errors_by_node=errors_by_node or {},
        telemetry=telemetry, cache_hits=cs.get("hits", 0),
        cache_misses=cs.get("misses", 0),
        cache_evictions=cs.get("evictions", 0), slo=slo)


def _window_grid(times: np.ndarray, window_s: float | None
                 ) -> tuple[float, float, float, int]:
    """(t_start, horizon, window_s, n_windows) — the window grid starts at
    the first arrival and node-hours are billed over the arrival span
    [times[0], times[-1]], matching the events path and never iterating
    phantom windows for a shifted trace."""
    n = len(times)
    t_start = float(times[0]) if n else 0.0
    horizon = float(times[-1]) if n else 0.0
    span = horizon - t_start
    if window_s is None or window_s >= span:
        # no epsilon: an exact-multiple span must not grow a phantom
        # empty window (the last window is inclusive of t == horizon)
        return t_start, horizon, max(span, 1e-9), 1
    return t_start, horizon, window_s, int(np.ceil(span / window_s))


def drive_fleet(times: np.ndarray, sizes: np.ndarray,
                backends: list[NodeBackend] | None, router: Router, *,
                window_s: float | None = None,
                autoscaler: Autoscaler | None = None,
                fleet: Fleet | None = None,
                factory=None,
                model_ids: np.ndarray | None = None,
                fleet_faults: FleetFaults | None = None,
                self_heal: SelfHealPolicy | None = None,
                drain_timeout: float = 120.0,
                telemetry: bool = False,
                grouped: bool | None = None,
                cache: FleetCache | None = None,
                query_keys: np.ndarray | None = None,
                offload_tuning: OffloadTuning | None = None,
                slo=None
                ) -> ClusterResult:
    """Run one trace through a fleet of node backends.  ``times`` must be
    sorted; ``model_ids`` (optional) labels each query with its tenant and
    is threaded through both the router and ``NodeBackend.submit``.

    Node *membership* is owned by a :class:`~repro_torch.cluster.lifecycle
    .FleetController`: the driver routes each window only across the
    controller's SERVING nodes, so booting nodes (``NodeSpec.boot_s``),
    draining nodes (autoscaler removals finishing their assigned work),
    and killed nodes (``fleet_faults``) are invisible to every routing
    policy.  When a :class:`FleetFaults` kill lands, the dead backend's
    ``cancel_pending`` hook surrenders its unfinished queries and the
    driver re-routes them to the survivors at the detection boundary
    (latency still measured from the original arrival); with
    ``reroute=False`` they are dropped instead.  A backend that dies
    *unplanned* — ``submit``/poll raising :class:`BackendDied`, or the
    controller's per-window health probe — is retired the same way, and
    a :class:`SelfHealPolicy` (``self_heal=``) additionally restarts it
    through BOOTING under a crash-loop budget and terminates DRAINING
    nodes once idle.

    Two ways to name the fleet:

      * ``backends`` — an explicit node list (the live tier: already-built
        ``LiveNodeBackend``s; autoscaling and fault restarts unavailable
        without a ledger/factory);
      * ``fleet`` + ``factory`` — a :class:`Fleet` ledger plus
        ``factory(view, t0) -> NodeBackend``; nodes are materialized
        lazily per window, which is what lets an :class:`Autoscaler`
        (mutating the ledger at window boundaries) order new nodes —
        BOOTING until their ``boot_s`` elapses — and retire removed ones
        after their assigned work completes.

    Simulated backends return completion times from ``submit`` and the
    loop runs in virtual time; realtime backends (``realtime = True``)
    return ``None``, the driver blocks at each window boundary
    (``advance_to``) while the wall clock catches up, and completions are
    collected from ``completed_records`` after a final drain.  Mixed
    fleets are rejected — one timeline cannot be both virtual and real.

    ``telemetry=True`` attaches a :class:`repro_torch.obs.RunTelemetry` to the
    result: per-query spans (stage stamps from whichever engine served
    each query, re-route/RPC-retry annotations from the driver), a
    metrics registry (per-node / per-model streaming-quantile latency,
    error and re-route counters), and a per-window :class:`FleetTimeline`
    of registry snapshots.  Off (the default) the driver does no span or
    registry work at all — today's behavior, at today's cost.

    ``grouped`` controls the fleet-vectorized window submit: when every
    active node is a plain ``SimNodeBackend``, a window is advanced in
    ONE batched numpy pass (``cluster.backend.submit_grouped`` over
    ``core.simulator.node_pass_many``) instead of N per-node ``submit``
    calls, including a single vectorized telemetry fold — per-query
    results are identical either way (the equivalence tests pin this).
    ``None``/``True`` (default) use it whenever eligible; ``False``
    forces the per-node loop (the ``fleet_speed`` benchmark's baseline).
    The driver falls back to per-node automatically for live/remote
    fleets, single-node windows, and any window where a kill landed
    (orphan re-routes and mid-submit deaths take the per-node path,
    keeping the faults machinery exactly as exercised before).

    ``cache`` + ``query_keys`` put a fleet-front result cache ahead of
    the router: each window's queries are looked up by their popularity
    key (``Traffic.generate_keyed``; key −1 never hits) and hits
    complete analytically at ``arrival + hit_latency_s`` without
    touching a node (pool label ``"cache"``, excluded from per-pool
    stats but counted in qps/percentiles); only the misses are routed.
    Completed misses are committed back at their completion times —
    within a window, repeats of an uncommitted key are misses (no
    request coalescing).  With telemetry on, hits get a ``cache`` span
    component (attribution stays closed) and hit/miss/eviction counters
    plus a per-window ``cache_hit_rate`` gauge stream into the registry.
    A single-window run (``window_s=None``) commits results only after
    the trace ends, so it observes no hits — pass a window to let
    results become answerable mid-trace.

    ``offload_tuning`` (:class:`OffloadTuning`, needs ``telemetry=True``
    and ``window_s``) runs the online offload-threshold controller
    per accelerator node: the driver folds each window's queueing delay
    into per-node CPU-path vs accel-path histograms (split at the
    node's current threshold) and steps a hill climb on the
    ``THRESHOLD_LADDER`` rungs from the window's p99s — the
    telemetry-driven closing of paper Fig. 10's static per-node tuning.

    ``slo`` (a :class:`repro_torch.obs.SloEngine`, needs ``window_s``; implies
    ``telemetry=True``) turns the run into an SLO-governed one: at every
    boundary the driver folds the window's span components into
    ``span_*_ms`` registry histograms (re-routed queries' latency enters
    the window sketches from their *original* arrival, so fault recovery
    is visible to the registry even though the scalar window p95 cannot
    represent it), hands the frozen snapshot to ``slo.on_window`` (burn
    rate, alert fire/clear, breach diagnosis), and — when the
    ``autoscaler`` has an ``inform`` hook (``DiagnosisPolicy``) — passes
    the diagnoses in before the scaling decision, stitching the policy's
    ``ControlAction``s into the engine's incident log.  At end of run the
    engine is finalized against the span table (per-incident
    attribution) and attached as ``ClusterResult.slo``.

    All three layers are pure opt-in: with ``cache=None``,
    ``offload_tuning=None`` and ``slo=None`` every hot-loop branch is
    untaken and the grouped fast path is bit-identical to before.
    """
    times = np.asarray(times, float)
    sizes = np.asarray(sizes, np.int64)
    if len(times) and np.any(np.diff(times) < 0):
        raise ValueError("times must be sorted (routers and the per-node "
                         "FCFS advance assume arrival order)")
    if autoscaler is not None:
        if window_s is None:
            raise ValueError("autoscaling requires window_s — scaling "
                             "happens at window boundaries, and a "
                             "single-window run would only observe after "
                             "all queries completed")
        if fleet is None or factory is None:
            raise ValueError("autoscaling resizes the fleet between "
                             "windows — pass the fleet ledger and a "
                             "backend factory(view, t0)")
        autoscaler.reset()
    if cache is not None:
        if query_keys is None:
            raise ValueError("cache needs query_keys — per-query "
                             "popularity keys aligned with the trace "
                             "(Traffic.generate_keyed); without them no "
                             "query can ever repeat")
        query_keys = np.asarray(query_keys, np.int64)
        if len(query_keys) != len(times):
            raise ValueError(f"query_keys misaligned with trace: "
                             f"{len(query_keys)} keys for {len(times)} "
                             f"queries")
    if offload_tuning is not None and (not telemetry or window_s is None):
        raise ValueError("offload_tuning is telemetry-driven — the "
                         "controller reads per-window p99-by-component "
                         "from the metrics registry, so it needs "
                         "telemetry=True and window_s")
    if slo is not None:
        if window_s is None:
            raise ValueError("slo evaluation is per-window — burn rates, "
                             "alerting and diagnosis all consume window "
                             "snapshots, so pass window_s")
        telemetry = True             # the engine reads the registry
        slo.reset()
    if (fleet_faults is not None and fleet_faults.kills
            and window_s is None):
        raise ValueError("fleet_faults kills need window_s — kills are "
                         "detected at window boundaries, and a single-"
                         "window run would only notice after the trace "
                         "ended (every orphan dropped, nothing re-routed)")
    if fleet is not None and fleet_faults is not None and fleet_faults.kills:
        # kills are written back to pool membership (ledger-owned node
        # identity): run them against a copy so back-to-back runs on the
        # caller's fleet stay fair.  Autoscaler-only mutations keep the
        # long-standing contract — the caller sees the final ledger.
        fleet = fleet.copy()
    controller = FleetController(fleet=fleet, factory=factory,
                                 backends=backends, faults=fleet_faults,
                                 heal=self_heal)
    router.reset()
    n = len(times)
    done = np.full(n, np.nan)
    pool_of = np.empty(n, object)
    t_start, horizon, window_s, n_windows = _window_grid(times, window_s)
    controller.start(t_start)
    node_hours = 0.0
    rerouted = 0
    timeline: list[tuple] = []
    errors_by_node: dict[str, int] = {}

    tel: RunTelemetry | None = None
    if telemetry:
        tel = RunTelemetry(spans=SpanTable(times),
                           registry=MetricsRegistry(),
                           timeline=FleetTimeline())
        span_on: set[tuple] = set()       # backends told to produce spans
        retry_seen: dict[tuple, int] = {}  # per-node retry_count cursor
        node_hist: dict[tuple, object] = {}  # hot-path histogram cache
        fleet_hist = tel.registry.histogram("fleet_latency_ms")
    if slo is not None:
        # per-window span-component histograms the SLO engine reads —
        # folded only when an engine is attached so slo=None runs stay
        # bit-identical (no extra registry traffic)
        slo_q = tel.registry.histogram("span_queueing_ms")
        slo_s = tel.registry.histogram("span_service_ms")
    if autoscaler is not None and tel is not None:
        # registry-backed scaling signal: bind the run's telemetry
        sig = getattr(autoscaler, "signal", None)
        if sig is not None and getattr(sig, "telemetry", None) is None:
            sig.bind(tel)

    def _node_name(b) -> str:
        return f"{b.pool}[{b.index_in_pool}]"

    def _tel_retry(b, sel_idx):
        """Drain a backend's accumulated RPC retry stall into the span
        table (attributed to the queries whose exchange stalled) and the
        fleet counters; ``sel_idx=None`` books fleet counters only (poll
        retries delay monitoring, not a specific query's submit)."""
        take = getattr(b, "take_retry_s", None)
        if take is None:
            return
        s = take()
        if s > 0.0:
            if sel_idx is not None:
                tel.spans.add_retry(sel_idx, s)
                if slo is not None:
                    # every query in the frame shared the stall
                    tel.registry.histogram("span_retry_ms").observe_many(
                        np.full(len(sel_idx), s * 1e3))
            tel.registry.counter("rpc_retry_seconds").inc(s)
        rc = getattr(b, "retry_count", 0)
        d = rc - retry_seen.get(b.key, 0)
        if d:
            tel.registry.counter("rpc_retries").inc(d)
            retry_seen[b.key] = rc

    tune = offload_tuning
    tuners: dict[tuple, OffloadController] = {}
    offl = [0, 0]                  # per-window (offloaded, submitted)
    cache_prev = {"hits": 0, "misses": 0, "evictions": 0}
    n_acts_seen = [0]              # policy ControlActions already stitched

    def _thr(b) -> float:
        t = b.spec.offload_threshold
        return float(t) if (t is not None and b.spec.accel is not None) \
            else np.inf

    def _tune_fold(active, assign, wt, ws, starts):
        """Grouped-window queueing-by-path fold: split each query's
        executor queueing delay (exec_start − arrival; the analytic
        engine releases on arrival) at its node's *current* threshold
        and stream both paths into per-node window histograms — the
        component percentiles the controller consumes."""
        thr = np.fromiter((_thr(b) for b in active), float, len(active))
        off = ws >= thr[assign]
        q = np.subtract(starts, wt)
        q *= 1e3
        offl[0] += int(off.sum())
        offl[1] += len(ws)
        if off.any():
            tel.registry.observe_grouped(
                "node_queue_acc_ms", "node", assign[off], q[off],
                fmt=lambda i: _node_name(active[int(i)]))
        if not off.all():
            tel.registry.observe_grouped(
                "node_queue_cpu_ms", "node", assign[~off], q[~off],
                fmt=lambda i: _node_name(active[int(i)]))

    def _tune_fold_node(b, t_arr, s_arr, starts):
        """Per-node-path variant of ``_tune_fold`` for one backend's
        window slice (sim per-node loop)."""
        off = s_arr >= _thr(b)
        q = np.subtract(starts, t_arr)
        q *= 1e3
        offl[0] += int(off.sum())
        offl[1] += len(s_arr)
        name = _node_name(b)
        if off.any():
            tel.registry.histogram(
                "node_queue_acc_ms", node=name).observe_many(q[off])
        if not off.all():
            tel.registry.histogram(
                "node_queue_cpu_ms", node=name).observe_many(q[~off])

    def _tune_step(active):
        """One controller decision per accelerator node per window, fed
        by the window sketches — read here, *before* the timeline
        snapshot steals them."""
        for b in active:
            if b.spec.accel is None:
                continue
            ctl = tuners.get(b.key)
            if ctl is None:
                ctl = tuners[b.key] = OffloadController(
                    sla_ms=tune.sla_ms, threshold=b.spec.offload_threshold,
                    ladder=tune.ladder, relax_frac=tune.relax_frac)
            name = _node_name(b)
            reg = tel.registry
            thr = ctl.step(
                reg.histogram("node_latency_ms",
                              node=name).window.quantile(0.99),
                reg.histogram("node_queue_cpu_ms",
                              node=name).window.quantile(0.99),
                reg.histogram("node_queue_acc_ms",
                              node=name).window.quantile(0.99))
            if thr != b.spec.offload_threshold:
                b.set_offload_threshold(thr)
            reg.gauge("offload_threshold", node=name).set(thr)
        tel.registry.gauge("offload_fraction").set(
            offl[0] / offl[1] if offl[1] else 0.0)
        tel.registry.counter("queries_offloaded").inc(offl[0])
        offl[0] = offl[1] = 0

    use_grouped = grouped is not False
    # grouped-path structures, keyed on the serving list *object* (the
    # controller returns the same cached list while membership is
    # unchanged, so steady-state windows skip every O(nodes) rebuild).
    # Eligibility cannot flip for a given list object: a kill or a
    # membership change always produces a new serving list.
    grp = {"ref": None, "ok": False, "engines": None, "pools": None}
    # did any window go through the per-node submit loop with telemetry
    # on?  Grouped windows stamp the span table inline; only per-node
    # windows leave span stamps behind in backend chunk histories, so a
    # run where every window grouped skips the end-of-run chunk walk
    chunk_spans = [False]
    # the grouped path may drop per-node chunk histories only when the
    # run provably never reads them: no telemetry (span_arrays), no
    # kills/chaos (cancel_pending rolls chunks back), no autoscaler or
    # heal policy (DRAINING's idle probe), and no caller-owned backends
    # (completed_records is public surface on those)
    grp_records = (tel is not None or backends is not None
                   or autoscaler is not None or self_heal is not None
                   or bool(controller.faults.kills)
                   or bool(getattr(controller.faults, "injections", None)))

    def _grouped_parts(active):
        if grp["ref"] is not active:
            grp["ref"] = active
            grp["ok"] = len(active) > 1 and grouped_eligible(active)
            if grp["ok"]:
                grp["engines"] = [b.engine for b in active]
                grp["pools"] = np.array([b.pool for b in active], object)
        return grp

    def _submit(active, assign, gidx, wt, ws, wm, allow_grouped=False,
                obs_t=None):
        """Submit a routed window; a node dying *inside* submit is not a
        driver crash — its share is returned as ``{key: lost global
        indices}`` for the heal/re-route loop.

        With ``allow_grouped`` (the plain-window call site) an all-sim
        node list takes the batched path: one ``submit_grouped`` advance
        plus one vectorized telemetry fold, no per-node Python loop.
        Single-node windows stay per-node — the batched layout only pays
        off across nodes.

        ``obs_t`` (re-route call sites, SLO runs only) overrides the
        arrival times the *registry* observes latency from: re-routed
        queries re-arrive at the boundary but their SLO-visible latency
        runs from the original arrival, so the window sketches see the
        re-route wait the scalar window p95 structurally cannot."""
        if allow_grouped and use_grouped and _grouped_parts(active)["ok"]:
            ret, order, segb, xs = submit_grouped(
                active, assign, gidx, wt, ws, wm,
                engines=grp["engines"], keep_records=grp_records)
            done[gidx] = ret
            pool_of[gidx] = grp["pools"][assign]
            if tel is not None:
                v = np.subtract(ret, wt)
                v *= 1e3
                tel.registry.observe_grouped(
                    "node_latency_ms", "node", assign, v,
                    fmt=lambda i: _node_name(active[int(i)]),
                    also=(fleet_hist,), order=order, bounds=segb)
                if xs is not None:
                    # stamp spans inline (released = arrival for the
                    # analytic engine) — the end-of-run chunk walk only
                    # runs for windows the per-node loop served
                    tel.spans.record_many(gidx, wt, xs, ret)
                    if tune is not None:
                        _tune_fold(active, assign, wt, ws, xs)
                    if slo is not None:
                        q = np.subtract(xs, wt)
                        q *= 1e3
                        slo_q.observe_many(q)
                        sv = np.subtract(ret, xs)
                        sv *= 1e3
                        slo_s.observe_many(sv)
                else:
                    chunk_spans[0] = True
            return {}
        if tel is not None:
            chunk_spans[0] = True
        lost: dict[tuple, np.ndarray] = {}
        for i, b in enumerate(active):
            sel = assign == i
            if not sel.any():
                continue
            st, ssz = wt[sel], ws[sel]
            try:
                ret = b.submit(gidx[sel], st, ssz,
                               wm[sel] if wm is not None else None)
            except BackendDied:
                lost[b.key] = gidx[sel]
                if tel is not None:
                    _tel_retry(b, gidx[sel])
                continue
            if ret is not None:
                done[gidx[sel]] = ret
                pool_of[gidx[sel]] = b.pool
            if tel is not None:
                _tel_retry(b, gidx[sel])
                if ret is not None:
                    # the sketch digest drops NaN itself — no masks here
                    # (per-model folds happen once per window, not per
                    # node: the window monitor owns that dimension).  The
                    # fleet rollup absorbs the *same* digest — fleet-wide
                    # latency is the merge of what the nodes observed,
                    # so the batch is bucketized exactly once
                    h = node_hist.get(b.key)
                    if h is None:
                        h = node_hist[b.key] = tel.registry.histogram(
                            "node_latency_ms", node=_node_name(b))
                    v = np.subtract(ret, obs_t[sel] if obs_t is not None
                                    else st)
                    v *= 1e3
                    observe_fanout(v, h, fleet_hist)
                    if tune is not None or slo is not None:
                        ch = getattr(b, "_chunks", None)
                        starts = ch[-1][5] if ch else None
                        if starts is not None:
                            if tune is not None:
                                _tune_fold_node(b, st, ssz, starts)
                            if slo is not None:
                                q = np.subtract(starts, st)
                                q *= 1e3
                                slo_q.observe_many(q)
                                sv = np.subtract(ret, starts)
                                sv *= 1e3
                                slo_s.observe_many(sv)
        return lost

    for w in range(n_windows):
        w0, w1 = t_start + w * window_s, t_start + (w + 1) * window_s
        idx = np.flatnonzero((times >= w0) & (times < w1 if w < n_windows - 1
                                              else times <= horizon))
        ctl0 = time.perf_counter()
        active, orphans = controller.begin_window(w0)
        if tel is not None:
            for b in active:
                if b.key not in span_on:
                    b.enable_spans()
                    span_on.add(b.key)
        if orphans:
            # a killed node's unfinished queries: void their (analytic)
            # completions, then re-submit to the survivors at the
            # detection boundary — re-routed queries re-arrive at w0 but
            # their latency is still measured from the original arrival
            oidx = np.array([q.index for q in orphans], np.int64)
            done[oidx] = np.nan
            pool_of[oidx] = None
            if controller.faults.reroute and active:
                ot = np.full(len(orphans), w0)
                osz = np.array([q.size for q in orphans], np.int64)
                om = np.array([q.model_id for q in orphans], np.int64) \
                    if model_ids is not None else None
                if tel is not None:
                    tel.spans.mark_reroute(oidx, w0)
                    tel.registry.counter("queries_rerouted").inc(len(oidx))
                    if slo is not None:
                        rr = np.subtract(np.full(len(oidx), w0),
                                         times[oidx])
                        rr *= 1e3
                        tel.registry.histogram(
                            "span_reroute_ms").observe_many(rr)
                lost = _submit(active, router.assign(ot, osz, active,
                                                     model_ids=om),
                               oidx, ot, osz, om,
                               obs_t=times[oidx] if slo is not None
                               else None)
                rerouted += len(orphans)
            else:
                if tel is not None:
                    tel.spans.mark_shed(oidx)
                    if slo is not None:
                        tel.registry.counter("queries_shed").inc(len(oidx))
                lost = {}
        else:
            lost = {}
        width = min(w1, horizon) - w0     # last window may be truncated
        node_hours += controller.billable_n * width / 3600.0
        wt, ws = times[idx], sizes[idx]
        wm = model_ids[idx] if model_ids is not None else None
        midx, mt, msz, mm = idx, wt, ws, wm
        if cache is not None and len(idx):
            hmask = cache.lookup_many(query_keys[idx], wt)
            if hmask.any():
                hidx = idx[hmask]
                hdone = wt[hmask] + cache.cfg.hit_latency_s
                done[hidx] = hdone
                pool_of[hidx] = "cache"
                if tel is not None:
                    tel.spans.mark_cache_hit(hidx, hdone)
                    observe_fanout(
                        np.full(len(hidx), cache.cfg.hit_latency_s * 1e3),
                        fleet_hist)
                    if slo is not None:
                        tel.registry.histogram(
                            "span_cache_ms").observe_many(
                            np.full(len(hidx),
                                    cache.cfg.hit_latency_s * 1e3))
                miss = ~hmask
                midx, mt, msz = idx[miss], wt[miss], ws[miss]
                mm = wm[miss] if wm is not None else None
        if len(active):
            assign = router.assign(mt, msz, active, model_ids=mm)
            # a kill window (orphans just re-routed) stays on the
            # per-node path end to end — the faults machinery is
            # exercised exactly as it was before the grouped path existed
            lost.update(_submit(active, assign, midx, mt, msz, mm,
                                allow_grouped=not orphans))
        # else: no SERVING node this window — queries stay NaN (dropped)
        elif tel is not None and len(midx):
            tel.spans.mark_shed(midx)
            if slo is not None:
                tel.registry.counter("queries_shed").inc(len(midx))
        while lost:
            # mid-submit deaths: retire each victim through the
            # controller (the heal policy decides whether it restarts),
            # then re-route its failed batch plus whatever work it had
            # already accepted to the remaining actives — repeatedly, in
            # case a survivor dies absorbing the re-route
            dead_keys = set(lost)
            resub = {int(g) for sel in lost.values() for g in sel}
            for key in dead_keys:
                for q in controller.node_died(key, w0):
                    done[q.index] = np.nan
                    pool_of[q.index] = None
                    resub.add(q.index)
            active = [b for b in active if b.key not in dead_keys]
            if not controller.faults.reroute or not active or not resub:
                break
            ridx = np.array(sorted(resub), np.int64)
            rt_ = np.maximum(times[ridx], w0)   # orphans re-arrive at w0
            rs_ = sizes[ridx]
            rm_ = model_ids[ridx] if model_ids is not None else None
            rerouted += len(ridx)
            if tel is not None:
                tel.spans.mark_reroute(ridx, rt_)
                tel.registry.counter("queries_rerouted").inc(len(ridx))
                if slo is not None:
                    rr = np.subtract(rt_, times[ridx])
                    rr *= 1e3
                    tel.registry.histogram(
                        "span_reroute_ms").observe_many(rr)
            lost = _submit(active, router.assign(rt_, rs_, active,
                                                 model_ids=rm_),
                           ridx, rt_, rs_, rm_,
                           obs_t=times[ridx] if slo is not None else None)
        if cache is not None and not controller.realtime and len(midx):
            # commit this window's completed misses at their completion
            # times — answerable by later arrivals once fresh_ts <= t
            # (insert_many skips NaN drops itself)
            cache.insert_many(query_keys[midx], done[midx])
        ctl_s = time.perf_counter() - ctl0
        if controller.realtime:
            advancing = controller.advance_targets()
            for b in advancing:
                b.advance_to(w1)
            # window p95 from completions landed so far — queries still in
            # flight at the boundary report in a later window (monitoring
            # semantics; the final result uses the full drained records).
            # take_new_records is O(new completions) per node — a cursor
            # into the runtime's completion log, not a rescan of every
            # record the node ever finished.  A node dying mid-poll is
            # the next boundary's health-pass problem, not this one's.
            lats = []
            ck: list[int] = []
            cd: list[float] = []
            for b in advancing:
                try:
                    recs = b.take_new_records()
                except BackendDied:
                    continue
                node_lats = [r.latency_ms for r in recs if r.error is None]
                lats += node_lats
                if cache is not None:
                    for r in recs:
                        if r.error is None:
                            ck.append(int(query_keys[r.index]))
                            cd.append(r.t_done)
                if tune is not None and recs:
                    thr_b = _thr(b)
                    qcpu: list[float] = []
                    qacc: list[float] = []
                    for r in recs:
                        if r.error is not None or np.isnan(r.t_exec_start):
                            continue
                        rel = r.t_released
                        if np.isnan(rel):
                            rel = r.t_arrival
                        q = (r.t_exec_start - rel) * 1e3
                        (qacc if sizes[r.index] >= thr_b
                         else qcpu).append(q)
                    offl[0] += len(qacc)
                    offl[1] += len(qacc) + len(qcpu)
                    name = _node_name(b)
                    if qacc:
                        tel.registry.histogram(
                            "node_queue_acc_ms",
                            node=name).observe_many(qacc)
                    if qcpu:
                        tel.registry.histogram(
                            "node_queue_cpu_ms",
                            node=name).observe_many(qcpu)
                if slo is not None and recs:
                    qn: list[float] = []
                    sn: list[float] = []
                    for r in recs:
                        if r.error is not None:
                            continue
                        rel = r.t_released
                        if np.isnan(rel):
                            rel = r.t_arrival
                        if not np.isnan(r.t_exec_start):
                            qn.append((r.t_exec_start - rel) * 1e3)
                            sn.append((r.t_done - r.t_exec_start) * 1e3)
                        else:
                            qn.append(0.0)
                            sn.append((r.t_done - rel) * 1e3)
                    if qn:
                        slo_q.observe_many(qn)
                        slo_s.observe_many(sn)
                if tel is not None:
                    if node_lats:
                        observe_fanout(
                            node_lats,
                            tel.registry.histogram(
                                "node_latency_ms", node=_node_name(b)),
                            fleet_hist)
                    for r in recs:
                        if r.error is not None:
                            tel.registry.counter(
                                "node_errors", node=_node_name(b)).inc()
                        elif r.model_id >= 0:
                            tel.registry.histogram(
                                "model_latency_ms",
                                model=str(r.model_id)).observe(r.latency_ms)
                    _tel_retry(b, None)
            if cache is not None and ck:
                cache.insert_many(np.asarray(ck, np.int64), np.asarray(cd))
            p95 = float(np.percentile(lats, 95)) if lats else 0.0
        else:
            wl = done[idx] - times[idx]
            ok = ~np.isnan(wl)
            p95 = float(np.percentile(wl[ok], 95) * 1e3) if ok.any() else 0.0
            if tel is not None and wm is not None and ok.any():
                # fleet_latency_ms already rolled up from the node
                # digests at submit time — only the per-model dimension
                # (e2e, dispatch included) is folded here
                tel.registry.observe_grouped(
                    "model_latency_ms", "model", wm[ok], wl[ok] * 1e3)
        offered = len(idx) / max(width, 1e-9)
        timeline.append((w0, offered, len(active), p95, width, ctl_s))
        if tune is not None:
            _tune_step(active)       # reads window sketches: must run
        if tel is not None:          # before snapshot() steals them
            if cache is not None:
                st = cache.stats()
                for k in ("hits", "misses", "evictions"):
                    d = st[k] - cache_prev[k]
                    if d:
                        tel.registry.counter(f"cache_{k}").inc(d)
                        cache_prev[k] = st[k]
                tel.registry.gauge("cache_hit_rate").set(cache.hit_rate)
                tel.registry.gauge("cache_size").set(st["size"])
            n_boot = controller.state_counts().get(NodeState.BOOTING.name, 0)
            tel.registry.gauge("serving_nodes").set(len(active))
            tel.registry.gauge("booting_nodes").set(n_boot)
            tel.registry.counter("booting_node_seconds").inc(n_boot * width)
            snap = tel.timeline.snapshot(
                tel.registry, w0, width,
                extra={"offered_qps": offered, "n_active": len(active),
                       "p95_ms": p95, "ctl_s": ctl_s})
            if slo is not None:
                # evaluate against the frozen window sketches the
                # snapshot just stole; breach diagnoses feed the scaler
                diags = slo.on_window(snap)
        if autoscaler is not None:
            if slo is not None and hasattr(autoscaler, "inform"):
                autoscaler.inform(diags, booting=n_boot)
            autoscaler.observe(w1, p95, offered, fleet)
            if slo is not None:
                acts = getattr(autoscaler, "actions", None)
                if acts is not None:
                    for a in acts[n_acts_seen[0]:]:
                        slo.record_action(a)   # stitch into the incident
                    n_acts_seen[0] = len(acts)
            controller.reconcile(w1)

    # kills that landed after the last window boundary: no windows remain
    # to re-route in, so their orphans can only drop
    for q in controller.finish(horizon):
        done[q.index] = np.nan
        pool_of[q.index] = None

    errors = 0
    if controller.realtime:
        for b in controller.advance_targets():
            try:
                b.drain(drain_timeout)
            except (TimeoutError, BackendDied):
                # a node that can't finish its drain (hung, or died after
                # the last boundary) is recorded, not fatal: whatever it
                # completed before failing still counts below
                controller.events.append(LifecycleEvent(
                    horizon, b.pool, b.index_in_pool, NodeState.SUSPECT))
        for b in controller.all_created():
            name = _node_name(b)
            for r in b.completed_records():
                if r.error is not None:
                    # a query whose apply_fn failed was not served: count
                    # it dropped (its near-instant "latency" would inflate
                    # measured capacity), surfaced via `errors` and the
                    # per-node breakdown
                    errors += 1
                    errors_by_node[name] = errors_by_node.get(name, 0) + 1
                    continue
                done[r.index] = r.t_done
                pool_of[r.index] = b.pool
                if tel is not None:
                    tel.spans.record(r.index, r.t_released, r.t_exec_start,
                                     r.t_done)
    elif tel is not None and chunk_spans[0]:
        # sim spans, vectorized per node: killed backends already rolled
        # orphaned completions out of their history, and re-routed queries
        # were re-recorded by whichever survivor actually served them
        # (grouped windows were stamped inline at submit, and chunk
        # replay simply re-writes those rows with identical values)
        for b in controller.all_created():
            sa = getattr(b, "span_arrays", None)
            if sa is not None:
                i_, rel, st, dn = sa()
                if len(i_):
                    tel.spans.record_many(i_, rel, st, dn)
    # factory-built backends are owned by the driver (the caller never
    # sees them) — release their resources; a no-op for sim nodes,
    # thread/runtime shutdown for live ones
    controller.close_all()

    if tel is not None:
        # the driver's done array is authoritative (kill rollbacks,
        # errored-query drops): adopt it and book the run-level counters
        tel.spans.finalize(done)
        n_done = int((~np.isnan(done)).sum())
        tel.registry.counter("queries_completed").inc(n_done)
        tel.registry.counter("queries_dropped").inc(len(times) - n_done)
        for name, cnt in errors_by_node.items():
            c = tel.registry.counter("node_errors", node=name)
            if c.value < cnt:        # drain-time errors the window
                c.inc(cnt - c.value)  # monitor never saw
        if slo is not None:
            # close open incidents and attach per-incident attribution
            slo.finalize(tel.spans, t_end=horizon)
    if fleet is not None:
        pool_counts = {p.name: p.count for p in fleet.pools}
    else:
        pool_counts = controller.pool_counts()
    return _result(times, done, pool_of, pool_counts, controller.n_nodes,
                   node_hours,
                   list(autoscaler.events) if autoscaler else [], timeline,
                   model_ids=model_ids, errors=errors, rerouted=rerouted,
                   lifecycle=list(controller.events),
                   errors_by_node=errors_by_node, telemetry=tel,
                   cache_stats=cache.stats() if cache is not None else None,
                   slo=slo)


def simulate_fleet(times: np.ndarray, sizes: np.ndarray, fleet: Fleet,
                   router: Router, *, window_s: float | None = None,
                   autoscaler: Autoscaler | None = None,
                   faults: FaultConfig | None = None,
                   fleet_faults: FleetFaults | None = None,
                   self_heal: SelfHealPolicy | None = None,
                   contention: ContentionModel | None = None,
                   model_ids: np.ndarray | None = None,
                   seed: int = 0,
                   telemetry: bool = False,
                   grouped: bool | None = None,
                   cache: FleetCache | None = None,
                   query_keys: np.ndarray | None = None,
                   offload_tuning: OffloadTuning | None = None,
                   slo=None
                   ) -> ClusterResult:
    """Run one trace through a simulated fleet.  ``times`` must be sorted.

    Fast path (default): ``drive_fleet`` over per-node ``SimNodeBackend``s
    (windowed numpy advance, stateful across windows); with an
    ``Autoscaler`` the fleet is resized at window boundaries (new nodes
    are ordered at a boundary and serve after their spec's ``boot_s``;
    removed nodes finish their assigned work first — their completions
    are already recorded).  ``fleet_faults`` kills whole nodes mid-run
    through the lifecycle controller (unfinished queries re-routed to
    survivors) and stays on the fast path.  With per-node ``faults``/
    ``contention`` every node routes through the event-driven reference
    instead (single window, no autoscaling, no fleet faults).
    ``grouped`` is forwarded to ``drive_fleet`` — ``False`` forces the
    per-node submit loop, default uses the fleet-vectorized batched
    advance whenever a window is eligible.
    """
    times = np.asarray(times, float)
    sizes = np.asarray(sizes, np.int64)
    if len(times) and np.any(np.diff(times) < 0):
        raise ValueError("times must be sorted (routers and the per-node "
                         "FCFS advance assume arrival order)")
    if autoscaler is not None and window_s is None:
        raise ValueError("autoscaling requires window_s — scaling happens "
                         "at window boundaries, and a single-window run "
                         "would only observe after all queries completed")

    events_mode = not _fast_eligible(contention, faults or FaultConfig())
    if events_mode:
        if autoscaler is not None or window_s is not None:
            raise ValueError("windowing/autoscaling need the fast path; "
                             "faults/contention force the (unwindowed) "
                             "event engine")
        if telemetry:
            raise ValueError("telemetry (spans/registry) needs the "
                             "windowed fast path; per-node faults/"
                             "contention force the unwindowed event "
                             "engine, which has no window loop to stamp "
                             "spans or snapshot metrics from")
        if fleet_faults is not None:
            raise ValueError("fleet_faults (whole-node kills) need the "
                             "windowed fast path; per-node faults/"
                             "contention force the unwindowed event "
                             "engine — use one fault layer per run")
        if cache is not None or offload_tuning is not None \
                or slo is not None:
            raise ValueError("the fleet-front cache, online offload "
                             "tuning and SLO evaluation need the "
                             "windowed fast path; per-node faults/"
                             "contention force the unwindowed event "
                             "engine")
        router.reset()
        n = len(times)
        done = np.full(n, np.nan)
        pool_of = np.empty(n, object)
        nodes = fleet.node_views()
        assign = router.assign(times, sizes, nodes, model_ids=model_ids)
        for i, nv in enumerate(nodes):
            sel = assign == i
            if not sel.any():
                continue
            qs = queries_from_arrays(times[sel], sizes[sel])
            done[sel] = event_done_times(
                qs, nv.spec.cpu, nv.spec.scheduler_config(),
                accel=nv.spec.accel, contention=contention,
                faults=faults or FaultConfig(), seed=seed + i)
            pool_of[sel] = nv.pool
        horizon = float(times[-1]) - float(times[0]) if n else 0.0
        return _result(times, done, pool_of,
                       {p.name: p.count for p in fleet.pools}, fleet.n_nodes,
                       fleet.n_nodes * horizon / 3600.0, [], [],
                       model_ids=model_ids)

    # autoscaler resizes mutate the ledger — never the caller's fleet
    # (kill write-back is already copy-guarded inside drive_fleet)
    work_fleet = fleet.copy() if autoscaler is not None else fleet
    return drive_fleet(times, sizes, None, router, window_s=window_s,
                       autoscaler=autoscaler, fleet=work_fleet,
                       factory=SimNodeBackend, model_ids=model_ids,
                       fleet_faults=fleet_faults, self_heal=self_heal,
                       telemetry=telemetry, grouped=grouped,
                       cache=cache, query_keys=query_keys,
                       offload_tuning=offload_tuning, slo=slo)


def cluster_max_qps(fleet: Fleet, router: Router, sla_ms: float, *,
                    size_dist: SizeDist = PRODUCTION, n_queries: int = 1500,
                    seed: int = 0, lo: float = 1.0, hi: float | None = None,
                    iters: int = 9, hint: float | None = None,
                    popularity: PopularityDist | None = None,
                    cache_cfg: CacheConfig | None = None,
                    offload_tuning: OffloadTuning | None = None,
                    window_s: float | None = None,
                    n_windows: int | None = None) -> float:
    """Largest stationary arrival rate whose fleet-wide p95 meets the SLA.

    Same discipline as the per-node ``max_qps_under_sla`` (the shared
    ``warm_bracket``/``bracket_bisect`` helpers): one trace draw per seed,
    rescaled per λ step (``rescale_trace``), sustain guard against backlog
    hiding in a finite trace, exponential bracket then bisection.
    ``hint`` warm-starts the bracket around a known-nearby rate — e.g.
    another policy's answer on the same fleet — instead of doubling up
    from ``lo``.

    ``popularity`` draws the trace with popularity keys (sizes coherent
    per key), which lets ``cache_cfg`` put a *fresh* fleet-front cache in
    front of each candidate rate (cache state must not leak across λ
    steps) and ``offload_tuning`` run the online threshold controller
    (implies telemetry; both layers want real windows).  Because the
    rescaled trace's span shrinks as λ grows, ``n_windows`` fixes the
    window *count* instead of the width — each candidate rate gets the
    same number of cache-commit / controller-step boundaries."""
    rng = np.random.default_rng(seed)
    unit_times, sizes = sample_trace(rng, n_queries, size_dist)
    keys = None
    if popularity is not None:
        keys = popularity.sample(rng, n_queries)
        sizes = keyed_sizes(rng, keys, size_dist)
    if cache_cfg is not None and popularity is None:
        raise ValueError("cache_cfg needs popularity — without keys no "
                         "query can ever repeat, so a cache can never hit")
    _memo: dict[float, bool] = {}

    def ok(qps: float) -> bool:
        hit = _memo.get(qps)
        if hit is not None:
            return hit
        ws_ = window_s
        if ws_ is None and n_windows:
            ws_ = float(unit_times[-1]) / qps / n_windows
        r = simulate_fleet(
            rescale_trace(unit_times, qps), sizes, fleet, router, seed=seed,
            window_s=ws_, telemetry=offload_tuning is not None,
            cache=FleetCache(cache_cfg) if cache_cfg is not None else None,
            query_keys=keys, offload_tuning=offload_tuning)
        v = r.meets(sla_ms) and r.qps >= SUSTAIN_FRACTION * qps
        _memo[qps] = v
        return v

    if not ok(lo):
        return 0.0                # even the floor rate misses the SLA
    # the runaway-doubling cap guards both branches: an explicit hi is a
    # bracket start like a hint (bracket_bisect doubles past a hi that is
    # still feasible), not an unguarded ceiling
    cap = 4e6 * max(fleet.n_nodes, 1)
    if hi is None:
        lo, hi = warm_bracket(ok, lo, hint)
    return bracket_bisect(ok, lo, hi, iters, cap=cap)
