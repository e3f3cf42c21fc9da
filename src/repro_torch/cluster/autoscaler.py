"""Autoscaling for the cluster tier: reactive p95/utilization scaling and
predictive boot-ahead scaling over traffic forecasts.

After each traffic window the driver reports the window's observed p95 and
offered rate; an autoscaler grows/shrinks pools at window boundaries.

**Reactive** (:class:`Autoscaler`):

  * scale **up** when the SLA is threatened — p95 > ``up_at``·SLA — or the
    fleet is running hot (offered rate > ``util_high`` × total capacity,
    the proactive signal: p95 barely moves with fleet size until the
    queueing cliff, so waiting for p95 alone reacts too late);
  * scale **down** only when both signals agree there is headroom — p95 <
    ``down_at``·SLA *and* offered rate < ``util_low`` × capacity — and
    only if the shrunk fleet would still run below ``util_high``;
  * a cooldown of ``cooldown_windows`` windows between events damps
    flapping.

**Predictive** (:class:`PredictiveAutoscaler`): with node boot latency
(``NodeSpec.boot_s`` > 0) a reactive scaler is structurally late — by the
time p95 breaches, the node it orders arrives ``boot_s`` too late for the
ramp that hurt it.  The predictive scaler forecasts the offered rate
``lead_s`` seconds ahead (set ``lead_s ≈ boot_s + window_s``) — from the
scenario's known :class:`~repro_torch.cluster.traffic.Traffic` rate curve when
given one, else by Holt's linear-trend EWMA over the observed timeline —
and scales when the *forecast* crosses the utilization bar, so capacity
finishes booting as the ramp arrives.  Reactive triggers remain as a
backstop, and scale-down additionally requires forecast headroom (don't
shed right before the morning ramp).

Pool choice is shared by both: grow the pool with the highest per-node
capacity (most queueing relief per node-hour spent), shrink the one with
the lowest (cheapest capacity to shed); pools pinned at their
``min_count``/``max_count`` bounds fall through to the next candidate.
Capacity consumed is accounted in node-hours by the driver; every decision
is recorded as a :class:`ScalingEvent` whose ``reason`` names the trigger
that fired (``"p95"`` / ``"util"`` / ``"forecast"``).

An autoscaler never reaches into engine state: it sees only a
``CapacityLedger`` — named pools with capacity weights and a ``scale``
method.  ``fleet.Fleet`` is the canonical ledger; the driver
(``cluster_sim.drive_fleet``) materializes the corresponding node
backends — simulated or live — through the fleet lifecycle controller, so
the same scaling policy governs either engine (and newly ordered nodes
pay their spec's ``boot_s`` before serving).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.obs.slo import ControlAction


@runtime_checkable
class CapacityLedger(Protocol):
    """What the autoscaler needs of a fleet: named pools carrying capacity
    weights and bounded resizing.  Satisfied by ``fleet.Fleet``."""

    pools: Sequence

    def total_capacity(self) -> float: ...

    def scale(self, name: str, delta: int) -> int: ...

    @property
    def n_nodes(self) -> int: ...


@dataclasses.dataclass(frozen=True)
class ScalingEvent:
    t_s: float
    pool: str
    delta: int
    p95_ms: float
    n_nodes: int              # fleet size after the event
    reason: str = ""          # trigger that fired: "p95" | "util" | "forecast"


class TelemetrySignal:
    """Registry-backed scaling signal: reads the latest window's p95 (and
    queueing component) from the :class:`~repro_torch.obs.metrics.FleetTimeline`
    sketches instead of the driver-plumbed ``p95_ms`` scalar.  The sketch
    p95 sees everything the registry folds — notably re-route wait on
    orphaned queries, which the scalar window p95 cannot represent —
    so a signal-fed scaler reacts to fault recovery the scalar one is
    blind to.  Attach with ``Autoscaler(signal=TelemetrySignal())``; the
    driver binds the run's telemetry at start (``bind``).  Windows with
    no completions fall back to the scalar path."""

    def __init__(self, telemetry=None):
        self.telemetry = telemetry

    def bind(self, telemetry) -> None:
        self.telemetry = telemetry

    def _window(self):
        tl = getattr(self.telemetry, "timeline", None)
        if tl is None or not tl.windows:
            return None
        return tl.windows[-1]

    def _q(self, metric: str, q: float) -> float | None:
        w = self._window()
        sk = w.sketch(metric) if w is not None else None
        if sk is None or not sk.n:
            return None
        return float(sk.quantile(q))

    def window_p95_ms(self) -> float | None:
        """Latest window's fleet-latency p95 from the sketch, or None."""
        return self._q("fleet_latency_ms", 0.95)

    def window_queueing_p95_ms(self) -> float | None:
        """Latest window's p95 executor-queueing component, or None
        (needs the SLO span folds: ``drive_fleet(slo=...)``)."""
        return self._q("span_queueing_ms", 0.95)


@dataclasses.dataclass
class Autoscaler:
    sla_ms: float
    up_at: float = 0.9        # p95 trigger, fraction of SLA
    down_at: float = 0.6
    util_high: float = 0.85   # offered/capacity triggers
    util_low: float = 0.6
    step: int = 1
    cooldown_windows: int = 1
    signal: TelemetrySignal | None = None   # registry p95 over the scalar
    events: list[ScalingEvent] = dataclasses.field(default_factory=list)
    _cooldown: int = 0

    def reset(self) -> None:
        self.events, self._cooldown = [], 0

    def _p95(self, p95_ms: float) -> float:
        """Effective p95 signal: the registry window sketch when a bound
        ``TelemetrySignal`` has one, else the driver's scalar."""
        if self.signal is not None:
            v = self.signal.window_p95_ms()
            if v is not None and not math.isnan(v):
                return v
        return p95_ms

    def _capacity(self, fleet: CapacityLedger) -> float:
        cap = fleet.total_capacity()
        if cap <= 0:
            raise ValueError(
                "fleet has no capacity weights — run Fleet.tune() or "
                "Fleet.estimate_capacity() before autoscaling (otherwise "
                "the utilization signal reads ∞ and scales up every window)")
        return cap

    def _apply(self, ranked, delta: int, t_s: float, p95_ms: float,
               fleet: CapacityLedger, reason: str) -> int:
        """Shared ranked-pool walk: first pool whose bounds admit the
        delta takes it; the event records which trigger asked."""
        for pool in ranked:
            applied = fleet.scale(pool.name, delta)
            if applied:
                self.events.append(ScalingEvent(t_s, pool.name, applied,
                                                p95_ms, fleet.n_nodes,
                                                reason))
                self._cooldown = self.cooldown_windows
                return applied
        return 0

    def _grow(self, t_s: float, p95_ms: float, fleet: CapacityLedger,
              reason: str) -> int:
        ranked = sorted(fleet.pools, key=lambda p: -p.qps_capacity)
        return self._apply(ranked, +self.step, t_s, p95_ms, fleet, reason)

    def _grow_to_rate(self, rate_qps: float, t_s: float, p95_ms: float,
                      fleet: CapacityLedger, reason: str,
                      target_util: float | None = None) -> int:
        """Proportional sizing: order however many nodes close the gap
        between the fleet's capacity and ``rate_qps / target_util``
        (default ``util_high``) in one boundary (an HPA-style step, not a
        fixed increment — a steep ramp would outrun one-node-per-window).
        Greedy over the ranked pools, one event per pool touched; the
        reactive scaler feeds the *current* offered rate in, the
        predictive one its forecast, the diagnosis policy passes its own
        target."""
        u = self.util_high if target_util is None else target_util
        need = rate_qps / u - fleet.total_capacity()
        total = 0
        for pool in sorted(fleet.pools, key=lambda p: -p.qps_capacity):
            if need <= 0:
                break
            want = max(int(np.ceil(need / max(pool.qps_capacity, 1e-9))),
                       self.step)
            applied = fleet.scale(pool.name, +want)
            if applied:
                self.events.append(ScalingEvent(t_s, pool.name, applied,
                                                p95_ms, fleet.n_nodes,
                                                reason))
                need -= applied * pool.qps_capacity
                total += applied
        if total:
            self._cooldown = self.cooldown_windows
        return total

    def _shrink(self, t_s: float, p95_ms: float, offered_qps: float,
                cap: float, fleet: CapacityLedger, reason: str) -> int:
        ranked = [p for p in sorted(fleet.pools,
                                    key=lambda p: p.qps_capacity)
                  if offered_qps < self.util_high
                  * (cap - self.step * p.qps_capacity)]
        return self._apply(ranked, -self.step, t_s, p95_ms, fleet, reason)

    def observe(self, t_s: float, p95_ms: float, offered_qps: float,
                fleet: CapacityLedger) -> int:
        """One window's verdict; mutates ``fleet`` and returns the node
        delta applied (0 when within band or cooling down)."""
        p95_ms = self._p95(p95_ms)
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        cap = self._capacity(fleet)
        util = offered_qps / cap
        if p95_ms > self.up_at * self.sla_ms:
            return self._grow(t_s, p95_ms, fleet, "p95")
        if util > self.util_high:
            return self._grow_to_rate(offered_qps, t_s, p95_ms, fleet,
                                      "util")
        if p95_ms < self.down_at * self.sla_ms and util < self.util_low:
            return self._shrink(t_s, p95_ms, offered_qps, cap, fleet, "util")
        return 0


@dataclasses.dataclass
class PredictiveAutoscaler(Autoscaler):
    """Boot-latency-ahead scaling over a traffic forecast (see module
    docstring).  ``traffic`` is any object with a vectorized ``rate(t)``
    curve (the ``cluster.traffic`` scenarios); without one the forecast
    is Holt's linear trend over the observed offered rates."""

    traffic: object | None = None
    lead_s: float = 0.0          # forecast horizon; ≈ boot_s + window_s
    ewma_alpha: float = 0.4      # level smoothing (trend uses alpha/2)
    _level: float | None = None
    _slope: float = 0.0
    _last_t: float | None = None

    def reset(self) -> None:
        super().reset()
        self._level, self._slope, self._last_t = None, 0.0, None

    def forecast(self, t_s: float, offered_qps: float) -> float:
        """Expected offered rate at ``t_s + lead_s`` — exact from the
        scenario curve when known, extrapolated otherwise.  Always feeds
        the EWMA so a mid-run fallback has history."""
        if self._level is None:
            self._level, self._last_t = offered_qps, t_s
        else:
            dt = max(t_s - self._last_t, 1e-9)
            a, prev = self.ewma_alpha, self._level
            self._level = a * offered_qps + (1 - a) * (
                self._level + self._slope * dt)
            self._slope = (a / 2) * (self._level - prev) / dt \
                + (1 - a / 2) * self._slope
            self._last_t = t_s
        if self.traffic is not None:
            return float(np.asarray(
                self.traffic.rate(np.array([t_s + self.lead_s]))).ravel()[0])
        return max(self._level + self._slope * self.lead_s, 0.0)

    def observe(self, t_s: float, p95_ms: float, offered_qps: float,
                fleet: CapacityLedger) -> int:
        p95_ms = self._p95(p95_ms)
        fc = self.forecast(t_s, offered_qps)   # keep EWMA warm every window
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        cap = self._capacity(fleet)
        util = offered_qps / cap
        if fc > self.util_high * cap:
            return self._grow_to_rate(fc, t_s, p95_ms, fleet, "forecast")
        if p95_ms > self.up_at * self.sla_ms:          # reactive backstop
            return self._grow(t_s, p95_ms, fleet, "p95")
        if util > self.util_high:
            return self._grow_to_rate(offered_qps, t_s, p95_ms, fleet,
                                      "util")
        if (p95_ms < self.down_at * self.sla_ms and util < self.util_low
                and fc < self.util_low * cap):
            return self._shrink(t_s, p95_ms, max(offered_qps, fc), cap,
                                fleet, "util")
        return 0


@dataclasses.dataclass
class DiagnosisPolicy:
    """Diagnosis-matched breach response: wraps a reactive scaler and,
    when the window came with SLO breach diagnoses
    (``drive_fleet(slo=..., autoscaler=DiagnosisPolicy(...))`` feeds them
    in via :meth:`inform` each boundary), replaces the raw-latency
    verdict with the action the *cause* calls for:

      * ``QUEUEING_SATURATION`` — genuine capacity shortfall: one
        rate-sized scale-out (``_grow_to_rate`` at ``target_util``), not
        a node-per-window drip;
      * ``FAULT_RECOVERY`` — retry/reroute growth: healing and re-route
        own recovery, so **hold** scale (the raw-latency baseline buys
        nodes here and pays node-hours for latency it cannot fix);
      * ``COLD_CAPACITY`` — work stuck behind booting nodes: hold if
        capacity is already booting, else pre-warm one step;
      * ``CACHE_DEGRADATION`` / ``SERVICE_REGRESSION`` — not capacity
        problems; delegate to the wrapped scaler's normal triggers.

    Calm windows delegate wholesale, so outside incidents the policy is
    exactly its wrapped scaler.  Every diagnosed decision is recorded as
    a :class:`~repro_torch.obs.slo.ControlAction` (the driver stitches these
    into the incident log).  Duck-types the ``Autoscaler`` surface the
    driver uses (``reset`` / ``observe`` / ``events`` / ``signal``).
    """

    scaler: Autoscaler
    target_util: float = 0.85    # sizing bar for diagnosed scale-outs
    prewarm_step: int = 1
    actions: list[ControlAction] = dataclasses.field(default_factory=list)
    _diags: list = dataclasses.field(default_factory=list)
    _booting: float = 0.0

    def reset(self) -> None:
        self.scaler.reset()
        self.actions, self._diags, self._booting = [], [], 0.0

    @property
    def events(self) -> list[ScalingEvent]:
        return self.scaler.events

    @property
    def signal(self) -> TelemetrySignal | None:
        return self.scaler.signal

    def inform(self, diagnoses, booting: float = 0.0) -> None:
        """Hand over this boundary's breach diagnoses (empty on calm
        windows) and the booting-node gauge; consumed by the next
        :meth:`observe`."""
        self._diags = list(diagnoses)
        self._booting = float(booting)

    def _act(self, t_s: float, objective: str, verdict: str, action: str,
             delta: int) -> int:
        self.actions.append(ControlAction(t_s, objective, verdict, action,
                                          delta))
        return delta

    def observe(self, t_s: float, p95_ms: float, offered_qps: float,
                fleet: CapacityLedger) -> int:
        diags, self._diags = self._diags, []
        if not diags:
            return self.scaler.observe(t_s, p95_ms, offered_qps, fleet)
        d = max(diags, key=lambda x: x.burn)    # worst objective decides
        v = d.verdict.name
        s = self.scaler
        p95_ms = s._p95(p95_ms)
        if s._cooldown > 0:
            s._cooldown -= 1
            return self._act(t_s, d.objective, v, "cooldown", 0)
        if v == "QUEUEING_SATURATION":
            delta = s._grow_to_rate(offered_qps, t_s, p95_ms, fleet,
                                    "diag:queueing",
                                    target_util=self.target_util)
            if delta == 0:      # capacity already sized; drain the backlog
                delta = s._grow(t_s, p95_ms, fleet, "diag:queueing")
            return self._act(t_s, d.objective, v, "scale_out", delta)
        if v == "FAULT_RECOVERY":
            return self._act(t_s, d.objective, v, "hold", 0)
        if v == "COLD_CAPACITY":
            if self._booting > 0:
                return self._act(t_s, d.objective, v, "hold", 0)
            old_step, s.step = s.step, self.prewarm_step
            try:
                delta = s._grow(t_s, p95_ms, fleet, "diag:cold")
            finally:
                s.step = old_step
            return self._act(t_s, d.objective, v, "prewarm", delta)
        delta = s.observe(t_s, p95_ms, offered_qps, fleet)
        return self._act(t_s, d.objective, v, "delegate", delta)
