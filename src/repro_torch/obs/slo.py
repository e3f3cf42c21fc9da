"""Declarative SLOs, burn-rate alerting, and the incident timeline.

An :class:`SloObjective` is the paper's latency-bounded-throughput
contract made declarative: *percentile* of query latency must stay under
*latency_ms*, with an optional extra *error-rate* budget, optionally
scoped to one tenant (``model_id`` — the substrate for per-tenant QoS:
the driver already folds ``model_latency_ms{model=...}`` per window).

The :class:`SloEngine` evaluates objectives once per window against the
:class:`~repro_torch.obs.metrics.FleetTimeline`'s frozen window sketches
(``WindowSnapshot.sketch``), so the same engine runs online inside
``drive_fleet(slo=...)`` and offline over a recorded timeline (the
sim-vs-live consistency tests replay both through fresh engines):

  * **burn rate** — each window's bad fraction (latency above the bound,
    plus shed and errored queries for fleet-scope objectives) divided by
    the objective's budget (``1 - percentile/100 + error_rate``).  A calm
    window burns ~0; burning at exactly 1.0 spends the error budget at
    the rate the SLO allows.
  * **multi-window alerting** — Google-SRE-style fast/slow pairs
    (:class:`BurnRateRule`): an alert fires when, for any rule, the burn
    averaged over the *long* window AND over the *short* window both
    exceed the rule's threshold; it clears as soon as no rule matches
    (the short window is what lets it clear quickly after recovery).
    Calm traffic never fires — the zero-false-alert property the calm
    twin benchmarks pin.
  * **breach diagnosis** — windows burning ≥ ``diagnose_at`` are handed
    to a :class:`~repro_torch.obs.diagnose.BreachDiagnoser` together with the
    per-window span-component signals the driver folds
    (``span_queueing_ms`` etc.); calm windows feed the rolling baseline
    instead.
  * **incident log** — :class:`IncidentLog` stitches alert fire/clear
    events, per-window diagnoses, and the controller's
    :class:`ControlAction`s into ordered :class:`Incident` records; the
    exporters serialize them for a per-incident postmortem.
"""
from __future__ import annotations

import collections
import dataclasses
import math

from repro_torch.obs.attribution import latency_attribution
from repro_torch.obs.diagnose import BreachDiagnoser, Diagnosis
from repro_torch.obs.spans import COMPONENTS

__all__ = ["SloObjective", "BurnRateRule", "DEFAULT_RULES", "AlertEvent",
           "ControlAction", "Incident", "IncidentLog", "SloEngine"]


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declarative objective: ``percentile`` of latency must stay
    under ``latency_ms``; ``error_rate`` widens the bad-event budget
    (errors and shed queries count as bad).  ``model_id`` scopes the
    objective to one tenant's ``model_latency_ms`` stream (fleet-wide
    when ``None``)."""
    name: str
    latency_ms: float
    percentile: float = 95.0
    error_rate: float = 0.0
    model_id: int | None = None

    @property
    def budget(self) -> float:
        """Allowed bad fraction per window — the burn-rate denominator."""
        return max(1.0 - self.percentile / 100.0 + self.error_rate, 1e-6)

    @property
    def metric(self) -> str:
        return "fleet_latency_ms" if self.model_id is None \
            else f'model_latency_ms{{model="{self.model_id}"}}'


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """One fast/slow alerting pair, in *window* units: fire when burn
    averaged over the last ``long_windows`` and the last
    ``short_windows`` both reach ``threshold`` (needs at least
    ``short_windows`` of history — a run's first window never pages)."""
    long_windows: int
    short_windows: int
    threshold: float


# a page-worthy pair (fast, high burn) and a ticket-worthy pair (slow,
# sustained burn at the budget rate) — callers with very short runs pass
# their own smaller rules
DEFAULT_RULES = (BurnRateRule(12, 3, 2.0), BurnRateRule(36, 12, 1.0))


@dataclasses.dataclass(frozen=True)
class AlertEvent:
    t_s: float
    objective: str
    kind: str                   # "fire" | "clear"
    burn_long: float
    burn_short: float
    rule: int                   # index into the engine's rules


@dataclasses.dataclass(frozen=True)
class ControlAction:
    """One controller decision taken in response to a diagnosis — what
    the cluster tier's ``DiagnosisPolicy`` emits and the incident log
    stitches next to the diagnosis that caused it."""
    t_s: float
    objective: str
    verdict: str                # Verdict name the action responded to
    action: str                 # "scale_out" | "hold" | "prewarm" | ...
    delta: int = 0              # node delta applied


@dataclasses.dataclass
class Incident:
    """One stitched incident: everything between an alert firing and
    clearing for one objective (``t_end`` None = still open at end of
    run), with the diagnoses and control actions that happened inside
    it (plus the few breach windows immediately preceding the fire —
    the fast window's lead-in)."""
    objective: str
    t_start: float
    t_end: float | None = None
    alerts: list[AlertEvent] = dataclasses.field(default_factory=list)
    diagnoses: list[Diagnosis] = dataclasses.field(default_factory=list)
    actions: list[ControlAction] = dataclasses.field(default_factory=list)
    peak_ms: float = 0.0
    attribution: object | None = None   # AttributionReport over the span

    @property
    def duration_s(self) -> float | None:
        return None if self.t_end is None else self.t_end - self.t_start

    def verdict_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for d in self.diagnoses:
            out[d.verdict.name] = out.get(d.verdict.name, 0) + 1
        return out

    @property
    def dominant_verdict(self) -> str | None:
        counts = self.verdict_counts()
        return max(counts, key=counts.get) if counts else None

    def worst(self) -> Diagnosis | None:
        return max(self.diagnoses, key=lambda d: d.burn, default=None)

    def timeline(self) -> list[tuple[float, str, str]]:
        """Ordered (t_s, kind, summary) merge of the incident's events."""
        evs = [(a.t_s, "alert", f"{a.kind} rule={a.rule} "
                f"burn={a.burn_short:.2f}") for a in self.alerts]
        evs += [(d.t_s, "diagnosis", f"{d.verdict.name} "
                 f"p={d.p_ms:.1f}ms burn={d.burn:.2f}")
                for d in self.diagnoses]
        evs += [(a.t_s, "action", f"{a.action} delta={a.delta:+d} "
                 f"({a.verdict})") for a in self.actions]
        return sorted(evs, key=lambda e: e[0])


class IncidentLog:
    """Stitches alert / diagnosis / action events into incidents, one
    open incident per objective at a time.  Diagnoses and actions that
    land *before* the alert fires (burn-rate alerting is deliberately
    slower than single-window breach detection) are buffered and folded
    into the incident when it opens."""

    PENDING_KEEP = 8            # lead-in events retained per objective

    def __init__(self):
        self.incidents: list[Incident] = []
        self._open: dict[str, Incident] = {}
        self._pend_d: dict[str, collections.deque] = {}
        self._pend_a: dict[str, collections.deque] = {}

    def reset(self) -> None:
        self.__init__()

    def _pending(self, store, objective) -> collections.deque:
        q = store.get(objective)
        if q is None:
            q = store[objective] = collections.deque(maxlen=self.PENDING_KEEP)
        return q

    def on_alert(self, evt: AlertEvent) -> None:
        inc = self._open.get(evt.objective)
        if evt.kind == "fire":
            if inc is None:
                inc = Incident(objective=evt.objective, t_start=evt.t_s)
                for d in self._pending(self._pend_d, evt.objective):
                    inc.diagnoses.append(d)
                    inc.peak_ms = max(inc.peak_ms, d.p_ms)
                for a in self._pending(self._pend_a, evt.objective):
                    inc.actions.append(a)
                self._pend_d.pop(evt.objective, None)
                self._pend_a.pop(evt.objective, None)
                self._open[evt.objective] = inc
                self.incidents.append(inc)
            inc.alerts.append(evt)
        elif inc is not None:               # clear
            inc.alerts.append(evt)
            inc.t_end = evt.t_s
            del self._open[evt.objective]

    def on_diagnosis(self, d: Diagnosis) -> None:
        inc = self._open.get(d.objective)
        if inc is not None:
            inc.diagnoses.append(d)
            inc.peak_ms = max(inc.peak_ms, d.p_ms)
        else:
            self._pending(self._pend_d, d.objective).append(d)

    def on_action(self, a: ControlAction) -> None:
        inc = self._open.get(a.objective)
        if inc is not None:
            inc.actions.append(a)
        else:
            self._pending(self._pend_a, a.objective).append(a)

    def close_all(self, t_s: float | None = None) -> None:
        """End of run: incidents still firing keep ``t_end=None`` (open)
        unless a horizon is given."""
        if t_s is not None:
            for inc in self._open.values():
                inc.t_end = float(t_s)
        self._open.clear()


@dataclasses.dataclass
class _ObjState:
    burns: collections.deque
    firing: bool = False
    rule: int = 0


class SloEngine:
    """Per-window SLO evaluation + alerting + diagnosis (see module
    docstring).  Feed it :class:`~repro_torch.obs.metrics.WindowSnapshot`s in
    order — ``drive_fleet(slo=engine)`` does this at every boundary, and
    offline replay is ``for w in timeline.windows: engine.on_window(w)``.
    """

    def __init__(self, objectives, *, rules=DEFAULT_RULES,
                 diagnoser: BreachDiagnoser | None = None,
                 diagnose_at: float = 1.0):
        if isinstance(objectives, SloObjective):
            objectives = (objectives,)
        self.objectives: tuple[SloObjective, ...] = tuple(objectives)
        if not self.objectives:
            raise ValueError("SloEngine needs at least one SloObjective")
        self.rules: tuple[BurnRateRule, ...] = tuple(rules)
        self.diagnoser = diagnoser or BreachDiagnoser()
        self.diagnose_at = diagnose_at
        self.log = IncidentLog()
        self.alerts: list[AlertEvent] = []
        self.diagnoses: list[Diagnosis] = []
        self.actions: list[ControlAction] = []
        # per-objective (t_s, width_s, p_ms, burn) rows — the SLO-side
        # violation accounting (the sketch-based percentile includes
        # re-route wait the driver's scalar window p95 cannot see)
        self.track: dict[str, list[tuple]] = {o.name: []
                                              for o in self.objectives}
        maxlen = max(r.long_windows for r in self.rules)
        self._state = {o.name: _ObjState(collections.deque(maxlen=maxlen))
                       for o in self.objectives}
        self._prev_err = 0.0
        self._prev_shed = 0.0

    # -- driver-facing lifecycle ------------------------------------------

    def reset(self) -> None:
        self.__init__(self.objectives, rules=self.rules,
                      diagnoser=type(self.diagnoser)(
                          ewma_alpha=self.diagnoser.ewma_alpha,
                          dominant_frac=self.diagnoser.dominant_frac,
                          cache_drop=self.diagnoser.cache_drop),
                      diagnose_at=self.diagnose_at)

    @property
    def incidents(self) -> list[Incident]:
        return self.log.incidents

    def record_action(self, action: ControlAction) -> None:
        self.actions.append(action)
        self.log.on_action(action)

    def violation_minutes(self, objective: str | None = None) -> float:
        """Minutes the objective's observed percentile sat above its
        bound, from the per-window sketch evaluation (defaults to the
        first objective)."""
        obj = self._obj(objective)
        return sum(w for (_, w, p, _) in self.track[obj.name]
                   if not math.isnan(p) and p > obj.latency_ms) / 60.0

    def _obj(self, name: str | None) -> SloObjective:
        if name is None:
            return self.objectives[0]
        for o in self.objectives:
            if o.name == name:
                return o
        raise KeyError(f"no objective named {name!r}")

    # -- evaluation --------------------------------------------------------

    def _signals(self, snap) -> tuple[dict[str, float], int]:
        """Per-window component signals: average ms each span component
        contributed per completed query (the driver folds
        ``span_<component>_ms`` window histograms when SLO is on)."""
        sk = snap.sketch("fleet_latency_ms")
        n = sk.n if sk is not None else 0
        nq = max(n, 1)
        comp = {}
        for c in COMPONENTS:
            s = snap.sketch(f"span_{c}_ms")
            comp[c] = s.total / nq if s is not None else 0.0
        return comp, n

    def _err_shed_delta(self, snap) -> tuple[float, float]:
        err = sum(v for k, v in snap.scalar_items()
                  if k.startswith("node_errors"))
        shed = snap.value("queries_shed") or 0.0
        d_err = max(err - self._prev_err, 0.0)
        d_shed = max(shed - self._prev_shed, 0.0)
        self._prev_err, self._prev_shed = err, shed
        return d_err, d_shed

    def _alerting(self, obj: SloObjective, t_s: float, burn: float) -> None:
        st = self._state[obj.name]
        st.burns.append(burn)
        hist = st.burns
        fired = None
        for i, r in enumerate(self.rules):
            if len(hist) < r.short_windows:
                continue
            longs = list(hist)[-r.long_windows:]
            shorts = list(hist)[-r.short_windows:]
            bl = sum(longs) / len(longs)
            bs = sum(shorts) / len(shorts)
            if bl >= r.threshold and bs >= r.threshold:
                fired = (i, bl, bs)
                break
        if fired is not None and not st.firing:
            st.firing, st.rule = True, fired[0]
            evt = AlertEvent(t_s, obj.name, "fire", fired[1], fired[2],
                             fired[0])
            self.alerts.append(evt)
            self.log.on_alert(evt)
        elif fired is None and st.firing:
            st.firing = False
            r = self.rules[st.rule]
            longs = list(hist)[-r.long_windows:]
            shorts = list(hist)[-r.short_windows:]
            evt = AlertEvent(t_s, obj.name, "clear",
                             sum(longs) / len(longs),
                             sum(shorts) / len(shorts), st.rule)
            self.alerts.append(evt)
            self.log.on_alert(evt)

    def on_window(self, snap) -> list[Diagnosis]:
        """Evaluate every objective against one window snapshot; returns
        the diagnoses of objectives whose window breached (empty on calm
        windows, whose signals feed the rolling baseline instead)."""
        t_s = snap.t_s
        comp, n_fleet = self._signals(snap)
        d_err, d_shed = self._err_shed_delta(snap)
        hit_rate = snap.value("cache_hit_rate")
        booting = snap.value("booting_nodes") or 0.0
        out: list[Diagnosis] = []
        any_breach = False
        for obj in self.objectives:
            sk = snap.sketch(obj.metric)
            n = sk.n if sk is not None else 0
            bad = float(sk.count_above(obj.latency_ms)) if sk is not None \
                else 0.0
            tot = float(n)
            if obj.model_id is None:
                bad += d_err + d_shed
                tot += d_err + d_shed
            frac = bad / tot if tot else 0.0
            burn = frac / obj.budget
            p_ms = sk.quantile(obj.percentile / 100.0) \
                if sk is not None and n else float("nan")
            self.track[obj.name].append((t_s, snap.width_s, p_ms, burn))
            self._alerting(obj, t_s, burn)
            if burn >= self.diagnose_at:
                any_breach = True
                d = self.diagnoser.diagnose(
                    t_s, obj.name, comp, p_ms=p_ms,
                    target_ms=obj.latency_ms, burn=burn,
                    hit_rate=hit_rate, booting=booting)
                self.diagnoses.append(d)
                self.log.on_diagnosis(d)
                out.append(d)
        if not any_breach:
            self.diagnoser.update_baseline(comp, hit_rate)
        return out

    def finalize(self, spans=None, t_end: float | None = None) -> None:
        """End of run: close open incidents and — given the run's span
        table — attach a per-incident :func:`latency_attribution` report
        (the breached percentile decomposed over exactly the queries
        that arrived during the incident)."""
        self.log.close_all(t_end)
        if spans is None:
            return
        for inc in self.incidents:
            obj = self._obj(inc.objective)
            t1 = inc.t_end if inc.t_end is not None else math.inf
            mask = (spans.t_enqueued >= inc.t_start) \
                & (spans.t_enqueued <= t1)
            if mask.any():
                inc.attribution = latency_attribution(
                    spans, (obj.percentile,), mask=mask)
