"""Breach diagnosis: *why* did the window breach its SLO?

A latency scalar cannot tell a retry storm from a queueing cliff, yet the
right control action differs completely (DeepRecSys attributes its
latency win to knowing which pipeline stage eats the budget; Lui et al.
show tail shape is component-coupled, so the split must be
per-component).  The :class:`BreachDiagnoser` consumes the same additive
span components the attribution layer reconciles (``SpanTable
.components`` / ``latency_attribution``), reduced to a per-window
signal — average milliseconds each component contributed per completed
query — and keeps a rolling *calm baseline* of those signals (EWMA,
updated only on windows that met the objective).  On a breach window it
computes each component's delta over the baseline and maps the dominant
excess onto a typed :class:`Verdict`:

  * ``FAULT_RECOVERY``      — retry + reroute growth dominates (a node
    died or RPCs are stalling; healing/re-route owns recovery — adding
    capacity mostly burns node-hours);
  * ``COLD_CAPACITY``       — boot_wait dominates (work is deferred
    behind booting nodes; pre-warm, don't pile on more orders);
  * ``CACHE_DEGRADATION``   — the fleet-front cache hit rate fell
    materially below its calm baseline (misses re-load the fleet), or
    the cache component itself dominates;
  * ``QUEUEING_SATURATION`` — executor queueing (+ dispatch) growth
    dominates: genuine capacity shortfall, scale out;
  * ``SERVICE_REGRESSION``  — per-query service time itself grew (model
    or device regression; more nodes won't shrink it).

Every verdict carries an evidence table (:class:`ComponentEvidence` per
component: window value, baseline, delta, share of the total excess) so
an incident postmortem shows the numbers the verdict was read from.
"""
from __future__ import annotations

import dataclasses
import enum
import math

from repro_torch.obs.spans import COMPONENTS

__all__ = ["Verdict", "ComponentEvidence", "Diagnosis", "BreachDiagnoser"]


class Verdict(enum.Enum):
    QUEUEING_SATURATION = "queueing_saturation"
    FAULT_RECOVERY = "fault_recovery"
    COLD_CAPACITY = "cold_capacity"
    CACHE_DEGRADATION = "cache_degradation"
    SERVICE_REGRESSION = "service_regression"


@dataclasses.dataclass(frozen=True)
class ComponentEvidence:
    """One component's row in a diagnosis: all values are average
    milliseconds per completed query over the breach window."""
    component: str
    window_ms: float
    baseline_ms: float
    delta_ms: float             # window - baseline
    share: float                # positive delta / total positive excess


@dataclasses.dataclass(frozen=True)
class Diagnosis:
    """One breach window's verdict plus the evidence it was read from."""
    t_s: float
    objective: str
    verdict: Verdict
    evidence: tuple[ComponentEvidence, ...]
    p_ms: float                 # observed objective-percentile latency
    target_ms: float            # the objective's bound
    burn: float                 # window burn rate (bad frac / budget)
    hit_rate: float | None = None
    baseline_hit_rate: float | None = None
    booting: float = 0.0        # booting-node gauge at the window

    @property
    def excess_ms(self) -> float:
        return float(sum(max(e.delta_ms, 0.0) for e in self.evidence))

    def table(self) -> str:
        """Fixed-width evidence table (ms per completed query)."""
        lines = [f"{'component':>10}  {'window':>9}  {'baseline':>9}  "
                 f"{'delta':>9}  {'share':>6}"]
        for e in self.evidence:
            lines.append(f"{e.component:>10}  {e.window_ms:9.3f}  "
                         f"{e.baseline_ms:9.3f}  {e.delta_ms:+9.3f}  "
                         f"{e.share:6.2f}")
        return "\n".join(lines)


def _nz(v: float | None) -> float:
    return 0.0 if v is None or math.isnan(v) else float(v)


@dataclasses.dataclass
class BreachDiagnoser:
    """Rolling-calm-baseline component diagnoser (see module docstring).

    ``ewma_alpha`` smooths the calm baseline; ``dominant_frac`` is the
    share of the total positive excess a component group must hold to
    claim the verdict outright (fault and cold checks run before the
    queueing-vs-service comparison — a reroute spike usually drags
    queueing up with it, so precedence encodes causality, not size);
    ``cache_drop`` is the absolute hit-rate fall below baseline that
    flags cache degradation even when the cache component itself is
    small (misses surface as queueing/service load, not cache time).
    """

    ewma_alpha: float = 0.3
    dominant_frac: float = 0.35
    cache_drop: float = 0.10
    baseline: dict[str, float] = dataclasses.field(default_factory=dict)
    baseline_hit_rate: float | None = None
    calm_windows: int = 0

    def reset(self) -> None:
        self.baseline = {}
        self.baseline_hit_rate = None
        self.calm_windows = 0

    def update_baseline(self, comp_ms: dict[str, float],
                        hit_rate: float | None = None) -> None:
        """Fold one *calm* window's component signals into the rolling
        baseline (never called on breach windows — a saturated baseline
        would hide the very delta the diagnosis needs)."""
        a = self.ewma_alpha
        for c in COMPONENTS:
            v = _nz(comp_ms.get(c))
            prev = self.baseline.get(c)
            self.baseline[c] = v if prev is None else a * v + (1 - a) * prev
        if hit_rate is not None:
            prev = self.baseline_hit_rate
            self.baseline_hit_rate = hit_rate if prev is None \
                else a * hit_rate + (1 - a) * prev
        self.calm_windows += 1

    def diagnose(self, t_s: float, objective: str,
                 comp_ms: dict[str, float], *, p_ms: float,
                 target_ms: float, burn: float,
                 hit_rate: float | None = None,
                 booting: float = 0.0) -> Diagnosis:
        """Decompose one breach window against the calm baseline and
        emit the verdict (see module docstring for the rule order)."""
        deltas = {c: _nz(comp_ms.get(c)) - self.baseline.get(c, 0.0)
                  for c in COMPONENTS}
        excess = sum(max(d, 0.0) for d in deltas.values())
        denom = excess if excess > 1e-12 else 1.0
        share = {c: max(d, 0.0) / denom for c, d in deltas.items()}
        evidence = tuple(ComponentEvidence(
            component=c, window_ms=_nz(comp_ms.get(c)),
            baseline_ms=self.baseline.get(c, 0.0), delta_ms=deltas[c],
            share=share[c]) for c in COMPONENTS)

        cache_fell = (hit_rate is not None
                      and self.baseline_hit_rate is not None
                      and self.baseline_hit_rate - hit_rate
                      >= self.cache_drop)
        if share["retry"] + share["reroute"] >= self.dominant_frac:
            verdict = Verdict.FAULT_RECOVERY
        elif share["boot_wait"] >= self.dominant_frac:
            verdict = Verdict.COLD_CAPACITY
        elif cache_fell or share["cache"] >= self.dominant_frac:
            verdict = Verdict.CACHE_DEGRADATION
        elif share["queueing"] + share["dispatch"] >= share["service"]:
            verdict = Verdict.QUEUEING_SATURATION
        else:
            verdict = Verdict.SERVICE_REGRESSION
        return Diagnosis(t_s=float(t_s), objective=objective,
                         verdict=verdict, evidence=evidence,
                         p_ms=float(p_ms), target_ms=float(target_ms),
                         burn=float(burn), hit_rate=hit_rate,
                         baseline_hit_rate=self.baseline_hit_rate,
                         booting=float(booting))
