"""Tail-latency attribution: decompose each percentile into stage time.

A percentile is a single query's latency, so "p95 = queueing + service"
is only meaningful over a *neighborhood* of the percentile: we take the
rank band around percentile ``p`` (±``band_frac`` of the completed
population, at least one query) and average each additive span component
over the band.  Because the components of every individual query sum
exactly to its end-to-end latency (``SpanTable.components``), the band
means sum exactly to the band's mean latency — the report carries both
that band latency and the conventional ``numpy.percentile`` value, and
``reconciles(tol)`` checks the decomposition closes against each.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.spans import COMPONENTS, SpanTable

__all__ = ["PercentileAttribution", "AttributionReport",
           "latency_attribution"]


@dataclasses.dataclass
class PercentileAttribution:
    """One percentile's decomposition (all seconds, trace time)."""
    percentile: float
    latency_s: float            # numpy.percentile of end-to-end latency
    sum_latency_s: float        # numpy.percentile of per-query comp. sums
    band_latency_s: float       # mean end-to-end latency over the rank band
    band_n: int                 # queries averaged
    components_s: dict[str, float]

    @property
    def component_sum_s(self) -> float:
        return float(sum(self.components_s.values()))

    def reconciles(self, tol: float = 0.05) -> bool:
        """Does the decomposition close within ``tol`` (relative)?  Two
        checks: the percentile of per-query component sums must match the
        percentile of measured end-to-end latency (equal iff every
        completed query's stamps telescope — a missing/skewed stamp
        breaks it), and the band's mean components must sum to the band's
        mean latency (the reported shares are themselves additive)."""
        scale = max(abs(self.latency_s), 1e-12)
        bscale = max(abs(self.band_latency_s), 1e-12)
        return (abs(self.sum_latency_s - self.latency_s) <= tol * scale
                and abs(self.component_sum_s - self.band_latency_s)
                <= tol * bscale)


@dataclasses.dataclass
class AttributionReport:
    n_completed: int
    n_dropped: int
    percentiles: list[PercentileAttribution]
    totals_s: dict[str, float]      # fleet-total seconds per component

    def at(self, p: float) -> PercentileAttribution:
        for row in self.percentiles:
            if abs(row.percentile - p) < 1e-9:
                return row
        raise KeyError(f"percentile {p} not in report")

    def reconciles(self, tol: float = 0.05) -> bool:
        return all(row.reconciles(tol) for row in self.percentiles)

    def table(self) -> str:
        """Human-readable fixed-width table (ms)."""
        names = list(COMPONENTS)
        head = ("pct    e2e_ms   band_ms  " +
                "  ".join(f"{n:>9}" for n in names) + "        sum")
        lines = [head]
        for row in self.percentiles:
            comps = "  ".join(f"{row.components_s[n] * 1e3:9.3f}"
                              for n in names)
            lines.append(f"p{row.percentile:<4g} {row.latency_s * 1e3:8.3f}"
                         f" {row.band_latency_s * 1e3:9.3f}  {comps}"
                         f"  {row.component_sum_s * 1e3:9.3f}")
        return "\n".join(lines)


def latency_attribution(spans: SpanTable,
                        percentiles: tuple[float, ...] = (50.0, 95.0, 99.0),
                        band_frac: float = 0.02,
                        mask: np.ndarray | None = None) -> AttributionReport:
    """Build the attribution report for one run's span table.  ``mask``
    (boolean, one entry per span row) restricts the population — e.g. to
    the queries that arrived during one incident."""
    ok = spans.completed if mask is None else spans.completed & mask
    lat = spans.latency()[ok]
    comps = {k: v[ok] for k, v in spans.components().items()}
    n = len(lat)
    rows: list[PercentileAttribution] = []
    if n:
        sums = sum(comps.values())
        order = np.argsort(lat, kind="stable")
        half = max(1, int(round(band_frac * n / 2)))
        for p in percentiles:
            # nearest-rank center, clipped band
            c = min(n - 1, max(0, int(np.ceil(p / 100.0 * n)) - 1))
            lo, hi = max(0, c - half), min(n, c + half + 1)
            band = order[lo:hi]
            rows.append(PercentileAttribution(
                percentile=float(p),
                latency_s=float(np.percentile(lat, p)),
                sum_latency_s=float(np.percentile(sums, p)),
                band_latency_s=float(lat[band].mean()),
                band_n=int(len(band)),
                components_s={k: float(v[band].mean())
                              for k, v in comps.items()}))
    else:
        for p in percentiles:
            rows.append(PercentileAttribution(
                percentile=float(p), latency_s=float("nan"),
                sum_latency_s=float("nan"),
                band_latency_s=float("nan"), band_n=0,
                components_s={k: float("nan") for k in comps}))
    if mask is None:
        totals = spans.stage_totals()
    else:
        totals = {k: float(np.nansum(v[ok]))
                  for k, v in spans.components().items()}
    return AttributionReport(
        n_completed=int(n), n_dropped=int(spans.n - n), percentiles=rows,
        totals_s=totals)
