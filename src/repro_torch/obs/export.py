"""Exporters: JSON-lines run artifacts and Prometheus text format.

``write_jsonl(result, path)`` serializes a ``ClusterResult`` (duck-typed —
obs stays importable without the cluster package) into a line-per-record
artifact: one ``run`` summary line, one ``window`` line per
``FleetTimeline`` snapshot, one ``attribution`` line per percentile,
``stage_totals``, and per-node ``node`` lines (errors, query counts).
Runs that carried an SLO engine (``drive_fleet(slo=...)``) additionally
get ``slo_objective`` / ``alert`` / ``diagnosis`` / ``action`` /
``incident`` lines — ``python -m repro_torch.obs.report`` renders per-incident
postmortems from those, and ``python -m repro_torch.obs.dump`` pretty-prints
the rest of the artifact back.  The artifact is line for line the JAX
package's, so either package's CLIs read it.

``to_prometheus(registry)`` renders a :class:`MetricsRegistry` in the
Prometheus text exposition format (counters / gauges verbatim,
histograms as summaries with ``quantile`` labels from the cumulative
sketch) — what a scrape endpoint would serve.
"""
from __future__ import annotations

import json
import math
from typing import Any, Iterator

from repro_torch.obs.attribution import AttributionReport
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["to_prometheus", "run_lines", "write_jsonl"]


def _esc(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"'
                          for k, v in sorted(labels.items())) + "}"


# HELP text per metric family; anything unlisted gets a generic line so
# every family still carries the promtool-expected HELP/TYPE pair.
_HELP = {
    "fleet_latency_ms": "End-to-end query latency across the fleet.",
    "model_latency_ms": "End-to-end query latency per model id.",
    "node_latency_ms": "End-to-end query latency per node.",
    "node_queue_cpu_ms": "CPU executor queueing delay per node.",
    "node_queue_acc_ms": "Accelerator executor queueing delay per node.",
    "node_queries": "Completed queries per node.",
    "node_errors": "Errored queries per node.",
    "queries_total": "Completed queries across the fleet.",
    "queries_shed": "Queries shed by admission control.",
    "cache_hit_rate": "Fleet-front result-cache hit rate.",
    "booting_nodes": "Nodes currently booting.",
    "span_reroute_ms": "Per-query reroute wait folded per window.",
    "span_retry_ms": "Per-query RPC retry backoff folded per window.",
    "span_cache_ms": "Per-query cache service time folded per window.",
    "span_queueing_ms": "Per-query executor queueing folded per window.",
    "span_service_ms": "Per-query service time folded per window.",
    "span_boot_wait_ms": "Per-query boot wait folded per window.",
    "span_dispatch_ms": "Per-query dispatch overhead folded per window.",
}


def _head(lines: list[str], typed: set, name: str, kind: str) -> None:
    if name not in typed:
        typed.add(name)
        lines.append(f"# HELP {name} "
                     + _HELP.get(name, f"{name} ({kind})."))
        lines.append(f"# TYPE {name} {kind}")


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format: every
    metric family gets a ``# HELP`` + ``# TYPE`` header, label sets are
    emitted in stable sorted order with escaped values (promtool-style
    format compliance)."""
    typed: set[str] = set()
    lines: list[str] = []
    for kind, name, labels, obj in registry.items():
        lab = _prom_labels(labels)
        if kind in ("counter", "gauge"):
            _head(lines, typed, name, kind)
            lines.append(f"{name}{lab} {obj.value:.9g}")
        else:                                  # histogram -> summary
            _head(lines, typed, name, "summary")
            sk = obj.total
            for q in (0.5, 0.95, 0.99):
                v = sk.quantile(q)
                ql = dict(labels, quantile=f"{q:g}")
                if not math.isnan(v):
                    lines.append(f"{name}{_prom_labels(ql)} {v:.9g}")
            lines.append(f"{name}_count{lab} {sk.n}")
            lines.append(f"{name}_sum{lab} {sk.total:.9g}")
    return "\n".join(lines) + ("\n" if lines else "")


def _clean(v: Any) -> Any:
    """NaN/inf -> None so the artifact is strict JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def _attribution_lines(report: AttributionReport) -> Iterator[dict]:
    for row in report.percentiles:
        yield {"kind": "attribution", "percentile": row.percentile,
               "latency_s": _clean(row.latency_s),
               "sum_latency_s": _clean(row.sum_latency_s),
               "band_latency_s": _clean(row.band_latency_s),
               "band_n": row.band_n,
               "components_s": {k: _clean(v)
                                for k, v in row.components_s.items()},
               "component_sum_s": _clean(row.component_sum_s)}
    yield {"kind": "stage_totals",
           "totals_s": {k: _clean(v) for k, v in report.totals_s.items()},
           "n_completed": report.n_completed,
           "n_dropped": report.n_dropped}


def _diag_rec(d: Any) -> dict:
    return {"kind": "diagnosis", "t_s": _clean(d.t_s),
            "objective": d.objective, "verdict": d.verdict.name,
            "p_ms": _clean(d.p_ms), "target_ms": _clean(d.target_ms),
            "burn": _clean(d.burn), "hit_rate": _clean(d.hit_rate),
            "booting": _clean(d.booting),
            "evidence": [{"component": e.component,
                          "window_ms": _clean(e.window_ms),
                          "baseline_ms": _clean(e.baseline_ms),
                          "delta_ms": _clean(e.delta_ms),
                          "share": _clean(e.share)} for e in d.evidence]}


def _slo_lines(slo: Any) -> Iterator[dict]:
    """Records for one run's ``SloEngine``: objective summaries, the
    alert/diagnosis/action streams, and self-contained stitched incident
    records (the report CLI renders postmortems from these alone)."""
    for o in slo.objectives:
        yield {"kind": "slo_objective", "name": o.name,
               "latency_ms": o.latency_ms, "percentile": o.percentile,
               "error_rate": o.error_rate, "model_id": o.model_id,
               "violation_minutes": _clean(slo.violation_minutes(o.name))}
    for a in slo.alerts:
        yield {"kind": "alert", "t_s": _clean(a.t_s),
               "objective": a.objective, "event": a.kind, "rule": a.rule,
               "burn_long": _clean(a.burn_long),
               "burn_short": _clean(a.burn_short)}
    for d in slo.diagnoses:
        yield _diag_rec(d)
    for a in slo.actions:
        yield {"kind": "action", "t_s": _clean(a.t_s),
               "objective": a.objective, "verdict": a.verdict,
               "action": a.action, "delta": a.delta}
    for inc in slo.incidents:
        worst = inc.worst()
        rec = {"kind": "incident", "objective": inc.objective,
               "t_start": _clean(inc.t_start), "t_end": _clean(inc.t_end),
               "duration_s": _clean(inc.duration_s),
               "peak_ms": _clean(inc.peak_ms),
               "dominant_verdict": inc.dominant_verdict,
               "verdict_counts": inc.verdict_counts(),
               "n_alerts": len(inc.alerts),
               "n_diagnoses": len(inc.diagnoses),
               "n_actions": len(inc.actions),
               "events": [{"t_s": _clean(t), "type": k, "what": s}
                          for t, k, s in inc.timeline()],
               "worst": None if worst is None else _diag_rec(worst)}
        if inc.attribution is not None:
            row = inc.attribution.percentiles[0]
            rec["attribution"] = {
                "percentile": row.percentile,
                "latency_ms": _clean(row.latency_s * 1e3),
                "band_n": row.band_n,
                "components_ms": {k: _clean(v * 1e3)
                                  for k, v in row.components_s.items()}}
        yield rec


def run_lines(result: Any) -> Iterator[dict]:
    """Yield the JSON-ready records for one ``ClusterResult``-shaped run
    (attribute access only — any object with the same surface works)."""
    yield {"kind": "run",
           "qps": _clean(float(result.qps)),
           "p50_ms": _clean(float(result.p50_ms)),
           "p95_ms": _clean(float(result.p95_ms)),
           "p99_ms": _clean(float(result.p99_ms)),
           "mean_ms": _clean(float(result.mean_ms)),
           "n_queries": int(result.n_queries),
           "dropped": int(result.dropped),
           "errors": int(getattr(result, "errors", 0)),
           "rerouted": int(getattr(result, "rerouted", 0)),
           "n_nodes": int(result.n_nodes),
           "node_hours": _clean(float(result.node_hours)),
           "cache_hits": int(getattr(result, "cache_hits", 0)),
           "cache_misses": int(getattr(result, "cache_misses", 0)),
           "cache_evictions": int(getattr(result, "cache_evictions", 0)),
           "cache_hit_rate": _clean(float(getattr(result, "cache_hit_rate",
                                                  0.0)))}
    for node, cnt in sorted(getattr(result, "errors_by_node", {}).items()):
        yield {"kind": "node", "node": node, "errors": int(cnt)}
    tel = getattr(result, "telemetry", None)
    if tel is not None:
        for w in tel.timeline.windows:
            yield {"kind": "window", "t_s": w.t_s, "width_s": w.width_s,
                   "extra": {k: _clean(v) for k, v in w.extra.items()},
                   "metrics": {k: _clean(v) for k, v in w.metrics.items()}}
        yield from _attribution_lines(tel.attribution())
    slo = getattr(result, "slo", None)
    if slo is not None:
        yield from _slo_lines(slo)


def write_jsonl(result: Any, path: str) -> int:
    """Write the run artifact; returns the number of lines written."""
    n = 0
    with open(path, "w") as f:
        for rec in run_lines(result):
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    return n
