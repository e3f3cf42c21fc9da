"""Fleet telemetry: per-query spans, streaming metrics, attribution.

``drive_fleet(..., telemetry=True)`` attaches a :class:`RunTelemetry` to
``ClusterResult.telemetry``: the run's :class:`SpanTable` (per-query stage
stamps from whichever engine served each query), the
:class:`MetricsRegistry` (per-node / per-model streaming-quantile
latency, error / re-route / retry counters), and the
:class:`FleetTimeline` of per-window registry snapshots.  See the module
docstrings of ``spans``/``metrics``/``attribution``/``export`` for the
individual layers, and ``python -m repro_torch.obs.dump`` (the run) and
``python -m repro_torch.obs.report`` (its incidents) for the artifact's
CLIs.  The port's copy of the JAX package's ``repro.obs``: numpy only,
equal to it on the same inputs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.attribution import (AttributionReport, PercentileAttribution,
                                         latency_attribution)
from repro_torch.obs.export import run_lines, to_prometheus, write_jsonl
from repro_torch.obs.metrics import (Counter, FleetTimeline, Gauge, Histogram,
                                     MetricsRegistry, QuantileSketch,
                                     WindowSnapshot, observe_fanout)
from repro_torch.obs.diagnose import (BreachDiagnoser, ComponentEvidence,
                                      Diagnosis, Verdict)
from repro_torch.obs.slo import (DEFAULT_RULES, AlertEvent, BurnRateRule,
                                 ControlAction, Incident, IncidentLog, SloEngine,
                                 SloObjective)
from repro_torch.obs.spans import COMPONENTS, STAGES, QuerySpan, SpanTable

__all__ = [
    "AttributionReport", "PercentileAttribution", "latency_attribution",
    "run_lines", "to_prometheus", "write_jsonl",
    "Counter", "FleetTimeline", "Gauge", "Histogram", "MetricsRegistry",
    "QuantileSketch", "WindowSnapshot", "observe_fanout",
    "COMPONENTS", "STAGES", "QuerySpan", "SpanTable",
    "BreachDiagnoser", "ComponentEvidence", "Diagnosis", "Verdict",
    "DEFAULT_RULES", "AlertEvent", "BurnRateRule", "ControlAction",
    "Incident", "IncidentLog", "SloEngine", "SloObjective",
    "RunTelemetry",
]


@dataclasses.dataclass
class RunTelemetry:
    """Everything one ``drive_fleet(telemetry=True)`` run observed."""
    spans: SpanTable
    registry: MetricsRegistry
    timeline: FleetTimeline

    def attribution(self, percentiles: tuple[float, ...] = (50.0, 95.0, 99.0),
                    band_frac: float = 0.02) -> AttributionReport:
        return latency_attribution(self.spans, percentiles,
                                   band_frac=band_frac)

    def prometheus(self) -> str:
        return to_prometheus(self.registry)
