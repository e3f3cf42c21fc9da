"""Incident postmortems: ``python -m repro_torch.obs.report FILE``.

Reads the JSON-lines artifact ``repro_torch.obs.export.write_jsonl`` produces
for a run that carried an SLO engine (``drive_fleet(slo=...)``) and
renders one postmortem block per stitched incident: the objective and
its breach span, the dominant diagnosis verdict with its verdict mix,
the ordered alert → diagnosis → action timeline, the worst window's
component-evidence table, and — when the run was finalized with its span
table — the incident-scoped percentile attribution.  A run with zero
incidents prints the objective summary and says so (the calm-twin
property the benchmarks pin).
"""
from __future__ import annotations

import argparse
import json
import sys


def _f(v, nd=2):
    return "-" if v is None else f"{v:.{nd}f}"


def _evidence_table(ev: list[dict]) -> list[str]:
    out = [f"    {'component':>10}  {'window':>9}  {'baseline':>9}  "
           f"{'delta':>9}  {'share':>6}"]
    for e in ev:
        d = e["delta_ms"]
        out.append(f"    {e['component']:>10}  {_f(e['window_ms'], 3):>9}  "
                   f"{_f(e['baseline_ms'], 3):>9}  "
                   f"{('-' if d is None else f'{d:+.3f}'):>9}  "
                   f"{_f(e['share']):>6}")
    return out


def render(lines: list[dict]) -> str:
    objectives = [r for r in lines if r.get("kind") == "slo_objective"]
    incidents = [r for r in lines if r.get("kind") == "incident"]
    out: list[str] = []
    for o in objectives:
        scope = "fleet" if o.get("model_id") is None \
            else f"model={o['model_id']}"
        out.append(f"objective {o['name']}: p{o['percentile']:g} "
                   f"<= {o['latency_ms']:g}ms ({scope}) "
                   f"violation_minutes={_f(o.get('violation_minutes'))}")
    if not incidents:
        out.append("incidents: none")
        return "\n".join(out)
    out.append(f"incidents: {len(incidents)}")
    for i, inc in enumerate(incidents, 1):
        t0, t1 = inc["t_start"], inc["t_end"]
        span = f"t={_f(t0)}s..{'open' if t1 is None else _f(t1) + 's'}"
        dur = inc.get("duration_s")
        out.append("")
        out.append(f"incident #{i} [{inc['objective']}] {span}"
                   + (f" ({_f(dur, 1)}s)" if dur is not None else "")
                   + f" peak_p={_f(inc.get('peak_ms'), 1)}ms")
        counts = inc.get("verdict_counts") or {}
        mix = ", ".join(f"{k}×{v}" for k, v in
                        sorted(counts.items(), key=lambda kv: -kv[1]))
        out.append(f"  verdict: {inc.get('dominant_verdict') or '-'}"
                   + (f"  ({mix})" if mix else ""))
        out.append(f"  events: {inc.get('n_alerts', 0)} alerts, "
                   f"{inc.get('n_diagnoses', 0)} diagnoses, "
                   f"{inc.get('n_actions', 0)} actions")
        for ev in inc.get("events", []):
            out.append(f"    t={_f(ev['t_s'])}s {ev['type']:<9} "
                       f"{ev['what']}")
        worst = inc.get("worst")
        if worst:
            out.append(f"  worst window: t={_f(worst['t_s'])}s "
                       f"{worst['verdict']} p={_f(worst['p_ms'], 1)}ms "
                       f"(target {_f(worst['target_ms'], 1)}ms) "
                       f"burn={_f(worst['burn'])}")
            out.extend(_evidence_table(worst.get("evidence", [])))
        att = inc.get("attribution")
        if att:
            comps = ", ".join(
                f"{k}={_f(v, 2)}ms"
                for k, v in att.get("components_ms", {}).items()
                if v is not None and v > 1e-9)
            out.append(f"  attribution p{att['percentile']:g}: "
                       f"{_f(att.get('latency_ms'), 1)}ms over "
                       f"{att.get('band_n', 0)} band queries: {comps}")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render per-incident SLO postmortems from a "
                    "telemetry JSON-lines run artifact.")
    ap.add_argument("file", help="artifact written by repro_torch.obs.export"
                                 ".write_jsonl for a run with an SLO "
                                 "engine attached")
    args = ap.parse_args(argv)
    lines = []
    with open(args.file) as f:
        for ln in f:
            ln = ln.strip()
            if ln:
                lines.append(json.loads(ln))
    if not any(r.get("kind") == "slo_objective" for r in lines):
        print("no SLO records in artifact (run with drive_fleet(slo=...))",
              file=sys.stderr)
        return 1
    print(render(lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
