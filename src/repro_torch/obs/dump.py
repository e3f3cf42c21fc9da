"""Summarize a telemetry run artifact: ``python -m repro_torch.obs.dump FILE``.

Reads the JSON-lines artifact ``repro_torch.obs.export.write_jsonl`` produces
(also written by ``benchmarks/latency_attribution.py``) and prints the
run summary, the per-percentile stage attribution table, per-node error
counts, and — with ``--windows`` — the per-window timeline.
``--window A:B`` and ``--node NAME`` narrow the timeline to an
incident's windows or one node's per-window metrics so a breach can be
inspected without dumping the whole run.
"""
from __future__ import annotations

import argparse
import json
import sys


def _f(v, scale=1.0):
    return "-" if v is None else f"{v * scale:.3f}"


def _parse_window(spec: str) -> tuple[float, float]:
    """Parse ``A:B`` into an inclusive [A, B] time range; either side
    may be empty (``:30`` / ``10:``)."""
    lo, _, hi = spec.partition(":")
    try:
        return (float(lo) if lo else float("-inf"),
                float(hi) if hi else float("inf"))
    except ValueError:
        raise SystemExit(f"bad --window spec {spec!r}; expected A:B")


def summarize(lines: list[dict], show_windows: bool = False,
              window: tuple[float, float] | None = None,
              node: str | None = None) -> str:
    if window is not None:
        show_windows = True
    out: list[str] = []
    runs = [r for r in lines if r.get("kind") == "run"]
    for r in runs:
        out.append(f"run: qps={_f(r['qps'])} p50={_f(r['p50_ms'])}ms "
                   f"p95={_f(r['p95_ms'])}ms p99={_f(r['p99_ms'])}ms "
                   f"n={r['n_queries']} dropped={r['dropped']} "
                   f"errors={r.get('errors', 0)} "
                   f"rerouted={r.get('rerouted', 0)} "
                   f"nodes={r['n_nodes']}")
        if r.get("cache_hits", 0) or r.get("cache_misses", 0):
            rate = r.get("cache_hit_rate")
            out.append(f"cache: hits={r['cache_hits']} "
                       f"misses={r['cache_misses']} "
                       f"evictions={r.get('cache_evictions', 0)} "
                       f"hit_rate={_f(rate)}")
    attrib = [r for r in lines if r.get("kind") == "attribution"]
    if attrib:
        names = list(attrib[0]["components_s"])
        out.append("attribution (ms):")
        out.append("  pct      e2e     band  " +
                   "  ".join(f"{n:>9}" for n in names) + "        sum")
        for r in attrib:
            comps = "  ".join(_f(r["components_s"][n], 1e3).rjust(9)
                              for n in names)
            out.append(f"  p{r['percentile']:<4g} "
                       f"{_f(r['latency_s'], 1e3).rjust(8)} "
                       f"{_f(r['band_latency_s'], 1e3).rjust(8)}  {comps}"
                       f"  {_f(r['component_sum_s'], 1e3).rjust(9)}")
    for r in lines:
        if r.get("kind") == "stage_totals":
            tot = ", ".join(f"{k}={_f(v, 1e3)}ms"
                            for k, v in r["totals_s"].items())
            out.append(f"stage totals: {tot}")
    nodes = [r for r in lines if r.get("kind") == "node"
             and (node is None or r["node"] == node)]
    if nodes:
        out.append("node errors: " + ", ".join(
            f"{r['node']}={r['errors']}" for r in nodes))
    windows = [r for r in lines if r.get("kind") == "window"]
    shown = windows
    if window is not None:
        lo, hi = window
        shown = [w for w in windows if lo <= w["t_s"] <= hi]
    if windows:
        out.append(f"windows: {len(windows)}"
                   + (f" ({len(shown)} selected)"
                      if len(shown) != len(windows) else ""))
        if show_windows:
            for w in shown:
                ex = w.get("extra", {})
                line = (f"  t={w['t_s']:.2f}s width={w['width_s']:.2f}s "
                        + " ".join(f"{k}={_f(v)}"
                                   for k, v in sorted(ex.items())))
                if node is not None:
                    tag = f'node="{node}"'
                    met = {k: v for k, v in w.get("metrics", {}).items()
                           if tag in k}
                    if met:
                        line += "\n" + "\n".join(
                            f"    {k}={_f(v)}"
                            for k, v in sorted(met.items()))
                out.append(line)
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dump",
        description="Summarize a telemetry JSON-lines run artifact.")
    ap.add_argument("file", help="artifact written by repro_torch.obs.export"
                                 ".write_jsonl")
    ap.add_argument("--windows", action="store_true",
                    help="also print the per-window timeline")
    ap.add_argument("--window", metavar="A:B", default=None,
                    help="only show timeline windows with t_s in the "
                         "inclusive range [A, B] seconds (either side "
                         "may be empty, e.g. ':30' or '10:'); implies "
                         "--windows")
    ap.add_argument("--node", metavar="NAME", default=None,
                    help="restrict node lines to NAME and, with the "
                         "timeline shown, print that node's per-window "
                         "metrics")
    args = ap.parse_args(argv)
    lines = []
    with open(args.file) as f:
        for ln in f:
            ln = ln.strip()
            if ln:
                lines.append(json.loads(ln))
    if not lines:
        print("empty artifact", file=sys.stderr)
        return 1
    rng = _parse_window(args.window) if args.window is not None else None
    print(summarize(lines, show_windows=args.windows, window=rng,
                    node=args.node))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
