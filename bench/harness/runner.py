"""One run of one cell: resolve it by name, run its driver, and make the
result line."""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from bench.harness import spec
from bench.harness.cell import Ctx, Outcome
from bench.harness.systems import Port

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")      # top-level module names


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro``; the port, ``repro_torch``, is another name)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return {"nvidia_smi": out[0] if out else ""}


def execute(name: str, *, seed: int, seconds: float, trace: bool, device,
            system=None, overrides: dict | None = None,
            t_process: float | None = None) -> tuple[Ctx, Outcome]:
    """Run the workload ``bench/workloads/<name>.json`` once, whether or not
    ``BENCHMARK.json`` lists it as a cell.  ``overrides`` replaces entries
    of the configuration's ``model``, the workload's ``params`` and
    ``limits`` (the CPU tests' small sizes)."""
    wl = spec.workload(name)
    cfg = spec.config(wl["config"])
    over = overrides or {}
    ctx = Ctx(cell=name, model={**cfg["model"], **over.get("model", {})},
              params={**wl["params"], **over.get("params", {})},
              limits={**wl["limits"], **over.get("limits", {})},
              seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
              system=system or Port(), t_process=time.monotonic() if t_process is None
              else t_process)
    return ctx, spec.driver(wl["driver"]).run(ctx)


def run_cell(name: str, **kw) -> tuple[dict, Outcome]:
    """(result line, outcome) of one run of a cell of ``BENCHMARK.json``;
    ``kw`` as ``execute``'s."""
    bench, _, _, _ = spec.resolve(name)
    ctx, outcome = execute(name, **kw)
    return line(bench, name, ctx, outcome), outcome


def line(bench: dict, name: str, ctx: Ctx, outcome: Outcome) -> dict:
    metrics = {}
    if ctx.trace:
        for m in spec.per_layer(bench, name):
            value = spec.reader(m["name"]).read(outcome.run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec.end_to_end(bench, name):
            metrics[m["name"]] = {"value": float(outcome.values[m["name"]]), "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    tr = outcome.run.trace
    if ctx.trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": [[k, v] for k, v in tr.idle_gaps]}
        outcome.counters["kernel_records_lost"] = tr.kernel_records_lost
    if dev.type == "cuda":
        out["card"] = card()
    out["system"] = ctx.system.name
    out["counters"] = outcome.counters
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return out


def checks_text(result: dict) -> list[str]:
    return [f"check {k} = {v['value']!r} (limit {v['limit']!r}) "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}"
            for k, v in result["checks"].items()]


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def dumps(result: dict) -> str:
    """One line of strict JSON: a number that is not finite (a check that
    read NaN) is written as a string."""
    return json.dumps(_finite(result), default=float, allow_nan=False)
