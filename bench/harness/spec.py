"""Finding a cell, its configuration, its workload and its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; each
piece of a cell lives in a file of its own under ``bench/``, named after
it, so a later change adds a cell, a configuration or a metric by adding
files and entries, never by editing one that is there.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, root: Path = ROOT) -> dict:
    """``bench/configs/<name>.json``: the model's widths under ``"model"``,
    with ``source``, ``reduced`` and ``assumed`` beside them."""
    return _json(root / "bench" / "configs" / f"{_checked('config', name)}.json")


def workload(name: str, root: Path = ROOT) -> dict:
    """``bench/workloads/<cell>.json``: the cell's configuration and traffic
    names, its driver, the driver's parameters and the limits of the
    numbers that decide ``correct``."""
    return _json(root / "bench" / "workloads" / f"{_checked('cell', name)}.json")


def resolve(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell entry, configuration, workload) of cell ``name``;
    raises where the files disagree with ``BENCHMARK.json``."""
    bench = benchmark(root)
    entry = cell(bench, name)
    wl = workload(name, root)
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {wl[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return bench, entry, config(entry["config"], root), wl


def _reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics a cell reports (``--trace 0``)."""
    return [m for m in bench["end_to_end"] if _reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a cell reports (``--trace 1``): those that list
    it, and those without a list whose end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """``bench/metrics/<metric>.py``, loaded by its path (a metric's name
    may hold dots).  It has ``read(run) -> float | None``."""
    path = root / "bench" / "metrics" / f"{_checked('metric', metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", metric), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{path} has no read(run)")
    return mod


def driver(name: str) -> ModuleType:
    """``bench/traffic/<driver>.py``, which has ``run(ctx) -> Outcome``."""
    if not name.isidentifier():
        raise ValueError(f"driver name {name!r} is not an identifier")
    return importlib.import_module(f"bench.traffic.{name}")
