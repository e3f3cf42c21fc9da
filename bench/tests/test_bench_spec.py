"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, workload and metric found by name, also when added as new
files."""
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from bench.harness import spec
from bench.harness.context import Run

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
WORKLOADS = sorted(p.stem for p in (ROOT / "bench" / "workloads").glob("*.json"))
READERS = sorted(p.name[:-3] for p in (ROOT / "bench" / "metrics").glob("*.py"))


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = CELLS + METRICS + [m["name"] for m in BENCH["end_to_end"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    bench, entry, cfg, wl = spec.resolve(cell)
    assert entry["config"] in {c["name"] for c in bench["configs"]}
    file = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    assert json.loads((ROOT / file).read_text()) == cfg
    assert cfg["reduced"] == next(c["reduced"] for c in bench["configs"]
                                  if c["name"] == entry["config"])
    assert spec.driver(wl["driver"]).run
    e2e = [m["name"] for m in spec.end_to_end(bench, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(bench, cell)
    for lim in wl["limits"].values():
        assert math.isfinite(lim)


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_workload_file_names_a_config_and_a_driver(name):
    wl = spec.workload(name)
    assert set(wl) == {"config", "traffic", "driver", "why", "params", "limits"}
    assert spec.config(wl["config"])["model"]["name"] == wl["config"]
    assert callable(spec.driver(wl["driver"]).run)
    assert name.startswith(wl["config"] + ".")


@pytest.mark.parametrize("name", READERS)
def test_every_reader_file_loads(name):
    assert spec.reader(name).read(Run()) is None


@pytest.mark.parametrize("metric", METRICS)
def test_metric_resolves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert spec.reader(metric).read(Run()) is None        # nothing to read: no reading
    for cell in m["workloads"]:
        assert cell in CELLS
        assert m["moves"] in [e["name"] for e in spec.end_to_end(BENCH, cell)]


def test_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "xdeepfm.extra", "config": "xdeepfm",
                               "traffic": "extra", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "extra_ms.p50", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "runtime",
                               "moves": "items_per_s", "workloads": ["xdeepfm.extra"]})
    next(m for m in bench["end_to_end"] if m["name"] == "items_per_s")["workloads"].append(
        "xdeepfm.extra")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((ROOT / "bench/workloads/xdeepfm.bulk.json").read_text())
    wl["traffic"] = "extra"
    (tmp_path / "bench/workloads/xdeepfm.extra.json").write_text(json.dumps(wl))
    (tmp_path / "bench/metrics/extra_ms.p50.py").write_text(
        "def read(run):\n    return run.percentile_ms('extra_s', 50)\n")

    got, entry, cfg, found = spec.resolve("xdeepfm.extra", tmp_path)
    assert entry["traffic"] == "extra" and found["driver"] == "bulk"
    assert [m["name"] for m in spec.per_layer(got, "xdeepfm.extra")] == ["extra_ms.p50"]
    assert "items_per_s" in [m["name"] for m in spec.end_to_end(got, "xdeepfm.extra")]
    reader = spec.reader("extra_ms.p50", tmp_path)
    assert reader.read(Run(samples={"extra_s": [0.001, 0.003]})) == pytest.approx(2.0)
    with pytest.raises(KeyError):
        spec.resolve("xdeepfm.extra")                     # not in the repo's own file


def test_workload_disagreeing_with_benchmark_is_refused(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = tmp_path / "bench/workloads/xdeepfm.bulk.json"
    wl = json.loads(p.read_text())
    wl["config"] = "dlrm-rmc2"
    p.write_text(json.dumps(wl))
    with pytest.raises(ValueError):
        spec.resolve("xdeepfm.bulk", tmp_path)


def test_bad_names_are_refused():
    for bad in ("../x", "a b", "", "x/y"):
        with pytest.raises(ValueError):
            spec.workload(bad)


def test_full_check_fits_its_budget():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert Path(ROOT / "bench").is_dir()
