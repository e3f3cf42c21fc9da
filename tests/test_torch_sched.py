"""DeepRecInfra's device models and simulator and DeepRecSched's tuner in
the port, against the JAX package's: numpy on both sides, so the same
inputs give the same numbers exactly.  Also the port's measured-curve
plumbing (``core.infra``) and its serving launcher."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.core import costs as jax_costs
from repro.core import latency_model as jax_lat
from repro.core import query_gen as jax_qg
from repro.core import scheduler as jax_sched
from repro.core import simulator as jax_sim
from repro_torch import configs
from repro_torch.core import costs, infra
from repro_torch.core import latency_model as lat
from repro_torch.core import query_gen as qg
from repro_torch.core import scheduler as sched
from repro_torch.core import simulator as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

BATCHES = [1, 4, 16, 64, 256, 1024]
CPU_S = [2e-4, 3e-4, 6e-4, 1.8e-3, 6.5e-3, 2.6e-2]       # a made-up CPU curve
CARD_S = [4e-4, 4.2e-4, 4.5e-4, 5e-4, 8e-4, 2.5e-3]      # a made-up card curve
PROBE = np.array([1, 2, 3, 5, 16, 17, 100, 700, 1000, 1024, 1500, 4096])


def _pair(kind: str):
    """The same device model in both packages."""
    if kind == "table":
        return (lat.TableDeviceModel(BATCHES, CPU_S), jax_lat.TableDeviceModel(BATCHES, CPU_S))
    if kind == "table_one_point":
        return lat.TableDeviceModel([8], [1e-3]), jax_lat.TableDeviceModel([8], [1e-3])
    arch = "dlrm-rmc2"
    return (lat.accelerator_model(configs.get(arch).config, kind),
            jax_lat.accelerator_model(jax_configs.get(arch).config, kind))


def _curves():
    return ((lat.TableDeviceModel(BATCHES, CPU_S), lat.TableDeviceModel(BATCHES, CARD_S)),
            (jax_lat.TableDeviceModel(BATCHES, CPU_S), jax_lat.TableDeviceModel(BATCHES, CARD_S)))


def _same(a, b) -> None:
    """Two results of the two packages' dataclasses hold the same values."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("kind", ["table", "table_one_point", "gpu", "tpu"])
def test_device_models_equal_the_reference(kind):
    port, ref = _pair(kind)
    assert [port.latency(int(b)) for b in PROBE] == [ref.latency(int(b)) for b in PROBE]
    assert np.array_equal(port.latency_batch(PROBE), ref.latency_batch(PROBE))
    assert np.array_equal(lat.service_time_table(port, 1500),
                          jax_lat.service_time_table(ref, 1500))


def test_contention_model_equals_the_reference():
    for f in (1.0, 1.3, 2.5):
        port, ref = lat.ContentionModel(f), jax_lat.ContentionModel(f)
        assert port.is_noop() == ref.is_noop()
        assert ([port.multiplier(b, t) for t in (1, 8, 40) for b in range(t + 1)]
                == [ref.multiplier(b, t) for t in (1, 8, 40) for b in range(t + 1)])


SIM_CASES = {
    "fast": dict(engine="fast"),
    "fast_offload": dict(engine="fast", offload=100),
    "events": dict(engine="events"),
    "events_offload": dict(engine="events", offload=100),
    "events_faults": dict(engine="auto", offload=300,
                          faults=dict(straggler_frac=0.05, straggler_mult=4.0,
                                      hedge_factor=2.0, fail_times=(0.2, 0.4))),
    "events_contention": dict(engine="auto", contention=1.5),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulate_equals_the_reference(case):
    c = SIM_CASES[case]
    (cpu, card), (jcpu, jcard) = _curves()
    qs = qg.generate_queries(np.random.default_rng(3), 2000.0, 1200)
    jqs = jax_qg.generate_queries(np.random.default_rng(3), 2000.0, 1200)
    assert qs == [qg.Query(q.qid, q.arrival, q.size) for q in jqs]
    kw = dict(batch_size=32, offload_threshold=c.get("offload"), n_executors=8)
    accel = card if c.get("offload") else None
    jaccel = jcard if c.get("offload") else None
    extra, jextra = {}, {}
    if "faults" in c:
        extra["faults"], jextra["faults"] = (sim.FaultConfig(**c["faults"]),
                                             jax_sim.FaultConfig(**c["faults"]))
    if "contention" in c:
        extra["contention"] = lat.ContentionModel(c["contention"])
        jextra["contention"] = jax_lat.ContentionModel(c["contention"])
    got = sim.simulate(qs, cpu, sim.SchedulerConfig(**kw), accel=accel, engine=c["engine"],
                       seed=1, **extra)
    want = jax_sim.simulate(jqs, jcpu, jax_sim.SchedulerConfig(**kw), accel=jaccel,
                            engine=c["engine"], seed=1, **jextra)
    _same(got, want)
    if "faults" in c:
        assert got.hedges > 0 and got.requeued > 0


@pytest.mark.parametrize("offload", [None, 150])
def test_max_qps_under_sla_equals_the_reference(offload):
    (cpu, card), (jcpu, jcard) = _curves()
    kw = dict(batch_size=64, offload_threshold=offload, n_executors=16)
    got = sim.max_qps_under_sla(cpu, sim.SchedulerConfig(**kw), 20.0,
                                accel=card if offload else None, n_queries=500)
    want = jax_sim.max_qps_under_sla(jcpu, jax_sim.SchedulerConfig(**kw), 20.0,
                                     accel=jcard if offload else None, n_queries=500)
    assert got == want > 0


@pytest.mark.parametrize("with_accel", [False, True])
def test_tune_equals_the_reference(with_accel):
    (cpu, card), (jcpu, jcard) = _curves()
    got = sched.tune(cpu, 25.0, accel=card if with_accel else None, n_queries=400)
    want = jax_sched.tune(jcpu, 25.0, accel=jcard if with_accel else None, n_queries=400)
    _same(got, want)
    assert any(knob == "threshold" for knob, _, _ in got.trace) == with_accel


def test_rmc2_bump_stops_both_tuners_at_batch_one():
    """The JAX package's committed CPU curve for dlrm-rmc2 rises from 0.33
    to 2.71 ms between batches 1 and 4 and falls to 1.92 at 16; the climb
    (patience 1) stops at the bump, below the static baseline's capacity.
    Both tuners do the same."""
    path = os.path.join(REPO, "artifacts", "cpu_latency_curves.json")
    port = sched.tune(lat.load_curves(path)["dlrm-rmc2"], 400.0, n_queries=1500)
    ref = jax_sched.tune(jax_lat.load_curves(path)["dlrm-rmc2"], 400.0, n_queries=1500)
    _same(port, ref)
    assert port.batch_size == 1 and round(port.qps) == 678


@pytest.mark.parametrize("max_size,n", [(1000, 40), (1000, 16), (7, 40), (1, 1)])
def test_static_baseline_equals_the_reference(max_size, n):
    assert sched.static_baseline(max_size, n) == jax_sched.static_baseline(max_size, n)


# the fleet-batched half of the simulator (the cluster tier's engine): a
# fast and a slow CPU, and a CPU with an offloading card, on both packages
FLEET_CPU = ([1., 4, 16, 64, 256, 1024], [.0008, .001, .0018, .0045, .015, .058])


def _engines(pkg_sim, pkg_lat, n: int):
    cpu = pkg_lat.TableDeviceModel(*FLEET_CPU)
    slow = pkg_lat.TableDeviceModel(FLEET_CPU[0], [1.5 * s for s in FLEET_CPU[1]])
    card = pkg_lat.TableDeviceModel(BATCHES, CARD_S)
    cfg = pkg_sim.SchedulerConfig(batch_size=8, n_executors=2)
    acfg = pkg_sim.SchedulerConfig(batch_size=8, n_executors=2, n_accelerators=1,
                                   offload_threshold=150)
    make = (lambda: pkg_sim.NodeEngine.make(cpu, cfg),
            lambda: pkg_sim.NodeEngine.make(slow, cfg),
            lambda: pkg_sim.NodeEngine.make(cpu, acfg, accel=card))
    return [make[i % 3]() for i in range(n)]


def _windows(n_segs: int, n_windows: int, hi: int):
    """Node-segmented windows of sorted arrivals and sizes (or service
    times), made from one seed."""
    rng = np.random.default_rng(5)
    out, t0 = [], 0.0
    for _ in range(n_windows):
        arr, val = [], []
        for _ in range(n_segs):
            r = int(rng.integers(0, 12))
            arr.append(np.sort(t0 + rng.uniform(0, 0.3, r)))
            val.append(rng.integers(1, hi, r) if hi > 1 else rng.uniform(0.01, 0.5, r))
        out.append((np.concatenate(arr), np.concatenate(val),
                    np.cumsum([len(a) for a in arr])))
        t0 += 0.15
    return out


@pytest.mark.parametrize("part", ["split_requests_many", "advance_pool_many",
                                  "node_pass_many"])
def test_fleet_batched_half_equals_the_reference(part):
    if part == "split_requests_many":
        rng = np.random.default_rng(4)
        sizes, batch = rng.integers(1, 700, 60), rng.choice([1, 4, 8, 32], 60)
        for a, b in zip(sim.split_requests_many(sizes, batch),
                        jax_sim.split_requests_many(sizes, batch)):
            assert np.array_equal(a, b)
        return
    if part == "advance_pool_many":
        cs = [0, 1, 2, 3, 4, 2]
        port = [sim.ExecPoolState(c) for c in cs]
        ref = [jax_sim.ExecPoolState(c) for c in cs]
        for arr, svc, bounds in _windows(len(cs), 4, 1):
            got = sim.advance_pool_many(arr, svc, bounds, port)
            want = jax_sim.advance_pool_many(arr, svc, bounds, ref)
            assert len(got) == bounds[-1] and np.array_equal(got, want, equal_nan=True)
            for p, r in zip(port, ref):
                assert p.fmax == r.fmax and np.array_equal(p.materialize(), r.materialize())
        return
    port, ref = _engines(sim, lat, 7), _engines(jax_sim, jax_lat, 7)
    for arr, sizes, bounds in _windows(7, 3, 600):
        got = sim.node_pass_many(arr, sizes, bounds, port, want_starts=True)
        want = jax_sim.node_pass_many(arr, sizes, bounds, ref, want_starts=True)
        for a, b in zip(got, want):
            assert np.array_equal(a, b, equal_nan=True)
        assert np.isfinite(got[0]).any()


RECSYS = ("ncf", "wnd", "mt-wnd", "dlrm-rmc1", "dlrm-rmc2", "dlrm-rmc3", "din", "dien",
          "xdeepfm", "autoint", "mind", "bert4rec")
LMS = ("qwen2-0.5b", "phi3-mini-3.8b", "yi-34b")


@pytest.mark.parametrize("arch", RECSYS + LMS)
def test_costs_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch).config, jax_configs.get(arch).config
    if arch in LMS:
        assert costs.lm_flops_per_token(cfg) == jax_costs.lm_flops_per_token(jcfg)
        for train in (False, True):
            assert (costs.lm_model_flops(cfg, 4096, train=train)
                    == jax_costs.lm_model_flops(jcfg, 4096, train=train))
        return
    for fn in ("recsys_flops_per_sample", "recsys_embed_bytes_per_sample",
               "recsys_activation_bytes_per_sample"):
        assert getattr(costs, fn)(cfg) == getattr(jax_costs, fn)(jcfg), fn
    assert costs.recsys_flops_per_sample(cfg) > 0
    for kind in ("gpu", "tpu"):
        _same(lat.accelerator_model(cfg, kind), jax_lat.accelerator_model(jcfg, kind))


def test_gcn_flops_takes_the_reference_config():
    cfg = jax_configs.get("gcn-cora").config
    assert costs.gcn_flops(cfg, 2708, 10556) == jax_costs.gcn_flops(cfg, 2708, 10556) > 0


def test_core_imports_no_model_code():
    code = ("import sys, repro_torch.core.scheduler, repro_torch.core.simulator\n"
            "print(sorted(m for m in sys.modules if m.startswith(('repro_torch.models', "
            "'repro_torch.kernels', 'repro_torch.core.costs', 'repro_torch.core.infra'))))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
    import repro_torch.core as core
    assert core.costs is costs and core.infra is infra


def test_curves_round_trip_with_metadata_inside_each_model(tmp_path):
    path = str(tmp_path / "curves.json")
    curves = {"a": lat.TableDeviceModel(BATCHES, CARD_S), "b": lat.TableDeviceModel([1, 2], [1.0, 2.0])}
    meta = {"a": {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "steps_ms": {"1": {"pad_ms": 0.1}}}}
    lat.save_curves(path, curves, meta)
    with open(path) as f:
        raw = json.load(f)
    assert sorted(raw) == ["a", "b"] and raw["a"]["card"].startswith("NVIDIA")
    assert lat.load_meta(path) == {**meta, "b": {}}
    for load in (lat.load_curves, jax_lat.load_curves):     # the reference reads it too
        back = load(path)
        assert sorted(back) == ["a", "b"]
        assert np.array_equal(back["a"].seconds, CARD_S) and back["b"].batches.tolist() == [1, 2]
    infra_meta = {"c": {"config": "c"}}
    infra.store_curves(tmp_path / "curves.json", {"c": lat.TableDeviceModel([1], [3.0])},
                       infra_meta)
    assert lat.load_meta(path) == {**meta, "b": {}, **infra_meta}


def test_h100_accelerator_reads_the_measured_file_or_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="never measured on the CPU"):
            infra.accelerator("dlrm-rmc2", "h100")
        with pytest.raises(RuntimeError, match="CUDA"):
            infra.measure_card_curve("dlrm-rmc1", cfg=configs.get("dlrm-rmc1").smoke_config)
    lat.save_curves(str(tmp_path / infra.CARD_CURVES),
                    {"dlrm-rmc2": lat.TableDeviceModel(BATCHES, CARD_S)}, {"dlrm-rmc2": {"card": "x"}})
    got = infra.accelerator("dlrm-rmc2", "h100")
    assert np.array_equal(got.seconds, CARD_S)
    _same(infra.accelerator("dlrm-rmc2", "gpu"),
          jax_lat.accelerator_model(jax_configs.get("dlrm-rmc2").config, "gpu"))
    assert not (tmp_path / infra.CPU_CURVES).exists()


def test_measure_cpu_curve_on_a_smoke_config():
    curve = infra.measure_cpu_curve("dlrm-rmc1", cfg=configs.get("dlrm-rmc1").smoke_config,
                                    iters=1)
    assert curve.batches.tolist() == BATCHES
    assert len(curve.seconds) == 6 and bool(np.all(curve.seconds > 0))
    assert infra._measure_cfg("dlrm-rmc2").vocab == 20_000


def test_measure_cpu_curve_on_one_thread_restores_the_threads():
    had = torch.get_num_threads()
    curve = infra.measure_cpu_curve("ncf", cfg=configs.get("ncf").smoke_config, iters=1,
                                    threads=1)
    assert bool(np.all(curve.seconds > 0)) and torch.get_num_threads() == had


def _serve_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if not ln.startswith("[serve] accelerator")]


def test_launcher_prints_the_references_lines_without_an_accelerator(tmp_path):
    curve = {"dlrm-rmc1": {"batches": BATCHES, "seconds": CPU_S}}
    for name in ("cpu_latency_curves.json", infra.CPU_CURVES):
        (tmp_path / name).write_text(json.dumps(curve))
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_ARTIFACTS=str(tmp_path), JAX_PLATFORMS="cpu")
    runs = [subprocess.run([sys.executable, "-m", mod, "--arch", "dlrm-rmc1", *extra],
                           capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
            for mod, extra in (("repro_torch.launch.serve", ["--accel", "none"]),
                               ("repro.launch.serve", []))]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    port, ref = runs[0].stdout, runs[1].stdout
    assert port.splitlines()[0] == "[serve] accelerator: none (CPU executors only)"
    assert _serve_lines(port) == ref.splitlines()
    assert len(ref.splitlines()) == 4 and "@70% load" in ref


def test_launcher_prints_the_cards_line(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    lat.save_curves(str(tmp_path / infra.CPU_CURVES),
                    {"dlrm-rmc1": lat.TableDeviceModel(BATCHES, CPU_S)})
    lat.save_curves(str(tmp_path / infra.CARD_CURVES),
                    {"dlrm-rmc1": lat.TableDeviceModel(BATCHES, CARD_S)},
                    {"dlrm-rmc1": {"card": "NVIDIA H100 80GB HBM3, 700.00 W"}})
    serve.main(["--arch", "dlrm-rmc1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] accelerator: NVIDIA H100 80GB HBM3, 700.00 W")
    assert "1024: 2.500" in out[0]
    tuned = next(ln for ln in out if ln.startswith("  tuned"))
    assert "thr=None" not in tuned
