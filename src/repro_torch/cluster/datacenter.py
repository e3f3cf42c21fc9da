"""The JAX package's two datacenter scenarios on the port, as functions
that return their numbers: ``examples/datacenter_sim.py``'s at-scale
table and ``examples/datacenter_fleet.py``'s fleet day.  The port's
examples (``datacenter_sim_torch.py``, ``datacenter_fleet_torch.py``) print
them as the reference does; ``chip_smoke.py``'s ``datacenter`` phase runs
them on the curves it has just measured on the card.

* ``sim_rows`` — per model: the static baseline's QPS under the SLA,
  DeepRecSched's tuned QPS and B*, and p95 at 70 % of the tuned capacity
  under stragglers, hedging and an executor failure; with the card's
  curves, the same tuned with the card as each node's accelerator.
* ``build_fleet`` / ``fleet_day`` — a heterogeneous tier (Skylake,
  Broadwell at 1.5× the curve, an accelerated pool), tuned per pool,
  through one compressed diurnal day: static against reactive
  autoscaling, four routers, reactive against predictive scaling with
  node boot latency, and a mid-day kill with and without re-route.

Calls and constants are the reference's, in the reference's order, so
that both packages give the same numbers on the same curves.
"""
from __future__ import annotations

import numpy as np

from repro_torch.cluster.autoscaler import Autoscaler, PredictiveAutoscaler
from repro_torch.cluster.cluster_sim import simulate_fleet
from repro_torch.cluster.fleet import Fleet, NodeSpec, Pool, ScaledDeviceModel
from repro_torch.cluster.lifecycle import FleetFaults, NodeKill
from repro_torch.cluster.router import make_router
from repro_torch.cluster.traffic import DiurnalTraffic
from repro_torch.configs.paper_models import SLA_TARGETS
from repro_torch.core import infra
from repro_torch.core.latency_model import (GPU_1080TI, AnalyticalDeviceModel,
                                            TableDeviceModel)
from repro_torch.core.query_gen import generate_queries
from repro_torch.core.scheduler import static_baseline, tune
from repro_torch.core.simulator import (FaultConfig, SchedulerConfig,
                                        max_qps_under_sla, simulate)

# ---- the at-scale table (examples/datacenter_sim.py)
MODELS = ("dlrm-rmc1", "dlrm-rmc3", "wnd")
TIER = "medium"
N_EXECUTORS = 40
TUNE_QUERIES = 1500
# production realism: 70 % of capacity, 2 % stragglers at 4x, hedges at
# 3x, one executor failure at t = 2 s
LOAD = 0.7
REALISM_QUERIES = 2000
FAULTS = FaultConfig(straggler_frac=0.02, straggler_mult=4.0, hedge_factor=3.0,
                     fail_times=(2.0,))

# ---- the fleet day (examples/datacenter_fleet.py)
FLEET_ARCH = "dlrm-rmc1"
SLA_MS = 100.0           # dlrm-rmc1 medium tier
DAY_S = 60.0             # one diurnal period, compressed; 30 autoscaler
#                          windows a day and a node boot of 3 windows
ROUTERS = ("round_robin", "least_outstanding", "size_aware", "hetero")


def _realism(cpu, sla_ms: float, cfg: SchedulerConfig, qps: float, *, accel=None,
             seed: int = 0) -> dict:
    """p95 at ``LOAD`` of ``qps`` under ``FAULTS`` (the events engine)."""
    qs = generate_queries(np.random.default_rng(seed), LOAD * qps, REALISM_QUERIES)
    sim = simulate(qs, cpu, cfg, accel=accel, faults=FAULTS, seed=seed)
    return {"p95_ms": sim.p95_ms, "ok": sim.p95_ms <= sla_ms, "hedges": sim.hedges,
            "requeued": sim.requeued, "n_queries": sim.n_queries, "dropped": sim.dropped}


def sim_rows(models, tier, cpu_curves, card_curves=None, *, seed: int = 0) -> list[dict]:
    """One row a model: the static baseline's QPS under the SLA, the
    tuner's on the CPU executors alone, its B*, and p95 at 70 % of the
    tuned capacity under stragglers, hedging and an executor failure.
    With ``card_curves`` (arch → the card's latency model) each row also
    holds the tuner with the card as the accelerator and the same faulted
    run with the card."""
    rows = []
    for arch in models:
        cpu = cpu_curves[arch]
        sla_ms = SLA_TARGETS[arch].get(tier)
        b0 = static_baseline(1000, N_EXECUTORS)
        # tuning runs on the numpy fast-path simulator (no faults there); the
        # realism run has faults active and routes to the event-driven engine
        q0 = max_qps_under_sla(cpu, SchedulerConfig(batch_size=b0), sla_ms,
                               n_queries=TUNE_QUERIES, iters=7, seed=seed)
        r = tune(cpu, sla_ms, n_queries=TUNE_QUERIES, seed=seed)
        row = {"arch": arch, "sla_ms": sla_ms, "static_batch": b0, "static": q0,
               "tuned": r.qps, "x": r.qps / max(q0, 1e-9), "batch": r.batch_size,
               **_realism(cpu, sla_ms, SchedulerConfig(batch_size=r.batch_size,
                                                       n_executors=N_EXECUTORS),
                          r.qps, seed=seed)}
        if card_curves is not None:
            card = card_curves[arch]
            rc = tune(cpu, sla_ms, accel=card, n_queries=TUNE_QUERIES, seed=seed)
            row["card"] = {
                "tuned": rc.qps, "batch": rc.batch_size, "threshold": rc.offload_threshold,
                **_realism(cpu, sla_ms, SchedulerConfig(batch_size=rc.batch_size,
                                                        offload_threshold=rc.offload_threshold,
                                                        n_executors=N_EXECUTORS),
                           rc.qps, accel=card, seed=seed)}
        rows.append(row)
    return rows


def build_fleet(synthetic: bool, *, cpu=None, accel=None) -> Fleet:
    """Skylake ×8 (min 2), Broadwell ×4 at 1.5× the CPU curve (min 1) and an
    accelerated pool ×4 (min 1).  ``synthetic`` takes the reference's
    canned CPU curve and analytic GTX 1080 Ti (pool "gpu"); otherwise the
    CPU pools take the host CPU's measured torch curve of FLEET_ARCH and
    the pool "h100" the card's (``infra.accelerator``, which raises
    without the curve file and without a card).  ``cpu`` and ``accel``
    replace the measured curves read from the files."""
    if synthetic:
        cpu = TableDeviceModel(
            np.array([1., 4, 16, 64, 256, 1024]),
            np.array([.0008, .001, .0018, .0045, .015, .058]))
        accel = AnalyticalDeviceModel(
            flops_per_sample=2e9, mem_bytes_per_sample=4e6,
            in_bytes_per_sample=4e4, **GPU_1080TI)
        accel_pool = "gpu"
    else:
        cpu = cpu if cpu is not None else infra.cpu_curves([FLEET_ARCH])[FLEET_ARCH]
        accel = accel if accel is not None else infra.accelerator(FLEET_ARCH, "h100")
        accel_pool = "h100"
    old = ScaledDeviceModel(cpu, 1.5)
    return Fleet([
        Pool("skylake", NodeSpec(cpu=cpu), count=8, min_count=2),
        Pool("broadwell", NodeSpec(cpu=old), count=4, min_count=1),
        Pool(accel_pool, NodeSpec(cpu=cpu, accel=accel), count=4, min_count=1),
    ])


def fleet_day(fleet: Fleet, *, day_s: float = DAY_S, seed: int = 0) -> dict:
    """Tune each pool, then drive one compressed diurnal day of ``day_s``
    through the static fleet, reactive autoscaling, the four routers,
    reactive against predictive scaling with node boot latency, and a
    kill of a quarter of the skylake pool at ``day_s / 2`` with and
    without re-route.  The autoscalers' window is ``day_s / 30`` and the
    boot ``day_s / 10``, as the reference's 2 s and 6 s of its 60 s day.
    Returns every number the JAX example prints; sets the pools' boot
    latency."""
    window_s, boot_s = day_s / 30, day_s / 10
    out = {"fleet": repr(fleet), "sla_ms": SLA_MS, "day_s": day_s, "window_s": window_s,
           "boot_s": boot_s}
    fleet.tune(SLA_MS, n_queries=1000)
    out["pools"] = [{"name": p.name, "count": p.count, "batch": p.spec.batch_size,
                     "threshold": p.spec.offload_threshold, "node_qps": p.qps_capacity}
                    for p in fleet.pools]

    # a compressed day at ~45% mean / ~72% peak of the tuned fleet capacity
    base = 0.45 * fleet.total_capacity()
    traffic = DiurnalTraffic(base_qps=base, amplitude=0.6, period_s=day_s)
    times, sizes = traffic.generate(np.random.default_rng(seed), day_s)
    out.update(queries=len(times), base_qps=traffic.base_qps, amplitude=traffic.amplitude)

    # ---- static peak-provisioned fleet vs reactive autoscaling
    router = make_router("hetero")
    r_static = simulate_fleet(times, sizes, fleet, router)
    r_auto = simulate_fleet(times, sizes, fleet, router, window_s=window_s,
                            autoscaler=Autoscaler(sla_ms=SLA_MS))
    out["timeline"] = [(t0, offered, n_nodes, p95)
                       for t0, offered, n_nodes, p95, *_ in r_auto.timeline[::3]]
    out["static"] = {"p95_ms": r_static.p95_ms, "node_hours": r_static.node_hours,
                     "nodes": fleet.n_nodes, "served": r_static.n_queries,
                     "dropped": r_static.dropped}
    out["autoscaled"] = {"p95_ms": r_auto.p95_ms, "node_hours": r_auto.node_hours,
                         "saved_pct": (1.0 - r_auto.node_hours / r_static.node_hours) * 100.0,
                         "events": len(r_auto.events), "final_nodes": r_auto.n_nodes,
                         "meets_sla": r_auto.meets(SLA_MS), "served": r_auto.n_queries,
                         "dropped": r_auto.dropped}

    # ---- routing policies at the diurnal peak
    out["routers"] = {}
    for name in ROUTERS:
        r = simulate_fleet(times, sizes, fleet, make_router(name))
        out["routers"][name] = {"p95_ms": r.p95_ms, "meets_sla": r.meets(SLA_MS)}

    # ---- predictive boot-ahead scaling: nodes take boot_s to come up
    for p in fleet.pools:
        p.spec.boot_s = boot_s
    predictive = PredictiveAutoscaler(sla_ms=SLA_MS, traffic=traffic,
                                      lead_s=boot_s + 2 * window_s)
    r_pred = simulate_fleet(times, sizes, fleet, make_router("round_robin"),
                            window_s=window_s, autoscaler=predictive)
    r_rct = simulate_fleet(times, sizes, fleet, make_router("round_robin"),
                           window_s=window_s, autoscaler=Autoscaler(sla_ms=SLA_MS))
    out["boot"] = {name: {"sla_violation_minutes": r.sla_violation_minutes(SLA_MS),
                          "node_hours": r.node_hours,
                          "triggers": sorted({e.reason for e in r.events})}
                   for name, r in (("reactive", r_rct), ("predictive", r_pred))}

    # ---- kill a quarter of the skylake pool mid-day: re-route recovers
    n_sky = fleet.pool("skylake").count
    kills = tuple(NodeKill(day_s / 2, "skylake", i) for i in range(max(n_sky // 4, 1)))
    r_kill = simulate_fleet(times, sizes, fleet, make_router("round_robin"),
                            window_s=window_s, fleet_faults=FleetFaults(kills=kills))
    r_drop = simulate_fleet(times, sizes, fleet, make_router("round_robin"),
                            window_s=window_s,
                            fleet_faults=FleetFaults(kills=kills, reroute=False))
    out["kill"] = {"killed": len(kills), "at_s": day_s / 2,
                   "reroute": {"rerouted": r_kill.rerouted, "dropped": r_kill.dropped,
                               "served": r_kill.n_queries, "p95_ms": r_kill.p95_ms},
                   "no_reroute": {"rerouted": r_drop.rerouted, "dropped": r_drop.dropped,
                                  "served": r_drop.n_queries}}
    return out
