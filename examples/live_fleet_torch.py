"""A live two-node datacenter with the PyTorch port: DLRM-RMC1 served by a
card node and a host-CPU node behind the heterogeneity-aware router, each
with its own online DeepRecSched controller, under two tenants — the
paper's deployment story (§VII) running real models instead of the
simulator, the counterpart of the JAX package's ``examples/live_fleet.py``.

Both nodes are calibrated through the serving runtime, weighted by their
simulated capacity under the SLA, and serve a two-tenant mix (a
big-query tenant pinned to the card's pool by router affinity).  The same
trace is then replayed through the nodes' simulated twins.

    PYTHONPATH=src python examples/live_fleet_torch.py                # card + host CPU, published size
    PYTHONPATH=src python examples/live_fleet_torch.py --device cpu   # both on the CPU, smoke config
"""
import argparse
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.cluster import (MultiTenantTraffic, StationaryTraffic, WallClock,
                                 calibrate_device, drive_fleet, live_node, make_router,
                                 sim_backends)
from repro_torch.cluster.fleet import NodeView
from repro_torch.configs.paper_models import SLA_TARGETS
from repro_torch.core.query_gen import PRODUCTION, SizeDist
from repro_torch.core.simulator import max_qps_under_sla
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve
from repro_torch.models import recsys

ARCH = "dlrm-rmc1"
HORIZON_S = 3.0
MAX_BUCKET = 256
# fraction of the simulated capacity sum to offer: the twins price each
# node's own work, while one process also pays every node's Python dispatch
# under one interpreter lock (at 0.3 on the CPU smoke config the host node's
# controller stepped its batch down and the node fell behind)
LOAD_FRAC = 0.1


def node_model(params, cfg, seed: int):
    """``apply_fn`` for one node's weights, and a payload factory slicing one
    host template as large as the largest query."""
    template = syn.recsys_batch(np.random.default_rng(seed), cfg, PRODUCTION.max_size,
                                with_label=False)

    def apply_fn(batch):
        return recsys.forward(params, cfg, batch)

    def make_batch(size, model_id):
        return {k: v[:size] for k, v in template.items()}

    return apply_fn, make_batch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the first node's device (default: the card); 'cpu' runs both "
                         "nodes on the CPU at the smoke config")
    dev = resolve(ap.parse_args().device)
    entry = configs.get(ARCH)
    cfg = entry.config if dev.type == "cuda" else entry.smoke_config
    sla_ms = SLA_TARGETS[ARCH].medium_ms
    # each node its own weights, made from the seed where it runs
    models = {}
    for seed, (pool, where) in enumerate((("card", dev), ("host", torch.device("cpu")))):
        params = recsys.init(torch.Generator(device=where).manual_seed(0), cfg, device=where)
        models[pool] = (where, *node_model(params, cfg, seed))

    # the host node's forward gets all cores but two: one for the card
    # node's worker thread, one for the feeders and the driver
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))
    try:
        print(f"{cfg.name}: calibrating both nodes through the runtime ...")
        clock, nodes = WallClock(), []
        for pool, (where, apply_fn, make_batch) in models.items():
            curve = calibrate_device(apply_fn, make_batch, max_bucket=MAX_BUCKET,
                                     torch_device=where)
            node = live_node(apply_fn, make_batch, pool=pool, device=curve,
                             batch_size=MAX_BUCKET, max_bucket=MAX_BUCKET, clock=clock,
                             sla_ms=sla_ms, torch_device=where)
            node.weight = max_qps_under_sla(node.spec.cpu, node.spec.scheduler_config(),
                                            sla_ms, n_queries=400, seed=5)
            nodes.append(node)
            print(f"  {pool} on {where}: b1={curve.latency(1) * 1e3:.2f}ms  "
                  f"b{MAX_BUCKET}={curve.latency(MAX_BUCKET) * 1e3:.2f}ms  "
                  f"node_qps={node.weight:7.0f}")

        total = sum(n.weight for n in nodes)
        traffic = MultiTenantTraffic(tenants=(
            ("ranker", StationaryTraffic(0.8 * LOAD_FRAC * total), PRODUCTION),
            ("bulk", StationaryTraffic(0.2 * LOAD_FRAC * total),
             SizeDist("production", mean=300.0)),
        ))
        times, sizes, labels = traffic.generate_labeled(np.random.default_rng(0), HORIZON_S)
        print(f"\ntwo-tenant trace: {len(times)} queries over {HORIZON_S:.0f}s "
              f"(~{LOAD_FRAC * total:.0f} qps offered, SLA {sla_ms:.0f}ms)")
        router = make_router("hetero")
        router.affinity = {1: {"card"}}             # big queries go to the card's pool
        r_live = drive_fleet(times, sizes, nodes, router, model_ids=labels)
    finally:
        torch.set_num_threads(threads)

    print(f"\nlive : qps={r_live.qps:7.0f}  p50={r_live.p50_ms:6.2f}ms  "
          f"p95={r_live.p95_ms:6.2f}ms  dropped={r_live.dropped} errors={r_live.errors}")
    for name, ps in r_live.per_pool.items():
        print(f"  pool {name:5s} {ps.n_queries:5d} queries  p95={ps.p95_ms:6.2f}ms")
    for mid, ms in sorted(r_live.per_model.items()):
        print(f"  tenant {traffic.tenants[mid][0]:7s} {ms.n_queries:5d} queries  "
              f"p95={ms.p95_ms:6.2f}ms")
    for n in nodes:
        if n.controller is not None and n.controller.history:
            knobs = [b for b, _ in n.controller.history]
            print(f"  controller {n.pool}: batch {knobs[:8]}{'...' if len(knobs) > 8 else ''}")

    # the same trace through the simulated twins
    twins = sim_backends([NodeView(n.pool, n.index_in_pool, n.spec, n.weight) for n in nodes])
    r_sim = drive_fleet(times, sizes, twins, router, model_ids=labels)
    print(f"sim  : qps={r_sim.qps:7.0f}  p50={r_sim.p50_ms:6.2f}ms  "
          f"p95={r_sim.p95_ms:6.2f}ms  dropped={r_sim.dropped}")
    print(f"\nsim-vs-live p95 gap: {abs(r_sim.p95_ms - r_live.p95_ms):.2f}ms "
          f"(SLA {sla_ms:.0f}ms: live {'OK' if r_live.meets(sla_ms) else 'VIOLATED'})")
    for n in nodes:
        n.close()


if __name__ == "__main__":
    main()
