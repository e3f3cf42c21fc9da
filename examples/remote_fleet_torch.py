"""A remote mini-datacenter with the PyTorch port: real worker *processes*
behind the fleet driver — the paper's "hundreds of machines" (§VII) as
separate OS processes instead of threads sharing one interpreter lock,
the counterpart of the JAX package's ``examples/remote_fleet.py``.

Three workers are spawned (``python -m repro_torch.serve.remote`` each
hosting a ``ServingRuntime``; by default each serves the ``mlp`` model on
the card, with ``--device cpu`` on the host), calibrated in lockstep so
every node's device curve carries the contention of the whole fleet busy,
and driven through the same ``drive_fleet`` loop the simulated and
in-process live tiers use.  Mid-run one worker takes a genuine
``SIGKILL`` (the ``FleetFaults`` path): its unfinished queries re-route to
the survivors and the supervisor reaps the corpse.

    PYTHONPATH=src python examples/remote_fleet_torch.py                # workers on the card
    PYTHONPATH=src python examples/remote_fleet_torch.py --device cpu   # workers on the host CPU
"""
import argparse

import numpy as np

from repro_torch.cluster import (FleetFaults, NodeKill, WallClock, drive_fleet,
                                 make_router)
from repro_torch.cluster.remote import WorkerSupervisor, boot_remote_fleet
from repro_torch.core.query_gen import SizeDist

MODEL = "mlp:128:256:2"
N_NODES = 3
MAX_BUCKET = 64
N_QUERIES = 240
LOAD_FRAC = 0.5               # fraction of the calibrated capacity to offer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the workers serve: the card when omitted, or cpu")
    ap.add_argument("--model", default=MODEL, help="model spec each worker serves")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    clock = WallClock()
    with WorkerSupervisor(torch_device=args.device) as sup:
        print(f"booting {N_NODES} worker processes of {args.model} "
              f"on {args.device or 'the card'} …")
        fleet = boot_remote_fleet(args.model, N_NODES, supervisor=sup,
                                  batch_size=MAX_BUCKET, max_bucket=MAX_BUCKET,
                                  burst=16, reps=3, clock=clock)
        boot = fleet[0].spec.boot_s
        pids = [b.handle.pid for b in fleet]
        print(f"  pids={pids}  measured boot+calibrate={boot:.2f}s")
        b64 = fleet[0].spec.cpu.latency(MAX_BUCKET) * 1e3
        rate = N_NODES * LOAD_FRAC / fleet[0].spec.cpu.latency(MAX_BUCKET)
        print(f"  contended b{MAX_BUCKET}={b64:.2f}ms → offering {rate:.0f} qps")

        sizes = SizeDist("production", max_size=MAX_BUCKET).sample(rng, N_QUERIES)
        horizon = N_QUERIES / rate
        kill_t = 0.5 * horizon
        # a flash crowd right before the kill: the victim dies holding a
        # queue, so there is actually something to re-route
        n_burst = N_QUERIES // 4
        times = np.sort(np.concatenate([
            rng.uniform(0.0, horizon, N_QUERIES - n_burst),
            rng.uniform(kill_t - 0.03 * horizon, kill_t - 1e-3, n_burst)]))
        print(f"serving {N_QUERIES} queries over {horizon:.2f}s "
              f"(flash crowd of {n_burst} before the kill); "
              f"SIGKILL of worker 0 at t={kill_t:.2f}s …")
        r = drive_fleet(
            times, sizes, fleet, make_router("least_outstanding"),
            window_s=horizon / 8,
            fleet_faults=FleetFaults(kills=(NodeKill(kill_t, "remote", 0),)),
            drain_timeout=120)

        print(f"\ncompleted {r.n_queries}/{N_QUERIES} "
              f"(dropped={r.dropped}, re-routed={r.rerouted})")
        print(f"p50={r.p50_ms:.1f}ms  p95={r.p95_ms:.1f}ms  "
              f"p99={r.p99_ms:.1f}ms  qps={r.qps:.0f}")
        print(f"victim exit code: {fleet[0].handle.proc.returncode} (SIGKILL = -9)")
        reaped = sup.reap()
        print(f"supervisor reaped: {[h.pid for h in reaped]}")
        for b in fleet:
            b.close()


if __name__ == "__main__":
    main()
