"""Serving launcher: DeepRecSched over DeepRecInfra for one model, with the
card's measured curve as its accelerator.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-rmc2 --tier medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch ncf --accel none

Reads the host's CPU latency curve for the model (measuring it on the CPU
when ``artifacts/torch_cpu_latency_curves.json`` lacks it) and, for
``--accel h100``, the card's (``artifacts/h100_latency_curves.json``;
measured on the card when the file lacks it, an error without a card).
Prints the accelerator's line, then runs the hill-climbing tuner against
the simulator and prints the static-vs-tuned capacity with the tuned
operating point validated under production faults.  ``--accel none`` tunes
the CPU executors alone; ``gpu``/``tpu`` are the analytic presets.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.paper_models import SLA_TARGETS
from repro_torch.core import infra
from repro_torch.core import latency_model as lat
from repro_torch.core.query_gen import generate_queries
from repro_torch.core.scheduler import static_baseline, tune
from repro_torch.core.simulator import (FaultConfig, SchedulerConfig,
                                        max_qps_under_sla, simulate)


def accel_line(arch: str, kind: str, accel) -> str:
    """What the tuner was given as its accelerator."""
    if kind == "none":
        return "[serve] accelerator: none (CPU executors only)"
    if kind != "h100":
        return f"[serve] accelerator: analytic {kind} preset"
    meta = lat.load_meta(str(infra.artifact_dir() / infra.CARD_CURVES))[arch]
    curve = ", ".join(f"{int(b)}: {s * 1e3:.3f}" for b, s in zip(accel.batches, accel.seconds))
    return f"[serve] accelerator: {meta['card']}, measured ms by bucket {{{curve}}}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rmc1")
    ap.add_argument("--tier", default="medium", choices=["low", "medium", "high"])
    ap.add_argument("--accel", default="h100", choices=["h100", "gpu", "tpu", "none"])
    ap.add_argument("--executors", type=int, default=40)
    args = ap.parse_args(argv)

    cpu = infra.cpu_curves([args.arch])[args.arch]
    sla_ms = SLA_TARGETS[args.arch].get(args.tier)
    accel = None if args.accel == "none" else infra.accelerator(args.arch, args.accel)
    print(accel_line(args.arch, args.accel, accel))

    b0 = static_baseline(1000, args.executors)
    q0 = max_qps_under_sla(cpu, SchedulerConfig(batch_size=b0,
                                                n_executors=args.executors),
                           sla_ms, n_queries=800, iters=7)
    r = tune(cpu, sla_ms, accel=accel, n_executors=args.executors,
             n_queries=800)
    print(f"[serve] {args.arch} @ {args.tier} (p95 ≤ {sla_ms:.0f} ms)")
    print(f"  static  B={b0:<5d}              → {q0:8.0f} QPS")
    print(f"  tuned   B={r.batch_size:<5d} thr={str(r.offload_threshold):<6s}"
          f" → {r.qps:8.0f} QPS  ({r.qps / max(q0, 1e-9):.2f}×)")

    qs = generate_queries(np.random.default_rng(0), 0.7 * r.qps, 3000)
    sim = simulate(qs, cpu,
                   SchedulerConfig(batch_size=r.batch_size,
                                   offload_threshold=r.offload_threshold,
                                   n_executors=args.executors),
                   accel=accel,
                   faults=FaultConfig(straggler_frac=0.02, straggler_mult=4.0,
                                      hedge_factor=3.0, fail_times=(2.0,)))
    status = "OK" if sim.p95_ms <= sla_ms else "VIOLATED"
    print(f"  @70% load w/ faults: p95 {sim.p95_ms:.1f} ms ({status}); "
          f"hedges={sim.hedges} requeued={sim.requeued} "
          f"accel_work={sim.accel_frac_work:.0%}")


if __name__ == "__main__":
    main()
