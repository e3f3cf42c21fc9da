"""DeepRecSched (paper §IV): hill-climbing over the two knobs.

1. per-request batch size — start at 1, climb the pow-2 ladder while the
   achievable QPS under the p95 SLA improves;
2. accelerator query-size threshold — start at 1 (everything offloaded),
   climb while QPS improves.

The static production baseline splits the *largest* query evenly over all
executors (batch = max_size / n_executors — e.g. 25 on a 40-core Skylake),
which is what the paper doubles.

Tuning-loop fast paths (all preserving the climb's selection rule):
  * warm start — neighboring knob points have near-identical achievable
    QPS, so each ``max_qps_under_sla`` call brackets around the previous
    point's answer instead of doubling up from λ=1 (``warm_start=True``);
  * parallel ladder — ``workers=N`` evaluates whole ladders eagerly in a
    process pool (each point cold, no warm-start hints — pool points are
    independent) and then replays the patience walk over the results in
    ladder order, so the chosen config matches a sequential
    ``warm_start=False`` climb exactly; vs a warm-started climb the picked
    knob can differ only when two ladder points' QPS are within the
    bracket's warm-start perturbation (≲5%).  The pool uses the spawn
    start method, so a script calling ``tune(workers=N)`` needs the usual
    ``if __name__ == "__main__":`` guard.  A spawned worker imports
    ``repro_torch`` and so torch, but this module and the simulator never
    touch CUDA, so the workers never initialise it.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Sequence

from repro_torch.core.latency_model import ContentionModel, DeviceModel
from repro_torch.core.query_gen import PRODUCTION, SizeDist
from repro_torch.core.simulator import SchedulerConfig, max_qps_under_sla

BATCH_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

# offload-threshold hill-climb rungs (paper Fig. 10 sweep).  The last rung
# means "never offload" for the default 1000-candidate size cap; ``tune``
# swaps it for ``size_dist.max_size + 1`` so non-default caps keep an
# explicit no-offload point.  The online controller climbs the same rungs.
THRESHOLD_LADDER = (1, 25, 50, 100, 150, 200, 300, 450, 700, 1001)


@dataclasses.dataclass
class TuneResult:
    batch_size: int
    offload_threshold: int | None
    qps: float
    trace: list[tuple]                   # (knob, value, qps) visited


def static_baseline(max_size: int, n_executors: int) -> int:
    return max(1, max_size // n_executors)


def _ladder_point(args) -> float:
    """Module-level worker so ladder points pickle into a process pool."""
    (cpu, cfg, sla_ms, accel, size_dist, contention, n_queries, seed,
     engine) = args
    return max_qps_under_sla(cpu, cfg, sla_ms, accel=accel,
                             size_dist=size_dist, contention=contention,
                             n_queries=n_queries, seed=seed, engine=engine)


def _climb(values: Sequence, evaluate, knob: str, trace: list,
           patience: int) -> tuple:
    """Patience-bounded hill climb; ``evaluate(v, idx, hint)`` → qps."""
    best_v, best_q = values[0], evaluate(values[0], 0, None)
    trace.append((knob, best_v, best_q))
    prev_q, misses = best_q, 0
    for i, v in enumerate(values[1:], start=1):
        q = evaluate(v, i, prev_q)
        trace.append((knob, v, q))
        prev_q = q
        if q > best_q:
            best_v, best_q, misses = v, q, 0
        else:
            misses += 1
            if misses > patience:
                break
    return best_v, best_q


def tune(cpu: DeviceModel, sla_ms: float, *, accel: DeviceModel | None = None,
         n_executors: int = 40, n_accelerators: int = 1,
         request_overhead_s: float = 1.35e-4,
         size_dist: SizeDist = PRODUCTION,
         contention: ContentionModel | None = None,
         batch_ladder: Sequence[int] = BATCH_LADDER,
         patience: int = 1, n_queries: int = 1500, seed: int = 0,
         engine: str = "auto", warm_start: bool = True,
         workers: int | None = None) -> TuneResult:
    """Run DeepRecSched's two hill climbs; returns the tuned config.

    ``n_accelerators``/``request_overhead_s`` parameterize the node being
    tuned (defaults match ``SchedulerConfig``) — the cluster tier tunes
    per-pool node classes whose configs differ in more than executor
    count."""
    trace: list[tuple] = []

    def point_cfg(batch: int, thr: int | None) -> SchedulerConfig:
        return SchedulerConfig(batch_size=batch, offload_threshold=thr,
                               n_executors=n_executors,
                               n_accelerators=n_accelerators,
                               request_overhead_s=request_overhead_s)

    def point_args(batch: int, thr: int | None):
        return (cpu, point_cfg(batch, thr), sla_ms, accel, size_dist,
                contention, n_queries, seed, engine)

    def run_ladder(knob: str, values: Sequence, make_cfg, pool) -> tuple:
        if pool is not None:
            args = [point_args(*make_cfg(v)) for v in values]
            results = list(pool.map(_ladder_point, args))
            return _climb(values, lambda v, i, hint: results[i],
                          knob, trace, patience)
        def evaluate(v, i, hint):
            return max_qps_under_sla(
                cpu, point_cfg(*make_cfg(v)), sla_ms, accel=accel,
                size_dist=size_dist, contention=contention,
                n_queries=n_queries, seed=seed,
                hint=hint if warm_start else None, engine=engine)
        return _climb(values, evaluate, knob, trace, patience)

    # one pool for both climbs — spawn worker startup is the fixed cost of
    # parallel mode, so pay it once (spawn, not fork: callers usually have
    # torch loaded, which is multithreaded, and forking that can deadlock;
    # a forked child cannot use CUDA either)
    pool = None
    if workers and workers > 1:
        pool = ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))
    try:
        # ---- knob 1: batch size (CPU path), no offload during this climb
        best_b, best_q = run_ladder("batch", list(batch_ladder),
                                    lambda b: (b, None), pool)

        if accel is None:
            return TuneResult(best_b, None, best_q, trace)

        # ---- knob 2: offload threshold (paper: start at 1 = all offloaded)
        thr_ladder = list(THRESHOLD_LADDER[:-1]) + [size_dist.max_size + 1]
        best_t, best_tq = run_ladder("threshold", thr_ladder,
                                     lambda t: (best_b, t), pool)
        if best_tq >= best_q:
            return TuneResult(best_b, best_t, best_tq, trace)
        return TuneResult(best_b, None, best_q, trace)
    finally:
        if pool is not None:
            pool.shutdown()
