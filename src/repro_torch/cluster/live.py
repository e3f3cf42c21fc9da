"""Live node backends: real PyTorch serving behind the ``NodeBackend`` contract.

A ``LiveNodeBackend`` wraps one ``serve.runtime.ServingRuntime`` (worker
threads running a PyTorch model on the card, or on the host CPU when the
caller names it) and adapts it to the same interface the simulated nodes
implement, so the fleet driver
(``cluster_sim.drive_fleet``), the routers, and the traffic scenarios run
unchanged against real execution:

  * a *feeder thread* paces submissions on the wall clock — trace time is
    anchored once per run by a shared :class:`WallClock`, every query is
    released at its trace arrival instant, and N backends feed N runtimes
    concurrently (one host process standing in for N machines);
  * completions are read back from the runtime's measured ``QueryRecord``s
    and converted to trace-time coordinates, so live results are directly
    comparable with simulated ones;
  * an optional per-node ``OnlineController`` hill-climbs the runtime's
    batch-size knob from measured p95 — the deployed form of DeepRecSched
    (paper §VI-B), now running per node behind a real router.

Calibration closes the sim-vs-real loop: ``calibrate_device`` measures the
apply_fn at the power-of-two request buckets the runtime actually pads to
and returns a :class:`BucketedDeviceModel` — the device model a
``SimNodeBackend`` twin of the live node plugs into the fast engine.
``chip_smoke.py``'s ``live`` phase runs the same trace through both on the
card and reports simulated-vs-measured agreement.

Two names for two devices: ``device=`` is the node's latency *curve* (a
``BucketedDeviceModel``), as in the JAX package's ``live_node``, and
``torch_device=`` is where the runtime runs the model — the card unless
the caller names another; with no card and none named, it raises.  All
runtimes on one card launch on its default stream, so two workers (or
two nodes) on one card run one after another there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.cluster.backend import CompletedQuery, NodeBackend, PendingQuery
from repro_torch.cluster.fleet import NodeSpec
from repro_torch.serve.batching import bucket_ladder
from repro_torch.serve.runtime import (OnlineController, PacedFeeder,
                                       ServingRuntime)


class WallClock:
    """Shared trace-time ↔ wall-time anchor for one live run.

    Every backend of a fleet holds the same clock; the first ``start``
    pins trace time ``t0`` to the current monotonic instant and later
    calls are no-ops, so all feeders pace against one origin."""

    def __init__(self):
        self.origin: float | None = None   # wall time of trace t = 0

    def start(self, t0_trace: float = 0.0) -> None:
        if self.origin is None:
            self.origin = time.monotonic() - t0_trace

    def wall(self, t_trace: float) -> float:
        if self.origin is None:
            raise RuntimeError("WallClock not started")
        return self.origin + t_trace

    def sleep_until(self, t_trace: float) -> None:
        delay = self.wall(t_trace) - time.monotonic()
        if delay > 0:
            time.sleep(delay)


@dataclasses.dataclass
class BucketedDeviceModel:
    """Measured latency per power-of-two request bucket — the *step*
    function a padding runtime actually exhibits (``pad_batch`` rounds
    every request up to ``bucket_for(size)``), unlike the log-linear
    interpolation of ``TableDeviceModel``.  Batches past the largest
    bucket clamp there, matching ``bucket_for``'s ``max_bucket`` clamp."""
    buckets: np.ndarray            # sorted powers of two
    seconds: np.ndarray

    def __post_init__(self):
        self.buckets = np.asarray(self.buckets, np.int64)
        self.seconds = np.asarray(self.seconds, float)

    def latency(self, batch: int) -> float:
        i = int(np.searchsorted(self.buckets, max(int(batch), 1)))
        return float(self.seconds[min(i, len(self.seconds) - 1)])

    def latency_batch(self, batches: np.ndarray) -> np.ndarray:
        b = np.maximum(np.asarray(batches, np.int64), 1)
        i = np.minimum(np.searchsorted(self.buckets, b),
                       len(self.seconds) - 1)
        return self.seconds[i]


def calibrate_device(apply_fn: Callable[[dict], object],
                     make_batch: Callable[[int, int], dict], *,
                     max_bucket: int = 256, burst: int = 32, reps: int = 5,
                     warmup_bursts: int = 1,
                     buckets: list[int] | None = None,
                     torch_device: torch.device | str | None = None
                     ) -> BucketedDeviceModel:
    """Measure the *steady-state runtime-path* request cost at every
    bucket ≤ ``max_bucket``.

    This is the live tier's analogue of ``infra.measure_cpu_curve``, but
    it measures through a real one-worker ``ServingRuntime`` rather than
    timing the bare apply_fn, and it measures *burst makespan* rather
    than solo round-trips: ``burst`` single-request queries are enqueued
    back-to-back and the per-request cost is (last completion − first
    start) / burst.  A busy worker never sleeps, so the number excludes
    the thread-wake latency a solo round-trip pays on every request (a
    several-hundred-µs overestimate for sub-ms models) while still
    including everything a steady-state request pays — ``pad_batch``,
    host→device transfer, dispatch, compute and the worker's wait for the
    card (a CUDA event synchronize before it stamps ``t_done``).  The
    returned curve is what a simulated twin of the live node feeds the
    fast engine (with ``request_overhead_s = 0``, the overhead being
    folded in), closing the sim-vs-real calibration loop.  The first
    burst per bucket absorbs warm-up (cuBLAS handles, the kernels' first
    launch) and is discarded; the median over ``reps`` resists
    scheduler noise in both directions (a minimum would latch onto
    frequency-boosted bursts and overstate sustained speed).
    """
    if buckets is None:
        buckets = bucket_ladder(max_bucket)
    else:
        # an explicit subset — callers stepping the ladder externally
        # (e.g. the remote tier's lockstep fleet calibration measures one
        # bucket across every worker at once)
        buckets = sorted(int(b) for b in buckets)
        max_bucket = max(max_bucket, buckets[-1])
    # batch_size = max_bucket → any query of size ≤ max_bucket is exactly
    # one request, padded to bucket_for(size) = size for power-of-two sizes
    rt = ServingRuntime(apply_fn, n_workers=1, batch_size=max_bucket,
                        max_bucket=max_bucket, device=torch_device)
    secs, qid = [], 0
    try:
        for b in buckets:
            batch = make_batch(b, -1)
            vals = []
            for rep in range(warmup_bursts + reps):
                q0 = qid
                for _ in range(burst):
                    rt.submit(qid, batch, b)
                    qid += 1
                rt.drain()
                t0 = min(rt.record(q).t_arrival for q in range(q0, qid))
                t1 = max(rt.record(q).t_done for q in range(q0, qid))
                if rep >= warmup_bursts:
                    vals.append((t1 - t0) / burst)
            secs.append(float(np.median(vals)))
    finally:
        rt.shutdown()
    # enforce monotonicity: timing noise at tiny buckets must not invert
    # the curve (a larger bucket can never be cheaper than a smaller one
    # on the padding runtime — it runs the superset shape)
    return BucketedDeviceModel(np.asarray(buckets),
                               np.maximum.accumulate(np.asarray(secs)))


class LiveNodeBackend(NodeBackend):
    """One live serving node: a ``ServingRuntime`` behind the backend
    contract (see module docstring).

    ``make_batch(size, model_id) -> dict`` builds the model input for a
    query — the trace carries only sizes (and tenant labels), the payload
    factory turns them into arrays.  ``spec`` describes the node to the
    routers (calibrated device curve, worker count, batch-size knob);
    execution itself is real, the spec is only the routing/estimation
    view.
    """

    realtime = True

    def __init__(self, runtime: ServingRuntime,
                 make_batch: Callable[[int, int], dict], *, spec: NodeSpec,
                 pool: str = "live", index_in_pool: int = 0,
                 weight: float = 1.0, clock: WallClock | None = None,
                 controller: OnlineController | None = None,
                 own_runtime: bool = False):
        self.rt = runtime
        self.make_batch = make_batch
        self.spec = spec
        self.pool = pool
        self.index_in_pool = index_in_pool
        self.weight = weight
        self.clock = clock or WallClock()
        self.controller = controller
        self.feed_errors: list[str] = []
        self._own_runtime = own_runtime
        # idx → (arrival, size, model_id); sizes kept so a kill can hand
        # unfinished queries back to the controller for re-routing
        self._meta: dict[int, tuple[float, int, int]] = {}
        self._killed = False
        self._log_cursor = 0           # take_new_records position
        self._feeder = PacedFeeder(self.clock.wall, self._release,
                                   self._feed_error)

    # ------------------------------------------------------------ backend

    def start(self, t0: float) -> None:
        self.clock.start(t0)

    def submit(self, idx: np.ndarray, times: np.ndarray, sizes: np.ndarray,
               model_ids: np.ndarray | None = None) -> None:
        if self._killed:
            raise RuntimeError(f"node {self.key} is dead (cancel_pending "
                               f"was called) — it accepts no new queries")
        if self.clock.origin is None and len(times):
            self.clock.start(float(times[0]))
        for j in range(len(idx)):
            i, t = int(idx[j]), float(times[j])
            m = int(model_ids[j]) if model_ids is not None else -1
            self._meta[i] = (t, int(sizes[j]), m)
            self._feeder.put(t, i, int(sizes[j]), m)
        return None

    def advance_to(self, t: float) -> None:
        self.clock.sleep_until(t)

    def drain(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        # bounded feeder wait (queue.join() has no timeout): a feeder
        # still sleeping toward far-future arrivals must trip the caller's
        # timeout, not block for the rest of the trace
        while self._feeder.unfinished:
            if time.monotonic() >= deadline:
                raise TimeoutError("feeder did not drain (queries still "
                                   "scheduled past the timeout)")
            time.sleep(0.005)
        self.rt.drain(max(deadline - time.monotonic(), 0.01))

    def _to_trace(self, r) -> CompletedQuery:
        origin = self.clock.origin or 0.0
        t_arr, _, m = self._meta.get(r.qid, (r.t_arrival - origin, 0, -1))
        # span stamps: the runtime's wall arrival is the instant the
        # feeder released the query into the executor queue, t_started
        # the first worker pickup — both mapped back to trace time
        return CompletedQuery(index=r.qid, t_arrival=t_arr,
                              t_done=r.t_done - origin,
                              model_id=m, error=r.error,
                              t_released=r.t_arrival - origin,
                              t_exec_start=r.t_started - origin
                              if r.t_started > 0.0 else float("nan"))

    def completed_records(self) -> list[CompletedQuery]:
        return [self._to_trace(r) for r in self.rt.completed()]

    def take_new_records(self) -> list[CompletedQuery]:
        """O(new completions): a cursor into the runtime's append-only
        completion log, not a seen-set rescan of every record the node
        ever finished (which would make the driver's per-window p95 loop
        O(total·windows) over a long run)."""
        fresh = self.rt.completed_log(self._log_cursor)
        self._log_cursor += len(fresh)
        return [self._to_trace(r) for r in fresh]

    def idle(self, t: float) -> bool:
        """True once the feeder has released everything it accepted and
        the runtime holds no outstanding query — what terminate-after-idle
        polls on a DRAINING node before closing it mid-run."""
        return not self._feeder.unfinished and self.rt.n_pending == 0

    def cancel_pending(self, t: float) -> list[PendingQuery]:
        """Kill the node mid-run: stop the feeder pacing queries in, shut
        the ``ServingRuntime`` down (workers abandon their queue), and
        return every accepted query that had not completed — both the
        still-scheduled ones and those lost inside the runtime."""
        self._killed = True
        self._feeder.stop()
        self.rt.shutdown()
        done = {r.qid for r in self.rt.completed()}
        return [PendingQuery(index=i, t_arrival=meta[0], size=meta[1],
                             model_id=meta[2])
                for i, meta in sorted(self._meta.items()) if i not in done]

    def close(self) -> None:
        # stop() wakes the feeder even mid-sleep: a close() during the
        # trace (e.g. a drain timeout) must not leave a thread pacing
        # queries into a shut-down runtime for the rest of its wall time
        self._feeder.stop()
        if self._own_runtime:
            self.rt.shutdown()

    # ------------------------------------------------------------- feeder

    def _release(self, qid: int, size: int, mid: int) -> None:
        self.rt.submit(qid, self.make_batch(size, mid), size)
        if self.controller is not None:
            self.controller.step()

    def _feed_error(self, qid: int, e: Exception) -> None:
        self.feed_errors.append(f"qid {qid}: {type(e).__name__}: {e}")


def live_node(apply_fn: Callable[[dict], object],
              make_batch: Callable[[int, int], dict], *, pool: str,
              index_in_pool: int = 0, n_workers: int = 1,
              batch_size: int = 32, max_bucket: int = 256,
              device: BucketedDeviceModel | None = None,
              weight: float = 1.0, clock: WallClock | None = None,
              sla_ms: float | None = None,
              controller_window: int = 25,
              torch_device: torch.device | str | None = None
              ) -> LiveNodeBackend:
    """Boot one live node: calibrate (unless a ``device`` curve is given),
    build the runtime + routing spec, optionally attach a per-node
    ``OnlineController`` when an ``sla_ms`` is named.  The backend owns
    the runtime (``close()`` shuts it down).  The model runs on
    ``torch_device``, the card unless the caller names another."""
    if device is None:
        device = calibrate_device(apply_fn, make_batch, max_bucket=max_bucket,
                                  torch_device=torch_device)
    # overhead is folded into the runtime-path curve (see calibrate_device)
    spec = NodeSpec(cpu=device, n_executors=n_workers,
                    batch_size=min(batch_size, max_bucket),
                    request_overhead_s=0.0)
    rt = ServingRuntime(apply_fn, n_workers=n_workers,
                        batch_size=spec.batch_size, max_bucket=max_bucket,
                        device=torch_device)
    ctl = OnlineController(rt, sla_ms, window=controller_window) \
        if sla_ms is not None else None
    return LiveNodeBackend(rt, make_batch, spec=spec, pool=pool,
                           index_in_pool=index_in_pool, weight=weight,
                           clock=clock, controller=ctl, own_runtime=True)
