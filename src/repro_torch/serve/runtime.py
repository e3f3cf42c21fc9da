"""Live serving runtime: real execution behind the DeepRecSched controllers.

Queries → split into requests of ≤ batch_size → FIFO queue → worker threads
pad each request to its bucket on the host, move it to the device, run the
model and wait for the device → a query completes when its last request
lands.  An online DeepRecSched controller periodically hill-climbs the
batch-size knob using the measured p95 over a sliding window — the
"deployed in production" form of the offline tuner (paper §VI-B).

PyTorch returns from a CUDA call before the GPU has finished, so a worker
records a CUDA event after ``apply_fn`` and waits on it before it stamps
``t_done``: a query's latency includes the device time it caused.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.scheduler import BATCH_LADDER, THRESHOLD_LADDER
from repro_torch.device import resolve
from repro_torch.serve.batching import bucket_for, pad_batch


def to_device(batch: dict, device: torch.device) -> dict:
    """Host request (numpy or tensor leaves) → tensors on ``device``."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


@dataclasses.dataclass
class _Request:
    qid: int
    batch: dict
    size: int


@dataclasses.dataclass
class QueryRecord:
    qid: int
    size: int
    t_arrival: float
    t_done: float = 0.0
    # wall instant a worker first picked one of the query's requests up —
    # the span layer's exec_start stamp; 0.0 until then
    t_started: float = 0.0
    error: str | None = None   # first apply_fn failure among the requests

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_arrival) * 1e3


class ServingRuntime:
    """n_workers threads over a shared request queue."""

    def __init__(self, apply_fn: Callable[[dict], object], *,
                 n_workers: int = 2, batch_size: int = 64,
                 max_bucket: int = 1024,
                 device: torch.device | str | None = None):
        """``apply_fn`` receives one padded request as a dict of tensors on
        ``device`` (the GPU unless the caller passes one)."""
        self._apply = apply_fn
        self.device = resolve(device)
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._outstanding: dict[int, int] = {}
        self._records: dict[int, QueryRecord] = {}
        self.batch_size = batch_size
        self.max_bucket = max_bucket
        self._n_done = 0
        self._fresh_done: list[QueryRecord] = []
        self._done_log: list[QueryRecord] = []
        self._stop = threading.Event()
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(n_workers)]
        for w in self._workers:
            w.start()

    # ---------------------------------------------------------------- api

    def submit(self, qid: int, batch: dict, size: int) -> None:
        """Split one query (leaves have leading dim ``size``) into requests.

        Requests are capped at ``max_bucket`` even when the batch-size knob
        climbs past it — ``bucket_for`` clamps there, and ``pad_batch``
        rejects oversize requests rather than dropping rows."""
        if size <= 0:
            # zero requests would leave a permanent _outstanding entry
            # that no worker ever clears, deadlocking drain()
            raise ValueError(f"query size must be >= 1, got {size}")
        bsz = min(self.batch_size, self.max_bucket)
        n_req = -(-size // bsz)
        with self._lock:
            self._records[qid] = QueryRecord(qid, size, time.monotonic())
            self._outstanding[qid] = n_req
        for i in range(n_req):
            lo, hi = i * bsz, min((i + 1) * bsz, size)
            sub = {k: v[lo:hi] for k, v in batch.items()}
            self._q.put(_Request(qid, sub, hi - lo))

    def drain(self, timeout: float = 60.0) -> None:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            with self._lock:
                if not self._outstanding:
                    return
            time.sleep(0.005)
        raise TimeoutError("serving queue did not drain")

    def shutdown(self) -> None:
        self._stop.set()
        for _ in self._workers:
            self._q.put(None)
        for w in self._workers:
            w.join(timeout=5)

    def completed(self) -> list[QueryRecord]:
        with self._lock:
            return [r for r in self._records.values() if r.t_done > 0]

    def record(self, qid: int) -> QueryRecord:
        with self._lock:
            return self._records[qid]

    @property
    def n_completed(self) -> int:
        """Completed-query count — an O(1) read (plain int, GIL-atomic)."""
        return self._n_done

    @property
    def n_pending(self) -> int:
        """Queries accepted but not yet fully completed — the idleness
        probe terminate-after-idle reads on a draining node."""
        with self._lock:
            return len(self._outstanding)

    def take_completed(self) -> list[QueryRecord]:
        """Atomically drain the completed-since-last-call buffer, in
        completion order.  This is the control loop's feed: per-query
        polls cost O(new completions), not an O(all records) rebuild
        under the lock (which would make a long-lived serving process
        quadratic in its own history)."""
        with self._lock:
            out, self._fresh_done = self._fresh_done, []
            return out

    def completed_log(self, start: int) -> list[QueryRecord]:
        """Completion-ordered records from position ``start`` of the
        append-only completion log — an O(new) read for callers keeping
        their own cursor (``len(previous) + start`` is the next cursor).
        Independent of ``take_completed``'s drain buffer, so a fleet's
        window monitor and a node's ``OnlineController`` can
        both consume completions without stealing each other's records.
        """
        with self._lock:
            return self._done_log[start:]

    def percentile_ms(self, p: float) -> float:
        lats = [r.latency_ms for r in self.completed()]
        return float(np.percentile(lats, p)) if lats else 0.0

    # ------------------------------------------------------------- worker

    def _worker(self) -> None:
        on_gpu = self.device.type == "cuda"
        while not self._stop.is_set():
            req = self._q.get()
            if req is None:
                return
            # first-dispatch stamp, lockless: the record was inserted
            # before the request was enqueued, and a two-worker race on
            # the first two requests differs by a queue handoff at most
            rec0 = self._records.get(req.qid)
            if rec0 is not None and rec0.t_started == 0.0:
                rec0.t_started = time.monotonic()
            err = None
            try:
                bucket = bucket_for(req.size, self.max_bucket)
                padded = pad_batch(req.batch, bucket)
                with torch.inference_mode():         # serving builds no graph
                    self._apply(to_device(padded, self.device))
                if on_gpu:
                    # the launches above are only enqueued; the request is
                    # done when the device has run them
                    torch.cuda.current_stream(self.device).record_event().synchronize()
            except Exception as e:
                # an apply_fn failure must not kill the worker thread or
                # strand the query's _outstanding entry (which would
                # deadlock drain()) — complete the query, carry the error
                err = f"{type(e).__name__}: {e}"
            finally:
                now = time.monotonic()
                with self._lock:
                    rec = self._records[req.qid]
                    if err is not None and rec.error is None:
                        rec.error = err
                    self._outstanding[req.qid] -= 1
                    if self._outstanding[req.qid] == 0:
                        del self._outstanding[req.qid]
                        rec.t_done = now
                        self._n_done += 1
                        self._fresh_done.append(rec)
                        self._done_log.append(rec)


class PacedFeeder:
    """Releases queries into a serving runtime at their trace arrival
    instants — the pacing half of a live node, shared by the in-process
    backend (``cluster.live.LiveNodeBackend``) and the remote worker
    (``serve.remote``), so the release/close/drain race handling lives in
    exactly one place.

    ``wall_of(t_trace) -> wall_instant`` maps trace time onto the wall
    clock (evaluated at release time, so a clock anchored after enqueue
    still paces correctly); ``release(qid, size, model_id)`` performs the
    submission; ``on_error`` (optional) observes a failed release — the
    query is dropped and feeding continues either way.  ``stop`` wakes
    the thread even mid-sleep: a close during the trace must not leave a
    thread pacing queries into a shut-down runtime for the rest of the
    trace's wall time; items still scheduled at stop are discarded."""

    def __init__(self, wall_of: Callable[[float], float],
                 release: Callable[[int, int, int], None],
                 on_error: Callable[[int, Exception], None] | None = None):
        self._wall_of = wall_of
        self._release = release
        self._on_error = on_error
        self._q: queue.Queue = queue.Queue()
        self._closing = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def put(self, t_trace: float, qid: int, size: int,
            model_id: int) -> None:
        self._q.put((t_trace, qid, size, model_id))

    @property
    def unfinished(self) -> int:
        """Items accepted but not yet released (or discarded) — the
        bounded-drain loop's wait condition."""
        return self._q.unfinished_tasks

    def stop(self, timeout: float = 5.0) -> None:
        self._closing.set()
        self._q.put(None)
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            t, qid, size, mid = item
            try:
                if self._closing.is_set():
                    continue               # discard still-scheduled work
                delay = self._wall_of(t) - time.monotonic()
                if delay > 0 and self._closing.wait(delay):
                    continue               # woken by stop(), not arrival
                self._release(qid, size, mid)
            except Exception as e:         # keep feeding; query → dropped
                if self._on_error is not None:
                    self._on_error(qid, e)
            finally:
                self._q.task_done()


class OnlineController:
    """Online hill climbing on the runtime's batch-size knob.

    Every ``window`` completed queries: if p95 is under the SLA, try the next
    larger batch (more batch-parallel efficiency); if over, step down
    (request parallelism).  The production deployment loop of paper §VI-B.
    """

    def __init__(self, runtime: ServingRuntime, sla_ms: float,
                 ladder=BATCH_LADDER, window: int = 50):
        self.rt = runtime
        self.sla_ms = sla_ms
        self.ladder = list(ladder)
        self.window = window
        self._pending: list[QueryRecord] = []
        self.history: list[tuple[int, float]] = []

    def step(self) -> None:
        # O(new completions) per poll, completion-ordered (take_completed
        # drains the runtime's fresh-done buffer — no full-record rescans,
        # no out-of-order double counting)
        self._pending += self.rt.take_completed()
        if len(self._pending) < self.window:
            return
        recent, self._pending = self._pending, []
        # errored queries complete near-instantly; feeding their fake
        # latencies to the controller would read as headroom and climb the
        # knob on a failing node — an all-errors window reads as a breach
        healthy = [r.latency_ms for r in recent if r.error is None]
        p95 = float(np.percentile(healthy, 95)) if healthy else float("inf")
        i = self._rung()
        if p95 > self.sla_ms and i > 0:
            self.rt.batch_size = self.ladder[i - 1]
        elif p95 < 0.7 * self.sla_ms and i < len(self.ladder) - 1:
            self.rt.batch_size = self.ladder[i + 1]
        self.history.append((self.rt.batch_size, p95))

    def _rung(self) -> int:
        """Ladder index of the current knob, snapping an off-ladder batch
        size (a runtime constructed with one, or an external knob write)
        to the nearest rung instead of raising ``ValueError``."""
        b = self.rt.batch_size
        if b in self.ladder:
            return self.ladder.index(b)
        i = min(range(len(self.ladder)), key=lambda k: abs(self.ladder[k] - b))
        self.rt.batch_size = self.ladder[i]
        return i


class OffloadController:
    """Online hill climbing on DeepRecSched's *second* knob — the
    query-size offload threshold (paper §V, Fig. 10) — fed by
    p99-by-component telemetry instead of a raw latency scalar.

    The boot-time ``tune()`` climb freezes the threshold against an
    offline profile; this controller re-runs the climb online, per node,
    so the knob tracks the traffic the node is actually seeing (the
    Hercules offline-profile + online-adjust split, arxiv 2203.07424).
    One decision per telemetry window:

      * **SLA breach** (e2e p99 > sla): move work toward the less-loaded
        path.  If the CPU-side queueing p99 dominates the accelerator's,
        step the threshold *down* one rung (offload more queries);
        otherwise the accelerator is the bottleneck — step *up* (keep
        more on CPU).
      * **Deep headroom** (e2e p99 < ``relax_frac``·sla): drift one rung
        back toward ``prefer`` — the offline-tuned operating point is
        the best throughput rung, so idle periods undo emergency moves.
      * otherwise hold.

    The controller is engine-agnostic: it owns no runtime, just the knob
    value.  Callers read ``threshold`` after each ``step`` and push it
    into their backend (``NodeBackend.set_offload_threshold`` for the
    fleet engines, ``SchedulerConfig`` rebuild for a bare runtime).
    ``threshold is None`` means "never offload" and snaps to the top
    rung, mirroring ``NodeSpec``'s convention."""

    def __init__(self, sla_ms: float, threshold: int | None = None,
                 ladder=THRESHOLD_LADDER, prefer: int | None = None,
                 relax_frac: float = 0.6):
        self.sla_ms = sla_ms
        self.ladder = list(ladder)
        self.threshold = self._snap(threshold)
        self.prefer = self._snap(prefer if prefer is not None else threshold)
        self.relax_frac = relax_frac
        # (threshold, e2e p99, cpu-queue p99, accel-queue p99) per step
        self.history: list[tuple[int, float, float, float]] = []

    def _snap(self, thr: int | None) -> int:
        if thr is None:
            return self.ladder[-1]
        if thr in self.ladder:
            return thr
        return min(self.ladder, key=lambda r: abs(r - thr))

    def step(self, p99_ms: float, cpu_queue_p99_ms: float,
             acc_queue_p99_ms: float) -> int:
        """One control decision from this window's component percentiles;
        returns the (possibly unchanged) threshold.  NaN inputs — an
        empty window — hold the knob."""
        i = self.ladder.index(self.threshold)
        if not np.isnan(p99_ms):
            if p99_ms > self.sla_ms:
                cpu_q = 0.0 if np.isnan(cpu_queue_p99_ms) else cpu_queue_p99_ms
                acc_q = 0.0 if np.isnan(acc_queue_p99_ms) else acc_queue_p99_ms
                if cpu_q >= acc_q and i > 0:
                    i -= 1                      # offload more
                elif cpu_q < acc_q and i < len(self.ladder) - 1:
                    i += 1                      # accel saturated: keep on CPU
            elif p99_ms < self.relax_frac * self.sla_ms:
                j = self.ladder.index(self.prefer)
                i += (i < j) - (i > j)          # drift one rung toward prefer
        self.threshold = self.ladder[i]
        self.history.append((self.threshold, float(p99_ms),
                             float(cpu_queue_p99_ms),
                             float(acc_queue_p99_ms)))
        return self.threshold
