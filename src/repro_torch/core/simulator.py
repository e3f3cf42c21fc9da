"""Simulator of an at-scale recommendation inference tier, two engines.

This is DeepRecInfra's serving model: queries arrive Poisson with
production-tail sizes, a splitter turns each query into ⌈size/B⌉ requests of
batch ≤ B (request- vs batch-level parallelism), requests run FCFS on a pool
of executors, and (optionally) queries ≥ an offload threshold run whole on an
accelerator.  Query latency = last-request completion − arrival; the system
metric is achievable QPS under a p95 SLA.

Engines (``simulate(..., engine=...)``):
  * ``"fast"`` — numpy fast path for the no-fault / no-hedge / no-contention
    case (the case every DeepRecSched tuner call hits).  All queries are
    split into flat request arrays up front, service times come from a
    precomputed per-device table, and the FCFS executor pool is advanced
    with vectorized slot assignment (``_advance_pool``) instead of
    per-event heap operations.
  * ``"events"`` — the discrete-event reference implementation, required for
    the production-realism knobs:
      - stragglers — a fraction of requests run a multiplier slower;
      - hedging — requests still running past ``hedge_factor ×`` the
        expected service time are duplicated, first copy wins;
      - executor failure — executors die at given times; their in-flight
        requests are re-queued after a detection timeout (at-least-once);
      - contention — busy-executor-dependent service-time inflation.
  * ``"auto"`` (default) — fast path when no such knob is active, else the
    event-driven reference.

The stateful per-node entry points (``node_pass``, ``advance_pool``,
``split_requests``, ``event_done_times``) are consumed by the cluster
tier's ``NodeBackend`` layer, which presents this engine and a live
``ServingRuntime`` behind one interface (the port's cluster tier is still to
come; the JAX package's is ``repro.cluster.backend``).
Their *batched* counterparts (``node_pass_many``, ``advance_pool_many``,
``split_requests_many`` over node-segmented flat arrays, with
``ExecPoolState`` carrying per-node free times across windows) advance an
entire simulated fleet in one numpy pass per traffic window — the
fleet-scale analog of the single-node fast path, consumed by the cluster
tier's grouped submit (``cluster.backend.submit_grouped``).
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import math
from collections import deque
from typing import Sequence

import numpy as np

from repro_torch.core.latency_model import (ContentionModel, DeviceModel,
                                            service_time_table)
from repro_torch.core.query_gen import (PRODUCTION, Query, SizeDist,
                                        queries_from_arrays, rescale_trace,
                                        sample_trace)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    batch_size: int                      # per-request batch size
    offload_threshold: int | None = None  # None → CPU-only
    n_executors: int = 40                # paper: 40-core Skylake
    n_accelerators: int = 1
    # per-request dispatch overhead (queue handoff, padding, completion
    # bookkeeping) — measured 0.135 ms on our live ServingRuntime with an
    # in-process worker; production RPC adds more.  This is what makes
    # request- vs batch-level parallelism a real tradeoff.
    request_overhead_s: float = 1.35e-4


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    straggler_frac: float = 0.0
    straggler_mult: float = 4.0
    hedge_factor: float = 0.0            # 0 → no hedging
    fail_times: Sequence[float] = ()     # executor death times (s)
    detect_timeout: float = 0.05


@dataclasses.dataclass
class SimResult:
    qps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    cpu_util: float
    accel_frac_work: float
    n_queries: int
    dropped: int = 0
    hedges: int = 0
    requeued: int = 0

    def meets(self, sla_ms: float) -> bool:
        return self.p95_ms <= sla_ms


# event kinds (heap tuples sort by (time, kind, ident) — _WAKE sorts after
# every real event at the same timestamp, like the magic value it replaces)
_ARRIVAL, _CPU_DONE, _ACC_DONE, _FAIL, _HEDGE_CHECK, _RELEASE = range(6)
_WAKE = 100                                  # re-try dispatch, no state change


def latency_percentiles_ms(lats: np.ndarray) -> tuple[float, float, float, float]:
    """(p50, p95, p99, mean) of latency seconds, in ms — the one metric
    assembly shared by both engines and the cluster tier, so the
    definitions cannot drift between per-node and fleet-level results."""
    return (float(np.percentile(lats, 50) * 1e3),
            float(np.percentile(lats, 95) * 1e3),
            float(np.percentile(lats, 99) * 1e3),
            float(lats.mean() * 1e3))


def _fast_eligible(contention: ContentionModel | None,
                   faults: FaultConfig) -> bool:
    no_contention = contention is None or contention.is_noop()
    no_faults = (not faults.straggler_frac and not faults.hedge_factor
                 and not len(faults.fail_times))
    return no_contention and no_faults


def simulate(queries: list[Query], cpu: DeviceModel, cfg: SchedulerConfig,
             *, accel: DeviceModel | None = None,
             contention: ContentionModel | None = None,
             faults: FaultConfig = FaultConfig(), seed: int = 0,
             engine: str = "auto") -> SimResult:
    """Simulate ``queries``; dispatches to the numpy fast path when no
    fault/contention knob is active (or ``engine`` forces a path)."""
    if engine not in ("auto", "fast", "events"):
        raise ValueError(engine)
    if engine != "events" and _fast_eligible(contention, faults):
        arrivals = np.array([q.arrival for q in queries], float)
        sizes = np.array([q.size for q in queries], np.int64)
        if len(arrivals) and np.any(np.diff(arrivals) < 0):
            # the fast path's FCFS identities assume arrival order; sort
            # (stably, preserving FIFO ties) rather than silently mis-queue
            order = np.argsort(arrivals, kind="stable")
            arrivals, sizes = arrivals[order], sizes[order]
        return simulate_arrays(arrivals, sizes, cpu, cfg, accel=accel)
    if engine == "fast":
        raise ValueError("fast engine cannot model faults/contention; "
                         "use engine='auto' or 'events'")
    return _simulate_events(queries, cpu, cfg, accel=accel,
                            contention=contention, faults=faults, seed=seed)


# ------------------------------------------------------- numpy fast path


def split_requests(sizes: np.ndarray, batch: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split query sizes into flat per-request arrays (request- vs
    batch-level parallelism).

    Returns ``(group, req_batch, bounds)``: the query index of each request,
    each request's batch size (⌈size/B⌉ full batches plus a remainder), and
    the exclusive per-query request-end offsets (``np.cumsum`` of the
    per-query request counts).  Request order is (arrival, intra-query) —
    exactly the FIFO order the event loop enqueues in.  This is the shared
    entry point for the per-node fast path: ``simulate_arrays`` and the
    cluster tier's per-node advance both use it.

    Sizes must be ≥ 1 (a zero-size query has no requests; its zero count
    would corrupt the neighboring query's remainder slot) — the query
    generators clip there, external callers are validated.
    """
    sizes = np.asarray(sizes, np.int64)
    if len(sizes) and sizes.min() < 1:
        raise ValueError("query sizes must be >= 1")
    B = max(int(batch), 1)
    n_req = -(-sizes // B)
    bounds = np.cumsum(n_req)
    group = np.repeat(np.arange(len(sizes)), n_req)
    req_batch = np.full(int(bounds[-1]) if len(bounds) else 0, B, np.int64)
    if len(bounds):
        req_batch[bounds - 1] = sizes - (n_req - 1) * B
    return group, req_batch, bounds


def _heap_advance(al: list, sl: list, h: list) -> list:
    """FIFO pass over a min-heap ``h`` of server free times (mutated in
    place): dispatch each request to the earliest-free server.  Shared by
    the zero-state fallback and the stateful ``advance_pool``."""
    out = [0.0] * len(al)
    heapreplace = heapq.heapreplace
    for j in range(len(al)):
        f = h[0]
        a = al[j]
        d = (a if a > f else f) + sl[j]
        heapreplace(h, d)
        out[j] = d
    return out


def advance_pool(arrivals: np.ndarray, svc: np.ndarray,
                 free: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stateful FCFS advance: departure times plus the updated per-server
    free times, given each server's current free time in ``free``.

    This is the cluster tier's per-node entry point — a fleet simulation
    advances every node window-by-window, carrying ``free`` across windows
    so queued work from one traffic window delays the next.  When the pool
    is idle before the first arrival this delegates to the vectorized
    ``_advance_pool`` regimes; otherwise it runs the FIFO free-time heap
    seeded with ``free``.

    The updated free times are the ``c`` largest values of
    ``free ∪ departures``: each dispatch replaces the pool's earliest free
    time with the request's departure, so by induction the heap always
    holds exactly the ``c`` largest such values.
    """
    free = np.asarray(free, float)
    c = len(free)
    r = len(arrivals)
    if r == 0:
        return np.empty(0), free.copy()
    if c == 0:
        return np.full(r, np.nan), free.copy()
    if float(free.max()) <= float(arrivals[0]):
        # every server is free by the first arrival — the initial state can
        # never delay a start, so the zero-state fast regimes apply
        dep = _advance_pool(arrivals, svc, c)
        both = np.concatenate([free, dep])
        return dep, np.sort(np.partition(both, len(both) - c)[-c:])
    h = free.tolist()
    heapq.heapify(h)
    out = _heap_advance(np.asarray(arrivals, float).tolist(),
                        np.asarray(svc, float).tolist(), h)
    return np.asarray(out), np.sort(np.asarray(h))


def _advance_pool(arrivals: np.ndarray, svc: np.ndarray, c: int) -> np.ndarray:
    """Departure time of each request under FCFS on ``c`` identical servers.

    ``arrivals`` must be nondecreasing and in FIFO order.  Uses the exact
    identity  S_j = max(a_j, c-th largest of {D_i : i<j})  — with fewer
    than c predecessors still in the system a server is always free (any
    queued predecessor would have started already, FCFS is work-conserving).

    Three vectorized regimes, one tight fallback:
      * c ≥ R        — nobody waits:  D = a + s.
      * c == 1       — Lindley recursion  D_j = max(a_j, D_{j-1}) + s_j,
                       solved in closed form with a prefix max.
      * constant s   — departures are nondecreasing, so the c-th largest
                       previous departure is D_{j-c} and the recurrence
                       splits into c independent Lindley chains (this is
                       the batch_size=1 case, the most request-heavy point
                       of every DeepRecSched ladder climb).
      * otherwise    — FIFO pass over a c-slot free-time heap (no global
                       event heap, no per-event dict churn).
    """
    r = len(arrivals)
    if r == 0:
        return np.empty(0)
    if c <= 0:                    # no servers: nothing ever departs
        return np.full(r, np.nan)
    if c >= r:
        return arrivals + svc
    if c == 1:
        cum = np.cumsum(svc)
        slack = arrivals - np.concatenate(([0.0], cum[:-1]))   # a_j − C_{j−1}
        return np.maximum.accumulate(slack) + cum
    if svc.min() == svc.max():
        s = float(svc[0])
        out = np.empty(r)
        for k in range(c):                   # c ≈ 40 chains, vectorized inside
            a = arrivals[k::c]
            m = np.arange(len(a))
            out[k::c] = np.maximum.accumulate(a - m * s) + (m + 1) * s
        return out
    return np.asarray(_heap_advance(arrivals.tolist(), svc.tolist(),
                                    [0.0] * c))


def node_pass(arrivals: np.ndarray, sizes: np.ndarray, cpu: DeviceModel,
              cfg: SchedulerConfig, *, accel: DeviceModel | None = None,
              cpu_free: np.ndarray | None = None,
              acc_free: np.ndarray | None = None,
              want_starts: bool = False):
    """One node's fast dispatch pipeline — offload split, request
    splitting, FCFS pool advance — optionally stateful via initial
    executor/accelerator free times (the cluster tier carries them across
    traffic windows; ``simulate_arrays`` starts idle).

    Returns ``(done_times, cpu_busy_s, accel_work, cpu_free, acc_free)``
    with NaN marking never-completed queries (e.g. empty pool).  With
    ``want_starts=True`` a sixth element is appended: each query's first
    executor dispatch time — derived from the Lindley departures (a
    request starts at departure minus service; a query starts at the min
    over its requests), which is how sim spans get an ``exec_start``
    stamp with no event loop.
    """
    n = len(sizes)
    B = max(cfg.batch_size, 1)
    thr = cfg.offload_threshold if accel is not None else None
    sizes = np.asarray(sizes, np.int64)
    if cpu_free is None:
        cpu_free = np.zeros(cfg.n_executors)
    if acc_free is None:
        acc_free = np.zeros(cfg.n_accelerators)

    off = sizes >= thr if thr is not None else np.zeros(n, bool)
    done = np.full(n, np.nan)
    exec_start = np.full(n, np.nan) if want_starts else None
    cpu_busy = 0.0
    acc_work = 0.0

    cpu_idx = np.flatnonzero(~off)
    if len(cpu_idx):
        csz = sizes[cpu_idx]
        carr = arrivals[cpu_idx]
        group, req_batch, bounds = split_requests(csz, B)
        svc_tab = service_time_table(cpu, B)
        req_svc = svc_tab[req_batch] + cfg.request_overhead_s
        depart, cpu_free = advance_pool(carr[group], req_svc, cpu_free)
        starts = np.concatenate(([0], bounds[:-1]))
        done[cpu_idx] = np.maximum.reduceat(depart, starts)
        if want_starts and len(depart):
            exec_start[cpu_idx] = np.minimum.reduceat(depart - req_svc,
                                                      starts)
        if cfg.n_executors > 0:
            cpu_busy = float(req_svc.sum())

    acc_idx = np.flatnonzero(off)
    if len(acc_idx):
        asz = sizes[acc_idx]
        acc_tab = service_time_table(accel, int(asz.max()))
        svc = acc_tab[asz]
        done[acc_idx], acc_free = advance_pool(arrivals[acc_idx],
                                               svc, acc_free)
        if want_starts:
            exec_start[acc_idx] = done[acc_idx] - svc
        acc_work = float(asz.sum())
    if want_starts:
        return done, cpu_busy, acc_work, cpu_free, acc_free, exec_start
    return done, cpu_busy, acc_work, cpu_free, acc_free


def simulate_arrays(arrivals: np.ndarray, sizes: np.ndarray,
                    cpu: DeviceModel, cfg: SchedulerConfig,
                    *, accel: DeviceModel | None = None) -> SimResult:
    """Fast-path simulation straight from (arrival, size) arrays.

    Semantically identical to the event-driven reference with
    ``FaultConfig()`` and no contention; ``tests/test_system.py`` asserts
    the equivalence.  Queries must be sorted by arrival (as produced by
    ``generate_queries``/``sample_trace``).
    """
    n = len(sizes)
    tot_work = float(np.asarray(sizes, np.int64).sum())
    done, cpu_busy, acc_work, _, _ = node_pass(arrivals, sizes, cpu, cfg,
                                               accel=accel)
    completed = ~np.isnan(done)
    n_done = int(completed.sum())
    if n_done == 0:               # matches the reference's all-dropped result
        return SimResult(0, 0, 0, 0, 0, 0, 0, 0, dropped=n)
    lats = done[completed] - arrivals[completed]
    dur = float(done[completed].max()) - float(arrivals[0])
    p50, p95, p99, mean = latency_percentiles_ms(lats)
    return SimResult(
        qps=n_done / dur, p50_ms=p50, p95_ms=p95, p99_ms=p99, mean_ms=mean,
        cpu_util=cpu_busy / (dur * max(cfg.n_executors, 1)),
        accel_frac_work=acc_work / max(tot_work, 1.0),
        n_queries=n_done, dropped=n - n_done)


# ------------------------------------------------ batched fleet fast path
#
# The per-node fast path above advances ONE node per Python call; a
# windowed fleet driver makes N such calls per window, and at 1k–10k
# nodes the ~30 small numpy ops per call dominate wall-clock.  The
# entry points below advance EVERY simulated node in one numpy pass per
# window over node-segmented flat arrays: queries of node k occupy
# ``[bounds[k-1], bounds[k])`` of the concatenation, per-node executor
# state is carried across windows by ``ExecPoolState``, and the offload
# split / request splitting / service-table lookups / ``reduceat``
# completion folds run once over the whole concatenation.  Only the
# irreducible stateful FCFS recursion falls back to per-segment
# ``advance_pool`` — and the dominant windowed-fleet regime (pool idle
# by the window's first arrival, fewer requests than executors) never
# does.


class ExecPoolState:
    """One executor pool's free-time multiset, carried across windows.

    ``advance_pool`` materializes the updated state eagerly (the top-c of
    ``free ∪ departures``, one ``np.partition`` per node per window).  At
    fleet scale only two facts are needed per window: the *max* free time
    (regime detection — is the pool idle by the window's first arrival?)
    and, rarely, the full top-c (seeding the heap fallback).  So the
    state is lazy: departures are appended as views (``defer``) with only
    the scalar ``fmax`` updated, and the top-c is computed on demand
    (``materialize``) or when the pending list grows past ~2c (bounding
    both the partition input and how long window arrays stay pinned by
    views)."""

    __slots__ = ("c", "_free", "_pend", "_npend", "fmax")

    def __init__(self, c: int, t0: float = 0.0):
        self.c = int(c)
        self._free = np.full(self.c, float(t0))
        self._pend: list[np.ndarray] = []
        self._npend = 0
        self.fmax = float(t0) if self.c else -math.inf

    def materialize(self) -> np.ndarray:
        """The pool's free times as an array of exactly ``c`` values —
        the top-c of everything deferred so far (set-identical to what
        eager ``advance_pool`` chaining would have produced; order is
        irrelevant to every consumer)."""
        if self._pend:
            both = np.concatenate([self._free] + self._pend)
            self._pend = []
            self._npend = 0
            if len(both) > self.c:
                both = np.partition(both, len(both) - self.c)[-self.c:]
            self._free = both
        return self._free

    def set_free(self, free: np.ndarray, fmax: float | None = None) -> None:
        """Adopt an eagerly computed free-time array (the ``advance_pool``
        fallback returns one).  ``fmax`` skips the max scan when the
        caller already folded it (the lockstep pass computes all segment
        maxima in one vectorized reduction)."""
        self._free = np.asarray(free, float)
        self._pend = []
        self._npend = 0
        if fmax is not None:
            self.fmax = fmax
        else:
            self.fmax = float(self._free.max()) if len(self._free) else -math.inf

    def defer(self, departures: np.ndarray, dep_max: float) -> None:
        """Regime-A bookkeeping: a window's departures join the free-time
        multiset lazily.  Correct because the next state is always the
        top-c of ``free ∪ departures`` and only its max is read eagerly."""
        self._pend.append(departures)
        self._npend += len(departures)
        if dep_max > self.fmax:
            self.fmax = dep_max
        if self._npend > 2 * self.c:
            self.materialize()


def split_requests_many(sizes: np.ndarray, batch_per_query: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``split_requests`` with a per-query batch size — the fleet path
    concatenates queries of many nodes (hence many ``batch_size`` knobs)
    into one array.  Returns the same ``(group, req_batch, bounds)``
    triple; for a constant ``batch_per_query`` the output is identical to
    ``split_requests(sizes, B)``."""
    sizes = np.asarray(sizes, np.int64)
    if len(sizes) and sizes.min() < 1:
        raise ValueError("query sizes must be >= 1")
    B = np.maximum(np.asarray(batch_per_query, np.int64), 1)
    n_req = -(-sizes // B)
    bounds = np.cumsum(n_req)
    group = np.repeat(np.arange(len(sizes)), n_req)
    req_batch = B[group]
    if len(bounds):
        req_batch[bounds - 1] = sizes - (n_req - 1) * B
    return group, req_batch, bounds


def advance_pool_many(arrivals: np.ndarray, svc: np.ndarray,
                      bounds: np.ndarray,
                      states: Sequence[ExecPoolState],
                      cs: np.ndarray | None = None) -> np.ndarray:
    """Batched stateful FCFS advance over node-segmented flat arrays.

    ``arrivals``/``svc`` are the concatenation of per-node request arrays
    (arrival-sorted within each segment), ``bounds`` the exclusive
    per-segment end offsets (one per state), ``states`` the per-node
    free-time multisets carried across windows.  ``cs`` optionally
    pre-folds each state's executor count (it never changes, so callers
    advancing the same fleet every window cache it).  Per-segment results
    are identical to chaining ``advance_pool`` on each node.

    Regime A — pool idle by its first arrival (``fmax <= a0``) and no
    more requests than executors (``r <= c``) — admits the closed form
    ``D = a + s``: after j < r dispatches the free-time multiset (top-c
    of ``free ∪ departures``) still holds at least ``c - j >= 1`` initial
    values ``<= a0 <= a_j``, so the earliest-free server never delays a
    start — the ``c >= r`` branch of ``_advance_pool`` verbatim.  All
    such segments are advanced in ONE vectorized add over the concatenation,
    with the state update deferred (``ExecPoolState.defer``) and the
    per-segment departure maxima carved out by a paired ``reduceat``.

    Regime B — the pool is still busy at its first arrival
    (``fmax > a0``), the common case at realistic utilization.  The
    scalar path would run the FIFO earliest-free-server heap; here all
    such segments run that *same* pass in lockstep: step ``j``
    dispatches request ``j`` of every busy segment at once with one
    ``argmin`` over an ``(H, c_max)`` free-time matrix (rows padded with
    ``+inf`` for smaller pools, segments sorted longest-first so each
    step works on a shrinking prefix).  The arithmetic per dispatch —
    ``(a if a > f else f) + s`` against the true minimum free time — is
    the heap pass verbatim, so results are bit-identical.

    The remainder — an idle pool whose window overfills it
    (``fmax <= a0``, ``r > c``) or a zero-executor node — falls back to
    the per-node ``advance_pool`` regimes (Lindley / c-chains / heap),
    seeded with the materialized free times; those branches are already
    vectorized within the segment.
    """
    arrivals = np.asarray(arrivals, float)
    svc = np.asarray(svc, float)
    bounds = np.asarray(bounds, np.int64)
    out = arrivals + svc                 # regime-A answer for everyone
    if not len(bounds) or not len(arrivals):
        return out
    seg_starts = np.concatenate(([0], bounds[:-1]))
    r = bounds - seg_starts
    nonempty = r > 0
    if cs is None:
        cs = np.fromiter((s.c for s in states), np.int64, len(states))
    fmax = np.fromiter((s.fmax for s in states), float, len(states))
    a0 = arrivals[np.minimum(seg_starts, len(arrivals) - 1)]
    easy = nonempty & (cs >= r) & (fmax <= a0)

    eidx = np.flatnonzero(easy)
    if len(eidx):
        # per-easy-segment departure max without touching hard segments:
        # reduceat over interleaved (start, end) pairs, keeping the even
        # slots; the -inf pad makes end == len a valid reduceat index
        pairs = np.empty(2 * len(eidx), np.int64)
        pairs[0::2] = seg_starts[eidx]
        pairs[1::2] = bounds[eidx]
        dmax = np.maximum.reduceat(np.append(out, -np.inf), pairs)[0::2]
        for k in range(len(eidx)):
            i = int(eidx[k])
            states[i].defer(out[seg_starts[i]:bounds[i]], float(dmax[k]))

    # regime B: busy pools (fmax > a0 implies c > 0) in lockstep
    lock = nonempty & (fmax > a0)
    lidx = np.flatnonzero(lock)
    if len(lidx):
        ls, lr = seg_starts[lidx], r[lidx]
        order = np.argsort(-lr, kind="stable")   # longest first: prefix steps
        lidx, ls, lr = lidx[order], ls[order], lr[order]
        frees = [states[int(i)].materialize() for i in lidx]
        cmax = max(len(f) for f in frees)
        F = np.full((len(lidx), cmax), np.inf)
        for k, f in enumerate(frees):
            F[k, : len(f)] = f
        rows = np.arange(len(lidx))
        neg = -lr                                # ascending; prefix = lr > j
        for j in range(int(lr[0])):
            m = int(np.searchsorted(neg, -j, side="left"))
            sel = rows[:m]
            k = F[:m].argmin(1)
            f = F[sel, k]
            idx = ls[:m] + j
            a = arrivals[idx]
            d = np.where(a > f, a, f) + svc[idx]
            F[sel, k] = d
            out[idx] = d
        newmax = np.where(np.isinf(F), -np.inf, F).max(1)
        for k in range(len(lidx)):
            st = states[int(lidx[k])]
            st.set_free(F[k, : st.c], float(newmax[k]))

    for i in np.flatnonzero(nonempty & ~easy & ~lock):
        s, e = int(seg_starts[i]), int(bounds[i])
        st = states[i]
        dep, free = advance_pool(arrivals[s:e], svc[s:e], st.materialize())
        out[s:e] = dep
        st.set_free(free)
    return out


@dataclasses.dataclass
class NodeEngine:
    """One simulated node's executor machinery for the batched fleet
    advance: the devices and scheduler knobs plus the executor /
    accelerator free-time state carried across windows.  Nodes sharing
    ``(cpu, accel, cfg)`` form one *class* — the batched pass prices and
    splits their queries with one table lookup per class."""

    cpu: DeviceModel
    cfg: SchedulerConfig
    accel: DeviceModel | None
    cpu_state: ExecPoolState
    acc_state: ExecPoolState

    @classmethod
    def make(cls, cpu: DeviceModel, cfg: SchedulerConfig,
             accel: DeviceModel | None = None,
             t0: float = 0.0) -> "NodeEngine":
        return cls(cpu, cfg, accel,
                   ExecPoolState(cfg.n_executors, t0),
                   ExecPoolState(cfg.n_accelerators, t0))

    @property
    def class_key(self) -> tuple:
        # SchedulerConfig is a frozen dataclass (hashable); devices are
        # compared by identity — pools share device objects
        return (id(self.cpu), id(self.accel), self.cfg)

    @functools.cached_property
    def class_id(self) -> int:
        """Small interned id shared by engines of the same class — lets
        the batched pass group a 10k-engine list per window without
        rehashing ``SchedulerConfig`` per engine."""
        return _CLASS_IDS.setdefault(self.class_key, len(_CLASS_IDS))

    def set_cfg(self, cfg: SchedulerConfig) -> None:
        """Re-knob this engine mid-run (online threshold/batch tuning).

        The engine's class membership changes, so the interned
        ``class_id`` is dropped (re-derived lazily against the new cfg)
        and the grouped-pass parts cache is invalidated — its per-class
        ``thr``/``Bcls`` tables were built from the old knobs and are
        keyed only on the engines-*list* identity, which a knob write
        does not change."""
        if cfg == self.cfg:
            return
        self.cfg = cfg
        self.__dict__.pop("class_id", None)
        _NPM_CACHE["ref"] = None


_CLASS_IDS: dict[tuple, int] = {}


_NPM_CACHE: dict = {"ref": None}


def _node_pass_parts(engines: Sequence[NodeEngine]) -> dict:
    """Static per-engines-list structures for ``node_pass_many`` — the
    class partition, per-class knob arrays, the state lists and their
    executor counts.  None of it changes while a fleet is advanced
    window after window, so it is cached on the *identity* of the
    ``engines`` sequence (the grouped driver reuses one list object per
    serving set; a fresh list per call simply recomputes)."""
    if _NPM_CACHE["ref"] is not engines:
        n_nodes = len(engines)
        cids = np.fromiter((e.class_id for e in engines), np.int64, n_nodes)
        _, first, cls_of = np.unique(cids, return_index=True,
                                     return_inverse=True)
        classes = [engines[int(i)] for i in first]
        cpu_states = [e.cpu_state for e in engines]
        acc_states = [e.acc_state for e in engines]
        _NPM_CACHE.update(
            ref=engines, cls_of=cls_of, classes=classes,
            node_ids=np.arange(n_nodes),
            thr=np.array([float(e.cfg.offload_threshold)
                          if e.accel is not None
                          and e.cfg.offload_threshold is not None
                          else np.inf for e in classes]),
            Bcls=np.array([max(e.cfg.batch_size, 1) for e in classes],
                          np.int64),
            cpu_states=cpu_states, acc_states=acc_states,
            cs_cpu=np.fromiter((s.c for s in cpu_states), np.int64,
                               n_nodes),
            cs_acc=np.fromiter((s.c for s in acc_states), np.int64,
                               n_nodes))
    return _NPM_CACHE


def node_pass_many(arrivals: np.ndarray, sizes: np.ndarray,
                   bounds: np.ndarray, engines: Sequence[NodeEngine],
                   *, want_starts: bool = False
                   ) -> tuple[np.ndarray, np.ndarray | None]:
    """Batched ``node_pass`` across many simulated nodes.

    Flat arrays are node-segmented: queries routed to node k occupy
    ``[bounds[k-1], bounds[k])``, arrival-sorted within the segment.  The
    whole fleet's offload split, request splitting, per-*class*
    service-time lookups, and per-query ``reduceat`` completion folds run
    once over the concatenation; the stateful pool advance itself goes
    through ``advance_pool_many``.  Returns ``(done, exec_start)`` flat
    per-query arrays (``exec_start`` is None unless ``want_starts``;
    NaN marks never-completed queries) — per segment exactly what
    ``node_pass`` returns, which the equivalence tests pin."""
    arrivals = np.asarray(arrivals, float)
    sizes = np.asarray(sizes, np.int64)
    bounds = np.asarray(bounds, np.int64)
    n_nodes = len(engines)
    nq = len(sizes)
    done = np.full(nq, np.nan)
    exec_start = np.full(nq, np.nan) if want_starts else None
    if nq == 0:
        return done, exec_start
    counts = bounds - np.concatenate(([0], bounds[:-1]))

    p = _node_pass_parts(engines)
    classes = p["classes"]
    cls_q = np.repeat(p["cls_of"], counts)         # class of each query
    seg_q = np.repeat(p["node_ids"], counts)       # node of each query
    off = sizes >= p["thr"][cls_q]

    cpu_sel = np.flatnonzero(~off)
    if len(cpu_sel):
        ccls = cls_q[cpu_sel]
        cseg = seg_q[cpu_sel]
        Bcls = p["Bcls"]
        group, req_batch, qb = split_requests_many(sizes[cpu_sel],
                                                   Bcls[ccls])
        req_svc = np.empty(len(req_batch))
        rcls = ccls[group]
        for c, e in enumerate(classes):
            m = rcls == c
            if m.any():
                tab = service_time_table(e.cpu, int(Bcls[c]))
                req_svc[m] = tab[req_batch[m]] + e.cfg.request_overhead_s
        n_req = np.diff(np.concatenate(([0], qb)))
        req_bounds = np.cumsum(
            np.bincount(cseg, n_req, minlength=n_nodes)).astype(np.int64)
        depart = advance_pool_many(arrivals[cpu_sel][group], req_svc,
                                   req_bounds, p["cpu_states"],
                                   cs=p["cs_cpu"])
        qstarts = np.concatenate(([0], qb[:-1]))
        done[cpu_sel] = np.maximum.reduceat(depart, qstarts)
        if want_starts:
            exec_start[cpu_sel] = np.minimum.reduceat(depart - req_svc,
                                                      qstarts)

    acc_sel = np.flatnonzero(off)
    if len(acc_sel):
        asz = sizes[acc_sel]
        acls = cls_q[acc_sel]
        svc = np.empty(len(asz))
        for c, e in enumerate(classes):
            m = acls == c
            if m.any():
                tab = service_time_table(e.accel, int(asz[m].max()))
                svc[m] = tab[asz[m]]
        acc_bounds = np.cumsum(
            np.bincount(seg_q[acc_sel], minlength=n_nodes)).astype(np.int64)
        dep = advance_pool_many(arrivals[acc_sel], svc, acc_bounds,
                                p["acc_states"], cs=p["cs_acc"])
        done[acc_sel] = dep
        if want_starts:
            exec_start[acc_sel] = dep - svc
    return done, exec_start


# ------------------------------------------- event-driven reference engine


def event_done_times(queries: list[Query], cpu: DeviceModel,
                     cfg: SchedulerConfig, *, accel: DeviceModel | None = None,
                     contention: ContentionModel | None = None,
                     faults: FaultConfig = FaultConfig(),
                     seed: int = 0) -> np.ndarray:
    """Per-query completion times (NaN = dropped) from the event-driven
    reference engine — the per-node entry point the cluster tier uses when
    faults/contention are enabled, where per-query latencies must be merged
    across nodes (a per-node ``SimResult``'s percentiles don't compose)."""
    done_at, *_ = _event_loop(queries, cpu, cfg, accel=accel,
                              contention=contention, faults=faults, seed=seed)
    return np.array([done_at.get(q.qid, np.nan) for q in queries])


def _simulate_events(queries: list[Query], cpu: DeviceModel,
                     cfg: SchedulerConfig, *, accel: DeviceModel | None = None,
                     contention: ContentionModel | None = None,
                     faults: FaultConfig = FaultConfig(),
                     seed: int = 0) -> SimResult:
    (done_at, cpu_busy_time, acc_work, tot_work, hedges,
     requeued) = _event_loop(queries, cpu, cfg, accel=accel,
                             contention=contention, faults=faults, seed=seed)
    lats = np.array([done_at[q.qid] - q.arrival for q in queries
                     if q.qid in done_at])
    dur = max(d for d in done_at.values()) - queries[0].arrival if done_at else 1.0
    if len(lats) == 0:
        return SimResult(0, 0, 0, 0, 0, 0, 0, 0, dropped=len(queries))
    p50, p95, p99, mean = latency_percentiles_ms(lats)
    return SimResult(
        qps=len(lats) / dur, p50_ms=p50, p95_ms=p95, p99_ms=p99, mean_ms=mean,
        cpu_util=cpu_busy_time / (dur * max(cfg.n_executors, 1)),
        accel_frac_work=acc_work / max(tot_work, 1.0),
        n_queries=len(lats), dropped=len(queries) - len(lats),
        hedges=hedges, requeued=requeued)


def _event_loop(queries: list[Query], cpu: DeviceModel,
                cfg: SchedulerConfig, *, accel: DeviceModel | None = None,
                contention: ContentionModel | None = None,
                faults: FaultConfig = FaultConfig(),
                seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)
    B = max(cfg.batch_size, 1)
    thr = cfg.offload_threshold if accel is not None else None

    events: list[tuple] = []
    for q in queries:
        heapq.heappush(events, (q.arrival, _ARRIVAL, q.qid))
    qmap = {q.qid: q for q in queries}

    pending: dict[int, int] = {}          # qid → outstanding requests
    done_at: dict[int, float] = {}
    cpu_free = cfg.n_executors            # free executor count
    alive = cfg.n_executors
    cpu_queue: deque[tuple[int, int]] = deque()  # (qid, req_batch) FIFO
    acc_free = cfg.n_accelerators
    acc_queue: deque[tuple[int, int]] = deque()
    cpu_busy_time = 0.0
    acc_work = 0.0
    tot_work = 0.0
    hedges = requeued = 0
    req_id = 0
    inflight: dict[int, tuple] = {}       # req → (qid, batch, start, end)
    finished_req: set[int] = set()

    for i, ft in enumerate(faults.fail_times):
        heapq.heappush(events, (ft, _FAIL, -1 - i))

    _lat_cache: dict[int, float] = {}

    def base_lat(batch: int) -> float:
        t = _lat_cache.get(batch)
        if t is None:
            t = cpu.latency(batch)
            _lat_cache[batch] = t
        return t

    _acc_cache: dict[int, float] = {}

    def acc_lat(batch: int) -> float:
        t = _acc_cache.get(batch)
        if t is None:
            t = accel.latency(batch)
            _acc_cache[batch] = t
        return t

    def svc_time(batch: int) -> float:
        t = base_lat(batch) + cfg.request_overhead_s
        if contention is not None:
            t *= contention.multiplier(cfg.n_executors - cpu_free, cfg.n_executors)
        if faults.straggler_frac and rng.random() < faults.straggler_frac:
            t *= faults.straggler_mult
        return t

    def dispatch_cpu(now: float):
        nonlocal cpu_free, req_id, cpu_busy_time, hedges
        while cpu_free > 0 and cpu_queue:
            qid, b = cpu_queue.popleft()
            cpu_free -= 1
            dt = svc_time(b)
            cpu_busy_time += dt
            rid = req_id
            req_id += 1
            inflight[rid] = (qid, b, now, now + dt)
            heapq.heappush(events, (now + dt, _CPU_DONE, rid))
            if faults.hedge_factor:
                heapq.heappush(events, (now + faults.hedge_factor * base_lat(b),
                                        _HEDGE_CHECK, rid))

    def dispatch_acc(now: float):
        nonlocal acc_free, req_id, acc_work
        while acc_free > 0 and acc_queue:
            qid, b = acc_queue.popleft()
            acc_free -= 1
            dt = acc_lat(b)
            rid = req_id
            req_id += 1
            inflight[rid] = (qid, b, now, now + dt)
            heapq.heappush(events, (now + dt, _ACC_DONE, rid))

    def complete(qid: int, now: float):
        pending[qid] -= 1
        if pending[qid] == 0:
            done_at[qid] = now

    while events:
        now, kind, ident = heapq.heappop(events)
        if kind == _ARRIVAL:
            q = qmap[ident]
            tot_work += q.size
            if thr is not None and q.size >= thr:
                pending[q.qid] = 1
                acc_work += q.size
                acc_queue.append((q.qid, q.size))
                dispatch_acc(now)
            else:
                n_req = math.ceil(q.size / B)
                pending[q.qid] = n_req
                left = q.size
                for _ in range(n_req):
                    cpu_queue.append((q.qid, min(B, left)))
                    left -= B
                dispatch_cpu(now)
        elif kind == _CPU_DONE:
            if ident in finished_req:
                continue                   # lost to a hedge twin / dead executor
            finished_req.add(ident)
            qid, b, _, _ = inflight.pop(ident)
            cpu_free = min(cpu_free + 1, alive)
            complete(qid, now)
            dispatch_cpu(now)
        elif kind == _ACC_DONE:
            qid, b, _, _ = inflight.pop(ident)
            acc_free += 1
            complete(qid, now)
            dispatch_acc(now)
        elif kind == _HEDGE_CHECK:
            if ident in finished_req or ident not in inflight:
                continue
            qid, b, start, end = inflight[ident]
            if cpu_free > 0:               # duplicate on a free executor
                hedges += 1
                finished_req.add(ident)    # original's completion is ignored
                inflight.pop(ident)
                # the original executor stays busy until its `end` (its
                # _CPU_DONE is swallowed by finished_req, so release it here)
                heapq.heappush(events, (end, _RELEASE, ident))
                cpu_queue.appendleft((qid, b))
                dispatch_cpu(now)
        elif kind == _FAIL:
            if alive <= 1:
                continue
            alive -= 1
            # kill one busy (or free) executor; re-queue a random in-flight req
            if cpu_free > 0:
                cpu_free -= 1
            else:
                live = [r for r in inflight if r not in finished_req]
                if live:
                    victim = live[int(rng.integers(len(live)))]
                    qid, b, _, _ = inflight.pop(victim)
                    finished_req.add(victim)
                    requeued += 1
                    cpu_queue.appendleft((qid, b))
                    heapq.heappush(events, (now + faults.detect_timeout,
                                            _WAKE, 0))
        elif kind == _RELEASE:             # hedged original finished: free core
            cpu_free = min(cpu_free + 1, alive)
            dispatch_cpu(now)
        else:                              # wake-up: just try dispatching
            dispatch_cpu(now)

    return done_at, cpu_busy_time, acc_work, tot_work, hedges, requeued


# ------------------------------------------------- achievable-QPS search

# sustain guard for every achievable-QPS search (per-node, cluster, and the
# live-parity benchmark): a rate only counts as feasible when the system
# actually processes ~this fraction of the offered rate — with a finite
# trace the backlog is bounded, so p95 alone can look fine at ANY λ
SUSTAIN_FRACTION = 0.85


def warm_bracket(ok, lo: float, hint: float | None) -> tuple[float, float]:
    """Seed a doubling bracket around a known-nearby answer instead of
    doubling up from ``lo``: expand upward from a feasible hint, halve
    downward (never below the caller's floor) from an infeasible one.
    Returns the ``(lo, hi)`` to hand to ``bracket_bisect``."""
    if hint is None or hint <= lo:
        return lo, lo
    if ok(hint):
        return hint, hint * 2
    hi = hint
    cand = hint / 2
    while cand > lo and not ok(cand):
        hi = cand
        cand /= 2
    return max(cand, lo), hi


def bracket_bisect(ok, lo: float, hi: float, iters: int,
                   cap: float | None = None) -> float:
    """Largest ``x`` with ``ok(x)`` under a monotone feasibility predicate.

    With ``cap``: exponential doubling bracket from ``hi`` first (capped
    there; a cap reached while still feasible is returned as-is), then
    bisection.  Without: plain bisection on the caller's ``[lo, hi]``.
    Callers are expected to memoize ``ok`` — the bracket re-tests ``hi``.
    Shared by the per-node ``max_qps_under_sla`` and the cluster tier's
    ``cluster_max_qps`` so the search discipline cannot drift."""
    if cap is not None:
        while ok(hi) and hi < cap:
            lo = hi
            hi *= 2
        if ok(hi):                # capped while still feasible (memo hit)
            return hi
    for _ in range(iters):
        mid = (lo + hi) / 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo


def max_qps_under_sla(cpu: DeviceModel, cfg: SchedulerConfig, sla_ms: float,
                      *, accel: DeviceModel | None = None,
                      size_dist: SizeDist = PRODUCTION,
                      contention: ContentionModel | None = None,
                      n_queries: int = 1500, seed: int = 0,
                      lo: float = 1.0, hi: float | None = None,
                      iters: int = 9, hint: float | None = None,
                      engine: str = "auto") -> float:
    """Largest arrival rate whose p95 latency meets the SLA (the paper's
    y-axis).  Exponential bracket + bisection on λ.

    The query trace is sampled once per seed: unit-rate arrival times plus
    sizes, with per-λ traces obtained by rescaling the arrival times — the
    same distribution as regenerating (numpy inter-arrival samplers scale
    multiplicatively in the mean), without re-drawing per bisection step.
    ``hint`` warm-starts the bracket around a known-nearby answer (e.g. the
    previous knob point of a hill climb) instead of doubling up from ``lo``.
    """
    if engine not in ("auto", "fast", "events"):
        raise ValueError(engine)
    if engine == "fast" and not _fast_eligible(contention, FaultConfig()):
        raise ValueError("fast engine cannot model contention; "
                         "use engine='auto' or 'events'")
    unit_times, sizes = sample_trace(np.random.default_rng(seed), n_queries,
                                     size_dist)
    use_fast = engine != "events" and _fast_eligible(contention, FaultConfig())
    _memo: dict[float, bool] = {}

    def ok(qps: float) -> bool:
        hit = _memo.get(qps)
        if hit is not None:
            return hit
        arrivals = rescale_trace(unit_times, qps)
        if use_fast:
            r = simulate_arrays(arrivals, sizes, cpu, cfg, accel=accel)
        else:
            r = _simulate_events(queries_from_arrays(arrivals, sizes), cpu,
                                 cfg, accel=accel, contention=contention,
                                 seed=seed)
        # completion window ≈ arrival window, see SUSTAIN_FRACTION
        v = (r.meets(sla_ms) and r.dropped == 0
             and r.qps >= SUSTAIN_FRACTION * qps)
        _memo[qps] = v
        return v

    if hi is None:
        lo, hi = warm_bracket(ok, lo, hint)
        return bracket_bisect(ok, lo, hi, iters, cap=4e6)
    return bracket_bisect(ok, lo, hi, iters)
