"""The ``NodeBackend`` interface: one serving-node contract, two engines.

A backend is what the fleet driver (``cluster_sim.drive_fleet``) and the
routers see of a node — the same four capabilities regardless of whether
the node is simulated or real:

  * ``submit(idx, times, sizes, model_ids)`` — a sorted window of queries
    routed to this node (``idx`` are global trace indices; ``model_ids``
    carry the per-query tenant label from
    ``MultiTenantTraffic.generate_labeled``);
  * ``advance_to(t)`` — advance the node to timeline time ``t`` (a no-op
    for simulated nodes, whose completion times are computed analytically
    at submit; a wall-clock wait for live nodes);
  * ``completed_records()`` — per-query completion facts
    (``CompletedQuery``), in trace-time coordinates for both engines;
  * ``weight`` — the capacity weight routers consume (per-node achievable
    QPS, from ``Fleet.tune``/``estimate_capacity`` or live calibration).

``SimNodeBackend`` wraps the stateful numpy fast-engine entry points in
``core.simulator`` (``node_pass`` carrying executor/accelerator free times
across traffic windows — exactly the pipeline ``simulate_arrays`` runs).
An all-sim window can skip the per-node loop entirely: ``submit_grouped``
advances every node of a routed window in one ``node_pass_many`` pass
(``grouped_eligible`` gates it), writing the same per-node histories the
per-node path would — the fleet driver's fast path at 1k+ nodes.
``cluster.live.LiveNodeBackend`` wraps a real ``serve.runtime
.ServingRuntime`` executing a PyTorch model on the card or the host CPU.
Routers are engine-blind: they read only the ``NodeHandle`` surface
(identity, spec, weight), so the same policy object produces the same
routing decisions against either backend kind — the property
``chip_smoke.py``'s ``live`` phase exploits to close the sim-vs-real loop.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.cluster.fleet import NodeSpec, NodeView
from repro_torch.core.simulator import NodeEngine, node_pass, node_pass_many


@runtime_checkable
class NodeHandle(Protocol):
    """The router-facing surface of a node: stable identity, the spec the
    cost estimators price work with, and a capacity weight.  Satisfied by
    ``fleet.NodeView`` and by every ``NodeBackend``."""
    pool: str
    index_in_pool: int
    spec: NodeSpec
    weight: float


class BackendDied(RuntimeError):
    """The execution engine behind a node is gone mid-run — the process
    crashed, the transport failed past its retry budget, or the runtime
    shut down underneath the driver.  The windowed driver catches this
    (never a bare ``RuntimeError``, which still means a caller bug),
    re-routes the victim's work, and lets the lifecycle controller's
    health pass decide whether to heal the node."""


@dataclasses.dataclass
class PendingQuery:
    """One query a backend accepted but had not completed when it was
    killed (``NodeBackend.cancel_pending``) — everything the fleet
    controller needs to re-route it to a surviving node."""
    index: int                  # global index into the driver's trace
    t_arrival: float
    size: int
    model_id: int = -1


@dataclasses.dataclass
class CompletedQuery:
    """One query's completion facts, in trace-time seconds (live backends
    convert wall clock back to the trace timeline so sim and live results
    are directly comparable)."""
    index: int                  # global index into the driver's trace
    t_arrival: float
    t_done: float               # NaN = dropped / never completed
    model_id: int = -1          # tenant label; -1 = unlabeled traffic
    error: str | None = None    # live only: the apply_fn failure, if any
    # span stamps (trace time; NaN = engine did not stamp): when the
    # query was released into the node's executor queue, and when an
    # executor first picked it up — what the obs layer's queueing/service
    # decomposition is built from
    t_released: float = float("nan")
    t_exec_start: float = float("nan")

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_arrival) * 1e3


class NodeBackend:
    """Base class for serving-node backends (see module docstring).

    ``realtime`` distinguishes the two timeline semantics: simulated
    backends complete work analytically the moment it is submitted, live
    backends complete work when the wall clock does.  A fleet must be
    homogeneous in this flag — the driver refuses to mix virtual and wall
    time on one timeline.
    """

    realtime = False

    pool: str = "node"
    index_in_pool: int = 0
    spec: NodeSpec
    weight: float = 1.0
    # transport degraded but the node may still be alive (an RPC ran past
    # its deadline): the health pass verifies SUSPECT nodes instead of
    # declaring them dead on one bad exchange
    suspect: bool = False

    @property
    def key(self) -> tuple[str, int]:
        """Stable node identity — what router state and the driver's
        backend pool are keyed by across fleet resizes."""
        return (self.pool, self.index_in_pool)

    @property
    def capacity_weight(self) -> float:
        return self.weight

    def start(self, t0: float) -> None:
        """Anchor the backend's timeline at trace time ``t0`` (live
        backends pin the shared wall clock here; sim backends need
        nothing — their free times were seeded at construction)."""

    def enable_spans(self) -> None:
        """Ask the backend to produce span stamps (``t_released``/
        ``t_exec_start`` on its ``CompletedQuery`` records) from here on.
        Idempotent; the default is a no-op — live/remote backends always
        stamp (the wall clock is already being read), while
        ``SimNodeBackend`` computes exec-starts only when asked so the
        telemetry-off driver costs exactly what it did before."""

    def submit(self, idx: np.ndarray, times: np.ndarray, sizes: np.ndarray,
               model_ids: np.ndarray | None = None) -> np.ndarray | None:
        """Accept a sorted window of queries routed to this node.

        Simulated backends return the per-query completion times
        immediately (the driver folds them into its result arrays without
        waiting); live backends return ``None`` — their completions
        surface later through ``completed_records``.
        """
        raise NotImplementedError

    def advance_to(self, t: float) -> None:
        """Advance the node's timeline to trace time ``t``."""

    def drain(self, timeout: float = 120.0) -> None:
        """Block until all submitted work has completed."""

    def completed_records(self) -> list[CompletedQuery]:
        """Everything this node has completed so far."""
        raise NotImplementedError

    def take_new_records(self) -> list[CompletedQuery]:
        """Completions since the last call — the windowed driver's
        monitoring feed.  The base implementation diffs
        ``completed_records`` against a seen-set (correct for any
        backend); ``LiveNodeBackend`` overrides it with an O(new
        completions) cursor into the runtime's append-only completion
        log, so per-window polls don't rescan a long run's full history.
        """
        seen = self._taken = getattr(self, "_taken", set())
        out = []
        for r in self.completed_records():
            if r.index not in seen:
                seen.add(r.index)
                out.append(r)
        return out

    def cancel_pending(self, t: float) -> list[PendingQuery]:
        """Kill the node at trace time ``t``: every accepted query the
        node had not already completed is forgotten and returned for
        re-routing, and the backend accepts no further ``submit``.
        "Already completed" is engine-specific at the boundary: a
        simulated node keeps analytic completions with ``done <= t``; a
        live node shuts its ``ServingRuntime`` down mid-run and keeps
        whatever the runtime had physically finished by the shutdown
        (including a worker's in-flight request).  Either way, a query
        is in exactly one of ``completed_records()`` or the returned
        pending list — nothing is double-counted or lost."""
        raise NotImplementedError

    def dead(self) -> bool:
        """Has the execution engine behind this node gone away unplanned?
        The lifecycle controller's health pass polls this every window;
        a dead node is retired (orphans re-routed) and — under a
        ``SelfHealPolicy`` — restarted through BOOTING.  Sim nodes never
        die on their own; real backends override."""
        return False

    def idle(self, t: float) -> bool:
        """Is every accepted query complete at trace time ``t``?  Drives
        terminate-after-idle for DRAINING nodes.  The base answer is
        ``False`` — a backend that cannot tell must never be terminated
        early (closing it would strand in-flight work)."""
        return False

    def set_offload_threshold(self, threshold: int | None) -> None:
        """Re-knob the node's query-size offload threshold mid-run — the
        write side of the online ``OffloadController``.  The spec is
        replaced (specs are frozen; router cost caches key on knob
        values, so a fresh spec object re-prices correctly) and takes
        effect for *subsequently* submitted windows; work already
        accepted keeps the knobs it was priced with.  For live/remote
        backends the spec swap alone is the whole semantics: execution
        happens on this host's real devices and the threshold only
        shapes how routers price the node."""
        if threshold == self.spec.offload_threshold:
            return
        self.spec = dataclasses.replace(self.spec,
                                        offload_threshold=threshold)

    def close(self) -> None:
        """Release node resources (worker threads, devices)."""


class SimNodeBackend(NodeBackend):
    """A simulated node: the numpy fast engine behind the backend contract.

    Wraps ``core.simulator.node_pass`` statefully — executor and
    accelerator free times persist across ``submit`` calls, so queued work
    from one traffic window delays the next, exactly as the windowed
    driver has always modeled it.  ``t0`` seeds the free times at the
    node's boot instant (autoscaled nodes boot idle at the window start
    they first appear in).
    """

    def __init__(self, view: NodeView, t0: float = 0.0):
        self.pool = view.pool
        self.index_in_pool = view.index_in_pool
        self.spec = view.spec
        self.weight = view.weight
        self.cfg = view.spec.scheduler_config()
        # executor/accelerator free times live in a NodeEngine so the
        # grouped fleet advance (submit_grouped) and the per-node path
        # below share one state representation — a window served by one
        # path leaves exactly the state the other resumes from
        self.engine = NodeEngine.make(self.spec.cpu, self.cfg,
                                      self.spec.accel, t0)
        # (idx, times, done, sizes, model_ids, exec_start-or-None)
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray | None,
                                 np.ndarray | None]] = []
        self._killed = False
        self._spans = False

    def enable_spans(self) -> None:
        self._spans = True

    def submit(self, idx: np.ndarray, times: np.ndarray, sizes: np.ndarray,
               model_ids: np.ndarray | None = None) -> np.ndarray:
        if self._killed:
            raise RuntimeError(f"node {self.key} is dead (cancel_pending "
                               f"was called) — it accepts no new queries")
        eng = self.engine
        if self._spans:
            done, _, _, cpu_free, acc_free, starts = node_pass(
                times, sizes, self.spec.cpu, self.cfg,
                accel=self.spec.accel,
                cpu_free=eng.cpu_state.materialize(),
                acc_free=eng.acc_state.materialize(), want_starts=True)
        else:
            done, _, _, cpu_free, acc_free = node_pass(
                times, sizes, self.spec.cpu, self.cfg, accel=self.spec.accel,
                cpu_free=eng.cpu_state.materialize(),
                acc_free=eng.acc_state.materialize())
            starts = None
        eng.cpu_state.set_free(cpu_free)
        eng.acc_state.set_free(acc_free)
        self._chunks.append((np.asarray(idx), np.asarray(times, float),
                             done, np.asarray(sizes, np.int64), model_ids,
                             starts))
        return done

    def completed_records(self) -> list[CompletedQuery]:
        out = []
        for idx, times, done, _, mids, starts in self._chunks:
            for j in range(len(idx)):
                out.append(CompletedQuery(
                    index=int(idx[j]), t_arrival=float(times[j]),
                    t_done=float(done[j]),
                    model_id=int(mids[j]) if mids is not None else -1,
                    t_released=float(times[j]),
                    t_exec_start=float(starts[j]) if starts is not None
                    else float("nan")))
        return out

    def span_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """Vectorized span stamps for every query this node served:
        ``(global_idx, t_released, t_exec_start, t_done)``.  A simulated
        query is released the instant it arrives (the analytic pipeline
        has no batching delay), so ``t_released`` is the submit-time
        arrival; ``t_exec_start`` is NaN for chunks served before
        ``enable_spans``."""
        if not self._chunks:
            z = np.empty(0)
            return z.astype(np.int64), z, z, z
        idx = np.concatenate([c[0] for c in self._chunks]).astype(np.int64)
        rel = np.concatenate([c[1] for c in self._chunks])
        done = np.concatenate([c[2] for c in self._chunks])
        start = np.concatenate([
            c[5] if c[5] is not None else np.full(len(c[0]), np.nan)
            for c in self._chunks])
        return idx, rel, start, done

    def idle(self, t: float) -> bool:
        """All analytic completions at or before ``t`` (NaN drops never
        complete and never will — they don't hold the node open)."""
        return all(not np.any(c[2] > t) for c in self._chunks)

    def set_offload_threshold(self, threshold: int | None) -> None:
        """Spec swap plus the simulated execution machinery: the engine's
        ``SchedulerConfig`` is rebuilt so the *next* submitted window
        splits CPU/accel work at the new threshold.  ``NodeEngine
        .set_cfg`` drops the engine's interned class id and invalidates
        the grouped-pass parts cache — the per-class threshold tables
        there were built from the old knob."""
        if threshold == self.spec.offload_threshold:
            return
        super().set_offload_threshold(threshold)
        self.cfg = self.spec.scheduler_config()
        self.engine.set_cfg(self.cfg)

    def cancel_pending(self, t: float) -> list[PendingQuery]:
        """A simulated kill at trace time ``t``: the analytically computed
        completion at ``done > t`` never actually happened — strip those
        queries (and NaN drops) from the node's history and hand them
        back for re-routing; completions at ``done <= t`` stand."""
        self._killed = True
        orphans: list[PendingQuery] = []
        kept = []
        for idx, times, done, sizes, mids, starts in self._chunks:
            alive = done <= t            # NaN compares False → orphaned
            for j in np.flatnonzero(~alive):
                orphans.append(PendingQuery(
                    index=int(idx[j]), t_arrival=float(times[j]),
                    size=int(sizes[j]),
                    model_id=int(mids[j]) if mids is not None else -1))
            if alive.any():
                kept.append((idx[alive], times[alive], done[alive],
                             sizes[alive],
                             mids[alive] if mids is not None else None,
                             starts[alive] if starts is not None else None))
        self._chunks = kept
        return orphans


def sim_backends(views: list[NodeView], t0: float = 0.0
                 ) -> list[SimNodeBackend]:
    """One ``SimNodeBackend`` per node of a fleet, booted idle at ``t0``."""
    return [SimNodeBackend(v, t0=t0) for v in views]


# ---------------------------------------------------- grouped fleet path


def grouped_eligible(backends) -> bool:
    """Can this node list be advanced by ``submit_grouped``?  Exactly the
    plain simulated engine — a live/remote node (wall-clock timeline), a
    ``SimNodeBackend`` subclass with its own ``submit``, or an
    already-killed node all defer to the per-node loop."""
    return all(type(b) is SimNodeBackend and not b._killed
               for b in backends)


def submit_grouped(backends: list[SimNodeBackend], assign: np.ndarray,
                   idx: np.ndarray, times: np.ndarray, sizes: np.ndarray,
                   model_ids: np.ndarray | None = None,
                   engines: list | None = None,
                   keep_records: bool = True
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batched numpy advance for a whole routed window of simulated
    nodes — the fleet-scale replacement for N per-node ``submit`` calls.

    ``assign`` maps each query to its node index in ``backends`` (the
    router's window assignment); the window is permuted node-segmented
    (stable sort, preserving FIFO arrival order within each node — the
    same order per-node ``submit`` would have seen), advanced in one
    ``node_pass_many`` pass, and each node's slice is appended to its own
    ``_chunks`` history — so ``completed_records`` / ``cancel_pending`` /
    ``idle`` / ``span_arrays`` behave exactly as if the node had served
    the window itself.  Span stamps are computed iff any node has them
    enabled (the driver enables all-or-none).

    Returns ``(done, order, seg_bounds, exec_starts)``: per-query
    completion times aligned with the *input* window order, the
    node-segmented permutation and its per-node end offsets (so the
    caller's telemetry fold can reuse the segmentation instead of
    re-sorting), and — when spans are enabled — each query's first
    executor dispatch time in input order (else ``None``), letting the
    driver stamp the span table inline per window instead of re-walking
    chunk histories at end of run.

    ``engines`` is an optional precomputed ``[b.engine for b in
    backends]`` — a steady-state driver caches it per serving list so
    the per-window work touches only nodes that actually received
    queries.  When omitted (or on any doubt) it is rebuilt here, with a
    dead-node check.

    ``keep_records=False`` skips the per-node ``_chunks`` scatter — the
    largest per-window cost of the grouped layout (hundreds of array
    slices a window).  Only a driver that has proven the history has no
    reader may pass it: no telemetry spans, no scheduled kills or chaos
    (``cancel_pending`` rolls chunks back), no autoscaler/heal
    (``idle`` reads them), no caller-owned backends
    (``completed_records`` is public surface).  The completion times
    themselves are unaffected — chunks are bookkeeping, not state.
    """
    assign = np.asarray(assign, np.int64)
    order = np.argsort(assign, kind="stable")
    seg_bounds = np.cumsum(np.bincount(assign, minlength=len(backends)))
    p_times = np.asarray(times, float)[order]
    p_sizes = np.asarray(sizes, np.int64)[order]
    p_idx = np.asarray(idx)[order]
    p_mids = model_ids[order] if model_ids is not None else None

    spans = False
    if engines is None:
        engines = []
        for b in backends:
            if b._killed:
                raise RuntimeError(f"node {b.key} is dead (cancel_pending "
                                   f"was called) — it accepts no new "
                                   f"queries")
            engines.append(b.engine)
            spans = spans or b._spans
    else:
        spans = backends[0]._spans if backends else False
    done_p, starts_p = node_pass_many(p_times, p_sizes, seg_bounds, engines,
                                      want_starts=spans)
    done = np.empty(len(p_times))
    done[order] = done_p
    starts = None
    if starts_p is not None:
        starts = np.empty(len(p_times))
        starts[order] = starts_p

    if keep_records:
        seg_starts = np.concatenate(([0], seg_bounds[:-1]))
        for i in np.flatnonzero(seg_bounds - seg_starts).tolist():
            b = backends[i]
            s, e = int(seg_starts[i]), int(seg_bounds[i])
            st = starts_p[s:e] if (starts_p is not None and b._spans) \
                else None
            b._chunks.append((p_idx[s:e], p_times[s:e], done_p[s:e],
                              p_sizes[s:e],
                              p_mids[s:e] if p_mids is not None else None,
                              st))
    return done, order, seg_bounds, starts
