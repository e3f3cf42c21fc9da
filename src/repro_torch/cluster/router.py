"""Pluggable query-routing policies for the cluster tier.

A ``Router`` maps a sorted window of queries ``(times, sizes)`` onto node
indices given the fleet's ``NodeView`` list.  Policies:

  * ``RoundRobinRouter``        — heterogeneity-blind baseline: query *j*
    goes to node ``j mod N`` (continued across windows).
  * ``LeastOutstandingRouter``  — greedy join-least-work: track each node's
    estimated time-to-drain (seconds of queued work over its executor
    pool), decay it in real time between arrivals, send each query to the
    node that would start it soonest.
  * ``SizeAwareRouter``         — static split: queries ≥ ``split_size``
    go to accelerator-capable nodes, the rest to CPU nodes, weighted
    round-robin by capacity within each class.
  * ``HeterogeneityAwareRouter`` — Hercules-style join-shortest-expected-
    completion: each node keeps separate executor-pool and accelerator
    backlogs, a query is scored per node as the backlog of the path it
    would take there plus its estimated drain time on that path, and goes
    to the globally cheapest node — so large batches flow to the devices
    that amortize them until those saturate, then overflow to CPUs.

Routers are *backend-agnostic*: they see nodes only through the
``NodeHandle`` surface of ``cluster.backend`` (stable identity, spec,
capacity weight) — satisfied by simulated and live ``NodeBackend``s alike,
so a policy makes identical decisions whether the node behind the handle
is the numpy fast engine or a real ``ServingRuntime``.  They are also
*lifecycle-blind*: the fleet driver hands ``assign`` only the nodes the
``cluster.lifecycle.FleetController`` reports as SERVING, so booting,
draining, and dead nodes never appear in the candidate list (and the
per-key state stores below survive nodes entering/leaving it; a freshly
promoted node joins at the fleet-median backlog — see ``_load_state`` —
rather than flooding from zero).  Estimated
per-query work is computed per node *class* (pools share specs) from the
same service-time tables the fast simulator uses, so routing cost
estimates and simulated reality agree.

Multi-tenant traffic (``MultiTenantTraffic.generate_labeled``) threads a
per-query ``model_ids`` array through ``assign``; the heterogeneity-aware
router can pin tenants to pools (``affinity=``) to enforce per-model
placement/SLA policies.
"""
from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np

from repro_torch.cluster.backend import NodeHandle
from repro_torch.core.latency_model import service_time_table


class Router:
    """Routing-policy interface; stateful across windows (the driver calls
    ``assign`` once per traffic window with the same node ordering)."""

    name = "base"

    def assign(self, times: np.ndarray, sizes: np.ndarray,
               nodes: Sequence[NodeHandle],
               model_ids: np.ndarray | None = None) -> np.ndarray:
        """Node index (into ``nodes``) for each query of a sorted window."""
        raise NotImplementedError

    def reset(self) -> None:
        """Forget cross-window state (new simulation run)."""


def _drain_consts(spec) -> float:
    """Memoized per-request executor-pool cost of ``spec`` — the
    ``service_time_table`` row lookup that ``_class_drain_seconds`` used
    to redo for the same spec every window.  Cached *on the spec object*
    (the same idiom the device models use for their service tables) and
    keyed by the knob values it depends on, so an in-place ``tune`` of a
    shared spec invalidates naturally; ``Fleet.tune``'s spec replacement
    (``dataclasses.replace``) starts a fresh cache either way."""
    knobs = (max(spec.batch_size, 1), spec.n_executors,
             spec.request_overhead_s)
    cached = getattr(spec, "_drain_cache", None)
    if cached is not None and cached[0] == knobs:
        return cached[1]
    B = knobs[0]
    per_req = float(service_time_table(spec.cpu, B)[B]
                    + spec.request_overhead_s)
    spec._drain_cache = (knobs, per_req)
    return per_req


def _class_drain_seconds(spec, sizes: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Estimated time (s) a node of ``spec`` needs to drain each query,
    plus which path it takes there: offloaded queries occupy the
    accelerator queue, split queries occupy the executor pool ⌈size/B⌉
    requests wide.  Returns ``(drain_seconds, offloaded_mask)``."""
    sizes = np.asarray(sizes, np.int64)
    B = max(spec.batch_size, 1)
    n_req = -(-sizes // B)
    # evaluation order matches the pre-memoization expression bit for bit:
    # (n_req * (tab[B] + overhead)) / n_executors
    est = n_req * _drain_consts(spec) / max(spec.n_executors, 1)
    off = np.zeros(len(sizes), bool)
    if spec.has_accel and len(sizes):
        acc_tab = service_time_table(spec.accel, int(sizes.max()))
        off = sizes >= spec.offload_threshold
        est = np.where(off, acc_tab[sizes] / max(spec.n_accelerators, 1), est)
    return est, off


def _est_work_by_class(nodes: Sequence[NodeHandle], sizes: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Class-compact drain estimates: ``(cls_of, est, off)`` where
    ``est``/``off`` hold one row per distinct node *class* and
    ``cls_of[i]`` maps node ``i`` to its row.  Classes are keyed by the
    drain-relevant spec values (not object identity), so equal-but-
    distinct specs — e.g. a copied fleet — share one row, and an N-node
    fleet of C classes costs O(C·Q) instead of O(N·Q)."""
    cls_of = np.empty(len(nodes), np.int64)
    keymap: dict = {}
    rows: list[tuple] = []
    for i, nv in enumerate(nodes):
        s = nv.spec
        key = (id(s.cpu), id(s.accel), s.batch_size, s.offload_threshold,
               s.n_executors, s.n_accelerators, s.request_overhead_s)
        c = keymap.get(key)
        if c is None:
            c = keymap[key] = len(rows)
            rows.append(_class_drain_seconds(s, sizes))
        cls_of[i] = c
    if not rows:
        return cls_of, np.empty((0, len(sizes))), \
            np.empty((0, len(sizes)), bool)
    return cls_of, np.stack([r[0] for r in rows]), \
        np.stack([r[1] for r in rows])


def _est_work(nodes: Sequence[NodeHandle], sizes: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """(n_nodes, n_queries) drain-seconds estimate and offload-path mask,
    one row per node — the class-compact rows fanned back out for
    policies that index per node."""
    cls_of, est, off = _est_work_by_class(nodes, sizes)
    if not len(cls_of):
        return est, off
    return est[cls_of], off[cls_of]


def _load_state(store: dict, nodes: Sequence[NodeHandle]) -> np.ndarray:
    """Per-node state aligned with ``nodes``, keyed by stable node identity
    ``(pool, index_in_pool)`` — an autoscaling resize must not wipe the
    surviving nodes' backlogs.

    Join-warmup: a node *not* in the store is freshly promoted
    (autoscaled, restarted), and seeding its backlog at 0 would make a
    greedy policy route the entire next window at it until its estimate
    catches up — the join-flood transient.  New keys are seeded at the
    *median* of the incumbents' backlogs instead: the joiner enters
    mid-pack, picks up a fair share immediately, and drifts to its true
    level as real assignments accrue.  A first window (no incumbents)
    seeds everyone at 0, as before."""
    vals = [store.get((nv.pool, nv.index_in_pool)) for nv in nodes]
    known = [v for v in vals if v is not None]
    fill = float(np.median(known)) if known else 0.0
    return np.array([fill if v is None else v for v in vals])


def _store_state(values: np.ndarray, nodes: Sequence[NodeHandle]) -> dict:
    """Rebuilding from the current node list drops removed nodes."""
    return {(nv.pool, nv.index_in_pool): float(values[i])
            for i, nv in enumerate(nodes)}


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._next = 0

    def reset(self) -> None:
        self._next = 0

    def assign(self, times, sizes, nodes, model_ids=None) -> np.ndarray:
        n = len(nodes)
        out = (self._next + np.arange(len(times))) % n
        self._next = int((self._next + len(times)) % n)
        return out.astype(np.int64)


def _assign_scalar(times: np.ndarray, est: np.ndarray, backlog: np.ndarray,
                   last_t: float) -> tuple[np.ndarray, np.ndarray, float]:
    """The original greedy join-least-work loop — decay every node's
    backlog at every query, argmin, add the winner's estimate.  O(N·Q)
    Python-level work; kept verbatim as the semantic reference the
    event-sorted heap evaluation below is tested against."""
    out = np.empty(len(times), np.int64)
    for j, t in enumerate(np.asarray(times, float)):
        backlog -= t - last_t          # queues drain in real time
        np.maximum(backlog, 0.0, out=backlog)
        i = int(np.argmin(backlog))
        backlog[i] += est[i, j]
        out[j] = i
        last_t = t
    return out, backlog, last_t


def _assign_heap(times: np.ndarray, est: np.ndarray, cls_of: np.ndarray,
                 backlog: np.ndarray, last_t: float
                 ) -> tuple[np.ndarray, np.ndarray, float]:
    """Event-sorted evaluation of the greedy join-least-work policy.

    "Decay and clamp" is memoryless: node *i*'s decayed backlog at time
    ``t`` is exactly ``max(d_i − t, 0)`` where ``d_i`` — its *drain
    instant* — is the time of its last update plus the backlog written
    then.  So instead of decaying all N backlogs per query (the scalar
    reference's O(N·Q)), keep the nodes in two heaps: busy ``(d_i, i)``
    and idle ``(i,)``.  Arrivals pop drained nodes into the idle heap;
    each query goes to the min-index idle node (its decayed backlog is
    0, and ``np.argmin`` breaks the all-zeros tie at the lowest index)
    or, with every node busy, to the smallest ``(d_i, i)`` — the same
    winner the argmin picks, tie-broken identically, in
    O((N + Q) log N).  ``est`` is class-compact; ``cls_of`` maps nodes
    to rows."""
    n = len(cls_of)
    out = np.empty(len(times), np.int64)
    if not len(times) or n == 0:
        return out, backlog, last_t
    busy = [(last_t + backlog[i], i) for i in range(n) if backlog[i] > 0.0]
    idle = [i for i in range(n) if backlog[i] <= 0.0]
    heapq.heapify(busy)
    heapq.heapify(idle)
    push, pop = heapq.heappush, heapq.heappop
    class_rows = [row.tolist() for row in est]
    node_rows = [class_rows[c] for c in cls_of.tolist()]
    tl = np.asarray(times, float).tolist()
    for j, t in enumerate(tl):
        while busy and busy[0][0] <= t:
            push(idle, pop(busy)[1])
        if idle:
            i = pop(idle)
            d = t + node_rows[i][j]
        else:
            d0, i = pop(busy)
            d = d0 + node_rows[i][j]
        out[j] = i
        push(busy, (d, i))
    t_last = tl[-1]
    new_backlog = np.zeros(n)
    for d, i in busy:
        b = d - t_last
        if b > 0.0:
            new_backlog[i] = b
    return out, new_backlog, t_last


class LeastOutstandingRouter(Router):
    name = "least_outstanding"

    def __init__(self):
        self._store: dict = {}
        self._last_t = 0.0

    def reset(self) -> None:
        self._store, self._last_t = {}, 0.0

    def assign(self, times, sizes, nodes, model_ids=None) -> np.ndarray:
        backlog = _load_state(self._store, nodes)
        cls_of, est, _ = _est_work_by_class(nodes, sizes)
        out, backlog, self._last_t = _assign_heap(
            np.asarray(times, float), est, cls_of, backlog, self._last_t)
        self._store = _store_state(backlog, nodes)
        return out


def _weighted_rr(counts: np.ndarray, weights: np.ndarray,
                 n_queries: int) -> np.ndarray:
    """Classic weighted round-robin: each pick minimizes served/weight;
    ``counts`` carries state across windows (mutated in place)."""
    out = np.empty(n_queries, np.int64)
    for j in range(n_queries):
        i = int(np.argmin((counts + 1.0) / weights))
        counts[i] += 1.0
        out[j] = i
    return out


class SizeAwareRouter(Router):
    """Static size split: ≥ ``split_size`` → accelerator-capable nodes."""

    name = "size_aware"

    def __init__(self, split_size: int = 256):
        self.split_size = split_size
        self._store: dict = {}

    def reset(self) -> None:
        self._store = {}

    def assign(self, times, sizes, nodes, model_ids=None) -> np.ndarray:
        n = len(nodes)
        counts = _load_state(self._store, nodes)
        weights = np.array([nv.weight for nv in nodes])
        accel = np.array([nv.spec.has_accel for nv in nodes])
        # WRR counts are cumulative: a node added mid-run must join at its
        # own class's level (classes serve disjoint traffic, so their
        # cumulative counts diverge), or argmin((counts+1)/weights) floods
        # it with its whole class until it catches up
        fresh = np.array([(nv.pool, nv.index_in_pool) not in self._store
                          for nv in nodes])
        if fresh.any() and not fresh.all():
            for cls in (accel, ~accel):
                f = fresh & cls
                incumbent = cls & ~fresh
                if f.any():
                    base = counts[incumbent] if incumbent.any() \
                        else counts[~fresh]
                    counts[f] = base.min()
        big = np.asarray(sizes) >= self.split_size
        out = np.empty(len(times), np.int64)
        for mask, node_mask in ((big, accel), (~big, ~accel)):
            if not mask.any():
                continue
            cls = np.flatnonzero(node_mask)
            if len(cls) == 0:              # no such node class: use them all
                cls = np.arange(n)
            sub = counts[cls]              # fancy index copies: write back
            picks = _weighted_rr(sub, weights[cls], int(mask.sum()))
            counts[cls] = sub
            out[mask] = cls[picks]
        self._store = _store_state(counts, nodes)
        return out


class HeterogeneityAwareRouter(Router):
    """Hercules-style join-shortest-expected-completion, path-aware.

    Each node keeps *two* backlogs — its executor pool and its accelerator
    queue — because a query's path on a node is fixed by that node's
    offload threshold.  A query's score on node *i* is the backlog of the
    path it would take there plus its estimated drain time on that path
    (slow CPU generations and amortizing accelerators both priced in);
    the query goes to the globally cheapest node.  Large-batch queries
    therefore flow to accelerator nodes while the accelerators have
    headroom and overflow onto CPU pools when they saturate; small queries
    spread over every node inversely to device speed.

    ``affinity`` (optional) maps a tenant's model id to the pool name(s)
    its queries may run on — per-model placement for multi-tenant traffic
    (labels from ``MultiTenantTraffic.generate_labeled`` arrive via the
    ``model_ids`` argument of ``assign``).  A tenant whose allowed pools
    have no node in the current fleet falls back to every node rather
    than dropping traffic."""

    name = "hetero"

    def __init__(self, affinity: dict[int, object] | None = None):
        # stored as given; assign() normalizes (affinity is just as often
        # assigned post-construction — make_router takes no kwargs)
        self.affinity = dict(affinity or {})
        self._cpu_store: dict = {}
        self._acc_store: dict = {}
        self._last_t = 0.0

    def reset(self) -> None:
        self._cpu_store, self._acc_store, self._last_t = {}, {}, 0.0

    def assign(self, times, sizes, nodes, model_ids=None) -> np.ndarray:
        cpu_b = _load_state(self._cpu_store, nodes)
        acc_b = _load_state(self._acc_store, nodes)
        est, off = _est_work(nodes, sizes)
        allowed: dict[int, np.ndarray] = {}
        if self.affinity and model_ids is not None:
            pools = np.array([nv.pool for nv in nodes])
            for m, names in self.affinity.items():
                # a bare string must not be iterated character-wise
                names = {names} if isinstance(names, str) else set(names)
                mask = np.isin(pools, list(names))
                if mask.any():              # else: fall back to every node
                    allowed[m] = mask
        out = np.empty(len(times), np.int64)
        last_t = self._last_t
        for j, t in enumerate(np.asarray(times, float)):
            dt = t - last_t
            cpu_b -= dt
            acc_b -= dt
            np.maximum(cpu_b, 0.0, out=cpu_b)
            np.maximum(acc_b, 0.0, out=acc_b)
            path = off[:, j]
            score = np.where(path, acc_b, cpu_b) + est[:, j]
            if model_ids is not None and int(model_ids[j]) in allowed:
                score = np.where(allowed[int(model_ids[j])], score, np.inf)
            i = int(np.argmin(score))
            (acc_b if path[i] else cpu_b)[i] += est[i, j]
            out[j] = i
            last_t = t
        self._cpu_store = _store_state(cpu_b, nodes)
        self._acc_store = _store_state(acc_b, nodes)
        self._last_t = last_t
        return out


ROUTERS = {r.name: r for r in (RoundRobinRouter, LeastOutstandingRouter,
                               SizeAwareRouter, HeterogeneityAwareRouter)}


def make_router(name: str) -> Router:
    try:
        return ROUTERS[name]()
    except KeyError:
        raise ValueError(f"unknown router {name!r}; "
                         f"choose from {sorted(ROUTERS)}") from None
