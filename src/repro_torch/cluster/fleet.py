"""Heterogeneous fleet description (Hercules-style capacity planning).

A ``Fleet`` is a set of named ``Pool``s, each holding ``count`` identical
nodes described by a ``NodeSpec``: a CPU generation (any ``DeviceModel``),
an optional accelerator, executor counts, and the node's DeepRecSched knobs
(per-request batch size and offload threshold).  ``Fleet.tune`` runs the
existing per-node DeepRecSched hill climb once per pool to fill in the
knobs and each pool's per-node achievable QPS — the capacity weight the
heterogeneity-aware routers consume.

``ScaledDeviceModel`` derives an older/slower CPU generation from a
measured curve by a multiplicative slowdown (the paper's Broadwell vs
Skylake gap without re-measuring on different silicon).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.latency_model import ContentionModel, DeviceModel
from repro_torch.core.query_gen import PRODUCTION, SizeDist
from repro_torch.core.scheduler import tune
from repro_torch.core.simulator import SchedulerConfig, max_qps_under_sla


@dataclasses.dataclass
class ScaledDeviceModel:
    """A ``DeviceModel`` that is ``factor``× slower than ``base`` at every
    batch size — e.g. ``factor=1.5`` for a Broadwell-class node derived
    from a measured Skylake curve."""
    base: DeviceModel
    factor: float

    def latency(self, batch: int) -> float:
        return self.base.latency(batch) * self.factor

    def latency_batch(self, batches: np.ndarray) -> np.ndarray:
        return np.asarray(self.base.latency_batch(batches)) * self.factor


@dataclasses.dataclass
class NodeSpec:
    """One node class: devices, executor counts, and DeepRecSched knobs.

    ``boot_s`` is the node-class boot latency: a node of this spec added
    to a running fleet (autoscaling, fault restart) spends its first
    ``boot_s`` seconds in the BOOTING lifecycle state and receives no
    queries until the delay elapses (``cluster.lifecycle``).  Nodes
    present when a run starts are warm.
    """
    cpu: DeviceModel
    accel: DeviceModel | None = None
    n_executors: int = 40
    n_accelerators: int = 1
    batch_size: int = 8
    offload_threshold: int | None = None
    request_overhead_s: float = 1.35e-4
    boot_s: float = 0.0

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(
            batch_size=self.batch_size,
            offload_threshold=self.offload_threshold,
            n_executors=self.n_executors,
            n_accelerators=self.n_accelerators,
            request_overhead_s=self.request_overhead_s)

    @property
    def has_accel(self) -> bool:
        return self.accel is not None and self.offload_threshold is not None


@dataclasses.dataclass
class Pool:
    """``count`` identical nodes of one ``NodeSpec``.

    ``qps_capacity`` is the per-node achievable QPS under the fleet's SLA
    (filled by ``Fleet.tune`` or ``Fleet.estimate_capacity``); routers use
    it as the node weight.  ``min_count``/``max_count`` bound autoscaling.

    Node identity is *ledger-owned*: ``members`` holds the explicit node
    indices this pool currently names (``None`` is the common compact
    case, meaning ``range(count)``).  A fault kill removes its exact
    index (``Fleet.kill``) instead of renaming the survivors by
    decrementing ``count``, so capacity accounting tracks the true pool
    and regrowth can reuse the dead slot.  ``count == len(members)``
    always.
    """
    name: str
    spec: NodeSpec
    count: int
    qps_capacity: float = 0.0
    min_count: int = 1
    max_count: int | None = None
    members: list[int] | None = None

    def member_ids(self) -> list[int]:
        """The node indices this pool names, ascending."""
        if self.members is None:
            return list(range(self.count))
        return list(self.members)


class Fleet:
    """A heterogeneous serving fleet: ordered pools of identical nodes."""

    def __init__(self, pools: list[Pool]):
        if not pools:
            raise ValueError("a Fleet needs at least one pool")
        names = [p.name for p in pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {names}")
        self.pools = list(pools)

    def __repr__(self) -> str:
        inner = ", ".join(f"{p.name}×{p.count}" for p in self.pools)
        return f"Fleet({inner})"

    @property
    def n_nodes(self) -> int:
        return sum(p.count for p in self.pools)

    def pool(self, name: str) -> Pool:
        for p in self.pools:
            if p.name == name:
                return p
        raise KeyError(name)

    def scale(self, name: str, delta: int) -> int:
        """Grow (+) or shrink (−) a pool, clamped to its bounds; returns
        the delta actually applied.  Growth fills the lowest free indices
        first — reusing slots earlier kills vacated — and shrink retires
        the highest-numbered members."""
        p = self.pool(name)
        target = p.count + delta
        lo = p.min_count
        hi = p.max_count if p.max_count is not None else target
        applied = max(lo, min(target, hi)) - p.count
        if applied > 0:
            members = p.member_ids()
            used = set(members)
            nxt = 0
            for _ in range(applied):
                while nxt in used:
                    nxt += 1
                members.append(nxt)
                used.add(nxt)
            p.members = sorted(members)
        elif applied < 0:
            p.members = sorted(p.member_ids())[:applied]
        p.count += applied
        return applied

    def kill(self, name: str, index: int) -> bool:
        """Write a node death back to the ledger: the exact index leaves
        the pool's membership (survivors keep their identities), capacity
        accounting drops with it, and a later ``scale(+)`` may refill the
        slot.  A fault is a fact, not a scaling decision — ``min_count``
        does not apply.  Returns whether the index was a member."""
        p = self.pool(name)
        members = p.member_ids()
        if index not in members:
            return False
        members.remove(index)
        p.members = members
        p.count -= 1
        return True

    def restore(self, name: str, index: int) -> bool:
        """Re-add a previously killed index (fault restart); no-op when
        the ledger already names it.  Bypasses ``max_count`` like
        ``kill`` bypasses ``min_count`` — re-provisioning a dead machine
        is not a scaling decision."""
        p = self.pool(name)
        members = p.member_ids()
        if index in members:
            return False
        p.members = sorted(members + [index])
        p.count += 1
        return True

    def copy(self) -> "Fleet":
        """Deep-enough copy: pools are fresh objects, specs/devices shared
        (device models are immutable apart from their service-time cache);
        membership lists are copied, not aliased."""
        return Fleet([dataclasses.replace(
            p, members=None if p.members is None else list(p.members))
            for p in self.pools])

    def total_capacity(self) -> float:
        return sum(p.count * p.qps_capacity for p in self.pools)

    # ------------------------------------------------------------ tuning

    def tune(self, sla_ms: float, *, size_dist: SizeDist = PRODUCTION,
             n_queries: int = 1500, seed: int = 0,
             contention: ContentionModel | None = None) -> "Fleet":
        """Run the per-node DeepRecSched hill climb once per pool: fills
        each spec's ``batch_size``/``offload_threshold`` and the pool's
        ``qps_capacity``.  Returns ``self`` for chaining."""
        for p in self.pools:
            r = tune(p.spec.cpu, sla_ms, accel=p.spec.accel,
                     n_executors=p.spec.n_executors,
                     n_accelerators=p.spec.n_accelerators,
                     request_overhead_s=p.spec.request_overhead_s,
                     size_dist=size_dist, contention=contention,
                     n_queries=n_queries, seed=seed)
            thr = r.offload_threshold
            if thr is not None and thr > size_dist.max_size:
                thr = None        # "threshold past the size cap" ≡ no offload
            p.spec = dataclasses.replace(
                p.spec, batch_size=r.batch_size, offload_threshold=thr)
            p.qps_capacity = r.qps
        return self

    def estimate_capacity(self, sla_ms: float, *,
                          size_dist: SizeDist = PRODUCTION,
                          n_queries: int = 1500, seed: int = 0) -> "Fleet":
        """Fill ``qps_capacity`` for the pools' *current* knobs (no climb) —
        cheaper than ``tune`` when the knobs are already set."""
        for p in self.pools:
            p.qps_capacity = max_qps_under_sla(
                p.spec.cpu, p.spec.scheduler_config(), sla_ms,
                accel=p.spec.accel, size_dist=size_dist,
                n_queries=n_queries, seed=seed)
        return self

    # ------------------------------------------------------------- nodes

    def node_views(self) -> list["NodeView"]:
        """Flattened per-node view (pool order, then member index within
        pool) — what routers and the cluster driver iterate over.

        Memoized behind a cheap membership fingerprint: the windowed
        driver calls this a few times per window, and at 1k–10k nodes
        rebuilding the ``NodeView`` list dominated the per-window cost.
        Any mutation that changes what the views would contain — tune,
        scale, kill, readmit, a spec swap — changes the fingerprint and
        invalidates the cache.  Callers must not mutate the returned
        list (``NodeView`` itself is frozen)."""
        fp = tuple((p.name, id(p.spec), p.count, p.qps_capacity,
                    None if p.members is None else tuple(p.members))
                   for p in self.pools)
        cached = getattr(self, "_views_cache", None)
        if cached is not None and cached[0] == fp:
            return cached[1]
        out = []
        for p in self.pools:
            for i in p.member_ids():
                out.append(NodeView(pool=p.name, index_in_pool=i, spec=p.spec,
                                    weight=max(p.qps_capacity, 1e-9)))
        self._views_cache = (fp, out)
        return out


@dataclasses.dataclass(frozen=True)
class NodeView:
    """What a ``Router`` sees of one node: identity, spec, capacity weight."""
    pool: str
    index_in_pool: int
    spec: NodeSpec
    weight: float
