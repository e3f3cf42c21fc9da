"""Fleet-front result cache: answer repeated queries before the router.

Production recommendation traffic is heavily skewed — a small set of hot
queries repeats (Gupta et al., arxiv 1906.03109) — so a result cache in
front of the fleet converts that skew directly into QPS-under-SLA: a hit
costs one lookup (``hit_latency_s``) instead of a node's queueing +
service time, and the saved node capacity serves the misses.

The cache is keyed by the popularity keys the traffic layer threads
through traces (``Traffic.generate_keyed``; key −1 = unique query, never
cacheable).  Entries are sharded by key (``key % shards`` — a stand-in
for the consistent hashing a real fleet front would use) with per-shard
capacity and eviction, so one hot shard cannot evict the whole fleet's
working set.  Two eviction policies:

  * ``lru`` — per-shard recency order (an ``OrderedDict``);
  * ``lfu`` — per-shard hit counts, evicting the least-frequently-used
    entry (ties broken oldest-first) — the better fit for Zipf traffic,
    where frequency is the signal recency only approximates.

Staleness is a TTL on the *result*: recommendation responses are
ranking snapshots, stale after seconds-to-minutes.  An entry answers a
query at time ``t`` iff ``fresh_ts <= t <= fresh_ts + ttl_s``; the
driver inserts each completed miss at its completion time, so a result
computed *after* a query arrived can never answer it (no time travel on
the virtual timeline), and expired entries drop on first touch.

The driver integration lives in ``cluster_sim.drive_fleet(cache=...)``:
hits complete analytically at ``t + hit_latency_s`` in sim (and
short-circuit submission entirely in live/remote), misses flow to the
router unchanged, and hit/miss/eviction counters stream into the
telemetry registry with a ``cache`` span component keeping latency
attribution closed.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

__all__ = ["CacheConfig", "FleetCache"]


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Knobs for the fleet-front cache.

    ``capacity`` is fleet-total entries (split evenly across shards);
    ``ttl_s`` the result-staleness bound; ``hit_latency_s`` what a hit
    costs end-to-end (front-cache lookup + response serialization —
    sub-millisecond next to a multi-ms node pass)."""
    capacity: int = 100_000
    ttl_s: float = 60.0
    policy: str = "lru"            # lru | lfu
    shards: int = 8
    hit_latency_s: float = 5e-4

    def __post_init__(self):
        if self.policy not in ("lru", "lfu"):
            raise ValueError(self.policy)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1: {self.capacity}")
        if self.shards < 1 or self.shards > self.capacity:
            raise ValueError(
                f"shards must be in [1, capacity]: {self.shards}")
        if not self.ttl_s > 0.0:        # also rejects NaN
            raise ValueError(f"ttl_s must be > 0: {self.ttl_s}")
        if not self.hit_latency_s >= 0.0:
            raise ValueError(
                f"hit_latency_s must be >= 0: {self.hit_latency_s}")


class FleetCache:
    """Sharded LRU/LFU result cache with TTL staleness (see module doc).

    ``lookup_many``/``insert_many`` take aligned key/time arrays — one
    call per driver window, queries in arrival order.  State is plain
    dicts: the cache sits outside the vectorized node advance, touches
    only cache-enabled runs, and its per-query cost is one dict op.
    """

    def __init__(self, cfg: CacheConfig = CacheConfig()):
        self.cfg = cfg
        # shard: key -> fresh_ts (LRU, recency = dict order)
        #        key -> [fresh_ts, freq] (LFU)
        self._shards: list[OrderedDict] = [OrderedDict()
                                           for _ in range(cfg.shards)]
        self._cap = max(1, cfg.capacity // cfg.shards)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.inserts = 0

    # -- read side ---------------------------------------------------------

    @property
    def size(self) -> int:
        return sum(len(s) for s in self._shards)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "expirations": self.expirations, "inserts": self.inserts,
                "size": self.size}

    # -- driver surface ----------------------------------------------------

    def lookup_many(self, keys: np.ndarray, times: np.ndarray) -> np.ndarray:
        """Hit mask for a window of queries (arrival order).

        A query at time ``t`` hits iff its key holds an entry with
        ``fresh_ts <= t <= fresh_ts + ttl_s``.  Key −1 (unique query)
        and in-window repeats of a not-yet-inserted key are misses — the
        driver commits results via ``insert_many`` only once they have
        actually completed, so no request coalescing is modeled.
        Expired entries are dropped on touch; hits refresh
        recency/frequency for their policy."""
        lfu = self.cfg.policy == "lfu"
        ttl = self.cfg.ttl_s
        nsh = self.cfg.shards
        hit = np.zeros(len(keys), bool)
        for i, (k, t) in enumerate(zip(keys.tolist(), times.tolist())):
            if k < 0:
                self.misses += 1
                continue
            shard = self._shards[k % nsh]
            ent = shard.get(k)
            if ent is None:
                self.misses += 1
                continue
            fresh = ent[0] if lfu else ent
            if fresh > t:                 # result not computed yet at t
                self.misses += 1
                continue
            if t - fresh > ttl:           # stale: drop on touch
                del shard[k]
                self.expirations += 1
                self.misses += 1
                continue
            self.hits += 1
            hit[i] = True
            if lfu:
                ent[1] += 1
            else:
                shard.move_to_end(k)
        return hit

    def insert_many(self, keys: np.ndarray, fresh_ts: np.ndarray) -> None:
        """Commit completed results: entry for ``keys[i]`` becomes
        answerable from ``fresh_ts[i]`` (its completion time) on.  Key −1
        and NaN timestamps (dropped queries) are skipped; re-inserting a
        present key refreshes it in place.  Over-capacity shards evict —
        LRU the coldest by recency, LFU the lowest hit count (oldest on
        ties)."""
        lfu = self.cfg.policy == "lfu"
        nsh = self.cfg.shards
        for k, ts in zip(keys.tolist(), fresh_ts.tolist()):
            if k < 0 or ts != ts:         # uncacheable / dropped (NaN)
                continue
            shard = self._shards[k % nsh]
            if k in shard:
                if lfu:
                    shard[k][0] = ts
                else:
                    shard[k] = ts
                    shard.move_to_end(k)
                continue
            if len(shard) >= self._cap:
                if lfu:
                    victim = min(shard, key=lambda q: (shard[q][1],
                                                       shard[q][0]))
                    del shard[victim]
                else:
                    shard.popitem(last=False)
                self.evictions += 1
            shard[k] = [ts, 0] if lfu else ts
            self.inserts += 1
