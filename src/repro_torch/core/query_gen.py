"""Real-time query modeling (DeepRecInfra §III-C).

Arrival process
    Queries for recommendation services arrive Poisson (paper profiling of a
    production datacenter); fixed and lognormal inter-arrival supported for
    the ablations prior work assumed.

Working-set (query) size
    The number of candidate items per query.  The paper's production
    distribution (Fig. 5) has a *heavier tail* than lognormal: most queries
    are small, but the top quartile of queries carries ~half the total work,
    and sizes cap around ~1000 candidates.  We model it as a lognormal body
    mixed with a Pareto tail, clipped to ``max_size`` — the constants are
    calibrated so that (a) p75 splits total work ~50/50 and (b) mean size is
    a few tens (benchmarks/query_distributions.py asserts both).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Query:
    qid: int
    arrival: float            # seconds
    size: int                 # candidate items to score


# ------------------------------------------------------------- size dists


@dataclasses.dataclass(frozen=True)
class SizeDist:
    kind: str                 # fixed | normal | lognormal | production
    mean: float = 130.0
    sigma: float = 0.5
    max_size: int = 1000
    tail_frac: float = 0.08   # production: mixture weight of the Pareto tail
    tail_alpha: float = 1.5   # production: Pareto shape (heavy)
    tail_xm: float = 250.0    # production: Pareto scale

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "fixed":
            s = np.full(n, self.mean)
        elif self.kind == "normal":
            s = rng.normal(self.mean, self.sigma * self.mean / 4, size=n)
        elif self.kind == "lognormal":
            mu = np.log(self.mean) - self.sigma ** 2 / 2
            s = rng.lognormal(mu, self.sigma, size=n)
        elif self.kind == "production":
            # lognormal body + Pareto tail, calibrated to paper Fig. 5/6:
            # top-quartile queries carry ~50% of total work; sizes reach 1000
            body_mean = self.mean * 0.9
            mu = np.log(body_mean) - self.sigma ** 2 / 2
            body = rng.lognormal(mu, self.sigma, size=n)
            tail = self.tail_xm * (1.0 + rng.pareto(self.tail_alpha, size=n))
            pick_tail = rng.random(n) < self.tail_frac
            s = np.where(pick_tail, tail, body)
        else:
            raise ValueError(self.kind)
        return np.clip(np.round(s), 1, self.max_size).astype(np.int64)


PRODUCTION = SizeDist("production")
LOGNORMAL = SizeDist("lognormal")


# ----------------------------------------------------------- popularity

# inverse-CDF tables for bounded Zipf draws, keyed by (alpha, catalog) —
# PopularityDist is frozen, so the O(catalog) weight normalization is
# paid once per distinct shape, not once per trace
_ZIPF_CDF: dict[tuple[float, int], np.ndarray] = {}


@dataclasses.dataclass(frozen=True)
class PopularityDist:
    """Which *content* each query asks for — the cacheability axis.

    Production recommendation traffic is heavily skewed (Gupta et al.,
    arxiv 1906.03109 characterize power-law query/embedding locality):
    a small set of hot items dominates, so identical queries repeat and
    a result cache in front of the fleet can answer them.  ``sample``
    draws one popularity *key* per query over a bounded catalog:

      * ``zipf``    — P(key = k) ∝ 1 / (k + 1)**alpha over ``catalog``
        keys (key 0 is the hottest), via one vectorized inverse-CDF
        lookup — a single ``rng`` pass, no per-query Python loop;
      * ``uniform`` — every catalog key equally likely (no skew, the
        cache-hostile control);
      * ``none``    — every query unique (key −1): nothing repeats, a
        result cache can never hit.

    Keys say nothing about *when* or *how big* — arrivals and sizes stay
    with ``ArrivalDist``/``SizeDist``; ``Traffic.generate_keyed`` ties a
    size to each distinct key so a repeated query really is the same
    query."""
    kind: str = "zipf"        # zipf | uniform | none
    alpha: float = 1.1
    catalog: int = 50_000

    def __post_init__(self):
        if self.kind not in ("zipf", "uniform", "none"):
            raise ValueError(self.kind)
        if self.catalog < 1:
            raise ValueError(f"catalog must be >= 1: {self.catalog}")

    def _cdf(self) -> np.ndarray:
        key = (self.alpha, self.catalog)
        cdf = _ZIPF_CDF.get(key)
        if cdf is None:
            w = 1.0 / np.power(np.arange(1, self.catalog + 1, dtype=float),
                               self.alpha)
            cdf = np.cumsum(w)
            cdf /= cdf[-1]
            _ZIPF_CDF[key] = cdf
        return cdf

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` popularity keys (int64; −1 = unique/uncacheable)."""
        if self.kind == "none":
            return np.full(n, -1, np.int64)
        if self.kind == "uniform":
            return rng.integers(0, self.catalog, size=n, dtype=np.int64)
        # bounded Zipf: one uniform batch + searchsorted over the cached
        # inverse CDF — vectorized end to end
        return np.searchsorted(self._cdf(), rng.random(n),
                               side="left").astype(np.int64)


ZIPF = PopularityDist("zipf")
NO_REPEATS = PopularityDist("none")


def keyed_sizes(rng: np.random.Generator, keys: np.ndarray,
                size_dist: SizeDist) -> np.ndarray:
    """Per-query sizes *coherent with the popularity keys*: every
    occurrence of a key is the same query, so it carries the same
    working-set size.  One ``size_dist`` draw per distinct key (unkeyed
    ``-1`` queries each draw independently), fanned back out with the
    ``np.unique`` inverse — no per-query loop."""
    uk, inv = np.unique(keys, return_inverse=True)
    usz = size_dist.sample(rng, len(uk))
    sizes = usz[inv]
    unkeyed = keys < 0
    n_u = int(unkeyed.sum())
    if n_u:
        sizes = sizes.copy() if sizes.base is not None else sizes
        sizes[unkeyed] = size_dist.sample(rng, n_u)
    return sizes


# --------------------------------------------------------------- arrivals


@dataclasses.dataclass(frozen=True)
class ArrivalDist:
    kind: str = "poisson"     # poisson | fixed | lognormal

    def inter_arrivals(self, rng: np.random.Generator, qps: float,
                       n: int) -> np.ndarray:
        mean = 1.0 / qps
        if self.kind == "poisson":
            return rng.exponential(mean, size=n)
        if self.kind == "fixed":
            return np.full(n, mean)
        if self.kind == "lognormal":
            sigma = 0.5
            mu = np.log(mean) - sigma ** 2 / 2
            return rng.lognormal(mu, sigma, size=n)
        raise ValueError(self.kind)


def generate_queries(rng: np.random.Generator, qps: float, n: int,
                     size_dist: SizeDist = PRODUCTION,
                     arrival: ArrivalDist = ArrivalDist()) -> list[Query]:
    times = np.cumsum(arrival.inter_arrivals(rng, qps, n))
    sizes = size_dist.sample(rng, n)
    return queries_from_arrays(times, sizes)


def sample_trace(rng: np.random.Generator, n: int,
                 size_dist: SizeDist = PRODUCTION,
                 arrival: ArrivalDist = ArrivalDist()
                 ) -> tuple[np.ndarray, np.ndarray]:
    """One reusable trace draw: (unit-rate arrival times, sizes).

    The arrival-time array for rate λ is ``times / λ`` — exact for every
    supported inter-arrival kind, since each sampler scales multiplicatively
    in its mean (exponential and fixed trivially; lognormal because a mean
    change only shifts μ, i.e. multiplies the sample).  The QPS search
    draws the trace once per seed and rescales per bisection step instead
    of regenerating, and draws in the same rng order as
    ``generate_queries`` so sizes match the legacy per-λ regeneration.
    """
    times = np.cumsum(arrival.inter_arrivals(rng, 1.0, n))
    sizes = size_dist.sample(rng, n)
    return times, sizes


def rescale_trace(unit_times: np.ndarray, qps: float) -> np.ndarray:
    """Arrival times at rate ``qps`` from a unit-rate trace.

    Exact for every supported inter-arrival kind — each sampler scales
    multiplicatively in its mean (see ``sample_trace``).  Public so the QPS
    search and the cluster tier's capacity bisection share one trace draw
    per seed instead of regenerating per λ step.
    """
    return unit_times / qps


def queries_from_arrays(arrivals: np.ndarray, sizes: np.ndarray) -> list[Query]:
    """Materialize ``Query`` objects for the event-driven engine."""
    return [Query(i, float(t), int(s))
            for i, (t, s) in enumerate(zip(arrivals, sizes))]


def query_stream(seed: int, qps: float, size_dist: SizeDist = PRODUCTION,
                 arrival: ArrivalDist = ArrivalDist(),
                 chunk: int = 1024) -> Iterator[Query]:
    """Endless stream (for the live serving runtime)."""
    rng = np.random.default_rng(seed)
    t0 = 0.0
    qid = 0
    while True:
        qs = generate_queries(rng, qps, chunk, size_dist, arrival)
        for q in qs:
            yield Query(qid, q.arrival + t0, q.size)
            qid += 1
        t0 += qs[-1].arrival
