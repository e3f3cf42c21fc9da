"""Cluster traffic scenarios beyond stationary Poisson (paper Fig. 13).

Each ``Traffic`` exposes a vectorized arrival-rate curve ``rate(t)`` (QPS)
and ``generate(rng, horizon_s, size_dist)`` → sorted ``(times, sizes)``
arrays ready for the cluster driver.  Non-homogeneous arrivals use Lewis &
Shedler thinning against ``peak_rate``: candidates are drawn from a
homogeneous Poisson process at the peak rate and accepted with probability
``rate(t)/peak``, which is exact for any bounded rate curve.  Sizes come
from the existing ``query_gen`` size distributions, so every scenario
composes with the production working-set tail.

Scenarios:
  * ``StationaryTraffic``  — constant-rate Poisson (the single-node case).
  * ``DiurnalTraffic``     — sinusoidal day/night swing, the paper's §VII
    production traffic shape.
  * ``BurstyTraffic``      — flash crowds: base rate times a burst
    multiplier inside given windows.
  * ``MultiTenantTraffic`` — a merge of named per-model streams, each with
    its own traffic shape and size distribution.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.query_gen import (PRODUCTION, PopularityDist, SizeDist,
                                        keyed_sizes)

# numpy 2.0 renamed trapz → trapezoid
trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Traffic:
    """Scenario interface: a bounded rate curve plus a trace generator."""

    def rate(self, t: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def peak_rate(self) -> float:
        raise NotImplementedError

    def expected_queries(self, horizon_s: float, n_grid: int = 4096) -> float:
        """∫₀ᴴ rate(t) dt via trapezoid on a fixed grid (analytic for the
        subclasses that can do better)."""
        t = np.linspace(0.0, horizon_s, n_grid)
        return float(trapezoid(self.rate(t), t))

    def generate(self, rng: np.random.Generator, horizon_s: float,
                 size_dist: SizeDist = PRODUCTION
                 ) -> tuple[np.ndarray, np.ndarray]:
        times = _thinned_poisson(rng, self.rate, self.peak_rate, horizon_s)
        return times, size_dist.sample(rng, len(times))

    def generate_keyed(self, rng: np.random.Generator, horizon_s: float,
                       size_dist: SizeDist = PRODUCTION,
                       popularity: PopularityDist = PopularityDist()
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(times, sizes, keys) with popularity-keyed repeats.

        Arrivals come from the scenario's own ``generate`` (so every
        subclass — stationary, diurnal, bursty, multi-tenant — carries
        the cacheability axis for free); sizes are redrawn *coherent
        with the keys* via ``keyed_sizes`` so that two queries with the
        same key are the same query.  Key −1 marks a unique query."""
        times, _ = self.generate(rng, horizon_s, size_dist)
        keys = popularity.sample(rng, len(times))
        return times, keyed_sizes(rng, keys, size_dist), keys


def _homogeneous_arrivals(rng: np.random.Generator, rate: float,
                          horizon_s: float) -> np.ndarray:
    """Poisson arrival times in [0, horizon) at constant ``rate``."""
    if rate <= 0 or horizon_s <= 0:
        return np.empty(0)
    times: list[np.ndarray] = []
    t0, mean_n = 0.0, rate * horizon_s
    # draw in chunks with head-room, top up in the (rare) short case
    n = int(mean_n + 6 * math.sqrt(mean_n) + 16)
    while t0 < horizon_s:
        chunk = t0 + np.cumsum(rng.exponential(1.0 / rate, size=n))
        times.append(chunk)
        t0 = float(chunk[-1])
    all_t = np.concatenate(times)
    return all_t[all_t < horizon_s]


def _thinned_poisson(rng: np.random.Generator, rate_fn, peak: float,
                     horizon_s: float) -> np.ndarray:
    cand = _homogeneous_arrivals(rng, peak, horizon_s)
    if len(cand) == 0:
        return cand
    keep = rng.random(len(cand)) * peak < rate_fn(cand)
    return cand[keep]


@dataclasses.dataclass(frozen=True)
class StationaryTraffic(Traffic):
    qps: float

    def rate(self, t: np.ndarray) -> np.ndarray:
        return np.full_like(np.asarray(t, float), self.qps)

    @property
    def peak_rate(self) -> float:
        return self.qps

    def expected_queries(self, horizon_s: float, n_grid: int = 4096) -> float:
        return self.qps * horizon_s

    def generate(self, rng: np.random.Generator, horizon_s: float,
                 size_dist: SizeDist = PRODUCTION
                 ) -> tuple[np.ndarray, np.ndarray]:
        times = _homogeneous_arrivals(rng, self.qps, horizon_s)
        return times, size_dist.sample(rng, len(times))


@dataclasses.dataclass(frozen=True)
class DiurnalTraffic(Traffic):
    """rate(t) = base · (1 + amplitude·sin(2π(t − phase_s)/period_s)) —
    the day/night swing of paper Fig. 13, by default one full "day" per
    ``period_s`` so tests can compress a day into seconds."""
    base_qps: float
    amplitude: float = 0.5          # 0..1, fraction of base
    period_s: float = 86400.0
    phase_s: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0,1]: {self.amplitude}")

    def rate(self, t: np.ndarray) -> np.ndarray:
        w = 2.0 * np.pi * (np.asarray(t, float) - self.phase_s) / self.period_s
        return self.base_qps * (1.0 + self.amplitude * np.sin(w))

    @property
    def peak_rate(self) -> float:
        return self.base_qps * (1.0 + self.amplitude)

    def expected_queries(self, horizon_s: float, n_grid: int = 4096) -> float:
        # ∫₀ᴴ base·(1 + a·sin(w(t−φ))) dt, antiderivative of sin in closed form
        w = 2.0 * np.pi / self.period_s
        integral = self.base_qps * horizon_s - (
            self.base_qps * self.amplitude / w) * (
            math.cos(w * (horizon_s - self.phase_s))
            - math.cos(w * (-self.phase_s)))
        return float(integral)


@dataclasses.dataclass(frozen=True)
class BurstyTraffic(Traffic):
    """Flash crowds: ``base_qps`` everywhere, multiplied by ``burst_mult``
    inside each ``(start_s, len_s)`` window."""
    base_qps: float
    burst_mult: float = 4.0
    bursts: tuple[tuple[float, float], ...] = ()   # (start_s, len_s)

    def rate(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, float)
        r = np.full_like(t, self.base_qps)
        for start, length in self.bursts:
            inside = (t >= start) & (t < start + length)
            r = np.where(inside, self.base_qps * self.burst_mult, r)
        return r

    @property
    def peak_rate(self) -> float:
        # burst_mult < 1 models a dip: the peak is then the *base* rate
        return self.base_qps * (max(self.burst_mult, 1.0) if self.bursts
                                else 1.0)

    def _merged_bursts(self, horizon_s: float) -> list[tuple[float, float]]:
        """Burst windows clipped to the horizon and unioned — ``rate()``
        applies the multiplier once inside *any* burst, so overlapping
        windows must not double-count."""
        ivs = sorted((max(s, 0.0), min(s + ln, horizon_s))
                     for s, ln in self.bursts)
        merged: list[tuple[float, float]] = []
        for lo, hi in ivs:
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return merged

    def expected_queries(self, horizon_s: float, n_grid: int = 4096) -> float:
        total = self.base_qps * horizon_s
        for lo, hi in self._merged_bursts(horizon_s):
            total += self.base_qps * (self.burst_mult - 1.0) * (hi - lo)
        return total


@dataclasses.dataclass(frozen=True)
class MultiTenantTraffic(Traffic):
    """Several models sharing the fleet: named per-tenant streams, each
    with its own traffic shape and size distribution, merged into one
    sorted timeline.  ``generate_labeled`` additionally returns each
    query's tenant index (into ``tenants`` order)."""
    tenants: tuple[tuple[str, Traffic, SizeDist], ...]

    def rate(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, float)
        return sum((tr.rate(t) for _, tr, _ in self.tenants),
                   np.zeros_like(t))

    @property
    def peak_rate(self) -> float:
        # conservative bound: per-tenant peaks may not align, but the sum
        # bounds the merged rate everywhere
        return sum(tr.peak_rate for _, tr, _ in self.tenants)

    def expected_queries(self, horizon_s: float, n_grid: int = 4096) -> float:
        return sum(tr.expected_queries(horizon_s, n_grid)
                   for _, tr, _ in self.tenants)

    def generate_labeled(self, rng: np.random.Generator, horizon_s: float
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        times, sizes, labels = [], [], []
        for i, (_, tr, dist) in enumerate(self.tenants):
            t, s = tr.generate(rng, horizon_s, dist)
            times.append(t)
            sizes.append(s)
            labels.append(np.full(len(t), i, np.int64))
        t = np.concatenate(times)
        order = np.argsort(t, kind="stable")
        return (t[order], np.concatenate(sizes)[order],
                np.concatenate(labels)[order])

    def generate_labeled_keyed(self, rng: np.random.Generator,
                               horizon_s: float,
                               popularity: PopularityDist = PopularityDist()
                               ) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
        """(times, sizes, labels, keys): per-tenant popularity keys with
        sizes coherent per (tenant, key).  Tenants draw from disjoint
        key ranges (tenant i owns ``[i·catalog, (i+1)·catalog)``) so a
        hot key for one model never aliases another model's results in
        a fleet-front cache."""
        times, sizes, labels, keys = [], [], [], []
        for i, (_, tr, dist) in enumerate(self.tenants):
            t, s, k = tr.generate_keyed(rng, horizon_s, dist, popularity)
            times.append(t)
            sizes.append(s)
            labels.append(np.full(len(t), i, np.int64))
            keys.append(np.where(k >= 0, k + i * popularity.catalog, k))
        t = np.concatenate(times)
        order = np.argsort(t, kind="stable")
        return (t[order], np.concatenate(sizes)[order],
                np.concatenate(labels)[order], np.concatenate(keys)[order])

    def generate_keyed(self, rng: np.random.Generator, horizon_s: float,
                       size_dist: SizeDist = PRODUCTION,
                       popularity: PopularityDist = PopularityDist()
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if size_dist is not PRODUCTION:
            raise ValueError(
                "MultiTenantTraffic sizes come from each tenant's own "
                "distribution; set them in `tenants`, not via "
                "generate_keyed()")
        t, s, _, k = self.generate_labeled_keyed(rng, horizon_s, popularity)
        return t, s, k

    def generate(self, rng: np.random.Generator, horizon_s: float,
                 size_dist: SizeDist = PRODUCTION
                 ) -> tuple[np.ndarray, np.ndarray]:
        if size_dist is not PRODUCTION:
            raise ValueError(
                "MultiTenantTraffic sizes come from each tenant's own "
                "distribution; set them in `tenants`, not via generate()")
        t, s, _ = self.generate_labeled(rng, horizon_s)
        return t, s
