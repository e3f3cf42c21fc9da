"""Process-local metrics: counters, gauges, and streaming quantiles.

The fleet driver reports per-node / per-model / per-window latency
percentiles for fleets of up to thousands of nodes, so the histogram
primitive must be *mergeable* and must not retain samples.
:class:`QuantileSketch` is a log-bucketed sketch (DDSketch-style): values
land in geometric buckets ``g**i <= v < g**(i+1)`` stored as a contiguous
``int64`` count array over the observed bucket range, so quantiles carry
a bounded *relative* error (``sqrt(g) - 1``, ~2% at the default), merge
is exact integer addition of bucket counts (associative and commutative —
fleet-wide = merge of per-node), and memory is O(dynamic range) — ~60
buckets per decade — independent of how many values were observed.

:class:`MetricsRegistry` is the process-local façade: named counters /
gauges / histograms with label sets, a per-window snapshot feed
(histograms keep a window-local sketch that resets on snapshot, next to
the cumulative one), and :class:`FleetTimeline` accumulating those
snapshots for ``ClusterResult``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["QuantileSketch", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "FleetTimeline", "WindowSnapshot",
           "RegistryCapture", "observe_fanout"]


class QuantileSketch:
    """Mergeable streaming-quantile sketch over non-negative values.

    ``rel_err`` bounds the relative error of any reported quantile: bucket
    growth is ``g = (1 + rel_err)**2`` and every value in a bucket is
    reported as the bucket's geometric midpoint, at most ``sqrt(g) - 1 =
    rel_err`` away.  Values ``<= 0`` land in a dedicated zero bucket and
    report as ``0.0``.  ``min``/``max`` are tracked exactly and clamp the
    reported quantile, so a one-sample sketch is exact.
    """

    __slots__ = ("rel_err", "_lng", "_base", "_cnt", "n", "n_zero",
                 "total", "vmin", "vmax")

    def __init__(self, rel_err: float = 0.02):
        if not 0.0 < rel_err < 1.0:
            raise ValueError("rel_err must be in (0, 1)")
        self.rel_err = rel_err
        self._lng = 2.0 * math.log1p(rel_err)   # log of bucket growth g
        self._base = 0                          # bucket index of _cnt[0]
        self._cnt = np.zeros(0, np.int64)
        self.n = 0
        self.n_zero = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    @property
    def counts(self) -> dict[int, int]:
        """Sparse bucket->count view (introspection; the storage itself
        is a contiguous array over the observed bucket range)."""
        nz = np.flatnonzero(self._cnt)
        return {int(i) + self._base: int(self._cnt[i]) for i in nz}

    def _ensure(self, lo: int, hi: int) -> None:
        """Grow the count array to cover buckets [lo, hi]."""
        if not len(self._cnt):
            self._base = lo
            self._cnt = np.zeros(hi - lo + 1, np.int64)
            return
        if lo < self._base:
            self._cnt = np.concatenate(
                [np.zeros(self._base - lo, np.int64), self._cnt])
            self._base = lo
        top = self._base + len(self._cnt) - 1
        if hi > top:
            self._cnt = np.concatenate(
                [self._cnt, np.zeros(hi - top, np.int64)])

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if v <= 0.0:
            self.n_zero += 1
            return
        i = int(math.floor(math.log(v) / self._lng))
        self._ensure(i, i)
        self._cnt[i - self._base] += 1

    def _digest(self, values: np.ndarray):
        """Bucketize a batch once: ``(n, sum, min, max, n_zero, lo,
        count_vector)`` — so a :class:`Histogram` pays the numpy work a
        single time and absorbs the digest into both its sketches."""
        a = np.asarray(values, float).ravel()
        if not len(a):
            return None
        # NaN propagates through min, so one reduction doubles as the
        # NaN probe — the clean batch (every hot-path caller) never pays
        # for isnan masks or a positivity scan
        mn = a.min()
        if math.isnan(mn):
            a = a[~np.isnan(a)]
            if not len(a):
                return None
            mn = a.min()
        if mn > 0.0:
            pos = a
        else:
            pos = a[a > 0.0]
        if len(pos):
            idx = np.log(pos)
            idx *= 1.0 / self._lng
            np.floor(idx, out=idx)
            idx = idx.astype(np.int64)
            lo = int(idx.min())
            cnt = np.bincount(idx - lo)
        else:
            lo, cnt = 0, None
        return (int(len(a)), float(a.sum()), float(mn),
                float(a.max()), int(len(a) - len(pos)), lo, cnt)

    def _absorb(self, digest) -> None:
        if digest is None:
            return
        n, tot, vmin, vmax, n_zero, lo, cnt = digest
        self.n += n
        self.total += tot
        self.vmin = min(self.vmin, vmin)
        self.vmax = max(self.vmax, vmax)
        self.n_zero += n_zero
        if cnt is not None:
            self._ensure(lo, lo + len(cnt) - 1)
            o = lo - self._base
            self._cnt[o:o + len(cnt)] += cnt

    def observe_many(self, values: np.ndarray) -> None:
        self._absorb(self._digest(values))

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (in place; returns self).  Exact on
        counts/min/max, so merge order never changes a reported quantile —
        the property the associativity tests pin down."""
        if abs(other._lng - self._lng) > 1e-12:
            raise ValueError("cannot merge sketches with different rel_err")
        if len(other._cnt):
            self._ensure(other._base, other._base + len(other._cnt) - 1)
            o = other._base - self._base
            self._cnt[o:o + len(other._cnt)] += other._cnt
        self.n += other.n
        self.n_zero += other.n_zero
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def reset(self) -> None:
        """Forget everything but keep the grown bucket array — resetting
        a window sketch in place means the next window never re-grows
        through the same dynamic range."""
        self._cnt[:] = 0
        self.n = 0
        self.n_zero = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def copy(self) -> "QuantileSketch":
        s = QuantileSketch(self.rel_err)
        s._base, s._cnt = self._base, self._cnt.copy()
        s.n, s.n_zero, s.total = self.n, self.n_zero, self.total
        s.vmin, s.vmax = self.vmin, self.vmax
        return s

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (nearest-rank over buckets)."""
        return self.quantiles((q,))[0]

    def count_above(self, v: float) -> int:
        """Observations greater than ``v``, at bucket resolution: values
        sharing ``v``'s bucket are *not* counted, so the answer can
        undercount by up to ``rel_err`` of mass near ``v`` — the SLO
        burn-rate evaluator's bad-event count, where the bound sits far
        from the bulk of a healthy window."""
        if self.n == 0 or v >= self.vmax:
            return 0
        if v < self.vmin:
            return self.n
        if v <= 0.0:
            return self.n - self.n_zero
        if not len(self._cnt):
            return 0
        j = int(math.floor(math.log(v) / self._lng)) - self._base + 1
        if j <= 0:
            return self.n - self.n_zero
        if j >= len(self._cnt):
            return 0
        return int(self._cnt[j:].sum())

    def quantiles(self, qs) -> list[float]:
        """Values at several quantiles, sharing one pass over the
        buckets (the per-window snapshot asks for p50/p95/p99 at once)."""
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError("q must be in [0, 1]")
        if self.n == 0:
            return [float("nan")] * len(qs)
        ranks = [min(self.n, max(1, int(math.ceil(q * self.n))))
                 for q in qs]
        if len(self._cnt):
            js = np.searchsorted(np.cumsum(self._cnt),
                                 [r - self.n_zero for r in ranks])
        else:
            js = [0] * len(qs)
        out = []
        for rank, j in zip(ranks, js):
            if rank <= self.n_zero:
                out.append(max(0.0, self.vmin))
            elif j >= len(self._cnt):
                out.append(self.vmax)   # unreachable unless counts drifted
            else:
                mid = math.exp((self._base + int(j) + 0.5) * self._lng)
                out.append(min(max(mid, self.vmin), self.vmax))
        return out

    def percentile(self, p: float) -> float:
        return self.quantile(p / 100.0)


def _labelkey(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


@dataclasses.dataclass
class Counter:
    """Monotone cumulative count (float so it can carry seconds)."""
    value: float = 0.0

    def inc(self, by: float = 1.0) -> None:
        self.value += by


@dataclasses.dataclass
class Gauge:
    """Last-written instantaneous value."""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """A cumulative sketch plus a window-local one (reset at each registry
    snapshot) so the timeline reports per-window percentiles while the
    run-wide sketch keeps accumulating."""

    def __init__(self, rel_err: float = 0.02):
        self.total = QuantileSketch(rel_err)
        self.window = QuantileSketch(rel_err)

    def observe(self, v: float) -> None:
        self.total.observe(v)
        self.window.observe(v)

    def observe_many(self, values: np.ndarray) -> None:
        # bucketize once, absorb twice (same rel_err -> same buckets)
        d = self.total._digest(values)
        self.total._absorb(d)
        self.window._absorb(d)


def observe_fanout(values: np.ndarray, *hists: Histogram) -> None:
    """Digest a batch once and absorb it into several histograms — e.g.
    a per-node histogram *and* the fleet-wide rollup.  All sketches in a
    registry share ``rel_err`` (hence bucket edges), so fanning a digest
    out is exact and the numpy bucketization is paid a single time no
    matter how many views observe the batch."""
    if not hists:
        return
    d = hists[0].total._digest(values)
    for h in hists:
        h.total._absorb(d)
        h.window._absorb(d)


class MetricsRegistry:
    """Named metrics with label sets.  ``counter/gauge/histogram`` create
    on first use and return the live object, so hot paths hold direct
    references instead of re-resolving names."""

    def __init__(self, rel_err: float = 0.02):
        self.rel_err = rel_err
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._hists: dict[tuple, Histogram] = {}
        self._fmt_cache: dict[tuple, str] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        k = (name, _labelkey(labels))
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter()
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        k = (name, _labelkey(labels))
        g = self._gauges.get(k)
        if g is None:
            g = self._gauges[k] = Gauge()
        return g

    def histogram(self, name: str, **labels: str) -> Histogram:
        k = (name, _labelkey(labels))
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = Histogram(self.rel_err)
        return h

    def observe_grouped(self, name: str, label: str, groups,
                        values, fmt=str, also=(), order=None,
                        bounds=None) -> None:
        """Fold a labeled batch into per-group histograms in one
        vectorized pass: the whole batch is bucketized once and group
        digests are carved out with ``reduceat``/``bincount``, so a
        window's per-model (or per-node) fold costs O(batch), not
        O(groups × batch) — the fleet-scale hot path.  ``fmt`` renders a
        group value into its label string (e.g. node index -> name).

        ``also`` takes extra :class:`Histogram` rollups (e.g. the
        fleet-wide latency histogram) that absorb the *whole* batch's
        digest — the column sums of the per-group bucket grid, so the
        rollup is exactly the merge of the per-group digests (what
        per-node ``observe_fanout`` calls would have produced) at no
        extra bucketization cost.

        ``order``/``bounds`` reuse a segmentation the caller already
        owns (the grouped fleet submit stable-sorts each window by node
        and returns the permutation + per-group end offsets): the
        argsort here is skipped and group starts come straight from the
        offsets.  Only taken when no value is NaN — a NaN filter would
        misalign the offsets, so that case falls back to sorting."""
        a = np.asarray(values, float).ravel()
        g = np.asarray(groups).ravel()
        keep = ~np.isnan(a)
        clean = keep.all()
        if not clean:
            a, g = a[keep], g[keep]
        if not len(a):
            return
        if clean and order is not None and bounds is not None:
            a, g = a[order], g[order]
            seg_starts = np.concatenate(([0], bounds[:-1]))
            starts = seg_starts[bounds > seg_starts]
            change = np.zeros(len(a), bool)
            change[starts] = True
        else:
            order = np.argsort(g, kind="stable")
            a, g = a[order], g[order]
            change = np.r_[True, g[1:] != g[:-1]]
            starts = np.flatnonzero(change)
        n_g = len(starts)
        counts = np.diff(np.r_[starts, len(a)])
        sums = np.add.reduceat(a, starts)
        mins = np.minimum.reduceat(a, starts)
        maxs = np.maximum.reduceat(a, starts)
        pospart = a > 0.0
        n_zero = counts - np.add.reduceat(pospart.astype(np.int64), starts)
        lng = 2.0 * math.log1p(self.rel_err)
        pos = a[pospart]
        if len(pos):
            ix = np.log(pos)
            ix *= 1.0 / lng
            np.floor(ix, out=ix)
            ix = ix.astype(np.int64)
            lo = int(ix.min())
            width = int(ix.max()) - lo + 1
            gid = np.cumsum(change) - 1
            key = gid[pospart] * width + (ix - lo)
            grid = np.bincount(key, minlength=n_g * width) \
                .reshape(n_g, width)
        else:
            lo, grid = 0, None
        for k in range(n_g):
            d = (int(counts[k]), float(sums[k]), float(mins[k]),
                 float(maxs[k]), int(n_zero[k]), lo,
                 grid[k] if grid is not None else None)
            h = self.histogram(name, **{label: fmt(g[starts[k]])})
            h.total._absorb(d)
            h.window._absorb(d)
        if also:
            d_all = (int(len(a)), float(sums.sum()), float(mins.min()),
                     float(maxs.max()), int(n_zero.sum()), lo,
                     grid.sum(axis=0) if grid is not None else None)
            for h in also:
                h.total._absorb(d_all)
                h.window._absorb(d_all)

    # -- read side ---------------------------------------------------------

    def _fmt(self, key: tuple) -> str:
        s = self._fmt_cache.get(key)
        if s is None:
            name, labels = key
            if labels:
                inner = ",".join(f'{k}="{v}"' for k, v in labels)
                s = f"{name}{{{inner}}}"
            else:
                s = name
            self._fmt_cache[key] = s
        return s

    def items(self):
        """(kind, name, labels, object) for every registered metric."""
        for (name, labels), c in sorted(self._counters.items()):
            yield "counter", name, dict(labels), c
        for (name, labels), g in sorted(self._gauges.items()):
            yield "gauge", name, dict(labels), g
        for (name, labels), h in sorted(self._hists.items()):
            yield "histogram", name, dict(labels), h

    def merged_histogram(self, name: str) -> QuantileSketch:
        """Fleet-wide sketch for ``name``: merge across all label sets —
        the operation the mergeable sketch exists for."""
        out = QuantileSketch(self.rel_err)
        for (n, _), h in self._hists.items():
            if n == name:
                out.merge(h.total)
        return out

    def capture(self, reset_window: bool = True) -> "RegistryCapture":
        """Freeze the window boundary cheaply: scalar values are copied,
        and each touched histogram's window sketch is *stolen* (the
        histogram gets a fresh one) — O(metrics) pointer work, no
        quantile math.  The capture renders the flat snapshot dict
        lazily, so per-window percentiles are computed when the timeline
        is read, not inside the serving loop."""
        scalars = [(self._fmt(k), c.value) for k, c in self._counters.items()]
        scalars += [(self._fmt(k), g.value) for k, g in self._gauges.items()]
        wins: list[tuple[str, QuantileSketch | None]] = []
        for k, h in self._hists.items():
            w = h.window
            if not w.n:
                # untouched window: nothing to steal, nothing to reset
                wins.append((self._fmt(k), None))
            elif reset_window:
                wins.append((self._fmt(k), w))
                h.window = QuantileSketch(self.rel_err)
            else:
                wins.append((self._fmt(k), w.copy()))
        return RegistryCapture(scalars, wins)

    def snapshot(self, reset_window: bool = True) -> dict[str, float]:
        """Flat name->value view: cumulative counters and gauges, plus
        window-local p50/p95/p99/count/mean for each histogram.  By
        default the window sketches are reset so the next snapshot
        covers only the interval since this one."""
        return self.capture(reset_window).render()


class RegistryCapture:
    """A registry's state frozen at one window boundary: scalar values
    by formatted name plus the stolen window sketches.  ``render()``
    computes the flat snapshot dict — deferred so the serving loop pays
    pointer swaps, and the quantile math runs when the artifact is
    read."""

    __slots__ = ("_scalars", "_wins", "_sk_idx", "_sc_idx")

    def __init__(self, scalars, wins):
        self._scalars = scalars
        self._wins = wins
        self._sk_idx = None
        self._sc_idx = None

    def sketch(self, name: str) -> QuantileSketch | None:
        """The stolen window sketch for one formatted metric name (e.g.
        ``fleet_latency_ms`` or ``node_latency_ms{node="cpu[0]"}``) —
        ``None`` when the metric was untouched this window.  This is the
        SLO engine's read side: evaluation happens against the *frozen*
        window, after the capture has already stolen it."""
        if self._sk_idx is None:
            self._sk_idx = dict(self._wins)
        return self._sk_idx.get(name)

    def value(self, name: str) -> float | None:
        """One captured scalar (counter/gauge) by formatted name."""
        if self._sc_idx is None:
            self._sc_idx = dict(self._scalars)
        return self._sc_idx.get(name)

    def scalar_items(self) -> list[tuple[str, float]]:
        """All captured (formatted name, value) scalar pairs."""
        return list(self._scalars)

    def render(self) -> dict[str, float]:
        out = dict(self._scalars)
        for base, w in self._wins:
            out[base + ".count"] = float(w.n) if w is not None else 0.0
            if w is not None and w.n:
                p50, p95, p99 = w.quantiles((0.50, 0.95, 0.99))
                out[base + ".p50"] = p50
                out[base + ".p95"] = p95
                out[base + ".p99"] = p99
                out[base + ".mean"] = w.mean
        return out


class WindowSnapshot:
    """One window's metrics: ``metrics`` is the registry snapshot (window-
    local histogram quantiles, cumulative counters), ``extra`` the driver's
    own per-window facts (offered QPS, active nodes, window p95).
    ``metrics`` renders lazily from a :class:`RegistryCapture` when the
    snapshot came off the hot path."""

    __slots__ = ("t_s", "width_s", "extra", "_metrics", "_capture")

    def __init__(self, t_s: float, width_s: float,
                 metrics: dict[str, float] | None = None,
                 extra: dict[str, float] | None = None,
                 capture: RegistryCapture | None = None):
        self.t_s = float(t_s)
        self.width_s = float(width_s)
        self.extra = dict(extra or {})
        self._metrics = metrics
        self._capture = capture

    @property
    def metrics(self) -> dict[str, float]:
        if self._metrics is None:
            c = self._capture
            self._metrics = c.render() if c is not None else {}
        return self._metrics

    def sketch(self, name: str) -> "QuantileSketch | None":
        """This window's frozen sketch for one formatted metric name
        (``None`` off the capture path or when untouched) — what the SLO
        engine evaluates objectives against."""
        c = self._capture
        return c.sketch(name) if c is not None else None

    def value(self, name: str) -> float | None:
        """One captured scalar (counter/gauge) by formatted name."""
        c = self._capture
        return c.value(name) if c is not None else None

    def scalar_items(self) -> list[tuple[str, float]]:
        c = self._capture
        return c.scalar_items() if c is not None else []

    def __repr__(self) -> str:
        return (f"WindowSnapshot(t_s={self.t_s}, width_s={self.width_s}, "
                f"metrics={self.metrics!r}, extra={self.extra!r})")


class FleetTimeline:
    """Per-window registry snapshots accumulated over a ``drive_fleet``
    run — the monitoring feed a dashboard would scrape, kept at
    O(windows x metrics) memory."""

    def __init__(self):
        self.windows: list[WindowSnapshot] = []

    def snapshot(self, registry: MetricsRegistry, t_s: float, width_s: float,
                 extra: dict[str, float] | None = None) -> WindowSnapshot:
        snap = WindowSnapshot(t_s=float(t_s), width_s=float(width_s),
                              extra=extra, capture=registry.capture())
        self.windows.append(snap)
        return snap

    def series(self, key: str) -> list[tuple[float, float]]:
        """(t_s, value) pairs for one metric/extra key across windows."""
        out = []
        for w in self.windows:
            v = w.metrics.get(key, w.extra.get(key))
            if v is not None:
                out.append((w.t_s, float(v)))
        return out

    def __len__(self) -> int:
        return len(self.windows)
