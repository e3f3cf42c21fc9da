"""The device's side of a traced window, read from ``torch.profiler``.

``Tracer`` profiles the host (CPU) and the card (CUDA) over a window the
driver opens and closes, timing it on the host's clock between a
synchronise after the start and one before the stop.  ``read`` turns the
profiler's raw events (``kineto_results.events()``, never the slower tree
of function events) into a ``Trace``: every device operation's name and
interval; the seconds the device was busy (the union of those intervals);
the idle gaps between them, each labelled by the innermost host operation
that was running at the gap's middle; and ``kernel_records_lost``, the
host's kernel launches whose correlation id no device record carries (the
profiler has been seen to lose records in processes older than a minute).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

_MIN_GAP_S = 2e-6            # shorter gaps are the device's own launch spacing
TRACE_SECONDS = 3.0          # the window's first seconds that a traced run profiles


@dataclasses.dataclass
class Trace:
    window_s: float
    names: list[str]               # device operations
    dur_s: np.ndarray
    busy_s: float
    idle_gaps: list[tuple[str, float]]
    kernel_records_lost: int

    def seconds(self, patterns) -> float:
        """Device seconds of the operations whose name holds any of ``patterns``."""
        keep = [i for i, n in enumerate(self.names) if any(p in n for p in patterns)]
        return float(self.dur_s[keep].sum()) if keep else 0.0

    def device_ops(self, top: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for n, d in zip(self.names, self.dur_s):
            key = n[:96]
            by[key] = by.get(key, 0.0) + float(d)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Tracer:
    """``start()`` / ``stop()`` around a window; does nothing when off."""

    def __init__(self, on: bool, device):
        self.on = on and torch.device(device).type == "cuda"
        self._prof = None
        self.window_s = 0.0

    def warm(self) -> None:
        """One short profile, so that the profiler's own first start is paid in
        set-up and not in the window."""
        if self.on:
            self.start()
            torch.zeros(1, device="cuda").add_(1)
            self.stop()

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self._t0 = time.monotonic()

    def stop(self) -> None:
        if not self.on:
            return
        torch.cuda.synchronize()
        self.window_s = time.monotonic() - self._t0
        self._prof.stop()

    def read(self) -> Trace | None:
        if self._prof is None:
            return None
        return read_events(self._prof.profiler.kineto_results.events(), self.window_s)


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{what}_us")() * 1000)


def read_events(events, window_s: float) -> Trace | None:
    """A ``Trace`` from raw profiler events; None when no operation ran on
    the device."""
    from torch.autograd import DeviceType
    dev, host, launched = [], [], set()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), _ns(e, "start"), _ns(e, "duration"), e.correlation_id()))
        else:
            name = e.name()
            start, dur = _ns(e, "start"), _ns(e, "duration")
            if "LaunchKernel" in name:
                launched.add(e.correlation_id())
            host.append((name, start, start + dur))
    if not dev:
        return None
    dev.sort(key=lambda r: r[1])
    names = [r[0] for r in dev]
    start = np.array([r[1] for r in dev], dtype=np.int64)
    dur = np.array([r[2] for r in dev], dtype=np.int64)
    lost = len(launched - {r[3] for r in dev})
    # union of the device intervals, and the gaps between its pieces
    end = np.maximum.accumulate(start + dur)
    new = np.ones(len(start), bool)
    new[1:] = start[1:] > end[:-1]
    piece_start = start[new]
    piece_end = np.append(end[np.flatnonzero(new)[1:] - 1], end[-1])
    busy = int((piece_end - piece_start).sum())
    gap_lo, gap_hi = piece_end[:-1], piece_start[1:]
    keep = (gap_hi - gap_lo) >= _MIN_GAP_S * 1e9
    gaps = _label_gaps(gap_lo[keep], gap_hi[keep], host)
    return Trace(window_s=window_s, names=names, dur_s=dur / 1e9, busy_s=busy / 1e9,
                 idle_gaps=gaps, kernel_records_lost=lost)


def _label_gaps(lo: np.ndarray, hi: np.ndarray, host: list) -> list[tuple[str, float]]:
    """Idle seconds by the innermost host operation running at each gap's
    middle (the one that started last among those still running), summed by
    that operation's name, longest first, at most ten."""
    if len(lo) == 0:
        return []
    host.sort(key=lambda r: r[1])
    h_start = np.array([r[1] for r in host], dtype=np.int64)
    h_end = np.array([r[2] for r in host], dtype=np.int64)
    by: dict[str, float] = {}
    for a, b in zip(lo, hi):
        mid = (a + b) // 2
        j = int(np.searchsorted(h_start, mid, side="right")) - 1
        label = "host outside any profiled op"
        for k in range(j, max(j - 256, -1), -1):
            if h_end[k] > mid:
                label = host[k][0][:80]
                break
        by[label] = by.get(label, 0.0) + (b - a) / 1e9
    return sorted(by.items(), key=lambda kv: -kv[1])[:10]
