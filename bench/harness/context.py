"""What a traced run hands to the per-layer metrics' readers
(``bench/metrics/<metric>.py``, each ``read(run) -> float | None``).

A reader that finds nothing to read returns None and the metric is left
out of the line; a share of a roofline or of a peak is never reported as 0
for want of a reading.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bench.harness.trace import Trace
from bench.work.counts import PEAKS


@dataclasses.dataclass
class Run:
    """``trace``: the traced window's device operations (None without a card
    or without ``--trace 1``).  ``work``: the frozen counts of the work that
    ran inside the traced window, summed (``k1_bound_s``, ``k3_bound_s``,
    ``k3bwd_bound_s``: each kernel's least time by ``bench/work``;
    ``model_flops``).  ``samples``: host-clock samples by name, in seconds
    (``dispatch_s`` a bulk pass)."""
    trace: Trace | None = None
    work: dict = dataclasses.field(default_factory=dict)
    samples: dict = dataclasses.field(default_factory=dict)

    def roofline_share(self, bound_key: str, kernels) -> float | None:
        """100 × the kernels' least time ÷ their device time in the trace."""
        if self.trace is None or not self.work.get(bound_key):
            return None
        t = self.trace.seconds(kernels)
        return 100.0 * self.work[bound_key] / t if t > 0 else None

    def mfu(self) -> float | None:
        """100 × the model FLOPs of the traced window's work ÷ (the window ×
        the dense TF32 peak)."""
        if self.trace is None or not self.work.get("model_flops") or self.trace.window_s <= 0:
            return None
        return 100.0 * self.work["model_flops"] / (self.trace.window_s * PEAKS["tf32_flops_per_s"])

    def idle_share(self) -> float | None:
        """100 × (1 − busy ÷ window) of the traced window."""
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def percentile_ms(self, sample: str, q: float) -> float | None:
        xs = self.samples.get(sample)
        if xs is None or len(xs) == 0:
            return None
        return float(np.percentile(np.asarray(xs), q)) * 1e3
