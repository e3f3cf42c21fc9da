"""Executor latency models (pluggable ``DeviceModel``).

* ``TableDeviceModel`` — interpolates a *measured* (batch → latency) curve;
  ``core.infra`` calibrates it by timing the real models, on the host's CPU
  (the executors) and on the card (the accelerator).
* ``AnalyticalDeviceModel`` — roofline-style:
      latency(B) = overhead + in_bytes(B)/xfer_bw + max(flops(B)/peak,
                                                        mem_bytes(B)/mem_bw)
  Instantiated with GPU-class constants it reproduces the paper's Fig. 4/6
  behavior (fixed transfer cost → only large batches win); with TPU-v5e
  constants it is the accelerator model used for TPU-native serving.

Contention: CPU executors can take a multiplicative slowdown as a function
of simultaneously-busy executors — the paper's inclusive-cache Broadwell
effect (§VI-A "optimizing across hardware platforms").
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Protocol

import numpy as np


class DeviceModel(Protocol):
    def latency(self, batch: int) -> float: ...

    def latency_batch(self, batches: np.ndarray) -> np.ndarray: ...


@dataclasses.dataclass
class TableDeviceModel:
    """Piecewise log-linear interpolation of measured latencies."""
    batches: np.ndarray            # sorted, >=1
    seconds: np.ndarray

    def __post_init__(self):
        self.batches = np.asarray(self.batches, float)
        self.seconds = np.asarray(self.seconds, float)
        # precompute the interpolation axes once — latency() used to redo
        # both np.log calls on every scalar lookup, which dominated the
        # simulator's service-time cost before results were table-cached
        self._log_b = np.log(self.batches)
        self._log_s = np.log(self.seconds)
        # final marginal cost per item, for extrapolation past the curve
        # (flat for degenerate single-point curves, which used to construct
        # fine and only crash when extrapolating)
        if len(self.batches) >= 2:
            self._tail_slope = ((self.seconds[-1] - self.seconds[-2])
                                / (self.batches[-1] - self.batches[-2]))
        else:
            self._tail_slope = 0.0

    def latency(self, batch: int) -> float:
        b = max(int(batch), 1)
        if b <= self.batches[0]:
            return float(self.seconds[0])
        if b >= self.batches[-1]:
            return float(self.seconds[-1]
                         + self._tail_slope * (b - self.batches[-1]))
        return float(np.exp(np.interp(np.log(b), self._log_b, self._log_s)))

    def latency_batch(self, batches: np.ndarray) -> np.ndarray:
        """Vectorized ``latency`` over an int array of batch sizes."""
        b = np.maximum(np.asarray(batches, float), 1.0)
        out = np.exp(np.interp(np.log(b), self._log_b, self._log_s))
        out = np.where(b <= self.batches[0], self.seconds[0], out)
        return np.where(
            b >= self.batches[-1],
            self.seconds[-1] + self._tail_slope * (b - self.batches[-1]), out)

    def to_json(self) -> dict:
        return {"batches": self.batches.tolist(), "seconds": self.seconds.tolist()}

    @classmethod
    def from_json(cls, d: dict) -> "TableDeviceModel":
        return cls(np.asarray(d["batches"], float), np.asarray(d["seconds"], float))


@dataclasses.dataclass
class AnalyticalDeviceModel:
    """Three-term analytic executor."""
    flops_per_sample: float
    mem_bytes_per_sample: float
    in_bytes_per_sample: float
    peak_flops: float              # /s
    mem_bw: float                  # B/s
    xfer_bw: float                 # B/s (PCIe for GPU; host infeed for TPU)
    overhead_s: float              # kernel launch / RPC / batching overhead

    def latency(self, batch: int) -> float:
        b = max(int(batch), 1)
        compute = (b * self.flops_per_sample) / self.peak_flops
        memory = (b * self.mem_bytes_per_sample) / self.mem_bw
        xfer = (b * self.in_bytes_per_sample) / self.xfer_bw
        return self.overhead_s + xfer + max(compute, memory)

    def latency_batch(self, batches: np.ndarray) -> np.ndarray:
        """Vectorized ``latency`` over an int array of batch sizes."""
        b = np.maximum(np.asarray(batches, float), 1.0)
        compute = (b * self.flops_per_sample) / self.peak_flops
        memory = (b * self.mem_bytes_per_sample) / self.mem_bw
        xfer = (b * self.in_bytes_per_sample) / self.xfer_bw
        return self.overhead_s + xfer + np.maximum(compute, memory)


def service_time_table(device: DeviceModel, up_to: int) -> np.ndarray:
    """Latency for every batch size ``1..up_to``, indexed by batch size
    (slot 0 is unused).

    The fast-path simulator looks service times up by batch size for whole
    request arrays at once; this computes the table once per device via
    ``latency_batch`` and caches it on the instance, growing geometrically
    so repeated calls with different ``up_to`` don't recompute.
    """
    up_to = max(int(up_to), 1)
    tab = getattr(device, "_svc_table", None)
    if tab is None or len(tab) <= up_to:
        n = 1 << (up_to - 1).bit_length()
        lb = getattr(device, "latency_batch", None)
        if lb is not None:
            vals = np.asarray(lb(np.arange(1, n + 1)), float)
        else:                       # protocol minimum: scalar latency only
            vals = np.array([device.latency(b) for b in range(1, n + 1)])
        tab = np.concatenate([[np.inf], vals])
        try:
            device._svc_table = tab
        except AttributeError:      # frozen custom model → recompute per call
            pass
    return tab


# hardware-constant presets
GPU_1080TI = dict(peak_flops=11.3e12, mem_bw=484e9, xfer_bw=12e9,
                  overhead_s=2.5e-3)
TPU_V5E = dict(peak_flops=197e12, mem_bw=819e9, xfer_bw=50e9,
               overhead_s=0.5e-3)


def accelerator_model(cfg, kind: str = "gpu") -> AnalyticalDeviceModel:
    """Build the accelerator model for a recsys config from analytic costs."""
    from repro_torch.core import costs
    hw = GPU_1080TI if kind == "gpu" else TPU_V5E
    return AnalyticalDeviceModel(
        flops_per_sample=costs.recsys_flops_per_sample(cfg),
        mem_bytes_per_sample=costs.recsys_embed_bytes_per_sample(cfg),
        in_bytes_per_sample=costs.recsys_activation_bytes_per_sample(cfg),
        **hw)


@dataclasses.dataclass
class ContentionModel:
    """latency multiplier vs #busy executors (inclusive-cache contention)."""
    factor_at_full: float = 1.0    # 1.0 → no contention (Skylake-like)

    def is_noop(self) -> bool:
        """True when every multiplier is 1.0 (the fast-path eligibility
        gate asks this instead of re-deriving the rule)."""
        return self.factor_at_full <= 1.0

    def multiplier(self, busy: int, total: int) -> float:
        if total <= 1 or self.is_noop():
            return 1.0
        frac = busy / total
        return 1.0 + (self.factor_at_full - 1.0) * frac


# ---------------------------------------------------------- calibration


def measure_curve(apply_fn: Callable[[int], None],
                  batches=(1, 4, 16, 64, 256, 1024), iters: int = 5) -> TableDeviceModel:
    """Time ``apply_fn(batch)`` (expected to block) per batch size."""
    import time
    secs = []
    for b in batches:
        apply_fn(b)                                 # warmup/compile
        t0 = time.perf_counter()
        for _ in range(iters):
            apply_fn(b)
        secs.append((time.perf_counter() - t0) / iters)
    return TableDeviceModel(np.asarray(batches, float), np.asarray(secs, float))


def save_curves(path: str, curves: dict[str, TableDeviceModel],
                meta: dict[str, dict] | None = None) -> None:
    """Write ``curves`` as JSON, one top-level key a model.  ``meta[name]``
    (where the curve was measured, its split by step) goes *inside* that
    model's dict, where ``load_curves`` ignores it: every top-level key
    reads as a curve."""
    meta = meta or {}
    with open(path, "w") as f:
        json.dump({k: {**meta.get(k, {}), **v.to_json()} for k, v in curves.items()},
                  f, indent=1)


def load_curves(path: str) -> dict[str, TableDeviceModel]:
    with open(path) as f:
        return {k: TableDeviceModel.from_json(v) for k, v in json.load(f).items()}


def load_meta(path: str) -> dict[str, dict]:
    """Each model's keys other than its curve's, as ``save_curves`` wrote them."""
    with open(path) as f:
        return {k: {m: x for m, x in v.items() if m not in ("batches", "seconds")}
                for k, v in json.load(f).items()}
