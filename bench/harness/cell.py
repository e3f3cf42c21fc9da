"""What a driver gets (``Ctx``) and gives back (``Outcome``)."""
from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from bench.harness.context import Run


@dataclasses.dataclass
class Ctx:
    cell: str
    model: dict                 # the configuration's widths (configs/<config>.json "model")
    params: dict                # the driver's parameters (workloads/<cell>.json "params")
    limits: dict                # the limit of each number compared
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    system: object              # systems.Port, systems.Control, or a fault around one
    t_process: float            # time.monotonic() when the process started

    def log(self, msg: str) -> None:
        print(f"[{self.cell}] {msg}", file=sys.stderr, flush=True)

    def check(self, name: str, value: float) -> "Check":
        return Check(name, float(value), float(self.limits[name]))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: within it when ``value <= limit``
    (a NaN never is)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    values: dict                # end-to-end metrics by name
    attempted: int
    failed: int
    checks: list
    run: Run
    memory_peak_bytes: int
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.monotonic()
