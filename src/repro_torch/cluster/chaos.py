"""Deterministic fault injection for the serving tier — the chaos
harness.

A :class:`ChaosPlan` is a :class:`~repro_torch.cluster.lifecycle.FleetFaults`
superset: besides whole-node SIGKILLs (inherited ``kills``) it schedules
transport- and boot-level faults at *trace times*, so a failure scenario
is a reproducible artifact — the same plan replays the same storm on
every run, which is what lets a chaos benchmark gate a release on "the
healed fleet survives this exact crash storm":

  * :class:`RpcHang` — the worker sleeps before replying to its next
    verb, driving the client's per-op deadline past expiry (the retry /
    reconnect / SUSPECT path);
  * :class:`FrameGarble` — the worker emits junk bytes before its next
    reply (poisoning the length-prefixed framing) or, with
    ``drop=True``, closes the connection without replying at all;
  * :class:`SlowStart` — a node's *next spawn* sleeps ``extra_s`` before
    announcing its port, standing in for a pathologically slow model
    load (exercises async boot-ahead: the driver must not stall on it).

Kills flow through the lifecycle controller exactly as plain
``FleetFaults`` kills do.  Hangs and garbles are *injections*: at each
window boundary the controller delivers the due ones to the target
backend's ``inject_chaos`` hook — remote backends arm the fault in the
worker over the wire; sim and live backends have no such hook and
silently ignore them (there is no transport to fault).  Slow starts are
consumed by ``RemoteBackendFactory`` at spawn time.
"""
from __future__ import annotations

import dataclasses

from repro_torch.cluster.lifecycle import FleetFaults, NodeKill

__all__ = ["ChaosPlan", "RpcHang", "FrameGarble", "SlowStart", "NodeKill",
           "crash_storm"]


@dataclasses.dataclass(frozen=True)
class RpcHang:
    """At trace time ``t_s``, arm the named worker to sleep ``hang_s``
    before replying to its next verb — a hung RPC from the client's
    point of view."""
    t_s: float
    pool: str
    index_in_pool: int
    hang_s: float = 2.0

    mode = "hang"

    @property
    def key(self) -> tuple[str, int]:
        return (self.pool, self.index_in_pool)


@dataclasses.dataclass(frozen=True)
class FrameGarble:
    """At trace time ``t_s``, poison the named worker's next reply:
    junk bytes before the frame (``drop=False`` — the client's framing
    desyncs and it must scrap + reconnect) or a connection closed
    without any reply (``drop=True``)."""
    t_s: float
    pool: str
    index_in_pool: int
    drop: bool = False

    @property
    def mode(self) -> str:
        return "drop" if self.drop else "garble"

    @property
    def key(self) -> tuple[str, int]:
        return (self.pool, self.index_in_pool)


@dataclasses.dataclass(frozen=True)
class SlowStart:
    """The named node's next spawn sleeps ``extra_s`` before announcing
    its port.  One-shot: a restart of the same node boots clean."""
    pool: str
    index_in_pool: int
    extra_s: float = 1.0

    @property
    def key(self) -> tuple[str, int]:
        return (self.pool, self.index_in_pool)


@dataclasses.dataclass(frozen=True)
class ChaosPlan(FleetFaults):
    """A full fault schedule: kills (inherited), hung RPCs, garbled /
    dropped frames, and slow-start spawns.  Frozen — a plan is data, all
    delivery state lives in the controller and factory consuming it."""
    hangs: tuple[RpcHang, ...] = ()
    garbles: tuple[FrameGarble, ...] = ()
    slow_starts: tuple[SlowStart, ...] = ()

    def injections(self) -> list:
        """The window-boundary deliverables (hangs + garbles), in trace
        order — what ``FleetController.begin_window`` dispatches to
        ``NodeBackend.inject_chaos``."""
        return sorted(self.hangs + self.garbles, key=lambda e: e.t_s)

    def slow_start_s(self, pool: str, index_in_pool: int) -> float:
        """Extra boot delay for the named node's next spawn (0 if the
        plan schedules none)."""
        for s in self.slow_starts:
            if s.key == (pool, index_in_pool):
                return float(s.extra_s)
        return 0.0

    def summary(self) -> dict[str, int]:
        """Fault counts by kind — stamped into telemetry artifacts so a
        run's observed retry/re-route attribution can be read against
        the storm that produced it."""
        return {"kills": len(self.kills), "hangs": len(self.hangs),
                "garbles": len(self.garbles),
                "slow_starts": len(self.slow_starts)}


def crash_storm(t_s: float, pool: str, indices, *,
                restart_after_s: float | None = None
                ) -> tuple[NodeKill, ...]:
    """A burst of simultaneous kills — the storm the chaos benchmark
    injects at the diurnal peak.  ``restart_after_s=None`` leaves the
    victims to the :class:`~repro_torch.cluster.lifecycle.SelfHealPolicy`
    (or permanently dead in the heal-off ablation)."""
    return tuple(NodeKill(t_s, pool, int(i), restart_after_s)
                 for i in indices)
