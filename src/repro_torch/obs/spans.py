"""Per-query spans: where a query's time went, for every engine.

A span is a small set of stage timestamps on the shared trace timeline::

    enqueued -> routed -> submitted -> batch_formed -> exec_start
             -> exec_done -> completed

plus annotations (re-route count, RPC-retry stall seconds, shed flag).
Rather than one object per query, :class:`SpanTable` stores the fleet's
spans as numpy columns (O(queries) floats, vectorized assembly), with
:class:`QuerySpan` as the per-query view for inspection and export.

How each engine fills the stamps:

  * **sim** — analytically from the Lindley recursion: ``node_pass
    (want_starts=True)`` returns each query's first executor dispatch
    (departure minus service per request, min over the query's requests),
    so ``exec_start`` needs no event loop;
  * **live** — ``ServingRuntime`` workers stamp ``QueryRecord.t_started``
    when they pick a request up; the backend converts wall clock back to
    trace time;
  * **remote** — the worker stamps the same way and the poll reply's
    completion rows carry two extra columns, so worker-side timings
    survive the socket hop.

The stamps *telescope*: with ``released`` falling back to ``routed`` when
a backend could not stamp it, the five components below sum exactly to
``completed - enqueued`` — the property `attribution` reconciles
percentile-by-percentile:

  ``reroute``  = routed − enqueued      (wait for re-route after a kill)
  ``retry``    = retry_s                (RPC deadline/backoff stall)
  ``cache``    = cache_s                (fleet-front result-cache lookup;
                                         for a hit it is the *whole*
                                         residual latency)
  ``dispatch`` = released − routed − retry_s − cache_s
                                        (submit + batch formation)
  ``queueing`` = exec_start − released  (executor queue depth)
  ``service``  = exec_done − exec_start (device/model execution)

plus ``boot_wait`` (admission deferred behind a booting fleet — zero
under the current driver, which drops instead of deferring; the column
keeps the decomposition closed for drivers that defer).  A cache hit
never reaches a node: ``mark_cache_hit`` stamps released = done so
dispatch/queueing/service telescope to zero and the hit's latency is
attributed entirely to ``cache``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SpanTable", "QuerySpan", "STAGES", "COMPONENTS"]

# canonical stage stamps, in order
STAGES = ("enqueued", "routed", "submitted", "batch_formed",
          "exec_start", "exec_done", "completed")

# additive latency components, in stage order
COMPONENTS = ("reroute", "retry", "cache", "dispatch", "queueing",
              "service", "boot_wait")


@dataclasses.dataclass
class QuerySpan:
    """One query's span view (trace-time seconds).  ``stages`` maps every
    canonical stage name to its timestamp (NaN when the engine could not
    stamp it); ``components`` the additive decomposition."""
    index: int
    stages: dict[str, float]
    components: dict[str, float]
    reroutes: int
    retry_s: float
    shed: bool

    @property
    def latency_s(self) -> float:
        return self.stages["completed"] - self.stages["enqueued"]


class SpanTable:
    """Column store of per-query spans for one ``drive_fleet`` run."""

    def __init__(self, times: np.ndarray):
        times = np.asarray(times, float)
        n = len(times)
        self.n = n
        self.t_enqueued = times.copy()
        self.t_routed = times.copy()     # re-stamped on re-route
        self.t_released = np.full(n, np.nan)
        self.t_exec_start = np.full(n, np.nan)
        self.t_done = np.full(n, np.nan)
        self.retry_s = np.zeros(n)
        self.cache_s = np.zeros(n)
        self.boot_wait_s = np.zeros(n)
        self.reroutes = np.zeros(n, np.int32)
        self.shed = np.zeros(n, bool)

    # -- write side (driver + backends) -----------------------------------

    def mark_reroute(self, idx: np.ndarray, t: float) -> None:
        """Queries re-submitted at boundary ``t`` after their node died:
        the routed stamp moves to the re-route instant and any stamps the
        dead node produced are void."""
        self.t_routed[idx] = t
        self.t_released[idx] = np.nan
        self.t_exec_start[idx] = np.nan
        self.reroutes[idx] += 1

    def add_retry(self, idx: np.ndarray, seconds: float) -> None:
        """Attribute an RPC retry stall to the queries whose submit it
        delayed (the whole window shares the stall — the frame carried
        all of them)."""
        self.retry_s[idx] += seconds

    def mark_shed(self, idx: np.ndarray) -> None:
        self.shed[idx] = True

    def mark_cache_hit(self, idx: np.ndarray, done: np.ndarray) -> None:
        """Queries answered by the fleet-front cache: they never reach a
        node, so released = done (dispatch/queueing/service telescope to
        zero) and the full residual latency lands in the ``cache``
        component."""
        self.t_released[idx] = done
        self.t_exec_start[idx] = np.nan
        self.t_done[idx] = done
        self.cache_s[idx] = done - self.t_routed[idx]

    def record(self, index: int, released: float, exec_start: float,
               done: float) -> None:
        """Backend-reported stamps for one query (NaN = not stamped)."""
        self.t_released[index] = released
        self.t_exec_start[index] = exec_start
        self.t_done[index] = done

    def record_many(self, idx: np.ndarray, released: np.ndarray,
                    exec_start: np.ndarray, done: np.ndarray) -> None:
        self.t_released[idx] = released
        self.t_exec_start[idx] = exec_start
        self.t_done[idx] = done

    def finalize(self, done: np.ndarray) -> None:
        """Adopt the driver's authoritative completion array (NaN =
        dropped); a backend stamp for a query the driver later voided
        (killed node) is erased."""
        self.t_done = np.asarray(done, float).copy()
        gone = np.isnan(self.t_done)
        self.t_released[gone] = np.nan
        self.t_exec_start[gone] = np.nan

    # -- read side ---------------------------------------------------------

    @property
    def completed(self) -> np.ndarray:
        return ~np.isnan(self.t_done)

    def latency(self) -> np.ndarray:
        """End-to-end seconds (NaN for dropped queries)."""
        return self.t_done - self.t_enqueued

    def components(self) -> dict[str, np.ndarray]:
        """Additive decomposition (see module docstring).  Sums exactly to
        ``latency()`` for every completed query; all-NaN rows for dropped
        ones."""
        rel = np.where(np.isnan(self.t_released), self.t_routed,
                       self.t_released)
        start = self.t_exec_start
        have = ~np.isnan(start)
        # a query without an exec stamp folds queueing into service so the
        # telescoped sum still closes
        queueing = np.where(have, start - rel, 0.0)
        service = np.where(have, self.t_done - start, self.t_done - rel)
        return {
            "reroute": self.t_routed - self.t_enqueued,
            "retry": self.retry_s.copy(),
            "cache": self.cache_s.copy(),
            "dispatch": rel - self.t_routed - self.retry_s - self.cache_s,
            "queueing": queueing,
            "service": service,
            "boot_wait": self.boot_wait_s.copy(),
        }

    def stage_totals(self) -> dict[str, float]:
        """Fleet-total seconds per component over completed queries."""
        ok = self.completed
        return {k: float(np.nansum(v[ok]))
                for k, v in self.components().items()}

    def span(self, index: int) -> QuerySpan:
        comp = {k: float(v[index]) for k, v in self.components().items()}
        rel = self.t_released[index]
        if np.isnan(rel):
            rel = self.t_routed[index]
        stages = {
            "enqueued": float(self.t_enqueued[index]),
            "routed": float(self.t_routed[index]),
            "submitted": float(self.t_routed[index]),
            "batch_formed": float(rel),
            "exec_start": float(self.t_exec_start[index]),
            "exec_done": float(self.t_done[index]),
            "completed": float(self.t_done[index]),
        }
        return QuerySpan(index=int(index), stages=stages, components=comp,
                         reroutes=int(self.reroutes[index]),
                         retry_s=float(self.retry_s[index]),
                         shed=bool(self.shed[index]))

    def __len__(self) -> int:
        return self.n
