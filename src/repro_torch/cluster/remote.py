"""Remote node backends: worker *processes* behind the ``NodeBackend``
contract — the third engine next to ``SimNodeBackend`` and
``LiveNodeBackend``.

A ``RemoteNodeBackend`` adapts one spawned worker process
(``serve.remote.serve_worker`` hosting a ``ServingRuntime``) to the exact
interface the fleet driver, routers, lifecycle controller, and autoscaler
already consume, so ``drive_fleet`` runs unchanged over real processes:

  * ``submit`` ships a traffic window over the socket in one frame; the
    *worker's own* feeder thread paces each query into its runtime at the
    query's trace arrival instant (trace time is anchored by sharing one
    ``CLOCK_MONOTONIC`` origin across all workers of a host — the
    supervisor sends the origin value, it does not re-derive it, so every
    node paces against the same instant);
  * ``take_new_records``/``completed_records`` poll the worker's
    append-only completion log through a cursor (O(new) per window) and
    cache rows locally, so a node's history survives its process;
  * ``cancel_pending`` is a real ``SIGKILL``: the process dies, and every
    accepted query not in the local completion cache is surrendered as an
    orphan for the driver's existing re-route path — including work the
    worker had finished but not yet reported, which is exactly the
    at-least-once re-execution a real fleet performs after losing a node;
  * ``close`` is an idempotent graceful shutdown (verb, then reap).

The ``WorkerSupervisor`` owns process lifecycle: it spawns workers
(``python -m repro_torch.serve.remote``), reads the port rendezvous off stdout,
connects, health-checks (``ping``), and reaps zombies (``reap`` —
``Popen.poll`` collects the exit status of anything that died, planned or
not).  ``remote_node``/``boot_remote_fleet`` measure real boot latency:
``NodeSpec.boot_s`` on a remote node is the *measured* spawn+calibrate
wall time of that process, not a modeling constant.  ``boot_remote_fleet``
calibrates all workers concurrently, so each node's device curve carries
the core contention of the full fleet actually running — what a
``SimNodeBackend`` twin needs for sim-vs-remote parity on an
oversubscribed host.

``RemoteBackendFactory`` plugs the same spawn path into ``drive_fleet``'s
``fleet=``+``factory=`` mode: an autoscaler ordering a node mid-run
boots a genuine OS process.  With ``async_boot=True`` the spawn runs in
a background thread behind a ``BootingRemoteBackend`` proxy — the order
returns immediately and the node joins at the first window boundary
after its process is serving (zero driver stall; keep the ledger spec's
``boot_s`` at 0 either way, the measured delay is recorded per node in
``boot_history``).

Transport robustness: every RPC runs under a per-op deadline, and any
failure *scraps the socket* — a timeout may land mid-frame, and a reused
desynced stream would corrupt every later reply.  ``RemoteNodeBackend``
retries with bounded exponential backoff over a **reconnect** (the
worker re-accepts with its state intact; submits carry sequence numbers
the worker dedupes, so resubmission is idempotent), marking itself
``suspect`` while exchanges fail.  The lifecycle controller's health
pass verifies SUSPECT nodes and — under a ``SelfHealPolicy`` — restarts
dead ones through BOOTING, while ``WorkerSupervisor.heal()`` offers the
same crash-loop-budgeted auto-restart (``RestartPolicy``) for standalone
worker pools.

This is the port's copy of the JAX package's ``repro.cluster.remote``: its
workers are the port's (``repro_torch.serve.remote``), and they serve on
the card unless the supervisor is given ``torch_device="cpu"``, which the
tests on the host pass.  A worker asked for the card on a machine without
one exits before it announces its port, and the spawn raises
``WorkerCrashed``.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

import repro_torch
from repro_torch.cluster.backend import (BackendDied, CompletedQuery, NodeBackend,
                                         PendingQuery)
from repro_torch.cluster.fleet import NodeSpec
from repro_torch.cluster.live import BucketedDeviceModel, WallClock
from repro_torch.serve.batching import bucket_ladder
from repro_torch.serve.remote import (MAX_FRAME, PORT_ANNOUNCE, ProtocolError,
                                      recv_frame, send_frame)


class WorkerCrashed(BackendDied):
    """The worker process behind a remote node is gone or unreachable
    (killed, crashed, or the transport failed) — the caller should treat
    the node as SUSPECT and verify, reconnect, or retire it."""


def _scrap(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


def _rpc(sock: socket.socket, msg: dict, *, timeout: float | None = 60.0,
         max_frame: int = MAX_FRAME) -> dict:
    """One request/reply exchange; raises ``WorkerCrashed`` when the
    transport fails and ``RuntimeError`` when the worker reports an
    application error.  An *outgoing* frame over the cap raises
    ``ProtocolError`` before any bytes move — that is the caller's
    payload, not a dead worker, and the stream is still clean.

    Any transport failure — a deadline expiring, the peer poisoning the
    stream, a reset — **closes the socket**: the stream may be mid-frame,
    and a connection whose frame boundary is lost would silently desync
    every later reply if it were reused.  Recovery is a reconnect (the
    worker re-accepts), never a retry on the same socket."""
    old = sock.gettimeout()
    try:
        sock.settimeout(timeout)
        try:
            send_frame(sock, msg, max_frame)
        except ProtocolError:
            sock.settimeout(old)
            raise                          # local oversize: caller error,
        try:                               # and no bytes moved
            reply = recv_frame(sock, max_frame)
        except ProtocolError as e:         # peer poisoned the stream
            _scrap(sock)
            raise WorkerCrashed(f"worker unreachable on "
                                f"{msg.get('op')!r}: "
                                f"{type(e).__name__}: {e}") from e
    except socket.timeout as e:
        # the deadline may have expired mid-frame — the connection is
        # unsyncable and must not be restored-and-reused
        _scrap(sock)
        raise WorkerCrashed(f"deadline ({timeout}s) expired on "
                            f"{msg.get('op')!r}; connection scrapped "
                            f"(possibly mid-frame)") from e
    except OSError as e:
        _scrap(sock)
        raise WorkerCrashed(f"worker unreachable on {msg.get('op')!r}: "
                            f"{type(e).__name__}: {e}") from e
    if reply is None:
        _scrap(sock)
        raise WorkerCrashed(f"worker closed the connection on "
                            f"{msg.get('op')!r}")
    try:
        sock.settimeout(old)
    except OSError:
        pass
    return reply


def _check(reply: dict) -> dict:
    if not reply.get("ok", False):
        raise RuntimeError(f"worker error: {reply.get('error')}")
    return reply


@dataclasses.dataclass
class WorkerHandle:
    """One spawned worker: the OS process, its connected socket, and the
    spec string it serves.  ``generation`` counts supervisor auto-restarts
    in this handle's lineage (0 = original spawn)."""
    proc: subprocess.Popen
    sock: socket.socket
    port: int
    model_spec: str
    generation: int = 0
    # launch kwargs (n_workers/batch_size/max_bucket) so a supervisor
    # heal() respawns the same configuration, not the defaults
    config: dict = dataclasses.field(default_factory=dict)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def reconnect(self, timeout: float = 10.0) -> None:
        """Dial the worker's port again on a fresh stream — the recovery
        path after ``_rpc`` scrapped a desynced socket.  The worker
        process re-accepts with all its state intact."""
        _scrap(self.sock)
        self.sock = socket.create_connection(("127.0.0.1", self.port),
                                             timeout=timeout)
        self.sock.settimeout(None)


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Crash-loop discipline for auto-restarting dead workers: at most
    ``max_restarts`` per lineage, with exponential backoff between
    attempts (restart ``k`` waits ``backoff_s·factor^k``, capped).  The
    same knobs a production supervisor (systemd, k8s) exposes — the
    budget is what turns a crash-*loop* into a dead node instead of an
    infinite spawn storm."""
    max_restarts: int = 3
    backoff_s: float = 0.2
    backoff_factor: float = 2.0
    backoff_cap_s: float = 10.0

    def delay_s(self, used: int) -> float:
        if self.backoff_s <= 0:
            return 0.0
        return min(self.backoff_s * self.backoff_factor ** used,
                   self.backoff_cap_s)


class WorkerSupervisor:
    """Spawns, health-checks, reaps, and heals remote worker processes.

    Workers run ``python -m repro_torch.serve.remote`` with ``src`` on
    ``PYTHONPATH`` (derived from the installed ``repro_torch`` package, so
    the child resolves the same code the parent runs), each on
    ``torch_device``: the card when it is ``None``, or ``"cpu"``.  The
    supervisor is the
    single owner of process handles: ``reap()`` collects exit statuses of
    anything that died — a graceful shutdown and a ``SIGKILL`` both leave
    a zombie until someone ``wait``s on it — ``heal()`` additionally
    respawns each corpse under the ``restart`` policy's crash-loop
    budget, and ``close()`` shuts every survivor down.  Usable as a
    context manager."""

    def __init__(self, *, python: str = sys.executable,
                 spawn_timeout: float = 120.0,
                 restart: RestartPolicy | None = None,
                 torch_device: str | None = None):
        self.python = python
        self.spawn_timeout = spawn_timeout
        self.restart = restart or RestartPolicy()
        self.torch_device = torch_device
        self.handles: list[WorkerHandle] = []

    # ------------------------------------------------------------ spawning

    def _env(self) -> dict:
        env = os.environ.copy()
        # locate the source root from the package's __path__ so the child
        # resolves the same code
        src = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def _await_port(self, proc: subprocess.Popen) -> int:
        """Read the ``REMOTE_WORKER_PORT=`` rendezvous off the worker's
        stdout.  A dedicated reader thread scans lines (tolerating any
        noise a model builder prints first — select() on the raw fd would
        starve if the announce arrived in the same pipe chunk as an
        earlier line and got swallowed into the reader's buffer) and then
        keeps *draining* the pipe for the process's lifetime: an
        unconsumed ~64KB pipe would otherwise block a chatty worker
        mid-verb the day a model builder prints progress."""
        found: dict = {}

        def _scan() -> None:
            for raw in proc.stdout:       # runs until EOF: drains stdout
                line = raw.decode(errors="replace")
                if "port" not in found and line.startswith(PORT_ANNOUNCE):
                    found["port"] = int(line[len(PORT_ANNOUNCE):])

        th = threading.Thread(target=_scan, daemon=True)
        th.start()
        deadline = time.monotonic() + self.spawn_timeout
        while time.monotonic() < deadline:
            th.join(timeout=0.2)
            if "port" in found:
                return found["port"]
            # scanner at EOF + process gone: either it died before
            # announcing, or it announced and exited inside this poll
            # window — join the finished scanner and check once more
            # before declaring a crash.  poll() (non-blocking) has
            # already reaped the child either way.
            if not th.is_alive() and proc.poll() is not None:
                th.join()
                if "port" in found:
                    return found["port"]
                raise WorkerCrashed(
                    f"worker exited (rc={proc.returncode}) before "
                    f"announcing its port")
        proc.kill()
        raise TimeoutError(f"worker pid {proc.pid} did not announce a port "
                           f"within {self.spawn_timeout}s")

    def _launch(self, model_spec: str, *, n_workers: int,
                batch_size: int, max_bucket: int,
                slow_start_s: float = 0.0) -> subprocess.Popen:
        cmd = [self.python, "-m", "repro_torch.serve.remote",
               "--model", model_spec, "--port", "0",
               "--workers", str(n_workers),
               "--batch-size", str(batch_size),
               "--max-bucket", str(max_bucket)]
        if self.torch_device is not None:
            cmd += ["--device", str(self.torch_device)]
        if slow_start_s > 0:
            cmd += ["--slow-start", str(slow_start_s)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                env=self._env())

    def _rendezvous(self, proc: subprocess.Popen, model_spec: str,
                    generation: int = 0,
                    config: dict | None = None) -> WorkerHandle:
        port = self._await_port(proc)
        sock = socket.create_connection(("127.0.0.1", port),
                                        timeout=self.spawn_timeout)
        sock.settimeout(None)
        handle = WorkerHandle(proc, sock, port, model_spec, generation,
                              config or {})
        self.handles.append(handle)
        return handle

    def spawn(self, model_spec: str, *, n_workers: int = 1,
              batch_size: int = 32, max_bucket: int = 256,
              slow_start_s: float = 0.0,
              generation: int = 0) -> WorkerHandle:
        cfg = dict(n_workers=n_workers, batch_size=batch_size,
                   max_bucket=max_bucket)
        proc = self._launch(model_spec, slow_start_s=slow_start_s, **cfg)
        return self._rendezvous(proc, model_spec, generation, cfg)

    def spawn_many(self, model_spec: str, n: int, *, n_workers: int = 1,
                   batch_size: int = 32, max_bucket: int = 256
                   ) -> list[WorkerHandle]:
        """Spawn ``n`` workers with overlapping boots: every process is
        launched before any rendezvous blocks, so the fleet pays roughly
        one interpreter startup of wall time instead of ``n``."""
        procs = [self._launch(model_spec, n_workers=n_workers,
                              batch_size=batch_size, max_bucket=max_bucket)
                 for _ in range(n)]
        handles = []
        cfg = dict(n_workers=n_workers, batch_size=batch_size,
                   max_bucket=max_bucket)
        try:
            for proc in procs:
                handles.append(self._rendezvous(proc, model_spec,
                                                config=cfg))
        except Exception:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
            raise
        return handles

    # ------------------------------------------------------------- health

    def ping(self, handle: WorkerHandle, timeout: float = 5.0) -> dict:
        return _check(_rpc(handle.sock, {"op": "ping"}, timeout=timeout))

    def healthy(self, handle: WorkerHandle, timeout: float = 5.0) -> bool:
        if not handle.alive():
            return False
        try:
            return bool(self.ping(handle, timeout).get("ok"))
        except (WorkerCrashed, RuntimeError):
            return False

    def reap(self) -> list[WorkerHandle]:
        """Collect every worker whose process has exited — planned
        shutdowns and kills alike.  ``Popen.poll`` waits on the child, so
        after this call none of the dead are zombies; their handles leave
        the supervisor's list and are returned for inspection."""
        dead = [h for h in self.handles if not h.alive()]
        for h in dead:
            self.handles.remove(h)
            try:
                h.sock.close()
            except OSError:
                pass
        return dead

    def heal(self) -> list[tuple[WorkerHandle, WorkerHandle | None]]:
        """``reap()`` + auto-restart: every collected corpse whose lineage
        still has crash-loop budget (``restart.max_restarts``) is
        respawned with the same model spec after the policy's backoff;
        one over budget stays dead.  Returns ``(corpse, replacement)``
        pairs (``None`` replacement = budget exhausted or the respawn
        itself failed).  This is the standalone supervisor loop; fleet
        runs heal through the lifecycle controller instead, which
        re-enters replacement nodes via BOOTING → SERVING."""
        out: list[tuple[WorkerHandle, WorkerHandle | None]] = []
        for corpse in self.reap():
            if corpse.generation >= self.restart.max_restarts:
                out.append((corpse, None))
                continue
            time.sleep(self.restart.delay_s(corpse.generation))
            try:
                fresh = self.spawn(corpse.model_spec, **corpse.config,
                                   generation=corpse.generation + 1)
            except (WorkerCrashed, TimeoutError, OSError):
                fresh = None
            out.append((corpse, fresh))
        return out

    # ------------------------------------------------------------ shutdown

    def close(self) -> None:
        """Gracefully shut every live worker down; kill the stubborn."""
        for h in list(self.handles):
            if h.alive():
                try:
                    _rpc(h.sock, {"op": "shutdown"}, timeout=5.0)
                except (WorkerCrashed, RuntimeError):
                    pass
                try:
                    h.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait(timeout=5)
            try:
                h.sock.close()
            except OSError:
                pass
        self.reap()

    def __enter__(self) -> "WorkerSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ backend


class RemoteNodeBackend(NodeBackend):
    """One worker process behind the ``NodeBackend`` contract (see module
    docstring).  ``spec`` is the routing/estimation view of the node; the
    execution is the remote process's."""

    realtime = True

    def __init__(self, handle: WorkerHandle, *, spec: NodeSpec,
                 pool: str = "remote", index_in_pool: int = 0,
                 weight: float = 1.0, clock: WallClock | None = None,
                 rpc_timeout: float = 60.0, rpc_retries: int = 2,
                 retry_backoff_s: float = 0.05):
        self.handle = handle
        self.spec = spec
        self.pool = pool
        self.index_in_pool = index_in_pool
        self.weight = weight
        self.clock = clock or WallClock()
        self.rpc_timeout = rpc_timeout
        self.rpc_retries = rpc_retries
        self.retry_backoff_s = retry_backoff_s
        self.suspect = False
        # idx → (arrival, size, model_id): the orphan set of a kill is
        # everything here minus the polled completion cache
        self._meta: dict[int, tuple[float, int, int]] = {}
        self._cache: list[CompletedQuery] = []
        self._done_idx: set[int] = set()
        self._cursor = 0
        self._seq = 0
        self._killed = False
        self._closed = False
        self._lock = threading.Lock()
        # wall seconds lost to failed RPC attempts + retry backoff since
        # the last take_retry_s() — the span layer's rpc_retry stall
        self._retry_s_acc = 0.0
        self.retry_count = 0

    def _rpc(self, msg: dict, *, timeout: float | None = None,
             check: bool = True, retries: int | None = None) -> dict:
        """One exchange with deadline + bounded-backoff retry.  A failed
        attempt scraps the socket (see module ``_rpc``), so each retry
        reconnects on a fresh stream — the worker process re-accepts with
        its state intact, and every verb here is idempotent on the worker
        side (submits carry a ``seq`` it dedupes; polls read from a
        client-held cursor).  The node is marked ``suspect`` while an
        exchange is failing and cleared on the first success; past the
        retry budget the last ``WorkerCrashed`` propagates and the
        lifecycle health pass takes over."""
        if self._killed:
            raise WorkerCrashed(f"node {self.key}: worker pid "
                                f"{self.handle.pid} was killed")
        tries = 1 + max(self.rpc_retries if retries is None else retries, 0)
        deadline = self.rpc_timeout if timeout is None else timeout
        delay = self.retry_backoff_s
        last: WorkerCrashed | None = None
        for attempt in range(tries):
            if attempt:
                time.sleep(delay)
                self._retry_s_acc += delay
                delay = min(delay * 2, 2.0)
                if not self.handle.alive():
                    break          # a corpse will not re-accept
                try:
                    with self._lock:
                        self.handle.reconnect()
                except OSError as e:
                    last = WorkerCrashed(
                        f"node {self.key}: reconnect to port "
                        f"{self.handle.port} failed: {e}")
                    continue
            a0 = time.perf_counter()
            try:
                with self._lock:
                    reply = _rpc(self.handle.sock, msg, timeout=deadline)
            except WorkerCrashed as e:
                # a failed attempt's wall time (a deadline expiry is the
                # whole timeout wait) is retry-path stall, attributable
                # to whatever window this exchange was carrying
                self._retry_s_acc += time.perf_counter() - a0
                self.retry_count += 1
                self.suspect = True
                last = e
                continue
            self.suspect = False
            return _check(reply) if check else reply
        self.suspect = True
        raise last if last is not None else WorkerCrashed(
            f"node {self.key}: worker pid {self.handle.pid} died")

    # ------------------------------------------------------------ backend

    def start(self, t0: float) -> None:
        self.clock.start(t0)
        self._rpc({"op": "start", "origin": self.clock.origin})

    def submit(self, idx: np.ndarray, times: np.ndarray, sizes: np.ndarray,
               model_ids: np.ndarray | None = None) -> None:
        if self._killed:
            raise RuntimeError(f"node {self.key} is dead (cancel_pending "
                               f"was called) — it accepts no new queries")
        if self.clock.origin is None and len(times):
            self.start(float(times[0]))
        rows = []
        for j in range(len(idx)):
            i, t = int(idx[j]), float(times[j])
            m = int(model_ids[j]) if model_ids is not None else -1
            self._meta[i] = (t, int(sizes[j]), m)
            rows.append([i, t, int(sizes[j]), m])
        # the seq makes a retried submit (reply lost, window re-sent over
        # a fresh connection) an acknowledged no-op on the worker
        self._seq += 1
        self._rpc({"op": "submit", "q": rows, "seq": self._seq})
        return None

    def advance_to(self, t: float) -> None:
        self.clock.sleep_until(t)

    def drain(self, timeout: float = 120.0) -> None:
        """Block until all accepted work completed.  A worker-side drain
        failure raises ``TimeoutError`` — callers (the driver's final
        drain) surface it as a lifecycle event and still collect the
        partial completion log, so a partly-drained node reports the
        queries it did finish rather than silently dropping the window."""
        reply = self._rpc({"op": "drain", "timeout": timeout},
                          timeout=timeout + 30.0, check=False)
        if not reply.get("ok", False):
            raise TimeoutError(f"node {self.key}: {reply.get('error')}")

    def take_retry_s(self) -> float:
        """Drain the accumulated RPC retry stall (seconds) — the driver
        reads this after each exchange batch and attributes it to the
        queries the stalled exchanges were carrying."""
        s, self._retry_s_acc = self._retry_s_acc, 0.0
        return s

    def _pull_new(self) -> list[CompletedQuery]:
        reply = self._rpc({"op": "poll", "cursor": self._cursor})
        fresh = []
        for row in reply["records"]:
            qid, t_arr, t_done, mid, err = row[:5]
            # trailing span columns are optional on the wire (older
            # workers, garbled-then-retried replies keep their shape)
            t_rel = float(row[5]) if len(row) > 5 and row[5] is not None \
                else float("nan")
            t_st = float(row[6]) if len(row) > 6 and row[6] is not None \
                else float("nan")
            fresh.append(CompletedQuery(index=int(qid),
                                        t_arrival=float(t_arr),
                                        t_done=float(t_done),
                                        model_id=int(mid), error=err,
                                        t_released=t_rel,
                                        t_exec_start=t_st))
        self._cursor += len(fresh)
        self._cache += fresh
        self._done_idx.update(r.index for r in fresh)
        return fresh

    def take_new_records(self) -> list[CompletedQuery]:
        if self._killed:
            return []
        return self._pull_new()

    def completed_records(self) -> list[CompletedQuery]:
        # a killed/closed node serves its history from the local cache —
        # the process (and its socket) no longer exists.  A node that
        # crashed *unnoticed* (no kill, no close) must still surrender
        # whatever it reported before dying rather than raise away the
        # whole run's record collection.
        if not self._killed and not self._closed:
            try:
                self._pull_new()
            except WorkerCrashed:
                pass
        return list(self._cache)

    # ------------------------------------------------------------- health

    def dead(self) -> bool:
        """Unplanned death probe for the lifecycle health pass: the
        process exited and this was not a planned kill/close."""
        return not (self._killed or self._closed) and not self.handle.alive()

    def idle(self, t: float) -> bool:
        """Every accepted query completed (the terminate-after-idle probe
        for DRAINING nodes).  An unreachable worker is idle — nothing
        more will ever complete."""
        if self._killed or self._closed:
            return True
        try:
            self._pull_new()
        except (WorkerCrashed, RuntimeError):
            return True
        return len(self._done_idx) >= len(self._meta)

    def verify(self, timeout: float = 5.0) -> bool:
        """Settle a SUSPECT verdict: ping (with reconnect via the retry
        path) and report whether the worker answered."""
        if self._killed or self._closed or not self.handle.alive():
            return False
        try:
            self._rpc({"op": "ping"}, timeout=timeout)
            return True
        except (WorkerCrashed, RuntimeError):
            return False

    def inject_chaos(self, event) -> None:
        """Arm a worker-side fault (``cluster.chaos`` events carry a
        ``mode`` and optional ``seconds``).  Best-effort: a node already
        unreachable has chaos enough."""
        msg = {"op": "chaos", "mode": event.mode}
        seconds = getattr(event, "hang_s", None)
        if seconds is not None:
            msg["seconds"] = float(seconds)
        try:
            self._rpc(msg, timeout=5.0, retries=0)
        except (WorkerCrashed, RuntimeError):
            pass

    def cancel_pending(self, t: float) -> list[PendingQuery]:
        """Kill the node for real: ``SIGKILL`` the worker process and
        surrender every accepted query not in the polled completion
        cache.  Completions the worker reached after the last poll die
        with it — those queries re-execute on the survivors, the
        at-least-once semantics of an actual node loss."""
        self._killed = True
        try:
            self.handle.proc.kill()
        except ProcessLookupError:
            pass
        try:
            self.handle.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        try:
            self.handle.sock.close()
        except OSError:
            pass
        return [PendingQuery(index=i, t_arrival=meta[0], size=meta[1],
                             model_id=meta[2])
                for i, meta in sorted(self._meta.items())
                if i not in self._done_idx]

    def reset_run(self) -> None:
        """Fresh worker-side runtime and local bookkeeping so the same
        process can serve another trace (benchmark probe ladders reuse
        workers across rungs; global trace indices restart per run)."""
        self._rpc({"op": "reset"})
        self._meta, self._cache = {}, []
        self._done_idx, self._cursor = set(), 0

    def close(self) -> None:
        if self._closed:
            return
        if not self._killed and self.handle.alive():
            # last poll before the process goes away: after close the
            # cache is this node's entire history (terminate-after-idle
            # closes nodes mid-run, long before record collection)
            try:
                self._pull_new()
            except (WorkerCrashed, RuntimeError):
                pass
        self._closed = True
        if not self._killed and self.handle.alive():
            try:
                self._rpc({"op": "shutdown"}, timeout=5.0, check=False,
                          retries=0)
            except WorkerCrashed:
                pass
            try:
                self.handle.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.handle.proc.kill()
        try:
            self.handle.sock.close()
        except OSError:
            pass


# ------------------------------------------------------------ construction


def _calibrate_handle(handle: WorkerHandle, *, max_bucket: int,
                      burst: int = 32, reps: int = 5,
                      buckets: list[int] | None = None,
                      timeout: float = 600.0) -> BucketedDeviceModel:
    msg = {"op": "calibrate", "max_bucket": max_bucket,
           "burst": burst, "reps": reps}
    if buckets is not None:
        msg["buckets"] = list(buckets)
    reply = _check(_rpc(handle.sock, msg, timeout=timeout))
    return BucketedDeviceModel(np.asarray(reply["buckets"], np.int64),
                               np.asarray(reply["seconds"], float))


def calibrate_lockstep(handles: list[WorkerHandle], *, max_bucket: int,
                       burst: int = 32, reps: int = 5
                       ) -> list[BucketedDeviceModel]:
    """Per-worker device curves measured with the whole fleet busy.

    Solo calibration answers "how fast is this process alone?" — the
    wrong question for a fleet that oversubscribes the host's cores: at
    the capacity cliff *every* worker is busy, and each one only gets its
    contended share of the machine.  Stepping the bucket ladder in
    lockstep — every worker measures the *same* bucket at the same
    moment, one barrier per bucket — keeps the measurement loads aligned,
    so each worker's curve carries the all-busy contention the cliff will
    actually exhibit (a free-running concurrent calibration drifts out of
    phase: a worker timing its burst while the others sit in a cheap
    bucket reads near-solo speed).  This is the curve a ``SimNodeBackend``
    twin needs for sim-vs-remote capacity parity on an oversubscribed
    host."""
    ladder = bucket_ladder(max_bucket)
    secs = [[] for _ in handles]
    for bucket in ladder:
        vals: list[float | None] = [None] * len(handles)
        errors: list[Exception] = []

        def _one(k: int) -> None:
            try:
                dev = _calibrate_handle(handles[k], max_bucket=max_bucket,
                                        burst=burst, reps=reps,
                                        buckets=[bucket])
                vals[k] = float(dev.seconds[0])
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=_one, args=(k,))
                   for k in range(len(handles))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        for k, v in enumerate(vals):
            secs[k].append(v)
    arr = np.asarray(ladder, np.int64)
    return [BucketedDeviceModel(arr, np.maximum.accumulate(np.asarray(s)))
            for s in secs]


def remote_node(model_spec: str, *, supervisor: WorkerSupervisor,
                pool: str = "remote", index_in_pool: int = 0,
                n_workers: int = 1, batch_size: int = 32,
                max_bucket: int = 256,
                device: BucketedDeviceModel | None = None,
                weight: float = 1.0,
                clock: WallClock | None = None,
                slow_start_s: float = 0.0,
                rpc_timeout: float = 60.0,
                rpc_retries: int = 2) -> RemoteNodeBackend:
    """Boot one remote node: spawn the worker process, calibrate its
    device curve in-process (unless ``device`` is given), and build the
    backend.  ``spec.boot_s`` is the *measured* spawn(+calibrate) wall
    time of this node — the real number the lifecycle layer previously
    modeled as a constant."""
    t0 = time.monotonic()
    handle = supervisor.spawn(model_spec, n_workers=n_workers,
                              batch_size=batch_size, max_bucket=max_bucket,
                              slow_start_s=slow_start_s)
    if device is None:
        device = _calibrate_handle(handle, max_bucket=max_bucket)
    boot_s = time.monotonic() - t0
    spec = NodeSpec(cpu=device, n_executors=n_workers,
                    batch_size=min(batch_size, max_bucket),
                    request_overhead_s=0.0, boot_s=boot_s)
    return RemoteNodeBackend(handle, spec=spec, pool=pool,
                             index_in_pool=index_in_pool, weight=weight,
                             clock=clock, rpc_timeout=rpc_timeout,
                             rpc_retries=rpc_retries)


def boot_remote_fleet(model_spec: str, n_nodes: int, *,
                      supervisor: WorkerSupervisor, pool: str = "remote",
                      n_workers: int = 1, batch_size: int = 32,
                      max_bucket: int = 256, burst: int = 32, reps: int = 5,
                      clock: WallClock | None = None
                      ) -> list[RemoteNodeBackend]:
    """Boot ``n_nodes`` worker processes and calibrate them in
    **lockstep** (see :func:`calibrate_lockstep`): each node's curve
    carries the core contention of the whole fleet busy — on an
    oversubscribed host that contended curve, not the solo one, is what a
    simulated twin must use to predict the remote fleet's capacity."""
    clock = clock or WallClock()
    t0 = time.monotonic()
    handles = supervisor.spawn_many(model_spec, n_nodes,
                                    n_workers=n_workers,
                                    batch_size=batch_size,
                                    max_bucket=max_bucket)
    devices = calibrate_lockstep(handles, max_bucket=max_bucket,
                                 burst=burst, reps=reps)
    boot_s = time.monotonic() - t0
    out = []
    for k, (handle, device) in enumerate(zip(handles, devices)):
        spec = NodeSpec(cpu=device, n_executors=n_workers,
                        batch_size=min(batch_size, max_bucket),
                        request_overhead_s=0.0, boot_s=boot_s)
        out.append(RemoteNodeBackend(handle, spec=spec, pool=pool,
                                     index_in_pool=k, weight=1.0,
                                     clock=clock))
    return out


class BootingRemoteBackend(NodeBackend):
    """A node the factory ordered asynchronously: holds the spawn future
    and proxies the ``NodeBackend`` contract once it resolves.  The
    lifecycle controller keeps the node BOOTING until ``ready()`` — the
    driver loop never blocks on the spawn, and the node joins the fleet
    at the first window boundary after its process is actually serving
    (matching how the sim models ``NodeSpec.boot_s``, except the delay
    is measured, not declared).  ``start`` before readiness is deferred
    and replayed on resolve; a cancel/close before readiness dooms the
    node — the spawned process is shut down the moment it appears."""

    realtime = True

    def __init__(self, future, view, clock: WallClock):
        self.pool = view.pool
        self.index_in_pool = view.index_in_pool
        self.spec = view.spec
        self.weight = view.weight
        self.clock = clock
        self._future = future
        self._inner: RemoteNodeBackend | None = None
        self._error: Exception | None = None
        self._t0: float | None = None
        self._doomed = False

    def _resolve(self) -> None:
        if self._inner is not None or self._error is not None \
                or not self._future.done():
            return
        try:
            b = self._future.result()
        except Exception as e:
            self._error = e
            return
        if self._doomed:
            b.close()
            self._error = WorkerCrashed(
                f"node {self.key}: cancelled while booting")
            return
        # the measured spec (real boot_s, calibrated curve) replaces the
        # ledger's view so routers price the node correctly
        self.spec = b.spec
        self._inner = b
        if self._t0 is not None:
            b.start(self._t0)

    def ready(self) -> bool:
        """Spawn finished and the node can serve — the controller's
        BOOTING → SERVING promotion gate."""
        self._resolve()
        return self._inner is not None

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until the spawn resolves (the controller's *initial*
        fleet materialization — a run can't start before its starting
        nodes exist; mid-run orders never wait)."""
        try:
            self._future.result(timeout)
        except Exception:
            pass                         # surfaced via ready()/dead()
        return self.ready()

    def dead(self) -> bool:
        self._resolve()
        if self._inner is not None:
            return self._inner.dead()
        return self._error is not None

    @property
    def suspect(self) -> bool:
        return self._inner.suspect if self._inner is not None else False

    @property
    def handle(self) -> WorkerHandle:
        self._resolve()
        if self._inner is None:
            raise WorkerCrashed(f"node {self.key}: still booting "
                                f"(no worker handle yet)")
        return self._inner.handle

    def start(self, t0: float) -> None:
        self._t0 = t0
        if self._inner is not None:
            self._inner.start(t0)

    def submit(self, idx, times, sizes, model_ids=None):
        self._resolve()
        if self._inner is None:
            raise WorkerCrashed(f"node {self.key}: not serving yet "
                                f"(still booting)")
        return self._inner.submit(idx, times, sizes, model_ids)

    def advance_to(self, t: float) -> None:
        if self._inner is not None:
            self._inner.advance_to(t)
        else:
            self.clock.sleep_until(t)

    def drain(self, timeout: float = 120.0) -> None:
        if self.ready():
            self._inner.drain(timeout)

    def take_new_records(self) -> list[CompletedQuery]:
        return self._inner.take_new_records() if self._inner is not None \
            else []

    def take_retry_s(self) -> float:
        return self._inner.take_retry_s() if self._inner is not None else 0.0

    def completed_records(self) -> list[CompletedQuery]:
        return self._inner.completed_records() if self._inner is not None \
            else []

    def cancel_pending(self, t: float) -> list[PendingQuery]:
        self._resolve()
        if self._inner is not None:
            return self._inner.cancel_pending(t)
        self._doomed = True      # resolve-time: close the late process
        return []

    def idle(self, t: float) -> bool:
        return self._inner.idle(t) if self._inner is not None else True

    def verify(self, timeout: float = 5.0) -> bool:
        self._resolve()
        return self._inner is not None and self._inner.verify(timeout)

    def inject_chaos(self, event) -> None:
        self._resolve()
        if self._inner is not None:
            self._inner.inject_chaos(event)

    def close(self) -> None:
        self._resolve()
        if self._inner is not None:
            self._inner.close()
        else:
            self._doomed = True


class RemoteBackendFactory:
    """``factory(view, t0)`` for ``drive_fleet``'s fleet mode: every
    materialization — initial fleet, autoscaler growth, fault/heal
    restart — spawns a genuine worker process.  Measured boots are
    recorded in ``boot_history`` as ``((pool, index), seconds)``.

    Synchronous mode (default): the spawn happens inline in the driver
    loop, so the wall clock pays the node's true boot latency as a
    driver *stall* — keep the ledger spec's ``boot_s`` at 0 (a modeled
    delay on top would double-count it).

    Async boot-ahead (``async_boot=True``): ``__call__`` submits the
    spawn to a background thread and returns a ``BootingRemoteBackend``
    immediately — an autoscaler order costs the driver microseconds, and
    the node is promoted SERVING at the first window boundary after its
    process actually came up.  This is the remote analogue of the sim's
    ``boot_s`` model: provisioning is billed from the order, capacity
    arrives later.

    A ``cluster.chaos.ChaosPlan`` (``chaos=``) contributes slow-start
    injections: the first spawn of a named node sleeps ``extra_s``
    before announcing its port."""

    def __init__(self, model_spec: str, supervisor: WorkerSupervisor, *,
                 device: BucketedDeviceModel | None = None,
                 n_workers: int = 1, batch_size: int = 32,
                 max_bucket: int = 256, clock: WallClock | None = None,
                 async_boot: bool = False, max_concurrent_boots: int = 4,
                 chaos=None, rpc_timeout: float = 60.0,
                 rpc_retries: int = 2):
        self.model_spec = model_spec
        self.supervisor = supervisor
        self.device = device
        self.n_workers = n_workers
        self.batch_size = batch_size
        self.max_bucket = max_bucket
        self.rpc_timeout = rpc_timeout
        self.rpc_retries = rpc_retries
        self.clock = clock or WallClock()
        self.async_boot = async_boot
        self.max_concurrent_boots = max_concurrent_boots
        self.chaos = chaos
        self.boot_history: list[tuple[tuple[str, int], float]] = []
        self._pool = None
        self._slow_started: set[tuple[str, int]] = set()

    def _slow_start_s(self, key: tuple[str, int]) -> float:
        if self.chaos is None or key in self._slow_started:
            return 0.0
        extra = self.chaos.slow_start_s(*key)
        if extra > 0:
            self._slow_started.add(key)   # one-shot: restarts boot clean
        return extra

    def _build(self, view, t0: float) -> RemoteNodeBackend:
        key = (view.pool, view.index_in_pool)
        t_spawn = time.monotonic()
        b = remote_node(self.model_spec, supervisor=self.supervisor,
                        pool=view.pool, index_in_pool=view.index_in_pool,
                        n_workers=self.n_workers,
                        batch_size=self.batch_size,
                        max_bucket=self.max_bucket, device=self.device,
                        weight=view.weight, clock=self.clock,
                        slow_start_s=self._slow_start_s(key),
                        rpc_timeout=self.rpc_timeout,
                        rpc_retries=self.rpc_retries)
        self.boot_history.append((key, time.monotonic() - t_spawn))
        return b

    def __call__(self, view, t0: float):
        if not self.async_boot:
            return self._build(view, t0)
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.max_concurrent_boots,
                thread_name_prefix="boot-ahead")
        future = self._pool.submit(self._build, view, t0)
        return BootingRemoteBackend(future, view, self.clock)

    def close(self) -> None:
        """Stop the boot-ahead thread pool (outstanding spawns finish —
        their backends are owned by whoever holds them)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
