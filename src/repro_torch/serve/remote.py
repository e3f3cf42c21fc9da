"""Remote serving workers: one ``ServingRuntime`` per OS process, over a
localhost socket.

The live tier (``cluster.live``) stands N machines in for N *threads* of
one Python process — every feeder, worker, and controller shares one GIL,
so a fleet probe is bounded by a single core no matter how many nodes it
claims to run, and wall-clock results inherit whatever else the process
was doing.  This module is the other half of the story: a **worker** is a
real OS process hosting exactly one ``ServingRuntime``; the fleet driver
talks to it over a length-prefixed JSON wire protocol, and
``cluster.remote.RemoteNodeBackend`` adapts the conversation to the same
``NodeBackend`` contract the simulated and in-process live nodes already
implement.  Kills are real ``SIGKILL``s, boot times are measured
spawn+calibrate wall time, and N workers genuinely occupy N cores.

Wire protocol
    Every message is one *frame*: a 4-byte big-endian length followed by
    that many bytes of JSON.  Frames above ``max_frame`` are rejected
    before the body is read (the stream is then unsyncable, so the worker
    replies with an error and hangs up); a connection that dies mid-frame
    raises ``ProtocolError`` rather than returning a truncated message.
    The conversation is strict request/reply from a single client at a
    time — but the worker keeps its listening socket open and *re-accepts*
    after a connection dies, so a supervisor whose socket desynced (a
    deadline expired mid-frame) reconnects to the same process and all of
    its state instead of declaring the node lost.  Submits carry a
    client-assigned ``seq``: a resubmit after a lost reply is deduplicated
    on both the sequence number and the query ids, making retry safe.

Verbs (the ``op`` field of each request):
    ``ping``       liveness + pid + completed-count, for health checks;
    ``calibrate``  measure the runtime-path device curve in-process
                   (buckets → seconds, the ``BucketedDeviceModel`` data);
    ``start``      pin the trace-time origin (a shared ``CLOCK_MONOTONIC``
                   instant — worker and supervisor are on one host);
    ``submit``     a window of queries ``[index, t_arrival, size,
                   model_id]``; a feeder thread paces each one into the
                   runtime at its trace arrival instant;
    ``poll``       completion records from a caller-held cursor into the
                   runtime's append-only completion log (O(new));
    ``drain``      block until all accepted work completed;
    ``reset``      fresh runtime + clock for the next benchmark run;
    ``chaos``      arm a fault-injection behavior for the *next* verb
                   (``hang``: sleep before replying; ``garble``: junk
                   bytes before the reply, poisoning the stream;
                   ``drop``: close the connection without replying) —
                   the test surface ``cluster.chaos`` drives;
    ``shutdown``   graceful exit (idempotent from the caller's side —
                   after the reply the socket closes and the process ends).

Models are named by *spec string* (``"name:arg:arg"``) and built inside
the worker from ``MODEL_BUILDERS`` — code never crosses the wire, only
names and numbers.  ``pybusy`` is the deliberately GIL-bound reference
model the JAX package's ``remote_scaling`` benchmark uses to show the
multi-process win.

This is the port's copy of the JAX package's ``repro.serve.remote``: the
same protocol, verbs and chaos arm, with the worker's ``ServingRuntime``
the port's.  A worker serves on the card unless it is started with
``--device cpu``; asked for the card on a machine without one it raises
before it announces its port, and never carries on on the CPU.  ``mlp``
is a PyTorch twin of the reference's jitted MLP (the same weights from
``default_rng(0)``) on the worker's device; ``pybusy`` and ``iosleep`` are
host work whatever the device, copied as they are.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import struct
import sys
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import default_device, resolve
from repro_torch.serve.runtime import PacedFeeder, ServingRuntime

_HEADER = struct.Struct("!I")
MAX_FRAME = 16 * 1024 * 1024
PORT_ANNOUNCE = "REMOTE_WORKER_PORT="


class ProtocolError(RuntimeError):
    """A malformed frame: oversized, or the peer died mid-frame.  The
    byte stream cannot be resynchronized past one of these — the only
    clean recovery is to close the connection."""


def send_frame(sock: socket.socket, obj, max_frame: int = MAX_FRAME) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > max_frame:
        raise ProtocolError(f"frame of {len(payload)} bytes exceeds the "
                            f"{max_frame}-byte cap")
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """``n`` bytes or ``None`` on EOF at a byte boundary."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket, max_frame: int = MAX_FRAME):
    """One decoded frame; ``None`` on clean EOF (peer closed between
    frames).  EOF *inside* a frame, or a declared length past
    ``max_frame``, raises ``ProtocolError`` — a truncated or runaway
    frame must never be silently handed to the caller."""
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    (length,) = _HEADER.unpack(head)
    if length > max_frame:
        raise ProtocolError(f"peer announced a {length}-byte frame, cap "
                            f"is {max_frame}")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise ProtocolError("connection closed mid-frame "
                            f"({length} bytes announced)")
    return json.loads(payload)


# ------------------------------------------------------------ model registry


def _mlp_model(args: list[str], device: torch.device | str | None = None):
    """``mlp[:d_in[:hidden[:layers]]]`` — a tanh MLP, the same shape the
    live_parity benchmark serves in-process: the reference's weights
    (``default_rng(0)``, w1 then w2) on ``device`` (the card unless the
    caller names one), ``layers`` times ``tanh(h @ w1) @ w2``, then the
    sum over features."""
    d_in = int(args[0]) if len(args) > 0 else 128
    hidden = int(args[1]) if len(args) > 1 else 256
    layers = int(args[2]) if len(args) > 2 else 2
    dev = resolve(device)

    rng = np.random.default_rng(0)
    w1 = torch.from_numpy(rng.normal(0, 0.05, (d_in, hidden)).astype(np.float32)).to(dev)
    w2 = torch.from_numpy(rng.normal(0, 0.05, (hidden, d_in)).astype(np.float32)).to(dev)

    def apply_fn(batch):
        h = batch["x"]
        for _ in range(layers):
            h = torch.tanh(h @ w1) @ w2
        return h.sum(dim=1)

    template = np.ones((4096, d_in), np.float32)

    def make_batch(size: int, model_id: int) -> dict:
        return {"x": template[:size]}

    return apply_fn, make_batch


def _pybusy_model(args: list[str], device=None):
    """``pybusy[:iters_per_row]`` — pure-Python per-row work that *holds
    the GIL* (~125 ns/iteration): the CPU-bound reference model.  Threads
    in one process serialize on it; processes don't — exactly the
    contrast the remote tier exists to expose."""
    iters = int(args[0]) if args else 800

    def apply_fn(batch):
        n = int(batch["x"].shape[0]) * iters
        acc = 0
        for i in range(n):
            acc = (acc * 3 + i) & 0xFFFF
        return np.array([float(acc)], np.float32)

    template = np.zeros((4096, 1), np.float32)

    def make_batch(size: int, model_id: int) -> dict:
        return {"x": template[:size]}

    return apply_fn, make_batch


def _iosleep_model(args: list[str], device=None):
    """``iosleep[:us_per_row]`` — per-row sleep with the GIL *released*:
    an I/O- or accelerator-offload-bound service whose per-node capacity
    is a property of the node, not of the host's core count.  The chaos
    benchmark serves this model so that killing half the fleet really
    removes half the throughput — with a CPU-bound model on a one-core
    host the survivors inherit the victims' cycles and a node loss
    costs nothing measurable."""
    us = float(args[0]) if args else 500.0

    def apply_fn(batch):
        time.sleep(int(batch["x"].shape[0]) * us * 1e-6)
        return np.zeros(1, np.float32)

    template = np.zeros((4096, 1), np.float32)

    def make_batch(size: int, model_id: int) -> dict:
        return {"x": template[:size]}

    return apply_fn, make_batch


MODEL_BUILDERS: dict[str, Callable] = {
    "mlp": _mlp_model,
    "pybusy": _pybusy_model,
    "iosleep": _iosleep_model,
}


def build_model(spec: str, device: torch.device | str | None = None):
    """``(apply_fn, make_batch)`` from a spec string ``"name[:arg...]"``;
    a model with weights puts them on ``device`` (the card for ``None``),
    the host models ignore it."""
    name, _, rest = spec.partition(":")
    try:
        builder = MODEL_BUILDERS[name]
    except KeyError:
        raise ValueError(f"unknown model spec {spec!r}; "
                         f"choose from {sorted(MODEL_BUILDERS)}") from None
    return builder(rest.split(":") if rest else [], device)


# ------------------------------------------------------------------- worker


class _Worker:
    """Per-process serving state: the runtime, the pacing feeder, and the
    trace-time bookkeeping the verbs operate on."""

    def __init__(self, apply_fn, make_batch, *, n_workers: int,
                 batch_size: int, max_bucket: int, device: torch.device):
        self._apply = apply_fn
        self.make_batch = make_batch
        self.device = device
        self.n_workers = n_workers
        self.batch_size = batch_size
        self.max_bucket = max_bucket
        self.origin: float | None = None     # wall instant of trace t = 0
        self._fresh()

    def _fresh(self) -> None:
        self.rt = ServingRuntime(self._apply, n_workers=self.n_workers,
                                 batch_size=self.batch_size,
                                 max_bucket=self.max_bucket,
                                 device=self.device)
        self._meta: dict[int, tuple[float, int, int]] = {}
        self._seen_seqs: set[int] = set()
        # the same pacing machinery LiveNodeBackend runs in-process:
        # release each query into the runtime at its trace arrival
        # instant (errors drop the query; the run continues)
        self._feeder = PacedFeeder(
            lambda t: (self.origin or 0.0) + t,
            lambda qid, size, mid: self.rt.submit(
                qid, self.make_batch(size, mid), size))

    def close(self) -> None:
        self._feeder.stop()
        self.rt.shutdown()

    def reset(self) -> None:
        """Fresh runtime + clock for the next benchmark run (query ids
        restart from the new trace's indices, so stale records must go)."""
        self.close()
        self.origin = None
        self._fresh()

    # ------------------------------------------------------------- verbs

    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True, "pid": os.getpid(),
                    "completed": self.rt.n_completed,
                    "device": str(self.device)}
        if op == "calibrate":
            from repro_torch.cluster.live import calibrate_device
            dev = calibrate_device(
                self._apply, self.make_batch,
                max_bucket=int(msg.get("max_bucket", self.max_bucket)),
                burst=int(msg.get("burst", 32)),
                reps=int(msg.get("reps", 5)),
                buckets=msg.get("buckets"),
                torch_device=self.device)
            return {"ok": True, "buckets": dev.buckets.tolist(),
                    "seconds": dev.seconds.tolist()}
        if op == "start":
            self.origin = float(msg["origin"])
            return {"ok": True}
        if op == "submit":
            rows = msg["q"]
            seq = msg.get("seq")
            if seq is not None and seq in self._seen_seqs:
                # a resubmit after a lost reply — the whole window was
                # already accepted, acknowledge without re-feeding it
                return {"ok": True, "accepted": 0, "dup": True}
            if self.origin is None and rows:
                self.origin = time.monotonic() - float(rows[0][1])
            accepted = 0
            for i, t, size, mid in rows:
                if int(i) in self._meta:
                    continue      # qid-level idempotency for seq-less rows
                self._meta[int(i)] = (float(t), int(size), int(mid))
                self._feeder.put(float(t), int(i), int(size), int(mid))
                accepted += 1
            if seq is not None:
                self._seen_seqs.add(seq)
            return {"ok": True, "accepted": accepted}
        if op == "poll":
            recs = self.rt.completed_log(int(msg.get("cursor", 0)))
            origin = self.origin or 0.0
            rows = []
            for r in recs:
                t_arr, _, mid = self._meta.get(
                    r.qid, (r.t_arrival - origin, 0, -1))
                # trailing span columns (release into the executor queue,
                # first worker pickup) so worker-side stage timings
                # survive the socket hop; older clients parse rows by
                # prefix and ignore them
                rows.append([r.qid, t_arr, r.t_done - origin, mid, r.error,
                             r.t_arrival - origin,
                             r.t_started - origin
                             if r.t_started > 0.0 else None])
            return {"ok": True, "records": rows}
        if op == "drain":
            deadline = time.monotonic() + float(msg.get("timeout", 60.0))
            while self._feeder.unfinished:
                if time.monotonic() >= deadline:
                    return {"ok": False, "error": "feeder did not drain "
                            "(queries still scheduled past the timeout)"}
                time.sleep(0.005)
            self.rt.drain(max(deadline - time.monotonic(), 0.01))
            return {"ok": True}
        if op == "reset":
            self.reset()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


class _ChaosArm:
    """Armed fault-injection for the next verb on this worker — the
    server half of the ``chaos`` verb.  One-shot: each armed behavior
    fires once and disarms."""

    def __init__(self):
        self.hang_s = 0.0       # sleep this long before the next reply
        self.garble = False     # junk bytes before the next reply
        self.drop = False       # close without replying to the next verb


def _serve_conn(conn: socket.socket, worker: _Worker, chaos: _ChaosArm,
                max_frame: int) -> bool:
    """Serve one client connection to completion.  Returns ``False`` on a
    graceful ``shutdown`` (the worker process should exit) and ``True``
    when the connection merely died — EOF, poisoned stream, or an armed
    ``drop`` — so the caller re-accepts and the same worker state serves
    the supervisor's reconnect."""
    try:
        while True:
            try:
                msg = recv_frame(conn, max_frame)
            except ProtocolError as e:
                # poisoned stream: report (best effort) and hang up —
                # there is no way to find the next frame boundary; the
                # supervisor reconnects on a fresh stream
                try:
                    send_frame(conn, {"ok": False, "error": str(e)})
                except OSError:
                    pass
                return True
            if msg is None:                 # client hung up
                return True
            op = msg.get("op")
            if op == "shutdown":
                try:
                    send_frame(conn, {"ok": True})
                except OSError:
                    pass
                return False
            if op == "chaos":
                mode = msg.get("mode")
                if mode == "hang":
                    chaos.hang_s = float(msg.get("seconds", 1.0))
                elif mode == "garble":
                    chaos.garble = True
                elif mode == "drop":
                    chaos.drop = True
                else:
                    send_frame(conn, {"ok": False,
                                      "error": f"unknown chaos mode "
                                               f"{mode!r}"})
                    continue
                send_frame(conn, {"ok": True, "armed": mode})
                continue
            if chaos.drop:
                chaos.drop = False
                return True                 # vanish mid-conversation
            try:
                reply = worker.handle(msg)
            except Exception as e:          # a failed verb is a reply,
                reply = {"ok": False,       # not a dead worker
                         "error": f"{type(e).__name__}: {e}"}
            if chaos.hang_s > 0:
                hang, chaos.hang_s = chaos.hang_s, 0.0
                time.sleep(hang)            # client's deadline expires here
            if chaos.garble:
                chaos.garble = False
                conn.sendall(b"\xde\xad\xbe\xef" * 3)   # poison the framing
            send_frame(conn, reply)
    except OSError:
        return True                         # connection died under us
    finally:
        conn.close()


def serve_worker(model_spec: str, *, host: str = "127.0.0.1", port: int = 0,
                 n_workers: int = 1, batch_size: int = 32,
                 max_bucket: int = 256, max_frame: int = MAX_FRAME,
                 slow_start_s: float = 0.0, announce=None,
                 device: torch.device | str | None = None) -> None:
    """Host one ``ServingRuntime`` behind the wire protocol: bind, print
    ``REMOTE_WORKER_PORT=<n>`` (the supervisor's rendezvous), then accept
    and serve supervisor connections until a ``shutdown`` verb.  The
    listening socket stays open between connections: a client whose
    stream desynced reconnects to the same process — runtime, completion
    log, and submit-dedup state all survive the transport.
    ``slow_start_s`` delays the port announce (after the model is built),
    standing in for a node whose model load is pathologically slow — the
    chaos harness's slow-start injection.  ``device`` is where the runtime
    runs the model: the card for ``None``, which raises without one."""
    dev = resolve(device)
    if dev.type == "cuda":
        default_device()                # no card: raise, never serve on the CPU
    apply_fn, make_batch = build_model(model_spec, dev)
    if slow_start_s > 0:
        time.sleep(slow_start_s)
    srv = socket.create_server((host, port))
    bound = srv.getsockname()[1]
    print(f"{PORT_ANNOUNCE}{bound}", file=announce or sys.stdout, flush=True)
    worker = _Worker(apply_fn, make_batch, n_workers=n_workers,
                     batch_size=batch_size, max_bucket=max_bucket, device=dev)
    chaos = _ChaosArm()
    try:
        while True:
            conn, _ = srv.accept()
            if not _serve_conn(conn, worker, chaos, max_frame):
                return
    finally:
        worker.close()
        srv.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="host one ServingRuntime worker over a localhost socket")
    ap.add_argument("--model", required=True,
                    help="model spec string, e.g. mlp:128:256:2 or "
                         "pybusy:800")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral; the bound port is announced on "
                         "stdout as REMOTE_WORKER_PORT=<n>")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-bucket", type=int, default=256)
    ap.add_argument("--max-frame", type=int, default=MAX_FRAME)
    ap.add_argument("--slow-start", type=float, default=0.0,
                    help="sleep this many seconds before announcing the "
                         "port (chaos harness: a pathologically slow "
                         "model load)")
    ap.add_argument("--device", default=None,
                    help="where the runtime runs the model: the card when "
                         "omitted (an error without one), or cpu")
    args = ap.parse_args(argv)
    serve_worker(args.model, host=args.host, port=args.port,
                 n_workers=args.workers, batch_size=args.batch_size,
                 max_bucket=args.max_bucket, max_frame=args.max_frame,
                 slow_start_s=args.slow_start, device=args.device)


if __name__ == "__main__":
    main()
