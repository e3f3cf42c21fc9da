"""The port's remote tier: every case of tests/test_remote.py, run against
``repro_torch.cluster.remote`` and ``repro_torch.serve.remote`` with the
workers spawned on the host CPU (``torch_device="cpu"``, the worker's
``--device cpu``) — wire-protocol edge cases, worker process lifecycle,
real SIGKILL re-route, supervisor reaping, with tiny ``pybusy`` models and
canned device curves, and no more spawns than the reference's file.  Then
the ``mlp`` model against the reference's jitted one (rtol 1e-5), and a
worker asked for the card on a machine without one."""
import os
import signal
import socket
import struct
import time

import numpy as np
import pytest

import torch

from repro_torch.cluster import (FleetFaults, NodeKill, WallClock, drive_fleet,
                                 make_router)
from repro_torch.cluster.fleet import NodeSpec, Pool, Fleet
from repro_torch.cluster.live import BucketedDeviceModel
from repro_torch.cluster.remote import (RemoteBackendFactory, WorkerCrashed,
                                        remote_node)
from repro_torch.cluster.remote import WorkerSupervisor as _Supervisor
from repro_torch.serve.remote import (ProtocolError, build_model, recv_frame,
                                      send_frame)

pytestmark = pytest.mark.cluster


def WorkerSupervisor(**kw):
    """The port's supervisor with its workers on the host CPU."""
    return _Supervisor(torch_device="cpu", **kw)


def _canned_device(service_s: float = 1e-4) -> BucketedDeviceModel:
    return BucketedDeviceModel(np.array([1, 2, 4, 8, 16, 32, 64]),
                               np.full(7, service_s))


def _node(sup, *, index=0, iters=50, service_s=1e-4, clock=None):
    return remote_node(f"pybusy:{iters}", supervisor=sup, pool="remote",
                       index_in_pool=index, device=_canned_device(service_s),
                       batch_size=16, max_bucket=64, clock=clock)


# ------------------------------------------------------------ wire protocol


def test_frame_roundtrip():
    a, b = socket.socketpair()
    try:
        msg = {"op": "submit", "q": [[0, 0.25, 8, -1]]}
        send_frame(a, msg)
        assert recv_frame(b) == msg
    finally:
        a.close()
        b.close()


def test_oversized_frame_rejected_on_send_and_recv():
    a, b = socket.socketpair()
    try:
        with pytest.raises(ProtocolError, match="exceeds"):
            send_frame(a, {"blob": "x" * 1024}, max_frame=64)
        # a peer *announcing* a runaway frame is rejected before the body
        # is read — the declared length alone condemns it
        a.sendall(struct.pack("!I", 2 ** 31))
        with pytest.raises(ProtocolError, match="cap"):
            recv_frame(b, max_frame=1024)
    finally:
        a.close()
        b.close()


def test_partial_frame_raises_not_truncates():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", 100) + b'{"op":')   # die mid-frame
        a.close()
        with pytest.raises(ProtocolError, match="mid-frame"):
            recv_frame(b)
    finally:
        b.close()


def test_clean_eof_returns_none():
    a, b = socket.socketpair()
    a.close()
    try:
        assert recv_frame(b) is None
    finally:
        b.close()


def _fake_server(reply_bytes: bytes, close_after: bool = False):
    """A socketpair 'worker' that reads one request then emits exactly
    ``reply_bytes`` and stalls — or hangs up (``close_after``) — the
    transport-fault bench for the client ``_rpc``."""
    import threading

    client, server = socket.socketpair()

    def _serve():
        try:
            recv_frame(server)                    # consume the request
            if reply_bytes:
                server.sendall(reply_bytes)
        except (OSError, ProtocolError):
            pass
        finally:
            if close_after:
                server.close()

    th = threading.Thread(target=_serve, daemon=True)
    th.start()
    return client, server, th


def test_rpc_garbage_before_header_scraps_socket():
    """Junk bytes where the client expects a frame header read as an
    absurd declared length: the client must scrap the connection (the
    stream is unsyncable), not retry on it."""
    from repro_torch.cluster.remote import _rpc as raw_rpc

    client, server, th = _fake_server(b"\xde\xad\xbe\xef" * 3)
    try:
        with pytest.raises(WorkerCrashed, match="unreachable"):
            raw_rpc(client, {"op": "ping"}, timeout=5.0)
        assert client.fileno() == -1              # scrapped, not reusable
    finally:
        th.join(timeout=5)
        server.close()


def test_rpc_slowloris_partial_frame_trips_deadline():
    """A peer that sends only the header and stalls must trip the per-op
    deadline; the half-read connection is scrapped (a later reply would
    desync against the unread remainder)."""
    from repro_torch.cluster.remote import _rpc as raw_rpc

    client, server, th = _fake_server(struct.pack("!I", 100) + b'{"ok"')
    try:
        with pytest.raises(WorkerCrashed, match="deadline"):
            raw_rpc(client, {"op": "ping"}, timeout=0.3)
        assert client.fileno() == -1
    finally:
        th.join(timeout=5)
        server.close()


def test_rpc_connection_reset_mid_reply():
    """The peer dying mid-reply (announced 100 bytes, delivered 10, then
    closed) is a WorkerCrashed, never a truncated message."""
    from repro_torch.cluster.remote import _rpc as raw_rpc

    client, server, th = _fake_server(struct.pack("!I", 100) + b'{"ok":true',
                                      close_after=True)
    try:
        with pytest.raises(WorkerCrashed, match="unreachable|closed"):
            raw_rpc(client, {"op": "ping"}, timeout=5.0)
        assert client.fileno() == -1
    finally:
        th.join(timeout=5)
        server.close()


def test_build_model_rejects_unknown_spec():
    with pytest.raises(ValueError, match="unknown model"):
        build_model("nosuchmodel:3")
    apply_fn, make_batch = build_model("pybusy:10")
    out = apply_fn(make_batch(4, -1))
    assert out.shape == (1,)


# ------------------------------------------------------- worker lifecycle


def test_worker_roundtrip_and_idempotent_shutdown():
    with WorkerSupervisor() as sup:
        b = _node(sup)
        assert b.spec.boot_s > 0                  # measured, not modeled
        assert sup.healthy(b.handle)
        b.start(0.0)
        b.submit(np.arange(5), np.linspace(0.0, 0.05, 5), np.full(5, 8))
        b.drain(30)
        recs = b.completed_records()
        assert sorted(r.index for r in recs) == list(range(5))
        for r in recs:                            # trace-time coordinates
            assert 0.0 <= r.t_arrival <= r.t_done < 10.0
            assert r.error is None
        # reset gives the same process a fresh run: old records are gone
        b.reset_run()
        assert b.completed_records() == []
        b.close()
        b.close()                                 # double shutdown: no-op
        assert sup.reap() and not sup.handles


def test_live_worker_survives_poisoned_stream_and_reaccepts():
    """An oversized frame poisons the stream: the worker replies with an
    error and hangs up that connection — but the *process* survives and
    re-accepts, so a reconnect reaches the same runtime state."""
    with WorkerSupervisor() as sup:
        b = _node(sup)
        sock = b.handle.sock
        sock.sendall(struct.pack("!I", 64 * 1024 * 1024))
        reply = recv_frame(sock)
        assert reply["ok"] is False and "cap" in reply["error"]
        assert recv_frame(sock) is None           # worker hung up ...
        assert b.handle.alive()                   # ... but did not exit
        b.handle.reconnect()
        assert sup.healthy(b.handle)              # same process, fresh stream
        b.close()


def test_worker_error_reply_keeps_connection_alive():
    with WorkerSupervisor() as sup:
        b = _node(sup)
        reply = b._rpc({"op": "frobnicate"}, check=False)
        assert reply["ok"] is False and "unknown op" in reply["error"]
        assert sup.healthy(b.handle)              # still serving verbs
        b.close()


def test_duplicate_submit_is_idempotent():
    """A resubmitted window (reply lost, client retried) must not feed
    the same queries twice: the worker dedupes on the submit ``seq`` and,
    for seq-less rows, on the query ids themselves."""
    with WorkerSupervisor() as sup:
        b = _node(sup)
        sock = b.handle.sock
        from repro_torch.cluster.remote import _rpc as raw_rpc

        raw_rpc(sock, {"op": "start", "origin": time.monotonic()})
        frame = {"op": "submit", "q": [[0, 0.0, 4, -1], [1, 0.0, 4, -1]],
                 "seq": 1}
        first = raw_rpc(sock, frame)
        assert first["accepted"] == 2
        again = raw_rpc(sock, frame)              # the retried window
        assert again["ok"] and again["accepted"] == 0 and again["dup"]
        # a *new* seq carrying already-accepted qids: qid-level dedup
        qid_dup = raw_rpc(sock, {"op": "submit", "q": [[1, 0.0, 4, -1]],
                                 "seq": 2})
        assert qid_dup["accepted"] == 0
        raw_rpc(sock, {"op": "drain", "timeout": 30})
        recs = raw_rpc(sock, {"op": "poll", "cursor": 0})["records"]
        assert sorted(r[0] for r in recs) == [0, 1]   # each served once
        b.close()


def test_hung_rpc_deadline_retry_reconnect_recovers():
    """The full SUSPECT round-trip: an armed hang drives the ping past
    its deadline (socket scrapped, node suspect), the retry reconnects to
    the re-accepting process, and the verb lands — no query lost, no
    process restarted."""
    with WorkerSupervisor() as sup:
        b = _node(sup)
        pid = b.handle.pid
        b.rpc_timeout = 0.4           # deadline well under the 1.2s hang
        b._rpc({"op": "chaos", "mode": "hang", "seconds": 1.2}, retries=0)
        reply = b._rpc({"op": "ping"}, retries=4)
        assert reply["ok"] and reply["pid"] == pid    # same process
        assert not b.suspect          # cleared on the first success
        b.close()


def test_hung_rpc_exhausted_retries_marks_suspect():
    with WorkerSupervisor() as sup:
        b = _node(sup)
        b.rpc_timeout = 0.3
        b._rpc({"op": "chaos", "mode": "hang", "seconds": 30.0}, retries=0)
        with pytest.raises(WorkerCrashed, match="deadline"):
            b._rpc({"op": "ping"}, retries=0)
        assert b.suspect
        # verify() goes through the retry path's reconnect — but the
        # worker is still sleeping inside the hang, so a short deadline
        # keeps failing; the node stays suspect until the hang drains
        b.handle.proc.kill()
        b._killed = True              # closed via kill: skip graceful path


def test_garbled_reply_scraps_and_recovers():
    """An armed garble poisons the reply framing: the client sees a
    ProtocolError (absurd declared length), scraps the socket, and the
    retry's reconnect reaches the same process."""
    with WorkerSupervisor() as sup:
        b = _node(sup)
        pid = b.handle.pid
        b._rpc({"op": "chaos", "mode": "garble"}, retries=0)
        reply = b._rpc({"op": "ping"}, retries=2)
        assert reply["ok"] and reply["pid"] == pid
        b.close()


def test_dropped_reply_resubmit_not_double_fed():
    """An armed drop loses a submit's reply; the retry resubmits the same
    window over a fresh connection and the seq dedup makes it a no-op —
    every query still served exactly once."""
    with WorkerSupervisor() as sup:
        b = _node(sup)
        b.start(0.0)
        b._rpc({"op": "chaos", "mode": "drop"}, retries=0)
        b.submit(np.arange(4), np.zeros(4), np.full(4, 4))
        b.drain(30)
        recs = b.completed_records()
        assert sorted(r.index for r in recs) == [0, 1, 2, 3]
        b.close()


def test_supervisor_heal_respawns_within_budget():
    """heal() = reap + policy-budgeted respawn: a killed worker comes
    back as generation+1 with the same launch config; a corpse past the
    budget stays dead."""
    from repro_torch.cluster.remote import RestartPolicy

    with WorkerSupervisor(restart=RestartPolicy(max_restarts=2,
                                                backoff_s=0.0)) as sup:
        h = sup.spawn("pybusy:50", n_workers=1, batch_size=16,
                      max_bucket=64)
        os.kill(h.pid, signal.SIGKILL)
        h.proc.wait(timeout=10)
        healed = sup.heal()
        assert len(healed) == 1
        corpse, fresh = healed[0]
        assert corpse.pid == h.pid and fresh is not None
        assert fresh.generation == 1
        assert fresh.config == dict(n_workers=1, batch_size=16,
                                    max_bucket=64)
        assert sup.healthy(fresh)
        # exhaust the lineage budget: a generation-2 corpse is not revived
        fresh.generation = 2
        os.kill(fresh.pid, signal.SIGKILL)
        fresh.proc.wait(timeout=10)
        assert sup.heal() == [(fresh, None)]
        assert not sup.handles


def test_await_port_tolerates_stdout_noise():
    """A worker (or a library it imports) printing to stdout before the
    announce must not starve the rendezvous: a block-buffered pipe ships
    the noise and the announce in one chunk, which a select()-based
    reader would lose into its line buffer."""
    import subprocess
    import sys

    sup = WorkerSupervisor(spawn_timeout=10.0)
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "print('import-time noise'); print('REMOTE_WORKER_PORT=7')"],
        stdout=subprocess.PIPE)
    try:
        assert sup._await_port(proc) == 7
    finally:
        proc.wait(timeout=10)


def test_supervisor_reaps_sigkilled_zombie():
    with WorkerSupervisor() as sup:
        b = _node(sup)
        pid = b.handle.pid
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 10
        while b.handle.proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        dead = sup.reap()
        assert [h.pid for h in dead] == [pid]
        assert dead[0].proc.returncode == -signal.SIGKILL   # no zombie left
        assert not sup.handles
        assert not sup.healthy(dead[0])


# --------------------------------------------------- kill/re-route, fleet


def test_worker_crash_mid_query_orphans_rerouted_via_lifecycle():
    """A mid-run SIGKILL (the FleetFaults path: cancel_pending kills the
    real process) surrenders the victim's unfinished queries and the
    driver re-routes them to the survivor — none lost."""
    clock = WallClock()
    with WorkerSupervisor() as sup:
        # ~50ms/query of GIL-held python work against 20ms arrivals → the
        # victim is over capacity and has a queue when the kill lands
        backends = [_node(sup, index=i, iters=60000, service_s=5e-2,
                          clock=clock) for i in range(2)]
        times = np.linspace(0.0, 0.4, 40)
        sizes = np.full(40, 8, np.int64)
        faults = FleetFaults(kills=(NodeKill(0.2, "remote", 0),))
        try:
            r = drive_fleet(times, sizes, backends,
                            make_router("round_robin"), window_s=0.1,
                            fleet_faults=faults, drain_timeout=60)
            assert r.rerouted > 0
            assert r.dropped == 0 and r.n_queries == 40
            assert backends[0].handle.proc.returncode == -signal.SIGKILL
            with pytest.raises(RuntimeError, match="dead"):
                backends[0].submit(np.array([99]), np.array([0.9]),
                                   np.array([4]))
            with pytest.raises(WorkerCrashed):
                backends[0]._rpc({"op": "ping"})
            # the dead node's polled history + the survivor's records
            # partition the trace
            done = {rec.index for b in backends
                    for rec in b.completed_records()}
            assert done == set(range(40))
            assert [h.pid for h in sup.reap()] == [backends[0].handle.pid]
        finally:
            for b in backends:
                b.close()


def test_async_factory_orders_return_instantly():
    """Boot-ahead: an async factory order costs the caller microseconds —
    the ~1s process spawn happens in a background thread and the proxy
    promotes once the worker is actually serving."""
    with WorkerSupervisor() as sup:
        factory = RemoteBackendFactory("pybusy:50", sup,
                                       device=_canned_device(),
                                       batch_size=16, max_bucket=64,
                                       async_boot=True)
        spec = NodeSpec(cpu=_canned_device(), n_executors=1, batch_size=16,
                        request_overhead_s=0.0)
        fleet = Fleet([Pool("remote", spec, count=1)])
        view = fleet.node_views()[0]
        t0 = time.monotonic()
        b = factory(view, 0.0)
        assert time.monotonic() - t0 < 0.5        # no spawn stall inline
        try:
            assert b.wait_ready(60)               # resolves to a live proc
            assert b.handle.alive()
            assert factory.boot_history[0][0] == ("remote", 0)
            b.start(0.0)
            b.submit(np.array([0]), np.array([0.0]), np.array([4]))
            b.drain(30)
            assert len(b.completed_records()) == 1
        finally:
            b.close()
            factory.close()


def test_remote_crash_storm_self_heals_end_to_end():
    """The tentpole round-trip on real processes: a crash storm SIGKILLs
    a worker mid-trace, its orphans re-route to the survivor, and the
    SelfHealPolicy re-materializes the dead node through BOOTING — no
    query lost, the driver never stalls a full window on the respawn."""
    from repro_torch.cluster import ChaosPlan, NodeState, SelfHealPolicy
    from repro_torch.cluster.chaos import crash_storm

    clock = WallClock()
    with WorkerSupervisor() as sup:
        # ~200ms of GIL-held work per query against ~100ms per-node
        # arrivals: the victim is over capacity and has a queue when the
        # kill lands, so real orphans re-route
        factory = RemoteBackendFactory("pybusy:400000", sup,
                                       device=_canned_device(2e-1),
                                       batch_size=16, max_bucket=64,
                                       clock=clock, async_boot=True)
        spec = NodeSpec(cpu=_canned_device(2e-1), n_executors=1,
                        batch_size=16, request_overhead_s=0.0)
        fleet = Fleet([Pool("remote", spec, count=2)])
        plan = ChaosPlan(kills=crash_storm(0.5, "remote", [0]))
        times = np.linspace(0.0, 1.5, 30)
        sizes = np.full(30, 4, np.int64)
        try:
            r = drive_fleet(times, sizes, None, make_router("round_robin"),
                            window_s=0.25, fleet=fleet, factory=factory,
                            fleet_faults=plan,
                            self_heal=SelfHealPolicy(max_restarts=1,
                                                     backoff_s=0.0),
                            drain_timeout=60)
        finally:
            factory.close()
        assert r.dropped == 0 and r.rerouted > 0
        seq = [e.state for e in r.lifecycle
               if (e.pool, e.index_in_pool) == ("remote", 0)]
        i = seq.index(NodeState.DEAD)
        assert NodeState.BOOTING in seq[i:]       # the heal re-ordered it
        # the respawn must not have stalled the driver a whole window
        assert max(r.driver_stall_s()) < 0.25


def test_remote_backend_factory_boots_real_process():
    """The fleet-mode factory contract: factory(view, t0) spawns a genuine
    worker process and records its measured boot time."""
    with WorkerSupervisor() as sup:
        factory = RemoteBackendFactory("pybusy:50", sup,
                                       device=_canned_device(),
                                       batch_size=16, max_bucket=64)
        spec = NodeSpec(cpu=_canned_device(), n_executors=1, batch_size=16,
                        request_overhead_s=0.0)
        fleet = Fleet([Pool("remote", spec, count=1)])
        view = fleet.node_views()[0]
        b = factory(view, 0.0)
        try:
            assert b.handle.alive()
            assert factory.boot_history[0][0] == ("remote", 0)
            assert factory.boot_history[0][1] > 0
            b.start(0.0)
            b.submit(np.array([0]), np.array([0.0]), np.array([4]))
            b.drain(30)
            assert len(b.completed_records()) == 1
        finally:
            b.close()


# ------------------------------------------------------------ the mlp twin


@pytest.mark.parametrize("spec,size", [("mlp", 5), ("mlp:16:32:3", 7), ("mlp:8:4:1", 1)])
def test_mlp_twin_matches_the_reference(spec, size):
    """The same spec through the reference's jitted tanh MLP and the port's:
    the same weights from default_rng(0), the same template rows, outputs
    within rtol 1e-5 (float32 matrix products round in other orders)."""
    from repro.serve.remote import build_model as jax_build_model

    apply_fn, make_batch = build_model(spec, "cpu")
    jax_apply, jax_make_batch = jax_build_model(spec)
    batch = make_batch(size, -1)
    np.testing.assert_array_equal(batch["x"], jax_make_batch(size, -1)["x"])
    got = apply_fn({"x": torch.from_numpy(batch["x"])})
    want = np.asarray(jax_apply(jax_make_batch(size, -1)))
    assert got.shape == want.shape == (size,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    # distinct rows give distinct outputs through the same weights
    x = np.random.default_rng(3).normal(size=(4, batch["x"].shape[1])).astype(np.float32)
    np.testing.assert_allclose(apply_fn({"x": torch.from_numpy(x)}).numpy(),
                               np.asarray(jax_apply({"x": x})), rtol=1e-5, atol=1e-6)


def test_worker_asked_for_the_card_without_one_raises():
    """No fallback: without a card, a worker that was not told the CPU
    raises before it builds a model, and the mlp builder raises too."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.serve.remote import serve_worker
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_worker("pybusy:10")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("mlp:8:8:1")
