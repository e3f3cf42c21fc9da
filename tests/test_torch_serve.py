"""The port's serving runtime on the CPU (device="cpu"): the cases of
tests/test_serve.py against repro_torch.serve, plus the port's own
guarantees — t_done is stamped after apply_fn returned, requests reach
apply_fn as tensors on the runtime's device, a failing apply_fn cannot
deadlock drain()."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import scheduler as jax_scheduler
from repro.serve import batching as jax_batching
from repro_torch.core import query_gen
from repro_torch.core.scheduler import BATCH_LADDER, THRESHOLD_LADDER
from repro_torch.serve.batching import bucket_for, bucket_ladder, pad_batch, slice_result
from repro_torch.serve.runtime import (OffloadController, OnlineController, PacedFeeder,
                                       ServingRuntime, to_device)


def _ones(n: int, d: int = 4) -> np.ndarray:
    return np.ones((n, d), np.float32)


def _runtime(batch_size=32, n_workers=2):
    w = torch.ones((4, 1)) * 0.5

    def apply_fn(batch):
        return batch["x"] @ w

    return ServingRuntime(apply_fn, n_workers=n_workers, batch_size=batch_size, device="cpu")


@pytest.mark.parametrize("size,max_bucket", [
    (1, 1024), (2, 1024), (3, 1024), (64, 1024), (65, 1024), (1024, 1024),
    (1025, 1024), (5000, 1024), (5, 4),
])
def test_bucketing_equals_the_reference(size, max_bucket):
    assert bucket_for(size, max_bucket) == jax_batching.bucket_for(size, max_bucket)


def test_bucket_ladder_and_knob_ladders_equal_the_reference():
    assert bucket_ladder(1024) == jax_batching.bucket_ladder(1024) == [2 ** i for i in range(11)]
    assert bucket_ladder(6) == [1, 2, 4]
    assert BATCH_LADDER == jax_scheduler.BATCH_LADDER
    assert THRESHOLD_LADDER == jax_scheduler.THRESHOLD_LADDER


def test_pad_and_slice_roundtrip():
    b = {"x": np.arange(6.0).reshape(3, 2)}
    p = pad_batch(b, 8)
    assert p["x"].shape == (8, 2)
    np.testing.assert_array_equal(p["x"][3:], np.broadcast_to(b["x"][:1], (5, 2)))  # row 0 repeats
    out = slice_result(p, 3)
    np.testing.assert_array_equal(out["x"], b["x"])
    q = pad_batch(b, 3)                    # exact fit: no copy, same object
    assert q["x"] is b["x"]
    b2 = {"x": np.ones((5, 2)), "y": np.zeros((5,))}
    p2 = pad_batch(b2, 8)
    assert p2["x"].shape == (8, 2) and p2["y"].shape == (8,)
    out2 = slice_result(p2, 5)
    assert out2["x"].shape == (5, 2) and out2["y"].shape == (5,)
    assert slice_result([torch.ones(4), (torch.ones(4, 2),)], 2)[1][0].shape == (2, 2)


def test_pad_batch_rejects_oversize():
    with pytest.raises(ValueError, match="split oversize"):
        pad_batch({"x": np.ones((9, 2))}, 8)


def test_pad_batch_keeps_leaf_kind():
    """numpy leaves are padded on the host and stay numpy; tensors stay tensors."""
    p = pad_batch({"x": np.ones((3, 2), np.float32)}, 8)
    assert isinstance(p["x"], np.ndarray) and p["x"].shape == (8, 2)
    q = pad_batch({"x": torch.arange(6.0).reshape(3, 2)}, 8)
    assert isinstance(q["x"], torch.Tensor) and q["x"].shape == (8, 2)
    assert torch.equal(q["x"][3:], q["x"][:1].expand(5, 2))


def test_to_device_moves_every_leaf():
    out = to_device({"a": np.arange(3, dtype=np.int32), "m": np.array([True, False]),
                     "t": torch.ones(2)}, torch.device("cpu"))
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    assert out["a"].dtype == torch.int32 and out["m"].dtype == torch.bool


def test_submit_rejects_zero_size():
    rt = _runtime()
    try:
        with pytest.raises(ValueError, match="size"):
            rt.submit(0, {"x": _ones(0)}, 0)
    finally:
        rt.shutdown()


def test_runtime_splits_oversize_when_knob_exceeds_bucket():
    rt = _runtime(batch_size=64)
    rt.max_bucket = 16
    try:
        rt.submit(0, {"x": _ones(50)}, 50)      # → ⌈50/16⌉ requests
        rt.drain(timeout=60)
        recs = rt.completed()
        assert len(recs) == 1 and recs[0].latency_ms > 0
    finally:
        rt.shutdown()


def test_runtime_completes_queries():
    rt = _runtime()
    try:
        rng = np.random.default_rng(0)
        for qid in range(20):
            size = int(rng.integers(1, 200))
            rt.submit(qid, {"x": _ones(size)}, size)
        rt.drain(timeout=60)
        recs = rt.completed()
        assert len(recs) == 20 and rt.n_completed == 20 and rt.n_pending == 0
        assert all(r.latency_ms > 0 and r.error is None for r in recs)
        assert len(rt.completed_log(5)) == 15
    finally:
        rt.shutdown()


def test_runtime_splits_by_batch_size_and_pads_to_buckets():
    seen = []

    def apply_fn(batch):
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
        seen.append(batch["x"].shape[0])
        return batch["x"].sum()

    rt = ServingRuntime(apply_fn, n_workers=1, batch_size=16, device="cpu")
    try:
        rt.submit(0, {"x": _ones(100)}, 100)   # → 6 requests of 16 and one of 4
        rt.drain(timeout=60)
        assert len(rt.completed()) == 1
        assert sorted(seen) == [4] + [16] * 6
    finally:
        rt.shutdown()


def test_t_done_is_stamped_after_apply_fn_returned():
    returned = []

    def apply_fn(batch):
        time.sleep(0.05)
        returned.append(time.monotonic())
        return batch["x"]

    rt = ServingRuntime(apply_fn, n_workers=1, batch_size=32, device="cpu")
    try:
        rt.submit(0, {"x": _ones(8)}, 8)
        rt.drain(timeout=30)
        rec = rt.record(0)
        assert rec.t_done >= returned[0] and rec.t_started >= rec.t_arrival
        assert rec.latency_ms >= 50.0
    finally:
        rt.shutdown()


def test_worker_error_surfaces_and_drain_completes():
    calls = []

    def apply_fn(batch):
        calls.append(batch["x"].shape[0])
        if len(calls) == 1:
            raise RuntimeError("boom")
        return batch["x"].sum()

    rt = ServingRuntime(apply_fn, n_workers=1, batch_size=32, device="cpu")
    try:
        rt.submit(0, {"x": _ones(8, 2)}, 8)
        rt.drain(timeout=30)                     # must not deadlock
        rt.submit(1, {"x": _ones(8, 2)}, 8)
        rt.drain(timeout=30)                     # worker still alive
        bad, good = rt.record(0), rt.record(1)
        assert bad.t_done > 0 and "boom" in bad.error
        assert good.t_done > 0 and good.error is None
    finally:
        rt.shutdown()


def test_runtime_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingRuntime(lambda b: b)


def test_counters_hold_under_many_workers():
    """More workers than cores, short switch interval: no completion is lost."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    rt = _runtime(batch_size=8, n_workers=16)
    try:
        for qid in range(200):
            rt.submit(qid, {"x": _ones(20)}, 20)
        rt.drain(timeout=60)
        assert rt.n_completed == 200 and len(rt.take_completed()) == 200
        assert rt.n_pending == 0
    finally:
        sys.setswitchinterval(old)
        rt.shutdown()


def test_online_controller_steps_down_on_sla_violation():
    rt = _runtime(batch_size=64)
    ctl = OnlineController(rt, sla_ms=0.0001, window=5)   # impossible SLA
    try:
        for qid in range(10):
            rt.submit(qid, {"x": _ones(64)}, 64)
        rt.drain(timeout=60)
        ctl.step()
        assert rt.batch_size < 64
    finally:
        rt.shutdown()


def test_online_controller_steps_up_when_headroom():
    rt = _runtime(batch_size=16)
    ctl = OnlineController(rt, sla_ms=1e6, window=5)
    try:
        for qid in range(10):
            rt.submit(qid, {"x": _ones(16)}, 16)
        rt.drain(timeout=60)
        ctl.step()
        assert rt.batch_size > 16
    finally:
        rt.shutdown()


def _fed_controller(batch_size, sla_ms, ladder=None):
    rt = _runtime(batch_size=batch_size)
    kwargs = {} if ladder is None else {"ladder": ladder}
    ctl = OnlineController(rt, sla_ms=sla_ms, window=5, **kwargs)
    for qid in range(6):
        rt.submit(qid, {"x": _ones(8)}, 8)
    rt.drain(timeout=60)
    return rt, ctl


def test_online_controller_snaps_off_ladder_knob():
    rt, ctl = _fed_controller(batch_size=48, sla_ms=1e6)   # 48 ∉ ladder
    try:
        ctl.step()
        assert rt.batch_size in ctl.ladder
        assert rt.batch_size == 64           # snapped to 32|64, headroom → up
    finally:
        rt.shutdown()


def test_online_controller_clamps_at_ladder_ends():
    rt, ctl = _fed_controller(batch_size=1, sla_ms=1e-6)
    try:
        ctl.step()
        assert rt.batch_size == 1
    finally:
        rt.shutdown()
    rt, ctl = _fed_controller(batch_size=16, sla_ms=1e6, ladder=(4, 8, 16))
    try:
        ctl.step()
        assert rt.batch_size == 16
    finally:
        rt.shutdown()


def test_online_controller_holds_inside_hysteresis_band():
    rt, ctl = _fed_controller(batch_size=16, sla_ms=1.0)
    try:
        done = rt.completed()
        p95 = float(np.percentile([r.latency_ms for r in done], 95))
        ctl.sla_ms = p95 / 0.85                # 0.7×SLA < p95 < SLA
        ctl.step()
        assert rt.batch_size == 16
        assert ctl.history and ctl.history[-1][0] == 16
    finally:
        rt.shutdown()


def test_online_controller_reads_an_all_error_window_as_a_breach():
    def apply_fn(batch):
        raise RuntimeError("down")

    rt = ServingRuntime(apply_fn, n_workers=1, batch_size=16, device="cpu")
    ctl = OnlineController(rt, sla_ms=1e6, window=5)
    try:
        for qid in range(6):
            rt.submit(qid, {"x": _ones(8)}, 8)
        rt.drain(timeout=30)
        ctl.step()
        assert rt.batch_size == 8 and ctl.history[-1][1] == float("inf")
    finally:
        rt.shutdown()


def test_offload_controller_breach_steps_toward_unloaded_path():
    ctl = OffloadController(sla_ms=100.0, threshold=300)
    assert ctl.step(250.0, cpu_queue_p99_ms=80.0, acc_queue_p99_ms=5.0) == 200
    assert ctl.step(250.0, cpu_queue_p99_ms=5.0, acc_queue_p99_ms=80.0) == 300
    assert [h[0] for h in ctl.history] == [200, 300]


def test_offload_controller_headroom_drifts_to_prefer():
    ctl = OffloadController(sla_ms=100.0, threshold=300)
    ctl.threshold = 50
    assert ctl.step(10.0, 0.0, 0.0) == 100
    assert ctl.step(10.0, 0.0, 0.0) == 150
    ctl.threshold = 700
    assert ctl.step(10.0, 0.0, 0.0) == 450


def test_offload_controller_holds_on_nan_and_mid_band():
    ctl = OffloadController(sla_ms=100.0, threshold=300)
    assert ctl.step(float("nan"), 1.0, 1.0) == 300
    assert ctl.step(80.0, 50.0, 1.0) == 300
    assert ctl.step(250.0, float("nan"), float("nan")) == 200


def test_offload_controller_snaps_and_clamps():
    assert OffloadController(sla_ms=1.0, threshold=None).threshold == 1001
    assert OffloadController(sla_ms=1.0, threshold=333).threshold == 300
    ctl = OffloadController(sla_ms=100.0, threshold=1)
    assert ctl.step(500.0, 10.0, 0.0) == 1
    ctl2 = OffloadController(sla_ms=100.0, threshold=1001)
    assert ctl2.step(500.0, 0.0, 10.0) == 1001


def test_paced_feeder_releases_in_order_and_stops():
    released, errors = [], []
    gate = threading.Event()

    def release(qid, size, mid):
        if qid == 1:
            raise RuntimeError("refused")
        released.append((qid, size, mid))
        if qid == 2:
            gate.set()

    t0 = time.monotonic()
    feeder = PacedFeeder(lambda t: t0 + t, release, on_error=lambda q, e: errors.append(q))
    for qid, t in enumerate((0.0, 0.01, 0.02)):
        feeder.put(t, qid, 10 + qid, 0)
    assert gate.wait(timeout=10)
    feeder.put(60.0, 3, 13, 0)                   # far future: stop() must not wait for it
    feeder.stop(timeout=5)
    assert released == [(0, 10, 0), (2, 12, 0)] and errors == [1]
    assert not feeder._thread.is_alive()


def test_query_stream_equals_the_reference():
    from repro.core import query_gen as jax_query_gen
    ours = query_gen.query_stream(3, qps=50.0, size_dist=query_gen.PRODUCTION)
    theirs = jax_query_gen.query_stream(3, qps=50.0, size_dist=jax_query_gen.PRODUCTION)
    for _ in range(2000):                         # crosses a chunk boundary
        a, b = next(ours), next(theirs)
        assert (a.qid, a.arrival, a.size) == (b.qid, b.arrival, b.size)
