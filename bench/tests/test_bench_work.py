"""The frozen counts at small shapes worked out by hand, and the readings
that divide them."""
import numpy as np
import pytest
import torch

from bench.harness.context import Run
from bench.harness.trace import Trace, read_events
from bench.traffic.bulk import distinct_rows
from bench.work import counts

HBM, TF32 = 3.35e12, 494.7e12


def test_peaks():
    assert counts.PEAKS["tf32_flops_per_s"] == TF32
    assert counts.PEAKS["hbm_bytes_per_s"] == HBM
    assert counts.bound_s(TF32, 0) == 1.0 and counts.bound_s(0, HBM) == 1.0


def test_k1_by_hand():
    # 4 bags of 3 ids into rows of 2, 5 distinct rows: 24 adds; 48 B of ids,
    # 40 B of rows, 32 B of pooled output
    assert counts.k1(4, 3, 2, 5) == (24.0, 120.0)


def test_k2_by_hand():
    # B = 2, F = 3, D = 4: 3 pairs of 8 FLOPs a sample; 96 B in, 24 B out
    assert counts.k2(2, 3, 4) == (48.0, 120.0)


def test_k3_by_hand():
    # B = 2, F = 3, H = 4, N = 5, D = 6: M = 12, K = 12
    assert counts.k3(2, 3, 4, 5, 6) == (2 * 12 * 12 * 5, (36 + 48 + 60 + 60) * 4)


def test_k3_bwd_by_hand():
    assert counts.k3_bwd(2, 3, 4, 5, 6) == (4 * 12 * 12 * 5 + 5 * 12 * 12,
                                             (60 + 2 * (36 + 48 + 60)) * 4)


XDEEPFM = {"interaction": "cin", "n_tables": 39, "embed_dim": 10, "hotness": 1,
           "cin_layers": [200, 200, 200], "dnn_widths": [400, 400]}
RMC2 = {"interaction": "dot", "n_tables": 40, "embed_dim": 32, "hotness": 80, "n_dense": 256,
        "dense_fc": [256, 128, 32], "predict_fc": [512, 128, 1]}


def test_model_flops():
    cin = 2 * 10 * 200 * (39 * 39 + 2 * 200 * 39)          # 68.48 MFLOP
    head = 2 * 600 + 2 * (390 * 400 + 400 * 400 + 400)
    assert counts.forward_flops(XDEEPFM) == 390 + cin + head + 2 * 390
    bottom = 2 * (256 * 256 + 256 * 128 + 128 * 32)
    top = 2 * (852 * 512 + 512 * 128 + 128)
    assert counts.forward_flops(RMC2) == 40 * 80 * 32 + bottom + 820 * 64 + top
    fwd = counts.forward_flops(XDEEPFM)
    bwd_cin = sum(counts.k3_bwd(1, 39, h, 200, 10)[0] for h in (39, 200, 200))
    assert counts.train_flops(XDEEPFM) == fwd + 2 * (fwd - cin) + bwd_cin


def test_k3_bound_is_compute_bound_at_published_width():
    flops = counts.k3(262144, 39, 200, 200, 10)[0]
    assert counts.k3_bound_s(XDEEPFM, 262144) > flops / TF32
    assert counts.k3_bound_s(XDEEPFM, 1) == pytest.approx(
        sum(counts.bound_s(*counts.k3(1, 39, h, 200, 10)) for h in (39, 200, 200)))


def test_distinct_rows():
    sparse = torch.tensor([[[0, 1], [0, 0]], [[1, 1], [2, 0]]], dtype=torch.int32)
    # table 0: rows {0, 1}; table 1: rows {0, 2}
    assert distinct_rows(sparse, vocab=3) == 4


class _Ev:
    def __init__(self, name, dev, start, dur, corr=0):
        from torch.autograd import DeviceType
        self._n, self._d = name, DeviceType.CUDA if dev else DeviceType.CPU
        self._s, self._u, self._c = start, dur, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c


def test_trace_union_gaps_and_lost_records():
    evs = [_Ev("k_a", 1, 1_000, 10_000, 1), _Ev("k_b", 1, 5_000, 10_000, 2),
           _Ev("k_a", 1, 40_000, 10_000, 3),
           _Ev("aten::copy_", 0, 14_000, 30_000), _Ev("outer", 0, 0, 100_000),
           _Ev("cudaLaunchKernel", 0, 0, 100, 1), _Ev("cudaLaunchKernel", 0, 0, 100, 9)]
    tr = read_events(evs, window_s=1e-4)
    assert tr.busy_s == pytest.approx(24e-6)               # [1, 15) and [40, 50) µs
    assert tr.idle_gaps == [("aten::copy_", pytest.approx(25e-6))]
    assert tr.kernel_records_lost == 1
    assert tr.seconds(("k_a",)) == pytest.approx(20e-6)
    assert tr.device_ops()[0] == ["k_a", pytest.approx(20e-6)]
    assert read_events([_Ev("aten::mm", 0, 0, 5)], 1.0) is None


def test_run_readings():
    tr = Trace(window_s=2.0, names=["cin_layer_kernel<float>"], dur_s=np.array([0.5]),
               busy_s=0.5, idle_gaps=[], kernel_records_lost=0)
    run = Run(trace=tr, work={"k3_bound_s": 0.1, "model_flops": TF32 * 0.2})
    assert run.roofline_share("k3_bound_s", ("cin_layer_kernel",)) == pytest.approx(20.0)
    assert run.roofline_share("k1_bound_s", ("embedding_bag_kernel",)) is None
    assert run.mfu() == pytest.approx(10.0)
    assert run.idle_share() == pytest.approx(75.0)
    assert Run().mfu() is None and Run().idle_share() is None
