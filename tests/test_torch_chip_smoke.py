"""The checks of ``chip_smoke.py`` can fail: K4's tolerance, scaled to the
plain result, refuses a kernel that zeroes its output or drops a run of
slots at the main path's cache lengths (decode_32k's and lm_generate's), the library attention the LM phases
use as a witness computes the plain version's function, and the logits gate
refuses a far reading or a control it could not tell apart.  Run on the CPU
with plain versions standing in for the kernel."""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

T = 32_768                                     # LM_SHAPES["decode_32k"].seq_len


def _inputs(dtype, b=1, hq=14, hkv=2, d=64, t=T, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_compare_passes_the_plain_version(dtype):
    q, k, v = _inputs(dtype)
    pos = torch.tensor([T], dtype=torch.int32)
    want = ref.decode_attention(q, k, v, pos)
    assert chip_smoke.decode_compare("same", want.clone(), want) == 0.0


@pytest.mark.parametrize("fault", ["zeros", "drop_256_slots", "drop_one_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_compare_refuses_a_broken_kernel_at_a_long_cache(dtype, fault):
    q, k, v = _inputs(dtype)
    pos = torch.tensor([T], dtype=torch.int32)
    want = ref.decode_attention(q, k, v, pos)
    assert float(want.abs().max()) < 0.1        # every output far below the sweep's atol
    bad = {"zeros": lambda: torch.zeros_like(want),
           "drop_256_slots": lambda: ref.decode_attention(q, k, v, pos - 256),
           "drop_one_tile": lambda: ref.decode_attention(q, k, v, pos - 64)}[fault]()
    with pytest.raises(SystemExit, match="outside"):
        chip_smoke.decode_compare(fault, bad, want)


@pytest.mark.parametrize("fault", ["drop_last_run", "drop_one_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_compare_refuses_a_dropped_run_at_lm_generate(dtype, fault):
    """At lm_generate's shape (B = 8, 1,024 slots, pos 528), a kernel that
    loses the last run of K4's plan (pos - run_slots) or a tile is refused."""
    from repro_torch.kernels import decode_attention as da
    b, t, p = chip_smoke.GEN_BATCH, chip_smoke.GEN_CACHE, chip_smoke.GEN_PROMPT + 16
    q, k, v = _inputs(dtype, b=b, t=t)
    run = da.plan(b, 2, t, 64, q.element_size(), 132).run_slots
    pos = torch.full((b,), p, dtype=torch.int32)
    want = ref.decode_attention(q, k, v, pos)
    drop = {"drop_last_run": run, "drop_one_tile": da.tile_slots(64, q.element_size())}[fault]
    with pytest.raises(SystemExit, match="outside"):
        chip_smoke.decode_compare(fault, ref.decode_attention(q, k, v, pos - drop), want)


@pytest.mark.parametrize("b,hq,hkv,d,t", [(3, 14, 2, 64, 100), (2, 8, 8, 16, 33)])
def test_library_decode_is_the_plain_function(b, hq, hkv, d, t):
    q, k, v = _inputs(torch.float32, b, hq, hkv, d, t, seed=1)
    pos = torch.tensor([1, t, t // 2][:b], dtype=torch.int32)
    torch.testing.assert_close(chip_smoke.library_decode(q, k, v, pos),
                               ref.decode_attention(q, k, v, pos), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel_l2,control_l2,passes", [
    (0.02, 1.2, True),       # bf16 noise, zeroed attention far off: as read on the card
    (0.2, 1.2, False),       # the kernel path's logits too far from the plain path's
    (0.02, 0.05, False),     # a zeroed attention the gate would not see
    (0.069, 1.419, True),    # an MoE LM's worst step, routing flips included: as read on the card
    (0.069, 0.09, False),    # ... with a zeroed attention the gate would not see
])
def test_logits_gate(kernel_l2, control_l2, passes):
    run = lambda: chip_smoke.gate_logits("step", {"l2_rel": kernel_l2}, {"l2_rel": control_l2})
    if passes:
        run()
    else:
        with pytest.raises(SystemExit):
            run()


def test_one_pass_tf32_witness_computes_the_cin_layer():
    """K3's witness is the CIN layer (on the CPU TF32 does not apply, so it
    is the float32 product): same function, same (B, N, D) layout."""
    rng = np.random.default_rng(4)
    x0, xk = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((3, 5, 10), (3, 7, 10)))
    w = torch.from_numpy(rng.normal(size=(35, 6)).astype(np.float32))
    torch.testing.assert_close(chip_smoke.one_pass_tf32(x0, xk, w), ref.cin_layer(x0, xk, w),
                               rtol=1e-5, atol=1e-5)
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cin_float64_bound_is_wider_than_a_float32_sum():
    """The 3xTF32 bound's factor at K = 7,800: the per-term split error
    (13·2^-24) plus gamma_4K at u = 2^-23, above the float32 recursive
    sum's gamma_{K+1} at u = 2^-24."""
    k = 7800
    c = chip_smoke.cin_float64_bound(k)
    u = 2.0 ** -24
    assert (k + 1) * u / (1 - (k + 1) * u) < c < 4 * k * 2 * u / (1 - 4 * k * 2 * u) + 1e-6


@pytest.mark.parametrize("fault", ["zero", "negative", "nan", "inf", "missing_bucket",
                                   "extra_bucket"])
def test_sched_curve_check_refuses_a_bad_curve(fault):
    ms = {b: 0.5 + 0.01 * b for b in chip_smoke.BUCKETS}
    chip_smoke.check_curve("good", dict(ms))
    if fault == "missing_bucket":
        del ms[64]
    elif fault == "extra_bucket":
        ms[2048] = 30.0
    else:
        ms[16] = {"zero": 0.0, "negative": -1.0, "nan": float("nan"), "inf": float("inf")}[fault]
    with pytest.raises(SystemExit, match="FAILED"):
        chip_smoke.check_curve(fault, ms)


@pytest.mark.parametrize("ms,flag", [({1: 0.3, 4: 0.3, 16: 0.5}, True),
                                     ({1: 0.33, 4: 2.71, 16: 1.92}, False)])
def test_sched_flags_a_curve_that_is_not_monotone(ms, flag):
    assert chip_smoke.monotone(ms) is flag


@pytest.mark.parametrize("named", [False, True])
def test_sched_writes_its_curves_where_the_caller_names(named, tmp_path, monkeypatch):
    """A run of the script never rewrites the committed curve files."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if named:
        monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
        assert chip_smoke.sched_artifacts() == tmp_path
    else:
        monkeypatch.delenv("REPRO_ARTIFACTS", raising=False)
        assert chip_smoke.sched_artifacts() == chip_smoke.Path(repo) / "build" / "artifacts"


class _Run:
    """What ``probe_ladder`` reads of a run: the SLA verdict and the rate."""

    def __init__(self, ok: bool, qps: float):
        self.ok, self.qps = ok, qps

    def meets(self, sla_ms: float) -> bool:
        return self.ok


@pytest.mark.parametrize("flaky", [False, True])
def test_live_probe_keeps_the_highest_passing_rung_and_probes_a_failure_once_more(flaky):
    """Rungs up to 300 pass; 300 fails its first probe when ``flaky``: the
    probe still keeps 300, and each rung above is probed exactly twice."""
    calls = []

    def run_at(rate):
        calls.append(rate)
        ok = rate <= 300 and not (flaky and rate == 300 and calls.count(300) == 1)
        return _Run(ok, rate)

    grid = [100.0, 200.0, 300.0, 400.0, 500.0]
    assert chip_smoke.probe_ladder(grid, run_at, 400.0) == 300.0
    assert calls.count(500.0) == calls.count(400.0) == 2
    assert calls.count(300.0) == (2 if flaky else 1)
    assert 100.0 not in calls                       # the top passing rung ends the probe


def test_live_probe_refuses_a_run_that_does_not_sustain_its_rate():
    grid = [100.0, 200.0]
    got = chip_smoke.probe_ladder(grid, lambda rate: _Run(True, 0.5 * rate), 400.0)
    assert got == 0.0


@pytest.mark.parametrize("ratio", [0.0, float("nan"), 0.4, 2.5, float("inf")])
def test_live_ratio_gate_refuses_a_twin_of_another_machine(ratio):
    with pytest.raises(SystemExit, match="ratio"):
        chip_smoke.check_ratio(ratio)


@pytest.mark.parametrize("ratio", [1.0, 0.5, 2.0, 0.8])
def test_live_ratio_gate_passes_a_twin_of_the_same_machine(ratio):
    chip_smoke.check_ratio(ratio)


@pytest.mark.parametrize("off", [-1, 1])
def test_live_launch_check_refuses_an_off_by_one_count(off):
    per = {"card": {"embedding_bag": 1, "dot_interaction": 1}}
    good = {"embedding_bag": 7, "dot_interaction": 7, "cin_layer": 0, "decode_attention": 0,
            "embedding_bag_backward": 0, "dot_interaction_backward": 0, "cin_layer_backward": 0}
    chip_smoke.check_launches("run", good, per, {"card": 7})
    bad = dict(good, dot_interaction=7 + off)
    with pytest.raises(SystemExit, match="launched"):
        chip_smoke.check_launches("run", bad, per, {"card": 7})


# ------------------------------------------------------------ the train gate


def _train_step(arch: str = chip_smoke.TRAIN_ARCH):
    """DLRM-RMC2's smoke config (or ``arch``'s) on the CPU: 64 samples of
    Zipf ids over 100 rows a table, so rows repeat within bags and across
    them."""
    from repro_torch import configs
    from repro_torch.data import synthetic as syn
    from repro_torch.models import recsys
    cfg = configs.get(arch).smoke_config
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in syn.recsys_batch(np.random.default_rng(0), cfg, 64).items()}
    return (lambda p, b: recsys.loss_fn(p, cfg, b)), params, batch


def _k1_bwd_writes_instead_of_adding(grad, idx, vocab, mode="sum"):
    """A K1-bwd that writes where it should add: of the lookups that share a
    row, one lookup's gradient survives."""
    b, f, h = idx.shape
    d = grad.shape[-1]
    rows = (idx.long() + torch.arange(f)[None, :, None] * vocab).reshape(-1)
    out = torch.zeros((f * vocab, d), dtype=grad.dtype)
    out[rows] = grad[:, :, None, :].expand(b, f, h, d).reshape(-1, d)
    return out.view(f, vocab, d)


def _k2_bwd_without_the_transpose(grad, feats):
    """A K2-bwd that forgets the Sᵀ half: S·X alone."""
    b, f, _ = feats.shape
    s = torch.zeros((b, f * f), dtype=grad.dtype)
    s[:, torch.from_numpy(ref.tril_pairs(f))] = grad
    return torch.bmm(s.view(b, f, f), feats)


def _k3_bwd_without_dxk(g, x0, xk, w):
    """A K3-bwd that leaves out xk's gradient: the first layer's x0 then
    gets half its gradient, the later layers' inputs none."""
    dx0, dxk, dw = ref.cin_layer_backward(g, x0, xk, w)
    return dx0, torch.zeros_like(dxk), dw


def test_train_gradient_gate_passes_xdeepfm_through_its_cin():
    """xDeepFM's smoke step on the CPU (K3 and K3-bwd's plain versions)
    passes against the float64 plain step; two CIN layers a step."""
    from repro_torch import configs
    loss_fn, params, batch = _train_step(chip_smoke.TRAIN_CIN_ARCH)
    _, got = chip_smoke.step_grads(loss_fn, params, batch)
    with chip_smoke.plain_backward():
        _, want = chip_smoke.step_grads(loss_fn, params, batch)
    assert chip_smoke.check_train_grads("cpu", got, want) < 1e-6
    cfg = configs.get(chip_smoke.TRAIN_CIN_ARCH).config
    assert chip_smoke.train_launches(cfg) == {
        "embedding_bag": 1, "embedding_bag_backward": 1, "dot_interaction": 0,
        "dot_interaction_backward": 0, "cin_layer": 3, "cin_layer_backward": 3}


def test_train_gradient_gate_passes_the_port_and_refuses_no_launch():
    """The port's step on the CPU (the plain forward, the plain backward in
    float32) passes against the float64 plain step, and neither launches."""
    from repro_torch.kernels import ops
    loss_fn, params, batch = _train_step()
    ops.reset_launch_counts()
    _, got = chip_smoke.step_grads(loss_fn, params, batch)
    with chip_smoke.plain_backward():
        _, want = chip_smoke.step_grads(loss_fn, params, batch)
    assert chip_smoke.check_train_grads("cpu", got, want) < 1e-6
    assert set(ops.launch_counts().values()) == {0}
    assert float(want["['tables']"].abs().max()) > 0


@pytest.mark.parametrize("fault", ["k1_bwd", "k2_bwd", "k3_bwd"])
def test_train_gradient_gate_refuses_a_broken_backward(fault):
    loss_fn, params, batch = _train_step(chip_smoke.TRAIN_CIN_ARCH if fault == "k3_bwd"
                                         else chip_smoke.TRAIN_ARCH)
    with chip_smoke.plain_backward():
        _, want = chip_smoke.step_grads(loss_fn, params, batch)
    broken = {"k1_bwd": _k1_bwd_writes_instead_of_adding,
              "k2_bwd": _k2_bwd_without_the_transpose,
              "k3_bwd": _k3_bwd_without_dxk}[fault]
    with chip_smoke.plain_backward(**{fault: broken}):
        _, bad = chip_smoke.step_grads(loss_fn, params, batch)
    with pytest.raises(SystemExit, match="outside"):
        chip_smoke.check_train_grads("broken", bad, want)


def test_k3_bwd_checks_reach_the_data_gradient_whole_and_in_runs():
    """The kernel checks take K3-bwd through both ways its data kernel
    stores dx0: at each of xDeepFM's layer shapes some batch cuts the data
    gradient into runs of h and some, train_batch's 65,536 among them,
    leaves it whole; a whole one is also held against the float32 plain
    backward."""
    from repro_torch import configs
    from repro_torch.kernels import cin
    d = configs.get("xdeepfm").config.embed_dim
    assert configs.RECSYS_SHAPES["train_batch"].batch in chip_smoke.CIN_BWD_BATCHES
    for f, h, hn in chip_smoke.xdeepfm_cin_shapes():
        splits = {b: cin.backward_plan(b, f, h, hn, d).data_splits
                  for b in chip_smoke.CIN_BWD_BATCHES}
        assert max(splits.values()) > 1
        assert splits[configs.RECSYS_SHAPES["train_batch"].batch] == 1
        assert any(s == 1 and b <= chip_smoke.CIN_BWD_PLAIN_MAX for b, s in splits.items())


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_cin_backward_float64_in_chunks_is_the_whole_pass(chunk):
    """The float64 reference the K3-bwd checks use at train_batch, taken a
    few samples at a time, is the whole float64 backward, and its second
    half that of the inputs' magnitudes."""
    rng = np.random.default_rng(4)
    b, f, h, n, d = 7, 3, 4, 5, 2
    g, x0, xk = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((b, n, d), (b, f, d), (b, h, d)))
    w = torch.from_numpy(rng.standard_normal((h * f, n)).astype(np.float32))
    exact, mag = chip_smoke.cin_backward_float64(g, x0, xk, w, chunk=chunk)
    want = ref.cin_layer_backward(g.double(), x0.double(), xk.double(), w.double())
    want_mag = ref.cin_layer_backward(g.double().abs(), x0.double().abs(),
                                      xk.double().abs(), w.double().abs())
    for a, e in zip(exact + mag, want + want_mag):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lost", [0, 1, 3])
def test_a_step_profile_counts_the_kernel_records_its_trace_lost(lost):
    """Each launch call on the host (runtime or driver) whose correlation id
    no device record carries is one kernel record lost; copies, aten ops
    and kernels without a launch call count nothing."""
    from types import SimpleNamespace as E
    from torch.autograd import DeviceType
    names = ["cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC", "cuLaunchKernel"]
    events = [E(id=i, device_type=DeviceType.CPU, name=names[i % 4]) for i in range(10)]
    events += [E(id=i, device_type=DeviceType.CUDA, name=f"kernel_{i}") for i in range(lost, 10)]
    events += [E(id=20, device_type=DeviceType.CPU, name="cudaMemcpyAsync"),
               E(id=3, device_type=DeviceType.CPU, name="aten::mm"),
               E(id=21, device_type=DeviceType.CUDA, name="Memcpy HtoD")]
    assert chip_smoke.lost_kernel_records(events) == lost


@pytest.mark.parametrize("off", [-1, 1])
def test_train_launch_check_refuses_an_off_by_one_count(off):
    steps = chip_smoke.TRAIN_STEPS
    good = {**dict.fromkeys(chip_smoke.KERNELS, 0), "embedding_bag": steps,
            "dot_interaction": steps, "embedding_bag_backward": steps,
            "dot_interaction_backward": steps}
    chip_smoke.expect_train_launches("run", good, steps)
    with pytest.raises(SystemExit, match="launched"):
        chip_smoke.expect_train_launches("run", dict(good, embedding_bag_backward=steps + off),
                                         steps)


@pytest.mark.parametrize("drift", ["one_ulp", "one_step", "none"])
def test_train_resume_check_is_bit_for_bit(drift):
    """The resumed and stopped runs' losses must equal the straight run's
    exactly: a loss one float32 ulp off, or one step's losses swapped, is
    refused; the same values pass."""
    straight = [0.6931471824645996, 0.6899, 0.68125, 0.6750001]
    resumed = list(straight)
    if drift == "one_ulp":
        resumed[2] = float(np.nextafter(np.float32(resumed[2]), np.float32(1)))
    elif drift == "one_step":
        resumed[1], resumed[2] = resumed[2], resumed[1]
    if drift == "none":
        chip_smoke.check_same_bits("train resumed losses", resumed, straight)
    else:
        with pytest.raises(SystemExit, match="other losses"):
            chip_smoke.check_same_bits("train resumed losses", resumed, straight)


# ------------------------------------------------------------ the cells gates


def _tree():
    rng = np.random.default_rng(0)
    return {"['tables']": torch.from_numpy(rng.normal(size=(3, 50, 8)).astype(np.float32)),
            "['dense']['mu']['w']": torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32)),
            "['dense']['count']": torch.tensor(1, dtype=torch.int32)}


def test_cells_leaf_gate_passes_equal_bits_and_names_a_leaf_held_at_tol():
    """The cells phase's sharded-against-unsharded check: equal bits pass
    with no leaf named; a leaf a few ulps off (a DTensor op summing in
    another order) passes at the gradient gate's TOL and is named."""
    want = _tree()
    got = {k: v.clone() for k, v in want.items()}
    assert chip_smoke.same_leaves("cells", got, want) == {
        "leaves": 3, "bit_equal": 3, "at_tol": [], "max_abs_err": 0.0}
    got["['dense']['mu']['w']"] = torch.nextafter(got["['dense']['mu']['w']"],
                                                  torch.tensor(np.inf))
    res = chip_smoke.same_leaves("cells", got, want)
    assert res["at_tol"] == ["['dense']['mu']['w']"] and res["bit_equal"] == 2
    assert 0 < res["max_abs_err"] < 1e-5


@pytest.mark.parametrize("fault", ["row_off", "missing_leaf", "table_zeroed"])
def test_cells_leaf_gate_refuses_a_step_that_differs(fault):
    """A table row moved by one adagrad step's size (0.01), a leaf the
    sharded step lost, a table zeroed: refused."""
    want = _tree()
    got = {k: v.clone() for k, v in want.items()}
    if fault == "row_off":
        got["['tables']"][1, 7] += 0.01
    elif fault == "missing_leaf":
        del got["['dense']['count']"]
    else:
        got["['tables']"].zero_()
    with pytest.raises(SystemExit, match="outside|leaves"):
        chip_smoke.same_leaves("cells", got, want)


@pytest.mark.parametrize("off", [-1, 1])
@pytest.mark.parametrize("kernel", ["embedding_bag", "dot_interaction_backward", "cin_layer"])
def test_cells_launch_check_refuses_an_off_by_one_count(kernel, off):
    """Exactly one K1, K2, K1-bwd and K2-bwd a train step (no K3, no K4):
    one more or one fewer of any is refused, a kernel the path must not
    run too."""
    one = {"embedding_bag": 1, "dot_interaction": 1, "embedding_bag_backward": 1,
           "dot_interaction_backward": 1}
    good = {**dict.fromkeys(chip_smoke.KERNELS, 0), **one}
    chip_smoke.expect_cell_launches("step", good, one)
    bad = dict(good, **{kernel: good[kernel] + off})
    if bad[kernel] < 0:
        bad[kernel] = 2
    with pytest.raises(SystemExit, match="launched"):
        chip_smoke.expect_cell_launches("step", bad, one)


def _lm_step():
    """(launches, loss pair, parameter pair, AdamW pair) of two equal
    steps: the qwen2 train_4k gate's arguments."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)).to(torch.bfloat16)
    params = {"['embed']": w, "['layers'][0]['ln1']['scale']": torch.ones(4, dtype=torch.bfloat16)}
    state = {"['mu']['embed']": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
             "['count']": torch.tensor(1, dtype=torch.int32)}
    loss = torch.tensor(11.93)
    clone = lambda t: {k: v.clone() for k, v in t.items()}   # noqa: E731
    return (dict.fromkeys(chip_smoke.KERNELS, 0), (loss.clone(), loss),
            (clone(params), params), (clone(state), state))


def test_lm_train_gate_passes_two_equal_steps():
    launches, loss, params, state = _lm_step()
    res = chip_smoke.lm_train_gate("qwen2", launches, loss, params, state)
    assert res["params"]["bit_equal"] == 2 and res["opt_state"]["bit_equal"] == 2


@pytest.mark.parametrize("fault", ["weight_one_ulp", "moment_off", "loss_one_ulp",
                                   "missing_leaf", "a_kernel_launched"])
def test_lm_train_gate_refuses_a_step_that_differs_or_launches(fault):
    """A bf16 weight one ulp off, an AdamW moment moved by a step's size, a
    loss one ulp off, a leaf lost, a K4 launch in a training step: refused."""
    launches, loss, params, state = _lm_step()
    if fault == "weight_one_ulp":
        w = params[0]["['embed']"]
        w[2, 1] = torch.nextafter(w[2, 1], torch.tensor(np.inf, dtype=torch.bfloat16))
    elif fault == "moment_off":
        state[0]["['mu']['embed']"][0, 0] += 3e-4
    elif fault == "loss_one_ulp":
        loss = (torch.nextafter(loss[0], torch.tensor(np.inf)), loss[1])
    elif fault == "missing_leaf":
        del state[0]["['count']"]
    else:
        launches["decode_attention"] = 1
    with pytest.raises(SystemExit, match="outside|leaves|loss|launched"):
        chip_smoke.lm_train_gate("qwen2", launches, loss, params, state)


# ----------------------------------------------------------- the lm_moe gates


def _moe_cfg(arch):
    from repro_torch import configs
    return configs.get(arch).config


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("off", [-1, 1])
def test_moe_launch_check_refuses_an_off_by_one_count(arch, off):
    """24 (granite-moe) or 48 (qwen3-moe) K4 launches a step, nothing else."""
    cfg = _moe_cfg(arch)
    step = chip_smoke.decode_launches(cfg, 1)
    assert step["decode_attention"] == {"granite-moe-1b-a400m": 24, "qwen3-moe-30b-a3b": 48}[arch]
    total = chip_smoke.decode_launches(cfg, 3)
    chip_smoke.check_moe_launches(arch, cfg, [step] * 3, total)
    bad_step = dict(step, decode_attention=step["decode_attention"] + off)
    with pytest.raises(SystemExit, match="step 1 launched"):
        chip_smoke.check_moe_launches(arch, cfg, [step, bad_step, step], total)
    with pytest.raises(SystemExit, match="prefill"):               # a launch outside the steps
        chip_smoke.check_moe_launches(arch, cfg, [step] * 3,
                                      dict(total, decode_attention=total["decode_attention"] + off))
    with pytest.raises(SystemExit, match="launched"):              # a K1 in a decode step
        chip_smoke.check_moe_launches(arch, cfg, [dict(step, embedding_bag=1)] + [step] * 2, total)


# ----------------------------------------------------------- the remote gates


def _fleet_result(n, dropped=0, errors=0, rerouted=0):
    import types
    return types.SimpleNamespace(n_queries=n, dropped=dropped, errors=errors, rerouted=rerouted)


def test_remote_run_check_refuses_a_lost_or_errored_query():
    chip_smoke.check_remote_run("clean", _fleet_result(100), 100, killed=False)
    chip_smoke.check_remote_run("sigkill", _fleet_result(100, rerouted=7), 100, killed=True)
    for bad in (_fleet_result(99), _fleet_result(100, dropped=1), _fleet_result(100, errors=1)):
        with pytest.raises(SystemExit, match="queries served"):
            chip_smoke.check_remote_run("clean", bad, 100, killed=False)
    with pytest.raises(SystemExit, match="re-routed"):       # a kill that re-routed nothing
        chip_smoke.check_remote_run("sigkill", _fleet_result(100), 100, killed=True)


def test_remote_worker_pids_must_be_among_the_cards_compute_apps():
    """One pid namespace (nvidia-smi lists this process's own pid): every
    worker's pid must be listed."""
    before = "100, 2048 MiB\n"
    during = before + "4242, 612 MiB\n4243, 610 MiB\n"
    files = {4242: ["/dev/nvidia0"], 4243: ["/dev/nvidia0"]}
    got = chip_smoke.workers_on_the_card([4242, 4243], 100, before, during, before, files,
                                         (2048, 3270))
    assert got["pids_listed"] and got["device_memory"] == {"4242": "612 MiB", "4243": "610 MiB"}
    with pytest.raises(SystemExit, match=r"\[4244\]"):
        chip_smoke.workers_on_the_card([4242, 4244], 100, before, during, before, files,
                                       (2048, 3270))


@pytest.mark.parametrize("fault", ["none", "one_short", "one_left_after", "no_device_file",
                                   "only_the_control_device"])
def test_remote_workers_in_a_pid_namespace_must_still_show_on_the_card(fault):
    """A container with its own pid namespace: nvidia-smi lists every
    process under another pid (the card machine's shows 1).  The list must
    grow by one entry a worker and shrink back after, and each worker must
    hold /dev/nvidiaN open."""
    before = "1, 2048 MiB\n"
    during = before + "1, 612 MiB\n1, 610 MiB\n"
    after = before
    files = {7: ["/dev/nvidia-uvm", "/dev/nvidia0", "/dev/nvidiactl"], 8: ["/dev/nvidia0"]}
    if fault == "one_short":
        during = before + "1, 612 MiB\n"
    elif fault == "one_left_after":
        after = before + "1, 610 MiB\n"
    elif fault == "no_device_file":
        files[8] = []
    elif fault == "only_the_control_device":
        files[8] = ["/dev/nvidiactl", "/dev/nvidia-uvm"]
    run = lambda: chip_smoke.workers_on_the_card([7, 8], 300, before, during, after, files,  # noqa: E731
                                                 (2048, 4888))
    if fault == "none":
        got = run()
        assert not got["pids_listed"]
        assert got["device_memory_mib_each"] == 1420.0
    else:
        with pytest.raises(SystemExit, match="compute apps|device file"):
            run()
    assert chip_smoke.parse_compute_apps("No running processes found\n") == []


# ------------------------------------------------------------ roofline gate

def _rmc2_count(batch: int = 64):
    from repro_torch import configs
    cfg = configs.get("dlrm-rmc2").config
    want = chip_smoke.cell_kernel_work(cfg, batch, train=True)
    counted = {k: {"calls": n, "flops_by_unit": dict(w[0]), "bytes": w[1]}
               for k, (n, w) in want.items()}
    return want, counted, {k: 1 for k in want}


def test_roofline_gate_passes_a_step_at_or_above_its_roofline():
    want, counted, launched = _rmc2_count()
    shares = chip_smoke.roofline_gate("rmc2", 10.0, {"plain": 10.0 / 1.05, "dtensor": 40.0},
                                      counted, launched, want)
    assert shares == {"plain": pytest.approx(1.05), "dtensor": 0.25}


@pytest.mark.parametrize("share", [1.06, 2.0, float("nan")])
def test_roofline_gate_refuses_a_step_faster_than_its_roofline(share):
    want, counted, launched = _rmc2_count()
    with pytest.raises(SystemExit, match="faster than its roofline"):
        chip_smoke.roofline_gate("rmc2", 10.0, {"plain": 10.0 / share, "dtensor": 40.0},
                                 counted, launched, want)


@pytest.mark.parametrize("fault", ["missing", "counted_twice", "not_launched", "other_work"])
def test_roofline_gate_refuses_a_count_that_is_not_the_launches(fault):
    want, counted, launched = _rmc2_count()
    if fault == "missing":               # a launched kernel the count left out
        del counted["dot_interaction_backward"]
    elif fault == "counted_twice":
        counted["embedding_bag"]["calls"] = 2
    elif fault == "not_launched":        # a count the step's launches do not show
        del launched["embedding_bag_backward"]
    else:                                # the kernel at another shape's work
        counted["dot_interaction"]["bytes"] += 4
    with pytest.raises(SystemExit, match="roofline rmc2"):
        chip_smoke.roofline_gate("rmc2", 1.0, {"plain": 10.0}, counted, launched, want)


@pytest.mark.parametrize("arch,shape", [("dlrm-rmc2", "train_batch"), ("xdeepfm", "serve_p99"),
                                        ("xdeepfm", "train_batch")])
def test_a_cells_count_holds_its_kernels_work(arch, shape):
    """The roofline phase's count of a cell (smoke size, a fake world of one
    rank, a CPU mesh) holds each kernel the step launches with its work()."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.launch import dryrun, steps
    cfg = configs.get(arch).smoke_config
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cell = steps.build_cell(arch, shape, mesh, smoke=True)
        b = configs.RECSYS_SHAPES[shape].batch
        want = chip_smoke.cell_kernel_work(
            cfg, b, train=configs.RECSYS_SHAPES[shape].kind == "train")
        res = chip_smoke.cell_roofline(cell, None, {"plain": 1e6}, {k: n for k, (n, _) in
                                                                  want.items()}, want, 0.0)
    assert set(res["kernels_counted"]) == set(want)
    assert res["roofline_ms"] > 0 and res["share_of_roofline"]["plain"] < 1
    assert res["dry_run_peak_gb"] > 0


def test_the_gate_holds_a_step_to_its_floor_at_the_distinct_rows():
    """K1 and K1-bwd are counted at every lookup's row, which a step whose
    ids repeat beats: a step 1.1 times faster than that roofline passes when
    the floor, with K1's and K1-bwd's bytes at the step's distinct rows,
    stays under it, and one faster than the floor fails."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.launch import dryrun, steps
    cfg = configs.get("dlrm-rmc2").smoke_config
    b = configs.RECSYS_SHAPES["train_batch"].batch
    want = chip_smoke.cell_kernel_work(cfg, b, train=True)
    needed = chip_smoke.cell_kernel_work(cfg, b, rows=1.0, train=True)
    launched = {k: n for k, (n, _) in want.items()}
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cell = steps.build_cell("dlrm-rmc2", "train_batch", mesh, smoke=True)
        probe = chip_smoke.cell_roofline(cell, None, {"plain": 1e6}, launched, want, 0.0, needed)
        spare = sum(want[k][1][1] - needed[k][1][1] for k in want)
        assert spare > 0 and probe["floor_ms"] < probe["roofline_ms"]
        assert probe["floor_t_memory_ms"] == pytest.approx(
            (probe["roofline"]["bytes_accessed"] - spare) / chip_smoke.analysis.HBM_BW * 1e3)
        step = probe["roofline_ms"] / 1.1
        assert step > probe["floor_ms"]
        res = chip_smoke.cell_roofline(cell, None, {"plain": step}, launched, want, 0.0, needed)
        assert res["share_of_roofline"]["plain"] == pytest.approx(1.1)
        assert res["share_of_floor"]["plain"] < 1
        with pytest.raises(SystemExit, match="faster than its roofline"):
            chip_smoke.cell_roofline(cell, None, {"plain": probe["floor_ms"] / 1.1}, launched,
                                     want, 0.0, needed)


# ------------------------------------------------------------------- fit


def test_fit_entry_gates_each_peak_below_the_cards_memory():
    """The roofline phase's fit entry at smoke size on the CPU (fake worlds
    of 256 and 512 ranks): it records each cell's dry-run peak and qwen2's
    counts (outside the layers below the whole vocabulary's gradient; at one
    layer without checkpoints, fewer FLOPs than with them), passes under a
    card's memory and refuses a card that holds less than a peak plus the
    margin."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    out = chip_smoke.fit_entry(smoke=True, device="cpu", total=10**15)
    assert set(out["cells"]) == {"yi-34b×train_4k×single_pod_16x16",
                                 "qwen2-0.5b×train_4k×multi_pod_2x16x16"}
    peaks = [c["peak_bytes_per_device"] for c in out["cells"].values()]
    assert min(peaks) > 0
    assert 0 < out["qwen2_l1_flops_no_checkpoints"] <= chip_smoke.FIT_QWEN_L1_FLOPS_MAX
    assert 0 < out["qwen2_outside_layers_flops"] < out["qwen2_whole_vocab_grad_flops"]
    assert out["qwen2_l1_flops_no_checkpoints"] <= out["qwen2_l1_flops"] < out["qwen2_l2_flops"]
    with pytest.raises(SystemExit, match="fit: yi-34b"):
        chip_smoke.fit_entry(smoke=True, device="cpu",
                             total=chip_smoke.FIT_MARGIN_BYTES + min(peaks) - 1)


# ------------------------------------------------------------ datacenter


@pytest.fixture(scope="module")
def datacenter_line():
    """The datacenter phase's body on the recorded curves (the host CPU's
    torch curves and the H100's) at a 1 s day."""
    from repro_torch.core import latency_model as lat
    cpu, card = (lat.load_curves(os.path.join(REPO, "artifacts", name))
                 for name in ("torch_cpu_latency_curves.json", "h100_latency_curves.json"))
    curves = {a: {"cpu": cpu[a], "card": card[a]} for a in chip_smoke.dc.MODELS}
    return chip_smoke.datacenter(curves, day_s=1.0)


def test_datacenter_line_has_its_keys(datacenter_line):
    import json
    line = json.loads(json.dumps(datacenter_line))
    assert line["phase"] == "datacenter" and line["day_s"] == 1.0
    assert line["cut"].startswith("the fleet's day 1 s, windows 0.0333333 s, boot 0.1 s")
    assert [r["arch"] for r in line["sim"]] == list(chip_smoke.dc.MODELS)
    for r in line["sim"]:
        assert {"static", "tuned", "x", "batch", "p95_ms", "ok", "hedges", "requeued"} <= set(r)
        assert {"tuned", "batch", "threshold", "p95_ms", "ok", "hedges", "requeued"} <= set(
            r["card"])
    fleet = line["fleet"]
    assert [p["name"] for p in fleet["pools"]] == ["skylake", "broadwell", "h100"]
    assert set(fleet) >= {"queries", "timeline", "static", "autoscaled", "routers", "boot",
                          "kill"}
    assert set(fleet["routers"]) == {"round_robin", "least_outstanding", "size_aware", "hetero"}
    assert set(fleet["boot"]) == {"reactive", "predictive"}
    assert fleet["kill"]["reroute"]["rerouted"] >= 1 and fleet["kill"]["no_reroute"]["dropped"] >= 1
    assert not any(line["launches"].values())
    assert set(line["seconds"]) == {"sim", "fleet", "total"}


def _broken(line: dict, fault: str) -> dict:
    import copy
    line = copy.deepcopy(line)
    fleet = line["fleet"]
    kill = fleet["kill"]
    if fault == "rerouted_day_drops":
        kill["reroute"]["dropped"] += 1
        kill["reroute"]["served"] -= 1
    elif fault == "nothing_rerouted":
        kill["reroute"]["rerouted"] = 0
    elif fault == "no_drop_without_reroute":
        kill["no_reroute"]["served"] += kill["no_reroute"]["dropped"]
        kill["no_reroute"]["dropped"] = 0
    elif fault == "query_lost":
        fleet["autoscaled"]["served"] -= 1
    elif fault == "non_finite":
        line["sim"][1]["card"]["p95_ms"] = float("nan")
    elif fault == "launched":
        line["launches"]["embedding_bag"] = 1
    elif fault == "slow":
        line["seconds"]["total"] = chip_smoke.DATACENTER_SECONDS + 1
    return line


@pytest.mark.parametrize("fault,match", [
    ("rerouted_day_drops", "with re-route"),
    ("nothing_rerouted", "with re-route"),
    ("no_drop_without_reroute", "without re-route dropped no query"),
    ("query_lost", "autoscaled served"),
    ("non_finite", "non-finite"),
    ("launched", "launches no kernel"),
    ("slow", "past"),
])
def test_datacenter_gates_refuse_a_broken_line(datacenter_line, fault, match):
    chip_smoke.check_datacenter(datacenter_line)
    with pytest.raises(SystemExit, match=match):
        chip_smoke.check_datacenter(_broken(datacenter_line, fault))


def test_cin_bwd_entry_splits_launches_by_layer_shape():
    """The kernels line's K3-bwd entry puts each layer shape's launches
    beside that shape's time, so launches × ms adds up over the step."""
    layers = chip_smoke.xdeepfm_cin_layers()
    shapes = chip_smoke.xdeepfm_cin_shapes()
    assert len(shapes) == 2 < len(layers)
    keys = ("kernel_ms", "bound_ms", "bound_by", "plain_ms", "library_ms", "library_chunk",
            "share_of_bound", "tf32x3_bound_ms", "tf32x3_share_of_bound",
            "fp32_cuda_core_bound_ms")
    times = [{"shape": [b, f, h, hn, 10], **{k: float(b * h) for k in keys}}
             for b in (1024, 65_536) for f, h, hn in shapes]
    steps = 15
    entry = chip_smoke.cin_bwd_by_layer(times, 1024, steps * len(layers))
    assert entry["launches"] == steps * len(layers)
    assert [e["shape"][1:4] for e in entry["layers"]] == [list(s) for s in shapes]
    assert [e["launches"] for e in entry["layers"]] == [steps * layers.count(s) for s in shapes]
    assert sum(e["launches"] for e in entry["layers"]) == entry["launches"]
    assert all(e["shape"][0] == 1024 and e["kernel_ms"] == 1024 * e["shape"][2]
               for e in entry["layers"])
    with pytest.raises(SystemExit, match="not a whole number"):
        chip_smoke.cin_bwd_by_layer(times, 65_536, steps * len(layers) + 1)
