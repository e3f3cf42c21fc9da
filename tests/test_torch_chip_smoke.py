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
            "embedding_bag_backward": 0, "dot_interaction_backward": 0}
    chip_smoke.check_launches("run", good, per, {"card": 7})
    bad = dict(good, dot_interaction=7 + off)
    with pytest.raises(SystemExit, match="launched"):
        chip_smoke.check_launches("run", bad, per, {"card": 7})


# ------------------------------------------------------------ the train gate


def _train_step():
    """DLRM-RMC2's smoke config on the CPU: 64 samples of Zipf ids over 100
    rows a table, so rows repeat within bags and across them."""
    from repro_torch import configs
    from repro_torch.data import synthetic as syn
    from repro_torch.models import recsys
    cfg = configs.get(chip_smoke.TRAIN_ARCH).smoke_config
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


@pytest.mark.parametrize("fault", ["k1_bwd", "k2_bwd"])
def test_train_gradient_gate_refuses_a_broken_backward(fault):
    loss_fn, params, batch = _train_step()
    with chip_smoke.plain_backward():
        _, want = chip_smoke.step_grads(loss_fn, params, batch)
    broken = {"k1_bwd": _k1_bwd_writes_instead_of_adding,
              "k2_bwd": _k2_bwd_without_the_transpose}[fault]
    with chip_smoke.plain_backward(**{fault: broken}):
        _, bad = chip_smoke.step_grads(loss_fn, params, batch)
    with pytest.raises(SystemExit, match="outside"):
        chip_smoke.check_train_grads("broken", bad, want)


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
