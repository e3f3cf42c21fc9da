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
