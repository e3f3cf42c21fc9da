"""K4's log-sum-exp and the merge of a KV cache cut over time, in their
plain versions (``kernels/ref.py``), on the CPU.

``ref.decode_attention(return_lse=True)``'s lse is ``torch.logsumexp`` of
the scaled scores over the valid slots, computed apart in float64, and
``-inf`` where ``pos <= 0``; its output is the lse-less call's, bit for
bit.  A cache cut into 2, 3 and 4 slices, each slice's result taken at its
local length ``clamp(pos − r·T_r, 0, T_r)`` and merged in slice order
(``ref.merge_decode_attention``), equals one call over the whole cache:
float32 within 1e-5, bfloat16 within 2e-2 (each slice's output is rounded
to bfloat16 before the merge, as K4's are), with ``pos`` at 0, at each
slice boundary, at a boundary ± 1 and at T.  ``write_kv`` on a slice
writes its own slot and keeps every other row."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.layers import attention

T = 24                                  # 2, 3 and 4 slices of equal length
F32_TOL, BF16_TOL = 1e-5, 2e-2


def _inputs(dtype, b: int, hq: int = 6, hkv: int = 2, d: int = 8, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, d), generator=g).to(dtype)
    k = torch.randn((b, T, hkv, d), generator=g).to(dtype)
    v = torch.randn((b, T, hkv, d), generator=g).to(dtype)
    return q, k, v


def _positions(n_slices: int) -> torch.Tensor:
    """0, T, and each slice boundary and its neighbours."""
    per = T // n_slices
    pos = {0, 1, T - 1, T}
    for r in range(1, n_slices):
        pos |= {r * per - 1, r * per, r * per + 1}
    return torch.tensor(sorted(pos), dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_is_the_logsumexp_of_the_valid_scaled_scores(dtype):
    pos = torch.tensor([0, -3, 1, 5, T - 1, T, T + 4], dtype=torch.int32)
    q, k, v = _inputs(dtype, len(pos))
    out, lse = ref.decode_attention(q, k, v, pos, return_lse=True)
    assert torch.equal(out, ref.decode_attention(q, k, v, pos))
    assert lse.dtype == torch.float32 and lse.shape == (len(pos), q.shape[1])
    g = q.shape[1] // k.shape[2]
    kk = k.double().repeat_interleave(g, dim=2)                       # (B, T, Hq, D)
    scores = torch.einsum("bhd,bthd->bht", q.double(), kk) / math.sqrt(q.shape[2])
    for i, p in enumerate(pos.tolist()):
        if p <= 0:
            assert torch.isneginf(lse[i]).all()
            continue
        want = torch.logsumexp(scores[i, :, :min(p, T)], dim=-1)
        np.testing.assert_allclose(lse[i].double().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _sliced(q, k, v, pos, n_slices: int):
    """Each slice's (out, lse) at its local length, stacked in slice order."""
    per = T // n_slices
    outs, lses = [], []
    for r in range(n_slices):
        local = (pos - r * per).clamp(0, per).to(pos.dtype)
        o, lse = ref.decode_attention(q, k[:, r * per:(r + 1) * per].contiguous(),
                                      v[:, r * per:(r + 1) * per].contiguous(), local,
                                      return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


@pytest.mark.parametrize("n_slices", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_merge_of_slices_equals_the_whole(dtype, n_slices):
    pos = _positions(n_slices)
    q, k, v = _inputs(dtype, len(pos), seed=n_slices)
    want, want_lse = ref.decode_attention(q, k, v, pos, return_lse=True)
    got, lse = ref.merge_decode_attention(*_sliced(q, k, v, pos, n_slices))
    assert got.dtype == dtype and got.shape == want.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol, atol=tol)
    empty = pos <= 0
    assert torch.isneginf(lse[empty]).all() and torch.isneginf(want_lse[empty]).all()
    np.testing.assert_allclose(lse[~empty].numpy(), want_lse[~empty].numpy(), rtol=1e-5,
                               atol=1e-5)
    # pos = 0: every slice empty, the slices weigh alike: the mean of V
    mean_v = v.float().mean(dim=1).repeat_interleave(q.shape[1] // k.shape[2], dim=1)
    np.testing.assert_allclose(got[empty].float().numpy(), mean_v[empty].numpy(),
                               rtol=tol, atol=tol)


def test_the_merge_sums_in_slice_order():
    """The merge's bits do not depend on anything but its inputs, and a
    slice that weighs nothing (lse -inf) changes nothing."""
    pos = _positions(4)
    q, k, v = _inputs(torch.float32, len(pos))
    outs, lses = _sliced(q, k, v, pos, 4)
    a = ref.merge_decode_attention(outs, lses)
    b = ref.merge_decode_attention(outs.clone(), lses.clone())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    garbage = torch.full_like(outs[:1], 1e6)
    c = ref.merge_decode_attention(torch.cat([outs, garbage]),
                                   torch.cat([lses, torch.full_like(lses[:1], -math.inf)]))
    full = pos > 0
    assert torch.equal(c[0][full], a[0][full])


def test_the_cpu_wrapper_returns_the_plain_lse():
    pos = torch.tensor([0, 7, T], dtype=torch.int32)
    q, k, v = _inputs(torch.float32, 3)
    out, lse = ops.decode_attention(q, k, v, pos, return_lse=True)
    want, want_lse = ref.decode_attention(q, k, v, pos, return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert torch.equal(ops.decode_attention(q, k, v, pos), want)


@pytest.mark.parametrize("n_slices", [2, 3, 4])
def test_write_kv_on_a_slice_keeps_every_row_that_is_not_its_own(n_slices):
    """Each slice written at the local slot ``pos − r·T_r``, the slices put
    back together, equals the whole cache's write; a slice whose range
    holds no ``pos`` is unchanged."""
    pos = _positions(n_slices)
    b, per = len(pos), T // n_slices
    g = torch.Generator().manual_seed(1)
    cache = {"k": torch.randn((b, T, 2, 4), generator=g),
             "v": torch.randn((b, T, 2, 4), generator=g), "pos": pos}
    new_k, new_v = torch.randn((b, 2, 4), generator=g), torch.randn((b, 2, 4), generator=g)
    slices = [{n: cache[n][:, r * per:(r + 1) * per].clone() for n in ("k", "v")}
              for r in range(n_slices)]
    before = [{n: t.clone() for n, t in s_.items()} for s_ in slices]
    whole = {n: cache[n].clone() for n in ("k", "v")}
    attention.write_kv({**whole, "pos": pos}, new_k, new_v)
    for r, s_ in enumerate(slices):
        attention._write_rows(s_["k"], s_["v"], new_k, new_v, pos, r * per)
        mine = (pos >= r * per) & (pos < (r + 1) * per)
        for n in ("k", "v"):
            assert torch.equal(s_[n][~mine], before[r][n][~mine]), (r, n)
    for n in ("k", "v"):
        assert torch.equal(torch.cat([s_[n] for s_ in slices], dim=1), whole[n]), n
