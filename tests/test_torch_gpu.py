"""The hand-written kernels on a GPU, against their plain PyTorch versions.
Needs a CUDA device and nvcc; skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-5, bfloat16 2e-2 (rtol = atol): both sides accumulate
in float32, in different orders.  K3 and K4 hold float32 to 1e-4, and K4
bfloat16 to 3e-2, the values tests/test_kernels.py holds their Pallas
kernels to."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import infra
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops, ref
from repro_torch.models import lm, recsys

pytestmark = pytest.mark.gpu
# serving launches no backward kernel
NO_BWD = {"embedding_bag_backward": 0, "dot_interaction_backward": 0}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("f,v,b,h,d", [
    (1, 64, 8, 4, 128), (1, 37, 4, 3, 130), (3, 1000, 9, 16, 256), (40, 5000, 65, 80, 32),
    (8, 100, 33, 1, 64), (2, 50, 5, 7, 8), (2, 50, 5, 7, 20),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_kernel(dev, f, v, b, h, d, dtype, mode):
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(rng.normal(size=(f, v, d)).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, v, size=(b, f, h)).astype(np.int32)).to(dev)
    before = ops.launch_counts()["embedding_bag"]
    got = ops.embedding_bag(tables, idx, mode=mode, check_indices=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["embedding_bag"] == before + 1
    torch.testing.assert_close(got.float(), ref.embedding_bag_stacked(tables, idx, mode=mode).float(),
                               **_tol(dtype))
    one = ops.embedding_bag(tables[0], idx[:, 0].contiguous(), mode=mode)
    torch.testing.assert_close(one.float(), got[:, 0].float(), rtol=0, atol=0)


@pytest.mark.parametrize("b,f,d", [(32, 8, 32), (64, 27, 16), (8, 4, 64), (10, 5, 130),
                                   (1, 41, 32), (1024, 41, 32), (7, 2, 1), (3, 300, 64),
                                   (1000, 41, 32), (1024, 11, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interaction_kernel(dev, b, f, d, dtype):
    """(1000, 41, 32): B not a multiple of a block's samples at F = 41;
    (1024, 11, 32): seven samples a block.  A second launch gives the same
    bits."""
    rng = np.random.default_rng(1)
    feats = torch.from_numpy((rng.normal(size=(b, f, d)) / d ** 0.5).astype(np.float32)).to(dev, dtype)
    got, full = ops.dot_interaction(feats), ops.gram(feats)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.dot_interaction_packed(feats).float(), **_tol(dtype))
    torch.testing.assert_close(full.float(), ref.gram(feats).float(), **_tol(dtype))
    assert torch.equal(ops.dot_interaction(feats), got) and torch.equal(ops.gram(feats), full)


@pytest.mark.parametrize("b,f,d,offset", [(9, 5, 3, 15), (64, 11, 32, 1), (5, 41, 32, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interaction_kernel_unaligned_start(dev, b, f, d, offset, dtype):
    """A contiguous input whose first element lies ``offset`` elements into
    its storage, off a 16-byte boundary (x[1:] of (10, 5, 3) starts 60
    bytes in): the kernel checks the address, not only the shape, and takes
    its scalar path."""
    rng = np.random.default_rng(3)
    flat = torch.from_numpy((rng.normal(size=offset + b * f * d) / d ** 0.5)
                            .astype(np.float32)).to(dev, dtype)
    feats = flat[offset:].view(b, f, d)
    assert feats.is_contiguous() and feats.data_ptr() % 16
    got, full = ops.dot_interaction(feats), ops.gram(feats)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.dot_interaction_packed(feats).float(), **_tol(dtype))
    torch.testing.assert_close(full.float(), ref.gram(feats).float(), **_tol(dtype))
    assert torch.equal(ops.dot_interaction(feats), got)


def _grad_close(got, want):
    """A float32 gradient against its float64 value: rtol 2e-5, atol 2e-5
    of its largest magnitude (chip_smoke.grad_compare's rule): a row sums
    thousands of terms in no fixed order, and where they cancel the result
    is far below the partial sums whose rounding it carries."""
    torch.testing.assert_close(got.double(), want, rtol=2e-5,
                               atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("b,f,v,h,d", [
    (65, 3, 1000, 80, 32), (7, 2, 50, 1, 32), (9, 4, 300, 80, 1), (33, 2, 100, 5, 130),
    (65, 3, 1000, 80, 130), (1, 40, 5000, 80, 32), (1024, 5, 10000, 80, 32),
    (5, 2, 70, 200, 64), (3, 1, 40, 7, 256),          # H beyond the 128 in flight; D = 256
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_kernel(dev, b, f, v, h, d, dtype, mode):
    """K1-bwd against the plain backward in float64 on the same gradient
    rows (bfloat16 ones widened exactly), every table's dense gradient, by
    ``_grad_close``.  Odd B, D = 1, 32 (the 16-byte vector atomics) and 130
    (scalar), H = 1 and 80, Zipf ids (hot rows)."""
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(syn._zipf_ids(rng, (b, f, h), v).astype(np.int32)).to(dev)
    ops.reset_launch_counts()
    got = ops.embedding_bag_backward(g, idx, v, mode=mode)
    torch.cuda.synchronize()
    assert ops.launch_counts()["embedding_bag_backward"] == 1
    assert got.dtype == torch.float32 and got.shape == (f, v, d)
    _grad_close(got, ref.embedding_bag_backward(g.double(), idx, v, mode=mode))


def test_embedding_bag_backward_kernel_same_bits_every_launch(dev):
    """No atomics: every row is summed by its one owning warp in the same
    order, so RMC2's shape under Zipf ids gives the same bits twice, and a
    table beyond D = 256 is refused."""
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=(1024, 40, 32)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(syn._zipf_ids(rng, (1024, 40, 80), 100_000).astype(np.int32)).to(dev)
    first = ops.embedding_bag_backward(g, idx, 100_000)
    assert torch.equal(ops.embedding_bag_backward(g, idx, 100_000), first)
    with pytest.raises(ValueError, match="D <= 256"):
        ops.embedding_bag_backward(torch.zeros((2, 1, 257), device=dev),
                                   torch.zeros((2, 1, 3), dtype=torch.int32, device=dev), 4)


@pytest.mark.parametrize("d", [1, 32, 130])
def test_embedding_bag_backward_kernel_all_lookups_on_one_row(dev, d):
    """The contention worst case: every lookup of every bag hits row 0 of
    its table (65 x 80 adds a row); every other row stays exactly 0."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.normal(size=(65, 3, d)).astype(np.float32)).to(dev)
    idx = torch.zeros((65, 3, 80), dtype=torch.int32, device=dev)
    got = ops.embedding_bag_backward(g, idx, 20)
    torch.cuda.synchronize()
    _grad_close(got, ref.embedding_bag_backward(g.double(), idx, 20))
    assert not got[:, 1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stacked", [True, False])
def test_embedding_bag_autograd_launches_k1_and_k1_bwd(dev, dtype, stacked):
    """Through autograd: one K1 and one K1-bwd, and the tables' gradient in
    their own dtype, against the plain backward."""
    rng = np.random.default_rng(6)
    t = torch.from_numpy(rng.normal(size=(3, 400, 32)).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, 400, size=(17, 3, 9)).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(17, 3, 32)).astype(np.float32)).to(dev, dtype)
    if not stacked:
        t, idx, g = t[0].contiguous(), idx[:, 0].contiguous(), g[:, 0].contiguous()
    t.requires_grad_()
    ops.reset_launch_counts()
    (grad,) = torch.autograd.grad(ops.embedding_bag(t, idx), t, g)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"embedding_bag": 1, "dot_interaction": 0, "cin_layer": 0,
                                   "decode_attention": 0, "embedding_bag_backward": 1,
                                   "dot_interaction_backward": 0}
    want = ref.embedding_bag_backward(g.double().reshape(17, -1, 32),
                                      idx.reshape(17, -1, 9), 400).reshape(t.shape)
    assert grad.dtype == dtype
    if dtype == torch.bfloat16:
        torch.testing.assert_close(grad.double(), want, **_tol(dtype))
    else:
        _grad_close(grad, want)


@pytest.mark.parametrize("b,f,d", [(1, 2, 1), (7, 2, 32), (33, 3, 130), (65, 11, 32),
                                   (9, 27, 16), (1024, 41, 32), (5, 41, 130), (3, 41, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interaction_backward_kernel(dev, b, f, d, dtype):
    """K2-bwd against the plain backward in float64 on the same inputs:
    float32 within 2e-5, bfloat16 outputs within 2e-2; F from 2 to 41, odd
    B, D = 1, 32 and 130.  A second launch gives the same bits (no atomics,
    sums in a fixed order)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=(b, f, d)) / d ** 0.5).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)).to(dev, dtype)
    ops.reset_launch_counts()
    got = ops.dot_interaction_backward(g, x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["dot_interaction_backward"] == 1
    assert got.dtype == dtype and got.shape == (b, f, d)
    want = ref.dot_interaction_backward(g.double(), x.double())
    torch.testing.assert_close(got.double(), want, **_tol(dtype))
    assert torch.equal(ops.dot_interaction_backward(g, x), got)


def test_dot_interaction_autograd_launches_k2_and_k2_bwd(dev):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(64, 41, 32)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(64, 820)).astype(np.float32)).to(dev)
    x.requires_grad_()
    ops.reset_launch_counts()
    (grad,) = torch.autograd.grad(ops.dot_interaction(x), x, g)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"embedding_bag": 0, "dot_interaction": 1, "cin_layer": 0,
                                   "decode_attention": 0, "embedding_bag_backward": 0,
                                   "dot_interaction_backward": 1}
    torch.testing.assert_close(grad.double(), ref.dot_interaction_backward(g.double(), x.double()),
                               rtol=2e-5, atol=2e-5)


def test_kernels_without_a_backward_raise_under_grad(dev):
    """K3, K4 and the full Gram product have no backward kernel: on a CUDA
    tensor that needs a gradient they raise, never hand back a result that
    autograd cannot see through; under no_grad they run."""
    x0, xk, w = (torch.randn(s, device=dev) for s in ((2, 3, 4), (2, 5, 4), (15, 6)))
    w.requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.cin_layer(x0, xk, w)
    with torch.no_grad():
        assert ops.cin_layer(x0, xk, w).shape == (2, 6, 4)
    feats = torch.randn((2, 3, 4), device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gram"):
        ops.gram(feats)
    q = torch.randn((1, 2, 8), device=dev, requires_grad=True)
    kv = torch.randn((1, 4, 1, 8), device=dev)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, kv, kv, torch.tensor([2], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("name", ["dlrm-rmc1", "dlrm-rmc2", "dlrm-rmc3", "wnd"])
def test_train_step_on_gpu_matches_cpu(dev, name):
    """One loss and every leaf's gradient of a paper smoke config on the
    card (K1, K1-bwd, and for the DLRMs K2, K2-bwd, once each) against the
    plain versions on the CPU, float32 within 1e-4."""
    from repro_torch.train.microbatch import value_and_grad
    from repro_torch.utils import leaves_with_paths
    cfg = configs.get(name).smoke_config
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             syn.recsys_batch(np.random.default_rng(0), cfg, 33).items()}
    loss_fn = lambda p, b: recsys.loss_fn(p, cfg, b)             # noqa: E731
    want_loss, want = value_and_grad(loss_fn, params, batch)
    params_d = torch.utils._pytree.tree_map(lambda x: x.to(dev), params)
    ops.reset_launch_counts()
    loss, got = value_and_grad(loss_fn, params_d, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    dot = int(cfg.interaction == "dot")
    assert ops.launch_counts() == {"embedding_bag": 1, "dot_interaction": dot, "cin_layer": 0,
                                   "decode_attention": 0, "embedding_bag_backward": 1,
                                   "dot_interaction_backward": dot}
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-4, atol=1e-4)
    for (k, g), (_, w) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4, msg=k)


def _cin_inputs(dev, b, f, h, hn, d, dtype, seed=2):
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy((rng.normal(size=(b, f, d)) / d ** 0.5).astype(np.float32)).to(dev, dtype)
    xk = torch.from_numpy((rng.normal(size=(b, h, d)) / d ** 0.5).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.normal(size=(h * f, hn)) / (h * f) ** 0.5).astype(np.float32)).to(dev, dtype)
    return x0, xk, w


@pytest.mark.parametrize("b,f,h,hn,d", [
    (8, 6, 5, 7, 128), (16, 10, 10, 4, 64), (4, 3, 8, 16, 130),   # tests/test_kernels.py
    (4, 6, 16, 8, 10), (1, 39, 39, 200, 10), (65, 39, 200, 200, 10), (3, 1, 1, 1, 1),
    (1, 39, 200, 200, 10), (64, 39, 200, 200, 10), (512, 39, 200, 200, 10),   # xDeepFM
    (2, 5, 7, 300, 3), (3, 4, 5, 73, 2),   # column tiles: 2 x 200 (the last 100), 128
    (9, 2, 3, 16, 1), (5, 4, 4, 7, 1),                            # D = 1; K below a stage
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cin_layer_kernel(dev, b, f, h, hn, d, dtype):
    """float32 within 1e-4 (the CPU sweep's tolerance), bfloat16 2e-2.
    Covers M = B·D not a multiple of the 128-row tile, K = H·F not a
    multiple of the 32-value stage, N below 200 and not a multiple of 8,
    N over several ragged column tiles, B = 1 with K split, D = 1 and
    D = 130."""
    x0, xk, w = _cin_inputs(dev, b, f, h, hn, d, dtype)
    before = ops.launch_counts()["cin_layer"]
    got = ops.cin_layer(x0, xk, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cin_layer"] == before + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    assert got.dtype == dtype and got.shape == (b, hn, d)
    torch.testing.assert_close(got.float(), ref.cin_layer(x0, xk, w).float(), **tol)


@pytest.mark.parametrize("b", [1, 512])
def test_cin_layer_kernel_same_bits_every_launch(dev, b):
    """No atomics and a fixed order of every sum: B = 1 (K split over
    blocks) and B = 512 give the same bits on a second launch."""
    from repro_torch.kernels import cin
    x0, xk, w = _cin_inputs(dev, b, 39, 200, 200, 10, torch.float32)
    if b == 1:
        assert cin.plan(b, 39, 200, 200, 10, torch.cuda.get_device_properties(dev).multi_processor_count)[0] > 1
    first = ops.cin_layer(x0, xk, w)
    again = ops.cin_layer(x0, xk, w)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_cin_layer_kernel_rows_agree_across_batch_sizes(dev):
    """512 rows alone (a request, K split three ways) and the same rows
    inside 2,048 (a bulk chunk, not split) differ only by float32 rounding:
    each 16-value stage is summed into a float32 total, so the order of the
    runs moves the result by a few ulps."""
    x0, xk, w = _cin_inputs(dev, 2048, 39, 200, 200, 10, torch.float32)
    whole = ops.cin_layer(x0, xk, w)
    head = ops.cin_layer(x0[:512].contiguous(), xk[:512].contiguous(), w)
    torch.testing.assert_close(whole[:512], head, rtol=1e-6, atol=1e-6)


def test_cin_layer_kernel_float64(dev):
    """At xDeepFM's K = 7,800 the 3xTF32 result is within 1e-5 of the
    largest output of the float64 value (a float32 sum's distance; one TF32
    pass is ~1e-3 of it)."""
    x0, xk, w = _cin_inputs(dev, 64, 39, 200, 200, 10, torch.float32)
    exact = ref.cin_layer(x0.double(), xk.double(), w.double())
    err = float((ops.cin_layer(x0, xk, w).double() - exact).abs().max())
    assert err <= 1e-5 * float(exact.abs().max())


@pytest.mark.parametrize("k,n", [(7800, 200), (30, 7), (5, 300)])
def test_cin_split_w_planes(dev, k, n):
    """The pre-pass: hi holds w rounded to TF32 (13 low bits zero), hi + lo
    is w within 2^-22 of its magnitude, zero past K and N, in wgmma's
    core-matrix order [k/4][n/8][n%8][k%4] within each (tile, stage)."""
    from repro_torch.kernels import cin
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dev)
    before = ops.launch_counts()["cin_layer"]
    planes = cin.split_w(w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cin_layer"] == before
    ct, st, _, bk, nt = planes.shape
    assert (nt, bk) == (cin.n_tile(n), cin.SLICE_K)
    assert int((planes[:, :, 0].contiguous().view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # (c, s, plane, kc, g, row, kk) -> (plane, s, kc, kk, c, g, row) -> (plane, K', N')
    full = planes.reshape(ct, st, 2, bk // 4, nt // 8, 8, 4).permute(2, 1, 3, 6, 0, 4, 5)
    hi, lo = full.reshape(2, st * bk, ct * nt)
    assert not hi[k:].any() and not hi[:, n:].any() and not lo[k:].any()
    assert float((hi[:k, :n] + lo[:k, :n] - w).abs().max()) <= 2.0 ** -22 * float(w.abs().max())


def test_cin_layer_kernel_splits_a_large_h_to_fit(dev):
    """H = 600 rows of xk (K = 24,000) do not fit a block's shared memory
    whole: the plan splits K although the 125 row tiles fill the card."""
    from repro_torch.kernels import cin
    b, f, h, hn, d = 1600, 40, 600, 8, 10
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cin.plan(b, f, h, hn, d, sms)[0] > cin.split_count(b * d, hn, h * f, sms)
    x0, xk, w = _cin_inputs(dev, b, f, h, hn, d, torch.float32)
    torch.testing.assert_close(ops.cin_layer(x0, xk, w), ref.cin_layer(x0, xk, w),
                               rtol=1e-4, atol=1e-4)


def _decode_inputs(dev, b, hq, hkv, d, t, dtype, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
               for shape in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    return q, k, v, rng


@pytest.mark.parametrize("b,hq,hkv,d,t", [
    (2, 8, 2, 64, 256), (4, 4, 4, 32, 128), (1, 16, 8, 128, 512),   # tests/test_kernels.py
    (3, 14, 2, 64, 1000), (1, 14, 2, 64, 32768),                    # qwen2-0.5b: G = 7
    (5, 7, 1, 8, 77), (2, 8, 2, 8, 1), (3, 4, 4, 16, 130),          # the smoke configs' D
    (2, 32, 32, 96, 300), (1, 56, 8, 128, 4097),                    # phi3 (D = 96), yi (G = 7)
    (8, 14, 2, 64, 1024),                                           # lm_generate's shape
    (8, 16, 8, 64, 1024), (8, 32, 4, 128, 1024),                    # granite-moe, qwen3-moe
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel(dev, b, hq, hkv, d, t, dtype):
    """pos drawn from [1, T] plus the edges 0, 1 and T, and pos on and one
    slot either side of the plan's run boundaries; float32 within 1e-4,
    bfloat16 within 3e-2, as tests/test_kernels.py holds the Pallas
    kernel."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, rng = _decode_inputs(dev, b, hq, hkv, d, t, dtype)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    run = da.plan(b, hkv, t, d, q.element_size(), da.sm_count(dev.index or 0)).run_slots
    boundaries = np.clip([(i // 3 + 1) * run + i % 3 - 1 for i in range(b)], 1, t)
    for pos in (rng.integers(1, t + 1, size=b), np.zeros(b), np.ones(b), np.full(b, t),
                boundaries, np.full(b, min(run + 1, t))):
        pos = torch.from_numpy(pos.astype(np.int32)).to(dev)
        before = ops.launch_counts()["decode_attention"]
        got = ops.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == before + 1
        assert got.dtype == dtype and got.shape == (b, hq, d)
        torch.testing.assert_close(got.float(), ref.decode_attention(q, k, v, pos).float(), **tol)
    again = ops.decode_attention(q, k, v, pos)
    assert torch.equal(again, got)                 # no atomics: the same bits every run


@pytest.mark.parametrize("b,t,pos", [(8, 1024, "uniform"), (1, 32768, "full"), (3, 1000, "runs")])
def test_decode_attention_kernel_graph_replay_same_bits(dev, b, t, pos):
    """At shapes the plan splits into runs (main kernel, then the combine as
    a programmatic dependent): a call captured in a CUDA graph and replayed
    gives the bits of an eager call, and a second eager call the same."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, rng = _decode_inputs(dev, b, 14, 2, 64, t, torch.bfloat16)
    p = da.plan(b, 2, t, 64, 2, da.sm_count(dev.index or 0))
    assert p.runs > 1
    pos = {"uniform": rng.integers(1, t + 1, size=b), "full": np.full(b, t),
           "runs": np.clip([(i + 1) * p.run_slots + i - 1 for i in range(b)], 1, t)}[pos]
    pos = torch.from_numpy(pos.astype(np.int32)).to(dev)
    eager = ops.decode_attention(q, k, v, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.decode_attention(q, k, v, pos)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
    assert torch.equal(ops.decode_attention(q, k, v, pos), eager)
    torch.testing.assert_close(eager.float(), ref.decode_attention(q, k, v, pos).float(),
                               rtol=3e-2, atol=3e-2)


def test_decode_attention_kernel_past_the_cache(dev):
    """pos > T reads every slot, as pos = T does."""
    q, k, v, _ = _decode_inputs(dev, 2, 14, 2, 64, 100, torch.float32)
    at_t = ops.decode_attention(q, k, v, torch.full((2,), 100, dtype=torch.int32, device=dev))
    past = ops.decode_attention(q, k, v, torch.full((2,), 250, dtype=torch.int32, device=dev))
    assert torch.equal(at_t, past)


def test_decode_attention_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, _ = _decode_inputs(dev, 2, 8, 2, 64, 16, torch.float32)
    pos = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention(q, k, v, pos.long())
    with pytest.raises(ValueError, match="the kernel takes D"):
        ops.decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                             v[..., :48].contiguous(), pos)
    with pytest.raises(ValueError, match="the kernel takes D"):
        ops.decode_attention(torch.zeros((2, 6, 64), device=dev), k, v, pos)   # G = 3
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, pos)
    with pytest.raises(ValueError, match="lies on"):
        ops.decode_attention(q, k, v, pos.cpu())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table = torch.zeros((10, 4), device=dev)
    with pytest.raises(TypeError, match="int32"):
        ops.embedding_bag(table, torch.zeros((3, 2), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        ops.embedding_bag(table.t().contiguous().t(), torch.zeros((3, 2), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="lies on"):
        ops.embedding_bag(table, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        ops.dot_interaction(torch.zeros((1, 2000, 64), device=dev))
    x0 = torch.zeros((2, 3, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.cin_layer(x0, x0, torch.zeros((6, 9), device=dev).t())
    with pytest.raises(ValueError, match="lies on"):
        ops.cin_layer(x0, x0, torch.zeros((9, 6)))


@pytest.mark.parametrize("name", ["ncf", "wnd", "mt-wnd", "dlrm-rmc1", "dlrm-rmc2", "dlrm-rmc3",
                                  "din", "dien", "xdeepfm", "autoint", "mind", "bert4rec"])
def test_forward_on_gpu_matches_cpu(dev, name):
    """Kernels on the card against plain versions on the CPU, same weights;
    1e-4 because cuBLAS and the CPU matmul sum in different orders."""
    cfg = configs.get(name).smoke_config
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             syn.recsys_batch(np.random.default_rng(0), cfg, 13, with_label=False).items()}
    want = recsys.forward(params, cfg, batch)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(dev)

    ops.reset_launch_counts()
    got = recsys.forward(to(params), cfg, to(batch))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    if name == "xdeepfm":          # K1 once, K3 once per CIN layer
        assert ops.launch_counts() == {"embedding_bag": 1, "dot_interaction": 0,
                                       "cin_layer": len(cfg.cin_layers), "decode_attention": 0,
                                       **NO_BWD}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "phi3-mini-3.8b", "yi-34b",
                                  "granite-moe-1b-a400m", "qwen3-moe-30b-a3b"])
def test_lm_decode_on_gpu_matches_cpu(dev, name):
    """prefill + 3 decode steps of an LM smoke config, dense or MoE: K4 on
    the card against the plain attention on the CPU (the MoE layers'
    dispatch on the card against the CPU's), float32 within 1e-4; K4 once
    per layer a step, nothing else."""
    cfg = configs.get(name).smoke_config
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(0), cfg, 3, 8)["tokens"])
    want, caches = lm.prefill(params, cfg, toks[:, :5], 8)
    wants = [want]
    for t in range(5, 8):
        want, caches = lm.decode_step(params, cfg, toks[:, t], caches)
        wants.append(want)
    params_d = torch.utils._pytree.tree_map(lambda x: x.to(dev), params)
    ops.reset_launch_counts()
    got, caches = lm.prefill(params_d, cfg, toks[:, :5].to(dev), 8)
    gots = [got]
    for t in range(5, 8):
        got, caches = lm.decode_step(params_d, cfg, toks[:, t].to(dev), caches)
        gots.append(got)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"embedding_bag": 0, "dot_interaction": 0, "cin_layer": 0,
                                   "decode_attention": 3 * cfg.n_layers, **NO_BWD}
    for g, w in zip(gots, wants):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def test_measure_card_curve_runs_on_the_card(dev):
    """Six positive points, a split of each into pad, copy and forward, and
    exactly the model's kernels a request: the curve is the card's."""
    cfg = configs.get("dlrm-rmc1").smoke_config
    ops.reset_launch_counts()
    got = infra.measure_card_curve("dlrm-rmc1", cfg=cfg)
    assert got.curve.batches.tolist() == [1, 4, 16, 64, 256, 1024]
    assert bool(np.all(got.curve.seconds > 0)) and len(got.curve.seconds) == 6
    assert got.requests == 6 * (infra.CARD_WARMUP + infra.CARD_REPS)
    assert ops.launch_counts() == {"embedding_bag": got.requests, "dot_interaction": got.requests,
                                   "cin_layer": 0, "decode_attention": 0, **NO_BWD}
    assert sorted(got.steps_ms) == [1, 4, 16, 64, 256, 1024]
    assert all(v > 0 for s in got.steps_ms.values() for v in s.values())


def _live_model(dev, arch="dlrm-rmc1", seed=0):
    cfg = configs.get(arch).smoke_config
    params = recsys.init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    template = syn.recsys_batch(np.random.default_rng(seed), cfg, 1000, with_label=False)
    n = [0]

    def apply_fn(batch):
        n[0] += 1
        return recsys.forward(params, cfg, batch)

    return apply_fn, (lambda size, model_id: {k: v[:size] for k, v in template.items()}), n


def test_calibrate_device_on_the_card_is_positive_and_monotone(dev):
    from repro_torch.cluster import calibrate_device
    apply_fn, make_batch, n = _live_model(dev)
    ops.reset_launch_counts()
    curve = calibrate_device(apply_fn, make_batch, max_bucket=64, burst=8, reps=3)
    assert curve.buckets.tolist() == [1, 2, 4, 8, 16, 32, 64]
    assert bool(np.all(curve.seconds > 0)) and bool(np.all(np.diff(curve.seconds) >= 0))
    assert n[0] == 7 * 8 * (1 + 3)
    assert ops.launch_counts() == {"embedding_bag": n[0], "dot_interaction": n[0],
                                   "cin_layer": 0, "decode_attention": 0, **NO_BWD}


def test_live_node_on_the_card_serves_every_query_with_exact_launches(dev):
    """A live node named no device runs on the card: every query of a short
    trace served, none errored, one K1 and one K2 a request."""
    from repro_torch.cluster import BucketedDeviceModel, drive_fleet, live_node, make_router
    from repro_torch.core.query_gen import sample_trace
    apply_fn, make_batch, n = _live_model(dev)
    curve = BucketedDeviceModel([1, 2, 4, 8, 16, 32, 64], np.full(7, 5e-4))
    node = live_node(apply_fn, make_batch, pool="card", device=curve, batch_size=32,
                     max_bucket=64)
    try:
        assert node.rt.device.type == "cuda"
        unit, sizes = sample_trace(np.random.default_rng(1), 60)
        ops.reset_launch_counts()
        r = drive_fleet(unit / 200.0, sizes, [node], make_router("round_robin"), telemetry=True)
        assert (r.n_queries, r.dropped, r.errors) == (60, 0, 0)
        assert n[0] == int(np.sum(-(-sizes // 32)))
        assert ops.launch_counts() == {"embedding_bag": n[0], "dot_interaction": n[0],
                                       "cin_layer": 0, "decode_attention": 0, **NO_BWD}
        assert r.telemetry.attribution().reconciles(0.05)
    finally:
        node.close()


def test_apply_moe_on_gpu_matches_cpu(dev):
    """The MoE layer at granite-moe's published widths (32 experts, top-8,
    d_model 1,024, d_ff 512) on the card against the CPU, float32: 8 decode
    tokens (capacity 2) and a prefill of 512 (capacity 160); the same
    routing, so the same dropped share, and y within 1e-4."""
    from repro_torch.layers import moe
    params = moe.init_moe(torch.Generator().manual_seed(0), 1024, 512, 32, 8, device="cpu")
    params_d = torch.utils._pytree.tree_map(lambda x: x.to(dev), params)
    for b, s in ((8, 1), (1, 512)):
        x = torch.from_numpy(np.random.default_rng(b).normal(size=(b, s, 1024))
                             .astype(np.float32))
        want, want_aux = moe.apply_moe(params, x, top_k=8)
        got, got_aux = moe.apply_moe(params_d, x.to(dev), top_k=8)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        assert float(got_aux["dropped_frac"]) == float(want_aux["dropped_frac"])
        torch.testing.assert_close(got_aux["aux_loss"].cpu(), want_aux["aux_loss"],
                                   rtol=1e-5, atol=0)


def test_remote_worker_serves_on_the_card(dev):
    """A worker the supervisor was not told a device for serves mlp on the
    card: it says so, its outputs equal the twin on the CPU, and it serves
    every query of a short trace."""
    from repro_torch.cluster.live import BucketedDeviceModel
    from repro_torch.cluster.remote import WorkerSupervisor, remote_node
    from repro_torch.serve.remote import build_model
    curve = BucketedDeviceModel(np.array([1, 2, 4, 8, 16, 32, 64]), np.full(7, 1e-4))
    with WorkerSupervisor() as sup:
        b = remote_node("mlp:128:256:2", supervisor=sup, device=curve, batch_size=16,
                        max_bucket=64)
        try:
            assert sup.ping(b.handle)["device"] == "cuda"
            b.start(0.0)
            b.submit(np.arange(20), np.linspace(0.0, 0.1, 20), np.full(20, 8))
            b.drain(30)
            recs = b.completed_records()
            assert sorted(r.index for r in recs) == list(range(20))
            assert all(r.error is None for r in recs)
        finally:
            b.close()
    apply_fn, make_batch = build_model("mlp:128:256:2", dev)
    cpu_fn, _ = build_model("mlp:128:256:2", "cpu")
    x = torch.from_numpy(make_batch(16, -1)["x"])
    torch.testing.assert_close(apply_fn({"x": x.to(dev)}).cpu(), cpu_fn({"x": x}),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ the GCN


def _gcn_on(dev, cfg, g: dict, loss_name: str = "loss_fn"):
    from repro_torch.models import gnn
    from repro_torch.train.microbatch import value_and_grad
    from repro_torch.utils import leaves_with_paths
    params = gnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = torch.utils._pytree.tree_map(lambda x: x.to(dev), params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
    loss, grads = value_and_grad(lambda p, b: getattr(gnn, loss_name)(p, cfg, b), params, batch)
    return loss.cpu(), [(k, v.cpu()) for k, v in leaves_with_paths(grads)]


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_gcn_on_gpu_matches_cpu_and_repeats_to_the_bit(dev, shape):
    """gcn-cora at Cora's shape (full batch) and at the molecule batch: the
    loss and every gradient on the card against the CPU within 1e-4, and a
    second run on the card gives the same bits (the sums over edges run in
    a fixed order)."""
    from repro_torch.configs import gcn_cora
    s = configs.GNN_SHAPES[shape]
    cfg = gcn_cora.config_for_shape(s)
    rng = np.random.default_rng(0)
    if s.kind == "full":
        g, name = syn.random_graph(rng, s.n_nodes, s.n_edges, cfg.d_feat, cfg.n_classes), "loss_fn"
    else:
        g, name = syn.molecule_batch(rng, s.batch, s.nodes_per_graph, s.edges_per_graph,
                                     cfg.d_feat, cfg.n_classes), "graph_loss_fn"
    want_loss, want = _gcn_on(torch.device("cpu"), cfg, g, name)
    loss, got = _gcn_on(dev, cfg, g, name)
    again_loss, again = _gcn_on(dev, cfg, g, name)
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
    assert torch.equal(loss, again_loss)
    for (k, a), (_, w), (_, b) in zip(got, want, again):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4, msg=k)
        assert torch.equal(a, b), k


def test_gcn_blocks_on_gpu_match_cpu(dev):
    """forward_blocks over sampled blocks on the card against the CPU."""
    from repro_torch.models import gnn
    cfg = configs.get("gcn-cora").smoke_config
    g = syn.random_graph(np.random.default_rng(0), 500, 4000, cfg.d_feat, cfg.n_classes)
    indptr, indices = syn.graph_to_csr(500, g["edge_index"])
    blocks, ids = gnn.sample_neighbors(indptr, indices, np.arange(32), [5, 4],
                                       np.random.default_rng(0))
    params = gnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = gnn.forward_blocks(params, cfg, torch.from_numpy(g["x"][ids]), blocks)
    params_d = torch.utils._pytree.tree_map(lambda x: x.to(dev), params)
    got = gnn.forward_blocks(params_d, cfg, torch.from_numpy(g["x"][ids]).to(dev), blocks)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------ distributed, one NCCL rank


@pytest.fixture
def nccl_world_of_one(dev):
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def test_distributed_runtime_in_an_nccl_world_of_one(nccl_world_of_one):
    """Each piece on CUDA tensors against its single-device meaning: the
    ring all-gather is the identity, the overlapped and reduce-scatter
    matmuls are x @ w, a one-stage pipeline is its stage, compressed_psum
    stays within one block scale, the sharded MoE at m = 1 is apply_moe."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import pipeline as pipe
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.layers import moe
    from repro_torch.train import grad_compress as gc
    from torch.distributed.tensor import distribute_tensor
    dev = nccl_world_of_one
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn((16, 64), generator=gen).to(dev), torch.randn((64, 32), generator=gen).to(dev)
    assert torch.equal(coll.ring_all_gather(x), x)
    torch.testing.assert_close(coll.overlapped_all_gather_matmul(x, w), x @ w)
    torch.testing.assert_close(coll.reduce_scatter_matmul(x, w), x @ w)
    ws = torch.randn((1, 64, 64), generator=gen).to(dev) * 0.1
    fwd = pipe.make_pipelined_fn(lambda w_, h: torch.tanh(h @ w_), num_microbatches=4)
    torch.testing.assert_close(fwd(ws, x), torch.tanh(x @ ws[0]))
    g = torch.randn((4196,), generator=gen).to(dev)
    mean, res = gc.compressed_psum({"g": g}, None, {"g": torch.zeros_like(g)})
    assert float((mean["g"] - g).abs().max()) <= float(g.abs().max()) / 127
    torch.testing.assert_close(mean["g"] + res["g"], g, rtol=0, atol=1e-6)

    cfg = configs.get("granite-moe-1b-a400m").config
    mesh = mesh_lib.make_host_mesh(1, 1)
    params = torch.utils._pytree.tree_map(lambda t: t.to(dev), moe.init_moe(
        gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, device="cpu"))
    experts = shd.to_placements(mesh, ("model", None, None))
    sharded = {"router": params["router"],
               **{k: distribute_tensor(params[k], mesh, experts) for k in ("wg", "wu", "wd")}}
    xm = torch.randn((4, 8, cfg.d_model), generator=gen).to(dev)
    y, aux = moe.make_sharded_moe(mesh, top_k=cfg.top_k)(sharded, xm)
    want, want_aux = moe.apply_moe(params, xm, top_k=cfg.top_k)
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(aux["aux_loss"], want_aux["aux_loss"], rtol=2e-5, atol=0)
    assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
