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
NO_BWD = {"embedding_bag_backward": 0, "dot_interaction_backward": 0, "cin_layer_backward": 0}


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


def _same_bits_under_graph_replay(call, eager):
    """``call()``, the whole wrapper call, captured in a CUDA graph and
    replayed, gives ``eager``'s bits (and the capture shows the call does
    not synchronise with the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)


def test_embedding_bag_backward_kernel_same_bits_every_launch(dev):
    """No atomics: the lookups are sorted by row and each row is summed in
    an order fixed by the data, so RMC2's shape under Zipf ids gives the
    same bits on a second launch and under CUDA-graph replay of the whole
    call, and a table beyond D = 256 is refused."""
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=(1024, 40, 32)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(syn._zipf_ids(rng, (1024, 40, 80), 100_000).astype(np.int32)).to(dev)
    first = ops.embedding_bag_backward(g, idx, 100_000)
    assert torch.equal(ops.embedding_bag_backward(g, idx, 100_000), first)
    ops.reset_launch_counts()
    _same_bits_under_graph_replay(lambda: ops.embedding_bag_backward(g, idx, 100_000), first)
    assert ops.launch_counts()["embedding_bag_backward"] == 2     # warm-up and capture: one each
    with pytest.raises(ValueError, match="D <= 256"):
        ops.embedding_bag_backward(torch.zeros((2, 1, 257), device=dev),
                                   torch.zeros((2, 1, 3), dtype=torch.int32, device=dev), 4)


def test_embedding_bag_backward_kernel_at_rmc2_with_hot_rows(dev):
    """RMC2's tables (40 x 10^6 x 32) at B = 1,024 under Zipf ids: row 0 of
    each table takes about 4,100 lookups, dozens of the plan's chunks, so
    its sum is split into partials and combined; every table's dense
    gradient against the float64 plain version."""
    from repro_torch.kernels import embedding_bag as eb
    rng = np.random.default_rng(10)
    b, f, v, h, d = 1024, 40, 1_000_000, 80, 32
    g = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(syn._zipf_ids(rng, (b, f, h), v).astype(np.int32)).to(dev)
    plan = eb.backward_plan(b, f, v, h, d, 4, eb.backward_vectorized(g))
    assert int((idx == 0).sum(dim=(0, 2)).min()) > 8 * plan.chunk
    got = ops.embedding_bag_backward(g, idx, v)
    torch.cuda.synchronize()
    for t in range(0, f, 8):                  # eight tables at a time: 256 MB of float64 each
        _grad_close(got[t:t + 8], ref.embedding_bag_backward(g[:, t:t + 8].double(),
                                                             idx[:, t:t + 8].contiguous(), v))


@pytest.mark.parametrize("d", [1, 32, 33, 64, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_kernel_widths(dev, d, dtype, mode):
    """Every row width the kernel is instantiated for (16-byte vectors and
    the scalar path; one lane group or a whole warp a row, one to eight
    vectors a lane), bags of H = 150 > 128 lookups, and Zipf ids on 60 rows
    so that row 0 spans many chunks: against the float64 plain version."""
    rng = np.random.default_rng(11)
    b, f, v, h = 37, 3, 60, 150
    g = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32)).to(dev, dtype)
    idx = torch.from_numpy(syn._zipf_ids(rng, (b, f, h), v).astype(np.int32)).to(dev)
    ops.reset_launch_counts()
    got = ops.embedding_bag_backward(g, idx, v, mode=mode)
    torch.cuda.synchronize()
    assert ops.launch_counts()["embedding_bag_backward"] == 1
    _grad_close(got, ref.embedding_bag_backward(g.double(), idx, v, mode=mode))
    assert torch.equal(ops.embedding_bag_backward(g, idx, v, mode=mode), got)


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
                                   "dot_interaction_backward": 0, "cin_layer_backward": 0}
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


@pytest.mark.parametrize("b,f,d,offset", [(9, 5, 3, 15), (64, 11, 32, 1), (5, 41, 32, 1),
                                          (1000, 41, 32, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interaction_backward_kernel_unaligned_start(dev, b, f, d, offset, dtype):
    """grad and feats whose first element lies ``offset`` elements into
    their storage, off a 16-byte boundary: the kernel takes its scalar copy
    path and reads nothing outside either tensor."""
    rng = np.random.default_rng(12)
    p = f * (f - 1) // 2
    xs = torch.from_numpy((rng.normal(size=offset + b * f * d) / d ** 0.5)
                          .astype(np.float32)).to(dev, dtype)
    gs = torch.from_numpy(rng.normal(size=offset + b * p).astype(np.float32)).to(dev, dtype)
    x, g = xs[offset:].view(b, f, d), gs[offset:].view(b, p)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    got = ops.dot_interaction_backward(g, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), ref.dot_interaction_backward(g.double(), x.double()),
                               **_tol(dtype))
    assert torch.equal(ops.dot_interaction_backward(g, x), got)


@pytest.mark.parametrize("b", [1000, 1024, 4099])
def test_dot_interaction_backward_kernel_same_bits_under_graph_replay(dev, b):
    """At RMC2's (F, D), B a multiple of the grid or not (each block walks
    its samples at the grid's stride, the last ones short): the float64
    plain version, a second launch and a CUDA-graph replay of the call."""
    from repro_torch.kernels import interaction as ix
    rng = np.random.default_rng(13)
    x = torch.from_numpy((rng.normal(size=(b, 41, 32)) / 32 ** 0.5).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(b, 820)).astype(np.float32)).to(dev)
    plan = ix.backward_plan(b, 41, 32, 4, ix.sm_count(dev.index or 0))
    assert plan.grid < b
    got = ops.dot_interaction_backward(g, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), ref.dot_interaction_backward(g.double(), x.double()),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(ops.dot_interaction_backward(g, x), got)
    _same_bits_under_graph_replay(lambda: ops.dot_interaction_backward(g, x), got)


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
                                   "dot_interaction_backward": 1, "cin_layer_backward": 0}
    torch.testing.assert_close(grad.double(), ref.dot_interaction_backward(g.double(), x.double()),
                               rtol=2e-5, atol=2e-5)


def test_kernels_without_a_backward_raise_under_grad(dev):
    """K4 and the full Gram product have no backward kernel: on a CUDA
    tensor that needs a gradient they raise, never hand back a result that
    autograd cannot see through.  K3 has one: under grad a call launches one
    K3, and ``.backward()`` one K3-bwd; under no_grad it launches K3 alone."""
    x0, xk, w = (torch.randn(s, device=dev) for s in ((2, 3, 4), (2, 5, 4), (15, 6)))
    w.requires_grad_()
    ops.reset_launch_counts()
    out = ops.cin_layer(x0, xk, w)
    torch.cuda.synchronize()
    assert (ops.launch_counts()["cin_layer"], ops.launch_counts()["cin_layer_backward"]) == (1, 0)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (ops.launch_counts()["cin_layer"], ops.launch_counts()["cin_layer_backward"]) == (1, 1)
    torch.testing.assert_close(w.grad, ref.cin_layer_backward(torch.ones_like(out), x0, xk,
                                                              w.detach())[2],
                               rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        assert ops.cin_layer(x0, xk, w).shape == (2, 6, 4)
    assert (ops.launch_counts()["cin_layer"], ops.launch_counts()["cin_layer_backward"]) == (2, 1)
    feats = torch.randn((2, 3, 4), device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gram"):
        ops.gram(feats)
    q = torch.randn((1, 2, 8), device=dev, requires_grad=True)
    kv = torch.randn((1, 4, 1, 8), device=dev)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, kv, kv, torch.tensor([2], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("name", ["dlrm-rmc1", "dlrm-rmc2", "dlrm-rmc3", "wnd", "xdeepfm"])
def test_train_step_on_gpu_matches_cpu(dev, name):
    """One loss and every leaf's gradient of a smoke config on the card (K1,
    K1-bwd, for the DLRMs K2, K2-bwd once each, for xDeepFM a K3 and a
    K3-bwd a CIN layer) against the plain versions on the CPU, float32
    within 1e-4."""
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
    cin = len(cfg.cin_layers) if cfg.interaction == "cin" else 0
    assert ops.launch_counts() == {"embedding_bag": 1, "dot_interaction": dot, "cin_layer": cin,
                                   "decode_attention": 0, "embedding_bag_backward": 1,
                                   "dot_interaction_backward": dot, "cin_layer_backward": cin}
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


CIN_BWD_SHAPES = [
    (8, 6, 5, 7, 128), (16, 10, 10, 4, 64), (4, 3, 8, 16, 130),   # tests/test_kernels.py
    (4, 6, 16, 8, 10), (1, 39, 39, 200, 10), (65, 39, 200, 200, 10), (3, 1, 1, 1, 1),
    (1, 39, 200, 200, 10), (64, 39, 200, 200, 10), (512, 39, 200, 200, 10),   # xDeepFM
    (2, 5, 7, 300, 3), (3, 4, 5, 73, 2),
    (9, 2, 3, 16, 1), (5, 4, 4, 7, 1),                            # D = 1; K below a stage
    (1600, 40, 600, 8, 10),                                       # K = 24,000, split
    (50, 100, 3, 16, 5), (20, 176, 2, 8, 3),      # one block an SM; chunks of 32 columns
    (8192, 39, 39, 200, 10), (8192, 39, 200, 200, 10),   # xDeepFM, the data gradient whole
    (6800, 7, 9, 33, 10),                         # whole, M = 68,000 not a multiple of 128
    (20, 191, 2, 8, 3),                           # the largest F a block holds at N = 8
    (40, 64, 3, 200, 10), (40, 89, 3, 200, 10),   # at N = 200: chunks of 64 and of 32
]

# K3-bwd's tile edges: N not a multiple of 8 (one and two column tiles), K =
# H·F not a multiple of the data product's chunk of columns, and row runs
# of the weight gradient that end inside a sample (row_run % D != 0)
CIN_BWD_EDGES = [(40, 39, 39, 13, 10), (33, 39, 200, 201, 10), (17, 13, 11, 24, 10),
                 (300, 6, 5, 16, 7), (1024, 39, 200, 200, 10)]


def _cin_bwd_check(got, x0, xk, w, g, dtype):
    """Each gradient against the plain backward on the card: float32 within
    1e-4 of the largest value (rtol = 1e-4 besides), bfloat16 (the float32
    result cast down) 2e-2.  In float32 also against float64 within
    ``cin.backward_error_bound``'s c · Σ|terms|."""
    want = ref.cin_layer_backward(g, x0, xk, w)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, e in zip(("dx0", "dxk", "dw"), got, want):
        assert a.dtype == dtype and a.shape == e.shape, name
        top = float(e.float().abs().max())
        torch.testing.assert_close(a.float(), e.float(), rtol=tol, atol=tol * max(top, 1e-30),
                                   msg=name)
    if dtype == torch.float32:
        exact = ref.cin_layer_backward(g.double(), x0.double(), xk.double(), w.double())
        mag = ref.cin_layer_backward(g.double().abs(), x0.double().abs(), xk.double().abs(),
                                     w.double().abs())
        from repro_torch.kernels import cin
        bound = cin.backward_error_bound(x0.shape[0], x0.shape[1], xk.shape[1], w.shape[1],
                                         x0.shape[2])
        for name, a, e, m in zip(("dx0", "dxk", "dw"), got, exact, mag):
            assert bool(((a.double() - e).abs() <= bound[name] * m).all()), name


@pytest.mark.parametrize("b,f,h,hn,d", CIN_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cin_layer_backward_kernel(dev, b, f, h, hn, d, dtype):
    """K3-bwd over the forward's sweep, a K of 24,000 cut into runs, F up to
    what a block's shared memory holds (191 at N = 8, 89 at N = 200), and
    batches of 6,800 and 8,192
    whose data gradient is not cut into runs of h (dx0 stored straight from
    shared memory, as at train_batch's 65,536): against the plain backward
    and, in float32, against float64 (``_cin_bwd_check``); one launch a
    call."""
    x0, xk, w = _cin_inputs(dev, b, f, h, hn, d, dtype)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(b, hn, d)).astype(np.float32)).to(
        dev, dtype)
    before = ops.launch_counts()["cin_layer_backward"]
    got = ops.cin_layer_backward(g, x0, xk, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cin_layer_backward"] == before + 1
    _cin_bwd_check(got, x0, xk, w, g, dtype)


@pytest.mark.parametrize("b,f,h,hn,d", CIN_BWD_EDGES)
def test_cin_layer_backward_kernel_at_its_tiles_edges(dev, b, f, h, hn, d):
    """Each shape sits on an edge of K3-bwd's tiles (``CIN_BWD_EDGES``), as
    its plan says; float32 against the plain backward and float64
    (``_cin_bwd_check``)."""
    from repro_torch.kernels import cin
    p = cin.backward_plan(b, f, h, hn, d)
    assert hn % 8 or (h * f) % p.chunk or (p.weight_splits > 1 and p.row_run % d)
    x0, xk, w = _cin_inputs(dev, b, f, h, hn, d, torch.float32)
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(b, hn, d)).astype(np.float32)).to(
        dev)
    got = ops.cin_layer_backward(g, x0, xk, w)
    torch.cuda.synchronize()
    _cin_bwd_check(got, x0, xk, w, g, torch.float32)


@pytest.mark.parametrize("b", [1, 512, 4096, 8192])
def test_cin_layer_backward_kernel_same_bits_every_launch(dev, b):
    """No atomics and sums in an order fixed by the shapes: a second launch
    on the same inputs gives the same bits (B = 1, 512 and 4,096 cut both
    products into runs; 8,192 only the weight gradient's rows)."""
    x0, xk, w = _cin_inputs(dev, b, 39, 200, 200, 10, torch.float32)
    g = torch.randn((b, 200, 10), device=dev)
    first = ops.cin_layer_backward(g, x0, xk, w)
    again = ops.cin_layer_backward(g, x0, xk, w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, again))


def test_cin_layer_backward_through_autograd_adds_the_first_layers_gradients(dev):
    """A CIN's first layer takes x0 as both inputs: autograd adds K3-bwd's
    dx0 and dxk into x0's gradient, against the plain backward's sum."""
    x0, _, w = _cin_inputs(dev, 33, 39, 39, 200, 10, torch.float32)
    g = torch.randn((33, 200, 10), device=dev)
    x0.requires_grad_()
    ops.reset_launch_counts()
    (got,) = torch.autograd.grad(ops.cin_layer(x0, x0, w), x0, g)
    torch.cuda.synchronize()
    assert (ops.launch_counts()["cin_layer"], ops.launch_counts()["cin_layer_backward"]) == (1, 1)
    dx0, dxk, _ = ref.cin_layer_backward(g, x0.detach(), x0.detach(), w)
    torch.testing.assert_close(got, dx0 + dxk, rtol=1e-4, atol=1e-4 * float((dx0 + dxk).abs().max()))


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


@pytest.mark.parametrize("b,hq,hkv,d,t", [
    (8, 14, 2, 64, 1024),                                           # lm_generate's shape
    (128, 14, 2, 64, 32768),                                        # decode_32k's
    (8, 16, 8, 64, 1024), (8, 32, 4, 128, 1024),                    # granite-moe, qwen3-moe
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_lse(dev, b, hq, hkv, d, t, dtype):
    """K4's log-sum-exp, written by the main kernel for a sequence of one
    run and by the combine for one of more, against the plain version's
    (float32 either way: within 1e-4 of 1 + |lse|), -inf where pos <= 0;
    the output the lse-less launch's bits, and one launch either way."""
    from repro_torch.kernels import decode_attention as da
    q, k, v, rng = _decode_inputs(dev, b, hq, hkv, d, t, dtype)
    run = da.plan(b, hkv, t, d, q.element_size(), da.sm_count(dev.index or 0)).run_slots
    boundaries = np.clip([(i // 3 + 1) * run + i % 3 - 1 for i in range(b)], 1, t)
    for pos in (rng.integers(1, t + 1, size=b), np.zeros(b), np.ones(b), np.full(b, t),
                boundaries, np.where(np.arange(b) % 2, 0, t)):
        pos = torch.from_numpy(pos.astype(np.int32)).to(dev)
        before = ops.launch_counts()["decode_attention"]
        out, lse = ops.decode_attention(q, k, v, pos, return_lse=True)
        plain_out = ops.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == before + 2
        assert torch.equal(out, plain_out)
        assert lse.dtype == torch.float32 and lse.shape == (b, hq)
        _, want = ref.decode_attention(q, k, v, pos, return_lse=True)
        assert torch.equal(torch.isneginf(lse), torch.isneginf(want))
        assert bool(torch.isneginf(lse[pos <= 0]).all())
        fin = torch.isfinite(want)
        err = (lse[fin] - want[fin]).abs()
        assert bool((err <= 1e-4 * (1 + want[fin].abs())).all()), float(err.max())


@pytest.mark.parametrize("pos_kind", ["full", "uniform"])
def test_decode_attention_sliced_and_merged_is_one_launch(dev, pos_kind):
    """A 32,768-slot cache cut into 16 slices of 2,048 (a decode_32k cache
    split over time on a 16-way model axis): each slice's launch with its
    log-sum-exp at its local length, merged in slice order
    (``ref.merge_decode_attention``), against one launch over the whole
    cache, bf16 within 3e-2 (atol scaled by the result's magnitude, as
    chip_smoke.py's ``decode_compare``); the merged lse within 1e-4."""
    b, t, n = 8, 32768, 16
    per = t // n
    q, k, v, rng = _decode_inputs(dev, b, 14, 2, 64, t, torch.bfloat16)
    pos = rng.integers(1, t + 1, size=b) if pos_kind == "uniform" else np.full(b, t)
    pos = torch.from_numpy(pos.astype(np.int32)).to(dev)
    whole, whole_lse = ops.decode_attention(q, k, v, pos, return_lse=True)
    outs, lses = [], []
    for r in range(n):
        local = (pos - r * per).clamp(0, per).to(torch.int32)
        o, lse = ops.decode_attention(q, k[:, r * per:(r + 1) * per].contiguous(),
                                      v[:, r * per:(r + 1) * per].contiguous(), local,
                                      return_lse=True)
        outs.append(o)
        lses.append(lse)
    merged, merged_lse = ref.merge_decode_attention(torch.stack(outs), torch.stack(lses))
    atol = 3e-2 * min(1.0, float(whole.abs().max()))
    torch.testing.assert_close(merged.float(), whole.float(), rtol=3e-2, atol=atol)
    torch.testing.assert_close(merged_lse, whole_lse, rtol=1e-4, atol=1e-4)


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


# ------------------------------------------------- DTensors, one NCCL rank


def _one_rank_mesh():
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_host_mesh(1, 1)


@pytest.mark.parametrize("split", ["columns", "rows"])
def test_embedding_bag_dtensor_route_launches_k1_and_k1_bwd(nccl_world_of_one, split):
    """A DTensor table (split by columns, or by rows: a zero row appended,
    every id on the one rank's range) and ids split over the batch: one K1
    forward and one K1-bwd, the plain tensors' bits."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as shd
    dev = nccl_world_of_one
    mesh = _one_rank_mesh()
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(rng.normal(size=(3, 500, 32)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 500, size=(64, 3, 8)).astype(np.int32)).to(dev)
    spec = (None, None, "model") if split == "columns" else (None, "model", None)
    t_d = distribute_tensor(tables.clone(), mesh, shd.to_placements(mesh, spec))
    i_d = distribute_tensor(idx, mesh, shd.to_placements(mesh, ("data",)))
    t_d.requires_grad_(True)
    plain = tables.clone().requires_grad_(True)
    ops.reset_launch_counts()
    got = ops.embedding_bag(t_d, i_d, mode="sum")
    got.to_local().square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["embedding_bag"] == 1 and counts["embedding_bag_backward"] == 1, counts
    want = ops.embedding_bag(plain, idx, mode="sum")
    want.square().sum().backward()
    assert torch.equal(got.to_local(), want)
    assert torch.equal(t_d.grad.full_tensor(), plain.grad)


def test_dot_interaction_and_cin_dtensor_routes_launch_their_kernels(nccl_world_of_one):
    """K2 and K2-bwd, and K3 (no gradient), on DTensors split over the
    batch: one launch each, the plain tensors' bits."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as shd
    dev = nccl_world_of_one
    mesh = _one_rank_mesh()
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.normal(size=(128, 27, 32)).astype(np.float32)).to(dev)
    f_d = distribute_tensor(feats.clone(), mesh, shd.to_placements(mesh, ("data",)))
    f_d.requires_grad_(True)
    plain = feats.clone().requires_grad_(True)
    ops.reset_launch_counts()
    got = ops.dot_interaction(f_d)
    got.to_local().square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["dot_interaction"] == 1 and counts["dot_interaction_backward"] == 1, counts
    want = ops.dot_interaction(plain)
    want.square().sum().backward()
    assert torch.equal(got.to_local(), want) and torch.equal(f_d.grad.to_local(), plain.grad)

    x0 = torch.from_numpy(rng.normal(size=(64, 39, 10)).astype(np.float32)).to(dev)
    xk = torch.from_numpy(rng.normal(size=(64, 200, 10)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(200 * 39, 200)).astype(np.float32) / 88).to(dev)
    batch_split = shd.to_placements(mesh, ("data",))
    ops.reset_launch_counts()
    with torch.no_grad():
        got = ops.cin_layer(distribute_tensor(x0, mesh, batch_split),
                            distribute_tensor(xk, mesh, batch_split),
                            distribute_tensor(w, mesh, shd.to_placements(mesh, ())))
        torch.cuda.synchronize()
        assert ops.launch_counts()["cin_layer"] == 1
        assert torch.equal(got.to_local(), ops.cin_layer(x0, xk, w))


def test_recsys_train_cell_on_dtensors_is_its_unsharded_step(nccl_world_of_one):
    """DLRM-RMC2's train_batch cell at smoke size, B = 256, on a (1, 1)
    mesh: its step on DTensors and on plain tensors from the same weights,
    state and batch give the same bits (loss, every parameter, every
    optimiser leaf), with one K1, K2, K1-bwd and K2-bwd each."""
    from repro_torch.launch import steps
    from repro_torch.serve.runtime import to_device
    from repro_torch.utils import leaves_with_paths, tree_map
    dev = nccl_world_of_one
    mesh = _one_rank_mesh()
    cfg = configs.get("dlrm-rmc2").smoke_config
    cell = steps._recsys_cell("dlrm-rmc2", configs.RecShape("train_batch", 256, "train"), mesh,
                              smoke=True)
    params = recsys.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    state = cell.init_state(params)
    batch = to_device(syn.recsys_batch(np.random.default_rng(0), cfg, 256), dev)
    sharded = cell.place(tree_map(torch.clone, params), tree_map(torch.clone, state), batch)
    one = {"embedding_bag": 1, "dot_interaction": 1, "embedding_bag_backward": 1,
           "dot_interaction_backward": 1, "cin_layer": 0, "decode_attention": 0,
           "cin_layer_backward": 0}
    for args in (sharded, (params, state, batch)):
        ops.reset_launch_counts()
        loss = cell.fn(*args)[2]
        torch.cuda.synchronize()
        assert ops.launch_counts() == one
        if args is sharded:
            loss_s = loss.to_local()
    assert torch.equal(loss_s, loss)
    for got_tree, want_tree in ((sharded[0], params), (sharded[1], state)):
        got = dict(leaves_with_paths(got_tree))
        for k, want in leaves_with_paths(want_tree):
            assert torch.equal(got[k].to_local().to(want.device), want), k


def test_lm_train_cell_on_dtensors_is_its_plain_step(nccl_world_of_one):
    """qwen2-0.5b's smoke train_4k cell at 4 x 1,024 tokens (two
    cross-entropy chunks) and two microbatches on a (1, 1) mesh: the step
    on DTensors, whose weight gradients are put at their parameters' split
    as they are made and whose unembedding and cross-entropy run on the
    rank's rows and vocabulary (``local_map``), gives the plain step's bits:
    the loss, every parameter and every optimiser leaf; no kernel launches."""
    from repro_torch.launch import steps
    from repro_torch.utils import leaves_with_paths, tree_map
    dev = nccl_world_of_one
    mesh = _one_rank_mesh()
    cfg = configs.get("qwen2-0.5b").smoke_config
    cell = steps._lm_cell("qwen2-0.5b", configs.LMShape("train_4k", 1024, 4, "train"), mesh,
                          smoke=True, n_micro=2)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    state = cell.init_state(params)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in syn.lm_batch(np.random.default_rng(0), cfg, 4, 1024).items()}
    sharded = cell.place(tree_map(torch.clone, params), tree_map(torch.clone, state), batch)
    ops.reset_launch_counts()
    loss_s = cell.fn(*sharded)[2].to_local()
    loss = cell.fn(params, state, batch)[2]
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0
    assert bool(torch.isfinite(loss)) and torch.equal(loss_s, loss)
    for got_tree, want_tree in ((sharded[0], params), (sharded[1], state)):
        got = dict(leaves_with_paths(got_tree))
        for k, want in leaves_with_paths(want_tree):
            assert torch.equal(got[k].to_local(), want), k


# ------------------------------------------- accounting on fake CUDA tensors


@pytest.fixture
def smoke_script(dev):
    """chip_smoke.py imported (its timing functions print the figures the
    accounting must equal)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def _counted_on_fake_cuda(fn, *shapes_dtypes):
    """The counter's kernels after ``fn`` on fake CUDA tensors of these
    shapes and dtypes, and the launches it made (none)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline import analysis
    with FakeTensorMode():
        args = [torch.empty(s, dtype=d, device="cuda") for s, d in shapes_dtypes]
    before = ops.launch_counts()
    _, c = analysis.count(fn, tuple(args))
    assert ops.launch_counts() == before
    return c.kernels


def _figure(timing: dict) -> tuple[dict, int]:
    return dict(timing["accounted_flops"]), timing["accounted_bytes"]


def _kernel_work(kernels: dict, name: str) -> tuple[dict, int]:
    k = kernels[name]
    assert k["calls"] == 1
    return dict(k["flops_by_unit"]), k["bytes"]


def test_accounted_embedding_bag_is_its_timing_figure(smoke_script):
    rng = np.random.default_rng(0)
    tables = torch.randn((4, 1000, 32), device="cuda")
    t = smoke_script.time_embedding_bag(rng, tables.device, tables, 64, "zipf", h=8)
    got = _counted_on_fake_cuda(ops.embedding_bag, ((4, 1000, 32), torch.float32),
                                ((64, 4, 8), torch.int32))
    assert _kernel_work(got, "embedding_bag") == _figure(t)
    assert t["gathered_bound_ms"] == t["accounted_bytes"] / smoke_script.HBM_BYTES_PER_S * 1e3


def test_accounted_embedding_bag_backward_is_its_timing_figure(smoke_script):
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = torch.randn((4, 1000, 32), device="cuda")
    t = smoke_script.time_embedding_bag_backward(rng, gen, tables.device, tables, 64, "zipf",
                                                 h=8, n_sets=2, plain=False)
    got = _counted_on_fake_cuda(lambda g, i: ops.embedding_bag_backward(g, i, 1000),
                                ((64, 4, 32), torch.float32), ((64, 4, 8), torch.int32))
    assert _kernel_work(got, "embedding_bag_backward") == _figure(t)


def test_accounted_dot_interaction_and_backward_are_their_timing_figures(smoke_script):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    fwd = smoke_script.time_dot_interaction(gen, dev, 64, "dlrm-rmc1", other_store=False)
    bwd = smoke_script.time_dot_interaction_backward(gen, dev, 64, "dlrm-rmc1", n_sets=2)
    b, f, d = fwd["shape"]
    got = _counted_on_fake_cuda(ops.dot_interaction, ((b, f, d), torch.float32))
    assert _kernel_work(got, "dot_interaction") == _figure(fwd)
    got = _counted_on_fake_cuda(ops.dot_interaction_backward,
                                ((b, f * (f - 1) // 2), torch.float32), ((b, f, d), torch.float32))
    assert _kernel_work(got, "dot_interaction_backward") == _figure(bwd)


def test_accounted_cin_layer_is_its_timing_figure(smoke_script):
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, f, h, hn, d = 8, 5, 4, 6, 10
    t = smoke_script.time_cin_layer(gen, torch.device("cuda"), b, f, h, hn, d)
    got = _counted_on_fake_cuda(ops.cin_layer, ((b, f, d), torch.float32),
                                ((b, h, d), torch.float32), ((h * f, hn), torch.float32))
    assert _kernel_work(got, "cin_layer") == ({"tf32": t["tensor_core_flops"]}, t["bytes"])


def test_accounted_cin_layer_backward_is_its_timing_figure(smoke_script):
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, f, h, hn, d = 8, 5, 4, 6, 10
    t = smoke_script.time_cin_layer_backward(gen, torch.device("cuda"), b, f, h, hn, d)
    got = _counted_on_fake_cuda(ops.cin_layer_backward, ((b, hn, d), torch.float32),
                                ((b, f, d), torch.float32), ((b, h, d), torch.float32),
                                ((h * f, hn), torch.float32))
    assert _kernel_work(got, "cin_layer_backward") == (t["flops_by_unit"], t["bytes"])


def test_accounted_decode_attention_is_its_timing_figure(smoke_script):
    gen = torch.Generator(device="cuda").manual_seed(0)
    hq, hkv, d = smoke_script.k4_heads()
    t = smoke_script.time_decode_attention(0, gen, torch.device("cuda"), "accounting", 2, 256,
                                           "uniform")
    got = _counted_on_fake_cuda(
        ops.decode_attention, ((2, hq, d), torch.bfloat16), ((2, 256, hkv, d), torch.bfloat16),
        ((2, 256, hkv, d), torch.bfloat16), ((2,), torch.int32))
    assert _kernel_work(got, "decode_attention") == _figure(t)
    # every slot counted; the run's own bound reads only up to each pos
    assert t["accounted_bound_ms"] >= t["bound_ms"]


def test_lm_decode_and_prefill_cells_on_dtensors_are_their_plain_steps(nccl_world_of_one):
    """qwen2's smoke decode cell (B = 4, 64 slots) on a (1, 1) mesh against
    ``lm.decode_step`` on copies of the same caches, 3 steps: the same
    bits, n_layers K4 launches a step on each path; granite-moe's smoke
    prefill cell (``make_sharded_moe``) against ``lm.prefill`` (``apply_moe``,
    whose ``index_add_`` sums in no fixed order on the card) within 1e-5."""
    from repro_torch.configs import LMShape
    from repro_torch.launch import steps
    dev = nccl_world_of_one
    mesh = _one_rank_mesh()
    cfg = configs.get("qwen2-0.5b").smoke_config
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(0), cfg, 4, 9)["tokens"]).to(dev)
    _, caches = lm.prefill(params, cfg, toks[:, :6], 64)
    cell = steps._lm_cell("qwen2-0.5b", LMShape("decode", 64, 4, "decode"), mesh, smoke=True)
    p_d, _, c_d = cell.place(params, None, [{k: t.clone() for k, t in c.items()}
                                            for c in caches])
    for i in range(6, 9):
        ops.reset_launch_counts()
        want, caches = lm.decode_step(params, cfg, toks[:, i], caches)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == cfg.n_layers
        ops.reset_launch_counts()
        got, c_d = cell.fn(p_d, cell.place(None, toks[:, i])[1], c_d)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == cfg.n_layers
        assert torch.equal(got.to_local(), want)
    for cd, c in zip(c_d, caches):
        assert all(torch.equal(cd[k].to_local(), c[k]) for k in c)

    cfg = configs.get("granite-moe-1b-a400m").smoke_config
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(1), cfg, 2, 16)["tokens"]).to(dev)
    cell = steps._lm_cell("granite-moe-1b-a400m", LMShape("prefill", 16, 2, "prefill"), mesh,
                          smoke=True)
    got, got_caches = cell.fn(*cell.place(params, toks))
    want, want_caches = lm.prefill(params, cfg, toks, 16)
    torch.testing.assert_close(got.to_local(), want, rtol=1e-5, atol=1e-5)
    for g, w in zip(got_caches, want_caches):
        for k in w:
            torch.testing.assert_close(g[k].to_local(), w[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["full", "batched"])
def test_gnn_cells_on_dtensors_are_their_plain_steps(nccl_world_of_one, kind):
    """The GCN smoke cell (a padded full graph, or a batch of molecules) on
    a (1, 1) mesh: one step on DTensors and on plain tensors, the same
    bits (loss, parameters, AdamW state)."""
    from repro_torch.configs import GNNShape
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.utils import leaves_with_paths, tree_map
    dev = nccl_world_of_one
    mesh = _one_rank_mesh()
    cfg = configs.get("gcn-cora").smoke_config
    rng = np.random.default_rng(0)
    if kind == "full":
        shape = GNNShape("full", "full", n_nodes=300, n_edges=1000)
        g = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
             syn.random_graph(rng, 300, 1000, cfg.d_feat, cfg.n_classes).items()}
        batch = steps.pad_graph(g, 512, 1024)
    else:
        shape = GNNShape("molecule", "batched", batch=8, nodes_per_graph=5, edges_per_graph=7)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 syn.molecule_batch(rng, 8, 5, 7, cfg.d_feat, cfg.n_classes).items()}
    cell = steps._gnn_cell("gcn-cora", shape, mesh, smoke=True)
    params = gnn.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    state = cell.init_state(params)
    sharded = cell.place(tree_map(torch.clone, params), tree_map(torch.clone, state), batch)
    loss_d = cell.fn(*sharded)[2]
    loss = cell.fn(params, state, batch)[2]
    assert torch.equal(loss_d.to_local(), loss)
    for got_tree, want_tree in ((sharded[0], params), (sharded[1], state)):
        got = dict(leaves_with_paths(got_tree))
        for k, want in leaves_with_paths(want_tree):
            assert torch.equal(got[k].to_local(), want), k


def test_remat_on_and_off_give_the_same_bits_on_cuda(dev):
    """qwen2-0.5b at published width, 2 of its 24 layers, bf16, 1 x 4,096
    tokens (``flash_sdpa`` runs): the loss and every gradient of
    ``lm.loss_fn`` with ``remat`` and without it, the same bits, and the
    step with ``remat`` holds less at its peak."""
    import dataclasses

    from repro_torch.train.microbatch import value_and_grad
    from repro_torch.utils import leaves_with_paths

    on = dataclasses.replace(configs.get("qwen2-0.5b").config, n_layers=2)
    assert on.remat
    params = lm.init(torch.Generator(device=dev).manual_seed(0), on, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in syn.lm_batch(np.random.default_rng(0), on, 1, 4096).items()}
    runs = {}
    for cfg in (on, dataclasses.replace(on, remat=False)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        loss, grads = value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b), params, batch)
        torch.cuda.synchronize()
        runs[cfg.remat] = (loss, dict(leaves_with_paths(grads)),
                           torch.cuda.max_memory_allocated(dev))
    assert bool(torch.isfinite(runs[True][0]))
    assert torch.equal(runs[True][0], runs[False][0])
    for k, g in runs[True][1].items():
        assert torch.equal(g, runs[False][1][k]), k
    assert runs[True][2] < runs[False][2]
