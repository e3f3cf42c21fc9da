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
                                       "cin_layer": len(cfg.cin_layers), "decode_attention": 0}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "phi3-mini-3.8b", "yi-34b"])
def test_lm_decode_on_gpu_matches_cpu(dev, name):
    """prefill + 3 decode steps of a dense LM smoke config: K4 on the card
    against the plain attention on the CPU, float32 within 1e-4; K4 once
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
                                   "decode_attention": 3 * cfg.n_layers}
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
                                   "cin_layer": 0, "decode_attention": 0}
    assert sorted(got.steps_ms) == [1, 4, 16, 64, 256, 1024]
    assert all(v > 0 for s in got.steps_ms.values() for v in s.values())
