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
                                   (1, 41, 32), (1024, 41, 32), (7, 2, 1), (3, 300, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interaction_kernel(dev, b, f, d, dtype):
    rng = np.random.default_rng(1)
    feats = torch.from_numpy((rng.normal(size=(b, f, d)) / d ** 0.5).astype(np.float32)).to(dev, dtype)
    got, full = ops.dot_interaction(feats), ops.gram(feats)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.dot_interaction_packed(feats).float(), **_tol(dtype))
    torch.testing.assert_close(full.float(), ref.gram(feats).float(), **_tol(dtype))


@pytest.mark.parametrize("b,f,h,hn,d", [
    (8, 6, 5, 7, 128), (16, 10, 10, 4, 64), (4, 3, 8, 16, 130),   # tests/test_kernels.py
    (4, 6, 16, 8, 10), (1, 39, 39, 200, 10), (65, 39, 200, 200, 10), (3, 1, 1, 1, 1),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cin_layer_kernel(dev, b, f, h, hn, d, dtype):
    """float32 within 1e-4 (the CPU sweep's tolerance), bfloat16 2e-2."""
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy((rng.normal(size=(b, f, d)) / d ** 0.5).astype(np.float32)).to(dev, dtype)
    xk = torch.from_numpy((rng.normal(size=(b, h, d)) / d ** 0.5).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.normal(size=(h * f, hn)) / (h * f) ** 0.5).astype(np.float32)).to(dev, dtype)
    before = ops.launch_counts()["cin_layer"]
    got = ops.cin_layer(x0, xk, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cin_layer"] == before + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    assert got.dtype == dtype and got.shape == (b, hn, d)
    torch.testing.assert_close(got.float(), ref.cin_layer(x0, xk, w).float(), **tol)


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
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel(dev, b, hq, hkv, d, t, dtype):
    """pos drawn from [1, T] plus the edges 0, 1 and T; float32 within
    1e-4, bfloat16 within 3e-2, as tests/test_kernels.py holds the Pallas
    kernel."""
    q, k, v, rng = _decode_inputs(dev, b, hq, hkv, d, t, dtype)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    for pos in (rng.integers(1, t + 1, size=b), np.zeros(b), np.ones(b), np.full(b, t)):
        pos = torch.from_numpy(pos.astype(np.int32)).to(dev)
        before = ops.launch_counts()["decode_attention"]
        got = ops.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == before + 1
        assert got.dtype == dtype and got.shape == (b, hq, d)
        torch.testing.assert_close(got.float(), ref.decode_attention(q, k, v, pos).float(), **tol)
    again = ops.decode_attention(q, k, v, pos)
    assert torch.equal(again, got)                 # no atomics: the same bits every run


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
