"""The hand-written kernels on a GPU, against their plain PyTorch versions.
Needs a CUDA device and nvcc; skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 2e-5, bfloat16 2e-2 (rtol = atol): both sides accumulate
in float32, in different orders."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops, ref
from repro_torch.models import recsys

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
                                       "cin_layer": len(cfg.cin_layers)}
