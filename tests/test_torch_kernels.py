"""Port kernels on the CPU: the plain PyTorch versions (what the wrappers
run for a CPU tensor) against the JAX package's Pallas kernels in interpret
mode, over the shape x dtype sweep of tests/test_kernels.py.  Inputs are
made with numpy from a seed and handed to both packages.

Tolerances: float32 2e-5, bfloat16 2e-2 (rtol = atol), as test_kernels.py —
both sides accumulate in float32 but in different orders, and round to
bfloat16 once at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import interaction as jax_ix_kernel
from repro.kernels import ops as jax_ops
from repro.layers import interactions as jax_ix
from repro.models import recsys as jax_recsys
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("vocab,batch,hot,dim", [
    (64, 8, 4, 128), (128, 16, 1, 128), (1000, 8, 16, 256),
    (37, 4, 3, 130),                       # D not a multiple of 16 bytes, odd everything
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_matches_pallas(vocab, batch, hot, dim, dtype):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    idx = rng.integers(0, vocab, size=(batch, hot)).astype(np.int32)
    jd, td = DTYPES[dtype]
    want = jax_ops.embedding_bag(jnp.asarray(table).astype(jd), jnp.asarray(idx),
                                 use_pallas=True, interpret=True)
    got = ops.embedding_bag(torch.from_numpy(table).to(td), torch.from_numpy(idx))
    assert got.dtype == td and got.shape == (batch, dim)
    np.testing.assert_allclose(_np32(got), _np32(want), **_tol(dtype))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_modes_match_pallas_and_float64(mode):
    rng = np.random.default_rng(8)
    table = rng.normal(size=(50, 128)).astype(np.float32)
    idx = rng.integers(0, 50, size=(8, 5)).astype(np.int32)
    got = ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), mode=mode)
    want = jax_ops.embedding_bag(jnp.asarray(table), jnp.asarray(idx), mode=mode,
                                 use_pallas=True, interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2e-5, atol=2e-5)
    # and against the float64-exact pooled value, as the Kahan-summing kernel is held
    exact = table.astype(np.float64)[idx].sum(axis=1)
    exact = exact / idx.shape[1] if mode == "mean" else exact
    np.testing.assert_allclose(got.double().numpy(), exact, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_stacked_embedding_bag_matches_sparse_pooled(pooling):
    """The (F, V, D) x (B, F, H) form is what recsys._sparse_pooled computes."""
    rng = np.random.default_rng(9)
    f, v, d, b, h = 5, 40, 24, 7, 6
    tables = rng.normal(size=(f, v, d)).astype(np.float32)
    sparse = rng.integers(0, v, size=(b, f, h)).astype(np.int32)
    cfg = jax_recsys.RecConfig(name="t", interaction="dot", n_tables=f, vocab=v,
                               embed_dim=d, hotness=h, pooling=pooling)
    want = jax_recsys._sparse_pooled({"tables": jnp.asarray(tables)}, cfg,
                                     jnp.asarray(sparse))
    got = ops.embedding_bag(torch.from_numpy(tables), torch.from_numpy(sparse), mode=pooling)
    assert got.shape == (b, f, d)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2e-5, atol=2e-5)
    # field f must read table f: the single-table form on each field agrees
    for k in range(f):
        one = ops.embedding_bag(torch.from_numpy(tables[k]),
                                torch.from_numpy(np.ascontiguousarray(sparse[:, k])),
                                mode=pooling)
        np.testing.assert_allclose(_np32(got[:, k]), _np32(one), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batch,fields,dim", [
    (32, 8, 32), (64, 27, 16), (8, 4, 64), (10, 5, 130),   # odd batch, odd dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interaction_matches_pallas(batch, fields, dim, dtype):
    rng = np.random.default_rng(10)
    feats = (rng.normal(size=(batch, fields, dim)) / dim ** 0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = jax_ops.dot_interaction(jnp.asarray(feats).astype(jd), use_pallas=True,
                                   interpret=True)
    got = ops.dot_interaction(torch.from_numpy(feats).to(td))
    assert got.dtype == td and got.shape == (batch, fields * (fields - 1) // 2)
    np.testing.assert_allclose(_np32(got), _np32(want), **_tol(dtype))


@pytest.mark.parametrize("batch,fields,dim", [(8, 11, 32), (6, 5, 130)])
def test_gram_matches_pallas(batch, fields, dim):
    rng = np.random.default_rng(11)
    feats = (rng.normal(size=(batch, fields, dim)) / dim ** 0.5).astype(np.float32)
    want = jax_ix_kernel.gram(jnp.asarray(feats), tile_b=2, interpret=True)
    got = ops.gram(torch.from_numpy(feats))
    assert got.shape == (batch, fields * fields)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fields", [2, 3, 11, 41])
def test_pair_order_matches_layer(fields):
    """Output p = i(i-1)/2 + j pairs row i with row j < i, the order of
    repro.layers.interactions.dot_interaction.  Random rows give every
    pair a distinct value, so a permutation cannot hide."""
    rng = np.random.default_rng(12)
    feats = rng.normal(size=(3, fields, 16)).astype(np.float32)
    want = np.asarray(jax_ix.dot_interaction(jnp.asarray(feats)))
    got = ops.dot_interaction(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    li, lj = np.tril_indices(fields, k=-1)
    np.testing.assert_array_equal(ref.tril_pairs(fields), li * fields + lj)
    p = np.arange(len(li))
    np.testing.assert_array_equal(li * (li - 1) // 2 + lj, p)   # the kernel's inversion


def test_wrappers_validate_arguments():
    table = torch.zeros((10, 4))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="pooling mode"):
        ops.embedding_bag(table, idx, mode="max")
    with pytest.raises(ValueError, match="expected table"):
        ops.embedding_bag(table, idx[:, None, :])
    with pytest.raises(ValueError, match="fields"):
        ops.embedding_bag(table[None], idx[:, None, :].expand(3, 2, 2))
    with pytest.raises(TypeError, match="dtype"):
        ops.embedding_bag(table.double(), idx)
    with pytest.raises(IndexError, match="indices span"):
        ops.embedding_bag(table, idx + 10, check_indices=True)
    with pytest.raises(ValueError, match=r"\(B, F, D\)"):
        ops.dot_interaction(torch.zeros((3, 4)))
    with pytest.raises(TypeError, match="dtype"):
        ops.dot_interaction(torch.zeros((3, 4, 5), dtype=torch.float16))


def test_empty_batch():
    assert ops.embedding_bag(torch.zeros((10, 4)),
                             torch.zeros((0, 2), dtype=torch.int32)).shape == (0, 4)
    assert ops.dot_interaction(torch.zeros((0, 5, 4))).shape == (0, 10)
