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
from repro.kernels import ref as jax_ref
from repro_torch.kernels import cin as cin_kernel
from repro_torch.kernels import decode_attention as da_kernel
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


@pytest.mark.parametrize("batch,f,h,hn,dim", [
    (8, 6, 5, 7, 128), (16, 10, 10, 4, 64), (4, 3, 8, 16, 130),   # tests/test_kernels.py
    (4, 6, 16, 8, 10),                                            # xDeepFM's D = 10
])
def test_cin_layer_matches_pallas(batch, f, h, hn, dim):
    """rtol = atol = 1e-4, as tests/test_kernels.py holds the Pallas kernel."""
    rng = np.random.default_rng(13)
    x0 = (rng.normal(size=(batch, f, dim)) / dim ** 0.5).astype(np.float32)
    xk = (rng.normal(size=(batch, h, dim)) / dim ** 0.5).astype(np.float32)
    w = rng.normal(size=(h * f, hn)).astype(np.float32)
    want = jax_ops.cin_layer(jnp.asarray(x0), jnp.asarray(xk), jnp.asarray(w),
                             use_pallas=True, interpret=True)
    got = ops.cin_layer(torch.from_numpy(x0), torch.from_numpy(xk), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (batch, hn, dim)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-4, atol=1e-4)
    # the plain version against the float64 value of the same sum
    exact = np.einsum("bhd,bfd,hfn->bnd", xk.astype(np.float64), x0.astype(np.float64),
                      w.reshape(h, f, hn).astype(np.float64))
    np.testing.assert_allclose(got.double().numpy(), exact, rtol=1e-5, atol=1e-5)


def test_cin_layer_bfloat16_accumulates_in_float32():
    """bfloat16 in and out, float32 inside: the result is the float32 sum
    of the bfloat16 inputs, rounded once."""
    rng = np.random.default_rng(14)
    x0, xk = (torch.from_numpy(rng.normal(size=(3, 5, 10)).astype(np.float32)).bfloat16()
              for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(25, 6)).astype(np.float32)).bfloat16()
    got = ops.cin_layer(x0, xk, w)
    assert got.dtype == torch.bfloat16
    want = ref.cin_layer(x0.float(), xk.float(), w.float()).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,k,want", [
    (512, 7800, 1), (1024, 1521, 1),        # 320+ output tiles: every SM has two already
    (256, 7800, 2), (64, 7800, 7), (1, 7800, 66), (1, 1521, 24),
    (1, 48, 1),                             # 3 slices: too few to split
])
def test_cin_split_count(b, k, want):
    """How K3 splits the reduction on a 132-SM card, at xDeepFM's D = 10,
    Hn = 200: enough runs for two blocks per SM, never a run of fewer than
    MIN_SLICES_PER_SPLIT slices of K."""
    got = cin_kernel.split_count(b * 10, 200, k, 132)
    assert got == want
    slices = -(-k // cin_kernel.SLICE_K)
    assert got == 1 or slices // got >= cin_kernel.MIN_SLICES_PER_SPLIT


def test_cin_tile_constants_match_the_source():
    """split_count sizes the workspace from the kernel's tile: the Python
    constants must be csrc/cin.cu's."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "cin.cu").read_text()
    tile = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (tile["BM"], tile["BN"], tile["BK"]) == \
        (cin_kernel.BLOCK_M, cin_kernel.BLOCK_N, cin_kernel.SLICE_K)


def _decode_inputs(b, hq, hkv, d, t, seed=15):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d))] + [rng]


@pytest.mark.parametrize("b,hq,hkv,d,t", [
    (2, 8, 2, 64, 256), (4, 4, 4, 32, 128), (1, 16, 8, 128, 512),   # tests/test_kernels.py
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(b, hq, hkv, d, t, dtype):
    """The plain K4 against the Pallas kernel in interpret mode and against
    the JAX reference, with pos drawn from [1, T] and at the edges 0, 1, T.
    float32 within 1e-4, bfloat16 within 3e-2, as tests/test_kernels.py
    holds the Pallas kernel (the JAX reference scores in bfloat16, the
    port in float32)."""
    q, k, v, rng = _decode_inputs(b, hq, hkv, d, t)
    jd, td = DTYPES[dtype]
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    qj, kj, vj = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    qt, kt, vt = (torch.from_numpy(x).to(td) for x in (q, k, v))
    for pos in (rng.integers(1, t + 1, size=b), np.zeros(b), np.ones(b), np.full(b, t)):
        pos = pos.astype(np.int32)
        got = ops.decode_attention(qt, kt, vt, torch.from_numpy(pos))
        assert got.dtype == td and got.shape == (b, hq, d)
        pallas = jax_ops.decode_attention(qj, kj, vj, jnp.asarray(pos), use_pallas=True,
                                          interpret=True)
        np.testing.assert_allclose(_np32(got), _np32(pallas), **tol)
        np.testing.assert_allclose(_np32(got), _np32(jax_ref.decode_attention(qj, kj, vj,
                                                                              jnp.asarray(pos))),
                                   **tol)


def test_decode_attention_edges():
    """pos = 0 masks every slot: the softmax is uniform and the result is
    the mean of V over all T (what both JAX versions give).  pos = 1 is slot
    0's V.  pos >= T reads every slot.  Query head h·G + g reads KV head h."""
    b, hq, hkv, d, t = 2, 6, 2, 8, 5
    q, k, v, _ = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                  for x in _decode_inputs(b, hq, hkv, d, t))
    g = hq // hkv
    zero = ops.decode_attention(q, k, v, torch.zeros(b, dtype=torch.int32))
    torch.testing.assert_close(zero, v.mean(dim=1).repeat_interleave(g, dim=1),
                               rtol=1e-6, atol=1e-6)
    one = ops.decode_attention(q, k, v, torch.ones(b, dtype=torch.int32))
    torch.testing.assert_close(one, v[:, 0].repeat_interleave(g, dim=1), rtol=1e-6, atol=1e-6)
    full = ops.decode_attention(q, k, v, torch.full((b,), t, dtype=torch.int32))
    assert torch.equal(full, ops.decode_attention(q, k, v, torch.full((b,), 3 * t)))
    want = torch.softmax(torch.einsum("bhgd,bthd->bhgt", q.reshape(b, hkv, g, d), k) / d ** 0.5,
                         dim=-1)
    want = torch.einsum("bhgt,bthd->bhgd", want, v).reshape(b, hq, d)
    torch.testing.assert_close(full, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,hkv,t,d,es,want", [
    (128, 2, 32768, 64, 2, 1),       # decode_32k: 256 blocks, ~two for every SM
    (65, 2, 32768, 64, 2, 3),        # 130 blocks leave 2 SMs idle: three runs a sequence
    (8, 2, 1024, 64, 2, 4),          # the generate phase: 16 blocks; 8 tiles, 2 a run
    (1, 2, 32768, 64, 2, 128),       # the latency case: 256 runs of 2 tiles
    (1, 8, 512, 128, 4, 4),          # narrow tiles (512-byte rows): 8 tiles
    (3, 1, 100, 8, 4, 1),            # one tile: nothing to split
])
def test_decode_attention_split_count(b, hkv, t, d, es, want):
    """How K4 splits each sequence on a 132-SM card: not at all once every
    SM has a block, else enough runs for two blocks per SM, never a run of
    fewer than MIN_TILES_PER_SPLIT tiles."""
    tile = da_kernel.tile_slots(d, es)
    got = da_kernel.split_count(b, hkv, t, tile, 132)
    assert got == want
    tiles = -(-t // tile)
    assert got == 1 or tiles // got >= da_kernel.MIN_TILES_PER_SPLIT


def test_decode_attention_constants_match_the_source():
    """The wrapper refuses what the source is not instantiated for, and
    sizes the split from the source's tile."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "decode_attention.cu").read_text()
    assert sorted(int(x) for x in re.findall(r"case (\d+): return launch_g<T, \d+>", src)) == \
        list(da_kernel.HEAD_DIMS)
    assert sorted(int(x) for x in re.findall(r"case (\d+): return launch<T, D, \d+>", src)) == \
        list(da_kernel.GROUPS)
    assert re.search(r"TT = ROW <= (\d+) \? (\d+) : (\d+);", src).groups() == tuple(
        str(x) for x in (da_kernel.WIDE_ROW_BYTES, da_kernel.WIDE_TILE, da_kernel.NARROW_TILE))


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
    x0, xk, w = torch.zeros((2, 3, 4)), torch.zeros((2, 5, 4)), torch.zeros((15, 6))
    assert ops.cin_layer(x0, xk, w).shape == (2, 6, 4)
    with pytest.raises(ValueError, match="expected x0"):
        ops.cin_layer(x0[0], xk, w)
    with pytest.raises(ValueError, match="share B and D"):
        ops.cin_layer(x0, xk[:, :, :3], w)
    with pytest.raises(ValueError, match="H·F"):
        ops.cin_layer(x0, xk, w[:14])
    with pytest.raises(ValueError, match="at least one field"):
        ops.cin_layer(x0[:, :0], xk, w[:0])
    with pytest.raises(TypeError, match="one dtype"):
        ops.cin_layer(x0, xk, w.bfloat16())
    with pytest.raises(TypeError, match="one dtype"):
        ops.cin_layer(x0.double(), xk.double(), w.double())
    q, k, pos = torch.zeros((2, 8, 16)), torch.zeros((2, 5, 2, 16)), torch.ones(2, dtype=torch.int32)
    assert ops.decode_attention(q, k, k, pos).shape == (2, 8, 16)
    with pytest.raises(ValueError, match="expected q"):
        ops.decode_attention(q[0], k, k, pos)
    with pytest.raises(ValueError, match="share B and D"):
        ops.decode_attention(q[:, :, :8], k, k, pos)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.decode_attention(q[:, :7], k, k, pos)
    with pytest.raises(ValueError, match="T >= 1"):
        ops.decode_attention(q, k[:, :0], k[:, :0], pos)
    with pytest.raises(TypeError, match="one dtype"):
        ops.decode_attention(q, k.bfloat16(), k, pos)
    with pytest.raises(TypeError, match="integer"):
        ops.decode_attention(q, k, k, pos.float())


def test_empty_batch():
    assert ops.embedding_bag(torch.zeros((10, 4)),
                             torch.zeros((0, 2), dtype=torch.int32)).shape == (0, 4)
    assert ops.dot_interaction(torch.zeros((0, 5, 4))).shape == (0, 10)
    assert ops.cin_layer(torch.zeros((0, 3, 4)), torch.zeros((0, 2, 4)),
                         torch.zeros((6, 5))).shape == (0, 5, 4)
    assert ops.decode_attention(torch.zeros((0, 4, 8)), torch.zeros((0, 3, 2, 8)),
                                torch.zeros((0, 3, 2, 8)),
                                torch.zeros(0, dtype=torch.int32)).shape == (0, 4, 8)
