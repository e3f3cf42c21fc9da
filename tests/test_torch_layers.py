"""Port layers against the JAX layers: weights initialised in JAX and
converted leaf by leaf (compat.from_jax_params), inputs made with numpy from
a seed.  float32 throughout; tolerance rtol = atol = 2e-5 (the two
frameworks' matmuls and transcendental functions round differently in the
last bits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jax_attn
from repro.layers import embedding as jax_emb
from repro.layers import interactions as jax_ix
from repro.layers import mlp as jax_mlp
from repro.layers import norms as jax_norms
from repro.layers import rnn as jax_rnn
from repro_torch import compat
from repro_torch.kernels import ops
from repro_torch.layers import attention
from repro_torch.layers import embedding as emb
from repro_torch.layers import interactions as ix
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import norms
from repro_torch.layers import rnn

TOL = dict(rtol=2e-5, atol=2e-5)
KEY = jax.random.PRNGKey(3)


def _convert(params):
    return compat.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x)


@pytest.mark.parametrize("act,final_act", [
    ("relu", None), ("relu", "relu"), ("sigmoid", None), ("gelu", "tanh"), ("silu", "sigmoid"),
])
def test_mlp_matches(act, final_act):
    params = jax_mlp.init_mlp(KEY, 12, [16, 8, 3])
    # give the zero-initialised biases a value, so a dropped bias would show
    params = [{"w": p["w"], "b": p["b"] + 0.1 * (i + 1)} for i, p in enumerate(params)]
    x = np.random.default_rng(0).normal(size=(5, 12)).astype(np.float32)
    want = jax_mlp.mlp(params, jnp.asarray(x), act=act, final_act=final_act)
    got = mlp_lib.mlp(_convert(params), _t(x), act=act, final_act=final_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_linear_keeps_in_out_layout():
    """w is (d_in, d_out) and applied as x @ w — not nn.Linear's (out, in)."""
    g = torch.Generator().manual_seed(0)
    p = mlp_lib.init_linear(g, 6, 4, device="cpu")
    assert p["w"].shape == (6, 4) and p["b"].shape == (4,)
    x = torch.randn((3, 6), generator=g)
    torch.testing.assert_close(mlp_lib.linear(p, x), x @ p["w"] + p["b"])
    assert "b" not in mlp_lib.init_linear(g, 6, 4, bias=False, device="cpu")
    stack = mlp_lib.init_mlp(g, 6, [5, 2], device="cpu")
    assert [q["w"].shape for q in stack] == [(6, 5), (5, 2)]


@pytest.mark.parametrize("mode", ["sum", "mean", "max", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_layer_matches(mode, weighted):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(30, 12)).astype(np.float32)
    idx = rng.integers(0, 30, size=(4, 3, 5)).astype(np.int32)     # leading dims (4, 3)
    w = rng.random(size=idx.shape).astype(np.float32) if weighted else None
    want = jax_emb.embedding_bag(jnp.asarray(table), jnp.asarray(idx), mode=mode,
                                 weights=None if w is None else jnp.asarray(w))
    got = emb.embedding_bag(_t(table), _t(idx), mode=mode,
                            weights=None if w is None else _t(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_bag_layer_rejects_unknown_mode():
    with pytest.raises(ValueError, match="pooling mode"):
        emb.embedding_bag(torch.zeros((4, 2)), torch.zeros((1, 1), dtype=torch.int32),
                          mode="median")


def test_init_table_shape_and_scale():
    t = emb.init_table(torch.Generator().manual_seed(0), 2000, 16, device="cpu")
    assert t.shape == (2000, 16) and t.dtype == torch.float32
    assert abs(float(t.std()) - 0.25) < 0.02            # 1/sqrt(16)


@pytest.mark.parametrize("keep_self", [False, True])
def test_dot_interaction_layer_matches(keep_self):
    feats = np.random.default_rng(2).normal(size=(6, 7, 8)).astype(np.float32)
    want = jax_ix.dot_interaction(jnp.asarray(feats), keep_self=keep_self)
    got = ix.dot_interaction(_t(feats), keep_self=keep_self)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gmf_and_fm_match():
    rng = np.random.default_rng(3)
    u, i = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(ix.gmf(_t(u), _t(i)).numpy(),
                               np.asarray(jax_ix.gmf(jnp.asarray(u), jnp.asarray(i))), **TOL)
    feats = rng.normal(size=(5, 6, 8)).astype(np.float32)
    np.testing.assert_allclose(ix.fm_interaction(_t(feats)).numpy(),
                               np.asarray(jax_ix.fm_interaction(jnp.asarray(feats))), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_din_attention_matches(masked):
    rng = np.random.default_rng(4)
    params = jax_ix.init_din_attention(KEY, 8, hidden=(10, 6))
    hist = rng.normal(size=(5, 9, 8)).astype(np.float32)
    tgt = rng.normal(size=(5, 8)).astype(np.float32)
    mask = (np.arange(9)[None] < rng.integers(1, 10, size=5)[:, None]) if masked else None
    want = jax_ix.din_attention(params, jnp.asarray(hist), jnp.asarray(tgt),
                                mask=None if mask is None else jnp.asarray(mask))
    got = ix.din_attention(_convert(params), _t(hist), _t(tgt),
                           mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        # a masked position carries no weight: changing it changes nothing
        hist2 = hist.copy()
        hist2[~mask] += 100.0
        got2 = ix.din_attention(_convert(params), _t(hist2), _t(tgt), mask=_t(mask))
        np.testing.assert_allclose(got2.numpy(), got.numpy(), **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_matches(with_h0):
    rng = np.random.default_rng(5)
    params = jax_rnn.init_gru(KEY, 6, 5)
    xs = rng.normal(size=(4, 7, 6)).astype(np.float32)
    h0 = rng.normal(size=(4, 5)).astype(np.float32) if with_h0 else None
    want = jax_rnn.gru(params, jnp.asarray(xs), None if h0 is None else jnp.asarray(h0))
    got = rnn.gru(_convert(params), _t(xs), None if h0 is None else _t(h0))
    assert got.shape == (4, 7, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_augru_matches():
    rng = np.random.default_rng(6)
    params = jax_rnn.init_gru(KEY, 5, 5)
    xs = rng.normal(size=(4, 7, 5)).astype(np.float32)
    att = rng.random(size=(4, 7)).astype(np.float32)
    want = jax_rnn.augru(params, jnp.asarray(xs), jnp.asarray(att))
    got = rnn.augru(_convert(params), _t(xs), _t(att))
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # zero attention freezes the state: (1-0)·h + 0·n
    frozen = rnn.augru(_convert(params), _t(xs), torch.zeros((4, 7)), h0=torch.ones((4, 5)))
    np.testing.assert_allclose(frozen.numpy(), np.ones((4, 5), np.float32), **TOL)


def test_from_jax_params_keeps_tree_and_dtypes():
    tree = {"a": [np.ones((2, 3), np.float32), {"b": np.arange(4, dtype=np.int32)}],
            "n": 7, "s": np.float32(2.5)}
    out = compat.from_jax_params(tree, device="cpu")
    assert out["a"][0].shape == (2, 3) and out["a"][0].dtype == torch.float32
    assert out["a"][1]["b"].dtype == torch.int32 and out["n"] == 7
    assert float(out["s"]) == 2.5
    bf = np.asarray(jnp.ones((2, 2), jnp.bfloat16))
    assert compat.from_jax_params({"w": bf}, device="cpu")["w"].dtype == torch.bfloat16
    # a 0-d integer array is a static int of the JAX tree, not a weight
    assert compat.from_jax_params({"n": np.asarray(5)}, device="cpu")["n"] == 5
    assert isinstance(compat.from_jax_params(np.int32(3), device="cpu"), int)
    # a GCN's "layers" is a list of layers of different widths: carried as it
    # is, not unstacked
    from repro.models import gnn as jax_gnn
    gcn = jax.tree.map(np.asarray, jax_gnn.init(jax.random.PRNGKey(0), jax_gnn.GCNConfig(
        name="g", n_layers=3, d_feat=5, d_hidden=4, n_classes=3)))
    out = compat.from_jax_params(gcn, device="cpu")
    assert isinstance(out["layers"], list) and len(out["layers"]) == 3
    for got, want in zip(out["layers"], gcn["layers"]):
        assert sorted(got) == ["b", "w"]
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])


# ------------------------------------------------------------ the recsys zoo


def test_cin_matches():
    """Two layers at xDeepFM-smoke widths; on the CPU the layer takes the
    plain version of the CIN kernel and launches nothing."""
    rng = np.random.default_rng(7)
    params = jax_ix.init_cin(KEY, 6, 8, (16, 12))
    x0 = rng.normal(size=(5, 6, 8)).astype(np.float32)
    want = jax_ix.cin(params, jnp.asarray(x0))
    ops.reset_launch_counts()
    got = ix.cin(_convert(params), _t(x0))
    assert got.shape == want.shape == (5, 28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.launch_counts()["cin_layer"] == 0
    own = ix.init_cin(torch.Generator().manual_seed(0), 6, 8, (16, 12), device="cpu")
    assert [tuple(w.shape) for w in own] == [tuple(w.shape) for w in params]


@pytest.mark.parametrize("dim,n_heads,d_attn", [(8, 2, 4), (16, 2, 32), (8, 1, 8)])
def test_autoint_layer_matches(dim, n_heads, d_attn):
    rng = np.random.default_rng(8)
    params = jax_ix.init_autoint_layer(KEY, dim, n_heads, d_attn)
    x = rng.normal(size=(4, 6, dim)).astype(np.float32)
    want = jax_ix.autoint_layer(params, jnp.asarray(x), n_heads=n_heads, d_attn=d_attn)
    got = ix.autoint_layer(_convert(params), _t(x), n_heads=n_heads, d_attn=d_attn)
    assert got.shape == (4, 6, n_heads * d_attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_capsule_routing_matches(masked):
    rng = np.random.default_rng(9)
    params = jax_ix.init_capsule_routing(KEY, 8)
    hist = rng.normal(size=(5, 7, 8)).astype(np.float32)
    mask = (np.arange(7)[None] < rng.integers(1, 8, size=5)[:, None]) if masked else None
    kw = dict(n_interests=3, n_iters=3)
    want = jax_ix.capsule_routing(params, jnp.asarray(hist), **kw,
                                  mask=None if mask is None else jnp.asarray(mask))
    got = ix.capsule_routing(_convert(params), _t(hist), **kw,
                             mask=None if mask is None else _t(mask))
    assert got.shape == (5, 3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_squash_matches():
    """n²/(1+n²) · x/√(n²+1e-9), over the last axis; a zero vector stays 0."""
    x = np.random.default_rng(10).normal(size=(4, 3, 5)).astype(np.float32)
    x[0, 0] = 0.0
    got = ix._squash(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ix._squash(jnp.asarray(x))), **TOL)
    assert not got[0, 0].any()
    assert float(got.norm(dim=-1).max()) < 1.0


def test_cross_network_matches():
    rng = np.random.default_rng(11)
    params = jax_ix.init_cross_network(KEY, 12, 3)
    params = [{"w": p["w"], "b": p["b"] + 0.05} for p in params]
    x0 = rng.normal(size=(6, 12)).astype(np.float32)
    want = jax_ix.cross_network(params, jnp.asarray(x0))
    np.testing.assert_allclose(ix.cross_network(_convert(params), _t(x0)).numpy(),
                               np.asarray(want), **TOL)
    own = ix.init_cross_network(torch.Generator().manual_seed(0), 12, 3, device="cpu")
    assert [(p["w"].shape, p["b"].shape) for p in own] == [((12, 12), (12,))] * 3


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norms_match(kind):
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(3, 5, 16)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    if kind == "layer":
        p = {"scale": scale, "bias": rng.normal(size=16).astype(np.float32)}
        want = jax_norms.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        got = norms.layer_norm(_convert(p), _t(x))
        init = norms.init_layer_norm(16, device="cpu")
        assert set(init) == {"scale", "bias"}
    else:
        p = {"scale": scale}
        want = jax_norms.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
        got = norms.rms_norm(_convert(p), _t(x))
        init = norms.init_rms_norm(16, device="cpu")
        assert set(init) == {"scale"}
        # bfloat16 input: float32 inside, bfloat16 out
        bf = norms.rms_norm(_convert(p), _t(x).bfloat16())
        assert bf.dtype == torch.bfloat16
        np.testing.assert_allclose(bf.float().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_heads,n_kv_heads", [(2, 2), (4, 2)])
def test_attention_matches(causal, n_heads, n_kv_heads):
    rng = np.random.default_rng(13)
    params = jax_attn.init_attention(KEY, 16, n_heads, n_kv_heads, 8)
    x = rng.normal(size=(3, 9, 16)).astype(np.float32)
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=8, causal=causal)
    want = jax_attn.attention(params, jnp.asarray(x), **kw)
    got = attention.attention(_convert(params), _t(x), **kw)
    assert got.shape == (3, 9, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal:
        # position s attends to positions <= s only: changing the last one
        # leaves every earlier output as it was
        x2 = x.copy()
        x2[:, -1] += 5.0
        got2 = attention.attention(_convert(params), _t(x2), **kw)
        np.testing.assert_allclose(got2[:, :-1].numpy(), got[:, :-1].numpy(), **TOL)


def test_rope_matches_and_rotates_interleaved_pairs():
    """Pairs (x[2i], x[2i+1]) are rotated and stacked back in place (not
    the rotate-half layout); angles are float32, the result x's dtype."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    freqs = attention.rope_freqs(8, base=500.0)
    np.testing.assert_allclose(freqs.numpy(), np.asarray(jax_attn.rope_freqs(8, base=500.0)),
                               rtol=1e-6, atol=0)
    for p in (pos, pos[0]):                                   # (B, S) and (S,) positions
        want = jax_attn.apply_rope(jnp.asarray(x), jnp.asarray(p), jax_attn.rope_freqs(8, base=500.0))
        got = attention.apply_rope(_t(x), _t(p), freqs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ang = pos[..., None].astype(np.float32) * freqs.numpy()           # (B, S, D/2)
    c, s_ = np.cos(ang)[:, :, None], np.sin(ang)[:, :, None]
    by_hand = np.stack([x[..., 0::2] * c - x[..., 1::2] * s_,
                        x[..., 0::2] * s_ + x[..., 1::2] * c], axis=-1).reshape(x.shape)
    np.testing.assert_allclose(attention.apply_rope(_t(x), _t(pos), freqs).numpy(), by_hand,
                               **TOL)
    bf = attention.apply_rope(_t(x).bfloat16(), _t(pos), freqs)
    assert bf.dtype == torch.bfloat16


def test_flash_sdpa_equals_dense_causal():
    """The chunked online-softmax path against the dense masked one, and
    against the JAX package's flash_sdpa (after tests/test_layers.py)."""
    rng = np.random.default_rng(22)
    b, s, hq, hkv, d = 2, 256, 4, 2, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32) for _ in range(2))
    dense = attention._sdpa(_t(q), _t(k), _t(v), attention.causal_mask(s, "cpu"))
    flash = attention.flash_sdpa(_t(q), _t(k), _t(v), causal=True, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)
    want = jax_attn.flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               q_chunk=64, kv_chunk=128)
    got = attention.flash_sdpa(_t(q), _t(k), _t(v), causal=True, q_chunk=64, kv_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_long_causal_attention_takes_the_flash_path(monkeypatch):
    """Past _FLASH_THRESHOLD score elements a causal self-attention runs
    chunked; the result is the dense one's."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(1, 64, 16)).astype(np.float32)
    params = _convert(jax_attn.init_attention(KEY, 16, 4, 2, 8))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, causal=True, freqs=attention.rope_freqs(8))
    dense = attention.attention(params, _t(x), **kw)
    calls = []
    real = attention.flash_sdpa
    monkeypatch.setattr(attention, "flash_sdpa", lambda *a, **k: calls.append(1) or real(
        *a, q_chunk=16, kv_chunk=32))
    monkeypatch.setattr(attention, "_FLASH_THRESHOLD", 32 * 32)
    flash = attention.attention(params, _t(x), **kw)
    assert calls == [1]
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_with_rope_and_bias_matches(qkv_bias):
    rng = np.random.default_rng(24)
    params = jax_attn.init_attention(KEY, 24, 6, 2, 8, qkv_bias=qkv_bias)
    if qkv_bias:                    # zero-initialised: draw them, so the bias is exercised
        params = {k: dict(p, b=jnp.asarray(rng.normal(size=p["b"].shape).astype(np.float32)))
                  if "b" in p else p for k, p in params.items()}
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 7)).astype(np.int32)
    kw = dict(n_heads=6, n_kv_heads=2, head_dim=8, causal=True)
    want = jax.jit(lambda xx, pp: jax_attn.attention(params, xx, positions=pp,
                                                     freqs=jax_attn.rope_freqs(8), **kw))(
        jnp.asarray(x), jnp.asarray(pos))
    got = attention.attention(_convert(params), _t(x), positions=_t(pos),
                              freqs=attention.rope_freqs(8), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    p_t = attention.init_attention(torch.Generator().manual_seed(0), 24, 6, 2, 8,
                                   qkv_bias=qkv_bias, device="cpu")
    assert {k: sorted(v) for k, v in p_t.items()} == {k: sorted(v) for k, v in params.items()}


def test_decode_matches_full_attention():
    """Token-by-token decode (the plain K4 on the CPU, with the cache
    written in place) equals the full causal forward and the JAX decode
    (after tests/test_layers.py)."""
    rng = np.random.default_rng(25)
    d, hq, hkv, hd, s, b = 32, 4, 2, 8, 6, 2
    params = jax_attn.init_attention(KEY, d, hq, hkv, hd)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd)
    freqs = attention.rope_freqs(hd)
    full = attention.attention(_convert(params), _t(x), causal=True, freqs=freqs, **kw)
    cache = attention.init_kv_cache(b, s, hkv, hd, device="cpu")
    cache_j = jax_attn.init_kv_cache(b, s, hkv, hd)
    jax_step = jax.jit(lambda c, xt: jax_attn.decode_attention(
        params, xt, c, freqs=jax_attn.rope_freqs(hd), **kw))
    ops.reset_launch_counts()
    for t in range(s):
        o, cache = attention.decode_attention(_convert(params), _t(x[:, t:t + 1]), cache,
                                              freqs=freqs, **kw)
        o_j, cache_j = jax_step(cache_j, jnp.asarray(x[:, t:t + 1]))
        np.testing.assert_allclose(o.numpy(), full[:, t:t + 1].numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(cache_j["k"]), **TOL)
    assert cache["pos"].tolist() == [s, s]
    assert ops.launch_counts()["decode_attention"] == 0


def test_kv_write_past_the_cache_is_dropped():
    """The JAX package's functional write drops an out-of-range slot; the
    in-place write keeps the old row there, per sequence."""
    cache = attention.init_kv_cache(2, 3, 1, 4, device="cpu")
    cache["k"].copy_(torch.arange(24.0).reshape(2, 3, 1, 4))
    before = cache["k"].clone()
    cache["pos"] = torch.tensor([1, 3], dtype=torch.int32)
    new = torch.full((2, 1, 4), -1.0)
    attention.write_kv(cache, new, new)
    assert torch.equal(cache["k"][0, 1], new[0]) and torch.equal(cache["v"][0, 1], new[0])
    assert torch.equal(cache["k"][1], before[1])
    assert torch.equal(cache["v"][1], torch.zeros((3, 1, 4)))


def test_swiglu_matches():
    rng = np.random.default_rng(26)
    params = jax_mlp.init_ffn_swiglu(KEY, 12, 20)
    x = rng.normal(size=(3, 4, 12)).astype(np.float32)
    want = jax_mlp.ffn_swiglu(params, jnp.asarray(x))
    np.testing.assert_allclose(mlp_lib.ffn_swiglu(_convert(params), _t(x)).numpy(),
                               np.asarray(want), **TOL)
    p_t = mlp_lib.init_ffn_swiglu(torch.Generator().manual_seed(0), 12, 20, device="cpu")
    assert {k: tuple(v["w"].shape) for k, v in p_t.items()} == \
        {k: tuple(v["w"].shape) for k, v in params.items()}


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged_matches(mode):
    rng = np.random.default_rng(14)
    table = rng.normal(size=(30, 6)).astype(np.float32)
    offsets = np.array([0, 3, 3, 7, 12], np.int32)          # bag 1 is empty
    indices = rng.integers(0, 30, size=12).astype(np.int32)
    want = jax_emb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(indices),
                                        jnp.asarray(offsets), num_bags=4, mode=mode)
    got = emb.embedding_bag_ragged(_t(table), _t(indices), _t(offsets), num_bags=4, mode=mode)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    seg = emb.segment_ids_from_offsets(_t(offsets), 12)
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(jax_emb.segment_ids_from_offsets(jnp.asarray(offsets), 12)))
    with pytest.raises(ValueError, match="pooling mode"):
        emb.embedding_bag_ragged(_t(table), _t(indices), _t(offsets), num_bags=4, mode="none")


def test_hashed_lookup_matches():
    rng = np.random.default_rng(15)
    table = rng.normal(size=(17, 4)).astype(np.float32)
    idx = rng.integers(-1000, 10 ** 6, size=(5, 3)).astype(np.int32)
    want = jax_emb.hashed_lookup(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_allclose(emb.hashed_lookup(_t(table), _t(idx)).numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("combine", ["mult", "add"])
def test_qr_lookup_matches(combine):
    """The QR tree carries an integer leaf (num_buckets) across compat."""
    params = jax_emb.init_qr_tables(KEY, 1000, 8, num_buckets=37)
    converted = _convert(params)
    assert converted["num_buckets"] == 37 and isinstance(converted["num_buckets"], int)
    idx = np.random.default_rng(16).integers(0, 1000, size=(6, 2)).astype(np.int32)
    want = jax_emb.qr_lookup(params, jnp.asarray(idx), combine=combine)
    got = emb.qr_lookup(converted, _t(idx), combine=combine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    own = emb.init_qr_tables(torch.Generator().manual_seed(0), 1000, 8, num_buckets=37,
                             device="cpu")
    assert own["q"].shape == (28, 8) and own["r"].shape == (37, 8) and own["num_buckets"] == 37
