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

from repro.layers import embedding as jax_emb
from repro.layers import interactions as jax_ix
from repro.layers import mlp as jax_mlp
from repro.layers import rnn as jax_rnn
from repro_torch import compat
from repro_torch.layers import embedding as emb
from repro_torch.layers import interactions as ix
from repro_torch.layers import mlp as mlp_lib
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
