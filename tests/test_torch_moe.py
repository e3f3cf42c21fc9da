"""The port's mixture-of-experts layer against the JAX package's on the CPU:
the same expert weights (initialised in JAX, converted by
compat.from_jax_params) and the same numpy inputs.

float32; y within rtol 1e-5 / atol 1e-6 (the routing is the same, the
matrix products and the per-token sums round in other orders); the dropped
share within 1e-7 (a count over the same routing: it is exact); the
auxiliary loss within rtol 1e-6, a few float32 ulps (XLA's and PyTorch's
softmax and mean round the same probabilities apart by one or two ulps,
and 64 identical tokens' mean by four).  Inputs are unit normals, so no two
router probabilities of a token tie and both top-k pick the same experts
in the same order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import moe as jax_moe
from repro_torch import compat
from repro_torch.layers import moe

# compiled once per case: op-by-op dispatch of the reference costs seconds
jax_apply_moe = jax.jit(jax_moe.apply_moe, static_argnames=("top_k", "capacity_factor"))
Y_TOL = dict(rtol=1e-5, atol=1e-6)
DROPPED_TOL = dict(rtol=0, atol=1e-7)
AUX_TOL = dict(rtol=1e-6, atol=0)


def _both(seed: int, d: int, f: int, e: int, k: int):
    jparams = jax_moe.init_moe(jax.random.PRNGKey(seed), d, f, e, k)
    return jparams, compat.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")


def _apply_both(jparams, params, x: np.ndarray, k: int, cf: float):
    want_y, want_aux = jax_apply_moe(jparams, jnp.asarray(x), top_k=k, capacity_factor=cf)
    got_y, got_aux = moe.apply_moe(params, torch.from_numpy(x), top_k=k, capacity_factor=cf)
    return (np.asarray(want_y), {n: float(v) for n, v in want_aux.items()},
            got_y.numpy(), {n: float(v) for n, v in got_aux.items()})


@pytest.mark.parametrize("b,s,d,f,e,k,cf,drops", [
    (2, 12, 16, 24, 8, 2, 1.25, True),        # capacity 7 of 48 assignments over 8 experts
    (3, 7, 32, 16, 4, 1, 1.0, True),          # top-1, capacity 5
    (1, 9, 16, 8, 8, 8, 1.25, False),         # top-k = E: 9 tokens an expert, capacity 11
    (2, 12, 16, 24, 8, 2, 8.0, False),        # capacity 48: nothing drops
    (4, 5, 24, 32, 6, 3, 6.0, False),
])
def test_apply_moe_matches_jax(b, s, d, f, e, k, cf, drops):
    jparams, params = _both(b * 100 + e, d, f, e, k)
    x = np.random.default_rng(e + k).normal(size=(b, s, d)).astype(np.float32)
    want_y, want_aux, got_y, got_aux = _apply_both(jparams, params, x, k, cf)
    assert got_y.shape == (b, s, d) and got_y.dtype == np.float32
    np.testing.assert_allclose(got_y, want_y, **Y_TOL)
    np.testing.assert_allclose(got_aux["dropped_frac"], want_aux["dropped_frac"], **DROPPED_TOL)
    np.testing.assert_allclose(got_aux["aux_loss"], want_aux["aux_loss"], **AUX_TOL)
    assert (got_aux["dropped_frac"] > 0) == drops


def test_identical_tokens_drop_past_capacity_as_in_the_reference():
    """tests/test_layers.py's case: 64 identical tokens all pick one expert
    of 4 at top-1, capacity max(int(64·0.25/4), 1) = 4: 60 of 64 drop, in
    both packages the same ones (the stable sort keeps the first four)."""
    jparams, params = _both(0, 8, 16, 4, 1)
    x = np.ones((1, 64, 8), np.float32)
    want_y, want_aux, got_y, got_aux = _apply_both(jparams, params, x, 1, 0.25)
    assert got_aux["dropped_frac"] > 0.5
    np.testing.assert_allclose(got_aux["dropped_frac"], want_aux["dropped_frac"], **DROPPED_TOL)
    np.testing.assert_allclose(got_aux["dropped_frac"], 60 / 64, **DROPPED_TOL)
    np.testing.assert_allclose(got_aux["aux_loss"], want_aux["aux_loss"], **AUX_TOL)
    np.testing.assert_allclose(got_y, want_y, **Y_TOL)
    kept = np.abs(got_y[0]).sum(-1) > 0
    assert kept.tolist() == [True] * 4 + [False] * 60


def test_moe_capacity_equals_the_reference():
    for tokens in (1, 3, 8, 64, 4096, 32768):
        for experts, top_k in ((4, 1), (8, 2), (32, 8), (128, 8)):
            for cf in (0.25, 1.0, 1.25, 2.0):
                assert moe.moe_capacity(tokens, experts, top_k, cf) == \
                    jax_moe.moe_capacity(tokens, experts, top_k, cf), (tokens, experts, cf)


def test_decode_capacity_of_the_published_configs():
    """A decode step at B = 8 routes 8 tokens: one slot an expert for
    qwen3-moe (128 experts), two for granite-moe (32)."""
    assert moe.moe_capacity(8, 128, 8) == 1
    assert moe.moe_capacity(8, 32, 8) == 2
    assert moe.moe_capacity(8 * 512, 128, 8) == 320


def test_init_moe_has_the_reference_layout():
    jparams = jax_moe.init_moe(jax.random.PRNGKey(1), 16, 24, 8, 2)
    params = moe.init_moe(torch.Generator().manual_seed(1), 16, 24, 8, 2, device="cpu")
    shapes = {jax.tree_util.keystr(p): v.shape
              for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert shapes == {"['router']['w']": (16, 8), "['wg']": (8, 16, 24),
                      "['wu']": (8, 16, 24), "['wd']": (8, 24, 16)}
    assert params["router"]["w"].shape == (16, 8) and "b" not in params["router"]
    for name in ("wg", "wu", "wd"):
        assert tuple(params[name].shape) == shapes[f"['{name}']"]
        assert params[name].dtype == torch.float32
    # the reference's scales: 1/sqrt(d_model) for wg and wu, 1/sqrt(d_ff) for wd
    big = moe.init_moe(torch.Generator().manual_seed(2), 64, 256, 16, 2, device="cpu")
    assert abs(float(big["wg"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(big["wd"].std()) - 256 ** -0.5) < 0.01
    half = moe.init_moe(torch.Generator().manual_seed(1), 16, 24, 8, 2, dtype=torch.bfloat16,
                        device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in (half["wg"], half["router"]["w"]))
