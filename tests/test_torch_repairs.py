"""Two repairs of the port, held against the JAX package.

* The lookups take ``jnp.take``'s values: an id in [-V, 0) counts from the
  end, an id outside [-V, V) gives a row of NaN.  ``layers.embedding.lookup``
  (the recommendation models' ``_take``, ``lm.forward``) and ``lm.prefill``
  and ``lm.decode_step`` (which indexed with ``table[idx]`` before) against
  ``jnp.take`` and the JAX package's LM at ids -1, -V, V and -V-1, NaN rows
  compared as NaN (``assert_array_equal`` counts NaN equal to NaN).
* ``adamw.update`` computes its bias corrections on the count's device:
  it runs under ``FakeTensorMode`` (a read of the count to the host stops a
  fake trace) and matches the reference over 3 steps at OPT_TOL."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from repro import configs as jax_configs
from repro.models import lm as jax_lm
from repro.train import optim as jax_optim
from repro_torch import compat, configs
from repro_torch.layers import embedding as emb_lib
from repro_torch.models import lm, recsys
from repro_torch.train import optim

OPT_TOL = dict(rtol=1e-6, atol=1e-7)        # tests/test_torch_train.py's
TOL = dict(rtol=1e-4, atol=1e-4)            # tests/test_torch_lm.py's
ARCH = "qwen2-0.5b"


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ids(v: int) -> np.ndarray:
    """(2, 4) int32 ids: -1, -V, V, -V-1 beside ids in range."""
    return np.array([[-1, 3, -v, v], [0, -v - 1, v - 1, 2]], np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_lookup_takes_what_jnp_take_takes(dtype):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(7, 5)).astype(dtype)
    ids = _ids(7)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = emb_lib.lookup(torch.from_numpy(table), torch.from_numpy(ids))
    assert np.isnan(want[0, 3]).all() and np.isnan(want[1, 1]).all()
    np.testing.assert_array_equal(got.numpy(), want)
    # the recommendation models' item lookups are this one
    np.testing.assert_array_equal(
        recsys._take(torch.from_numpy(table), torch.from_numpy(ids)).numpy(), want)


def test_lookup_gradient_reaches_only_the_rows_read():
    table = torch.randn(6, 3, requires_grad=True)
    ids = torch.tensor([[-1, 2], [6, -7]])
    rows = emb_lib.lookup(table, ids)
    torch.nan_to_num(rows, nan=0.0).sum().backward()
    want = torch.zeros(6, 3)
    want[5] = 1.0
    want[2] = 1.0
    torch.testing.assert_close(table.grad, want)


def _lm_pair():
    cfg_j = jax_configs.get(ARCH).smoke_config
    cfg = configs.get(ARCH).smoke_config
    params_j = jax_lm.init(jax.random.PRNGKey(5), cfg_j)
    params = compat.from_jax_params(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg, params_j, params


def test_lm_forward_at_wrapped_and_outside_ids_matches_jax():
    cfg_j, cfg, params_j, params = _lm_pair()
    v = cfg.vocab
    # rows 0 and 1 read a NaN row; row 2 only wraps
    toks = np.concatenate([_ids(v), np.array([[-1, -v, 2, 3]], np.int32)])
    want, _ = jax_lm.forward(params_j, cfg_j, jnp.asarray(toks))
    got = lm.forward(params, cfg, torch.from_numpy(toks))
    # a NaN row spreads through attention (0 · NaN of a masked slot is
    # NaN): NaN where the reference has NaN, its values elsewhere
    want, got = np.asarray(want, np.float32), _np(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL)
    assert np.isnan(want[:2]).all() and not np.isnan(want[2]).any()


def test_lm_prefill_and_decode_at_wrapped_and_outside_ids_match_jax():
    cfg_j, cfg, params_j, params = _lm_pair()
    v = cfg.vocab
    prompt = np.array([[-1, 3], [-v, 2], [4, 5], [1, 0]], np.int32)
    steps = [np.array([v, -v - 1, -1, -v], np.int32), np.array([2, 2, 2, 2], np.int32)]
    want, caches_j = jax_lm.prefill(params_j, cfg_j, jnp.asarray(prompt), 6)
    got, caches = lm.prefill(params, cfg, torch.from_numpy(prompt), 6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)        # no NaN in the prompt
    for tok in steps:
        want, caches_j = jax_lm.decode_step(params_j, cfg_j, jnp.asarray(tok), caches_j)
        got, caches = lm.decode_step(params, cfg, torch.from_numpy(tok), caches)
        want, got_np = np.asarray(want, np.float32), _np(got)
        np.testing.assert_array_equal(np.isnan(got_np), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got_np[ok], want[ok], **TOL)
    # sequences 0 and 1 read a NaN row and stay NaN; 2 and 3 wrapped
    assert np.isnan(want[:2]).all() and not np.isnan(want[2:]).any()


def test_adamw_update_runs_on_fake_tensors():
    opt = optim.adamw(1e-3, weight_decay=0.01)
    with FakeTensorMode():
        params = {"w": torch.empty(4, 3), "b": torch.empty(3)}
        state = opt.init(params)
        grads = {"w": torch.empty(4, 3), "b": torch.empty(3)}
        for _ in range(2):
            params, state = opt.update(grads, state, params)
    assert is_fake(params["w"]) and is_fake(state["count"])


def test_adamw_matches_the_reference_over_three_steps():
    rng = np.random.default_rng(7)
    p_np = {"w": rng.normal(size=(5, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    jopt, opt = jax_optim.adamw(0.05, weight_decay=0.01), optim.adamw(0.05, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, p_np)
    p = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    jstate, state = jopt.init(jp), opt.init(p)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p_np.items()}
        jp, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        p, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, p)
    for k in p_np:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), err_msg=k, **OPT_TOL)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(state[m][k].numpy(), np.asarray(jstate[m][k]),
                                       err_msg=f"{m} {k}", **OPT_TOL)
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert state["count"].dtype == torch.int32
