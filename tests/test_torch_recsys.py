"""The port's recommendation model against repro.models.recsys: weights
initialised in JAX and converted through numpy, batches made by the port's
numpy generator and handed to both.  float32; logits within rtol = atol =
2e-5 (different matmul and summation orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data import synthetic as jax_syn
from repro.models import recsys as jax_recsys
from repro_torch import compat, configs
from repro_torch.configs.paper_models import BOTTLENECK, PAPER_MODELS, SLA_TARGETS
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.models import recsys

MODELS = ["ncf", "wnd", "mt-wnd", "dlrm-rmc1", "dlrm-rmc2", "dlrm-rmc3", "din", "dien"]
TOL = dict(rtol=2e-5, atol=2e-5)


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", MODELS)
def test_configs_equal_the_reference(name):
    for kind in ("config", "smoke_config"):
        want = dataclasses.asdict(getattr(jax_configs.get(name), kind))
        got = dataclasses.asdict(getattr(configs.get(name), kind))
        assert got == want
    assert SLA_TARGETS[name].medium_ms == jax_configs.paper_models.SLA_TARGETS[name].medium_ms
    assert BOTTLENECK[name] == jax_configs.paper_models.BOTTLENECK[name]
    assert name in configs.list_archs("recsys") and name in PAPER_MODELS


@pytest.mark.parametrize("name", MODELS)
def test_batches_equal_the_reference(name):
    """Same seed, same numpy draws: the port's host-side batch equals the
    JAX package's, leaf for leaf, and follows recsys_layout."""
    cfg = configs.get(name).smoke_config
    got = syn.recsys_batch(np.random.default_rng(5), cfg, 9)
    want = jax_syn.recsys_batch(np.random.default_rng(5), jax_configs.get(name).smoke_config, 9)
    assert set(got) == set(want)
    layout = syn.recsys_layout(cfg, 9)
    for k, v in got.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, np.asarray(want[k]))
        assert (v.shape, v.dtype) == (layout[k][0], np.dtype(layout[k][1]))


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_the_reference(name):
    jcfg = jax_configs.get(name).smoke_config
    cfg = configs.get(name).smoke_config
    jparams = jax_recsys.init(jax.random.PRNGKey(0), jcfg)
    params = compat.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = syn.recsys_batch(np.random.default_rng(1), cfg, 7, with_label=False)
    want = np.asarray(jax_recsys.forward(jparams, jcfg, {k: jnp.asarray(v)
                                                         for k, v in batch.items()}))
    ops.reset_launch_counts()
    got = recsys.forward(params, cfg, _tensors(batch))
    assert got.shape == want.shape == ((7, 4) if name == "mt-wnd" else (7,))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ops.launch_counts() == {"embedding_bag": 0, "dot_interaction": 0}   # CPU tensors


@pytest.mark.parametrize("name", MODELS)
def test_init_builds_the_reference_tree(name):
    """Own initialisation: same keys and shapes as the JAX init, finite logits."""
    cfg = configs.get(name).smoke_config
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jparams = jax_recsys.init(jax.random.PRNGKey(0), jax_configs.get(name).smoke_config)
    assert _shapes(params) == _shapes(jparams)
    batch = syn.recsys_batch(np.random.default_rng(2), cfg, 3, with_label=False)
    out = recsys.forward(params, cfg, _tensors(batch))
    assert torch.isfinite(out).all() and not out.requires_grad


@pytest.mark.parametrize("pooling", ["mean", "concat"])
def test_other_poolings_match_the_reference(pooling):
    jcfg = dataclasses.replace(jax_configs.get("wnd").smoke_config, pooling=pooling, hotness=1)
    cfg = dataclasses.replace(configs.get("wnd").smoke_config, pooling=pooling, hotness=1)
    jparams = jax_recsys.init(jax.random.PRNGKey(1), jcfg)
    params = compat.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = syn.recsys_batch(np.random.default_rng(3), cfg, 5, with_label=False)
    want = jax_recsys.forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = recsys.forward(params, cfg, _tensors(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fm_interaction_matches_the_reference():
    kw = dict(name="fm-t", interaction="fm", n_dense=6, dense_fc=(8, 4), n_tables=3,
              vocab=50, embed_dim=4, hotness=2, predict_fc=(8, 1))
    jcfg, cfg = jax_recsys.RecConfig(**kw), recsys.RecConfig(**kw)
    jparams = jax_recsys.init(jax.random.PRNGKey(2), jcfg)
    params = compat.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = syn.recsys_batch(np.random.default_rng(4), cfg, 5, with_label=False)
    want = jax_recsys.forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = recsys.forward(params, cfg, _tensors(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("interaction", ["cin", "self-attn", "mind", "bidir-seq"])
def test_unported_interactions_raise(interaction):
    cfg = recsys.RecConfig(name="later", interaction=interaction, n_tables=2, vocab=10,
                           embed_dim=4, seq_len=4, item_vocab=10)
    with pytest.raises(NotImplementedError, match="later slice"):
        recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        recsys.forward({}, cfg, {})


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("no-such-model")
