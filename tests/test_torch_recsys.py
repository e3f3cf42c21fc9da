"""The port's recommendation model against repro.models.recsys: weights
initialised in JAX and converted through numpy, batches made by the port's
numpy generator and handed to both.  float32; logits and scores within
rtol = atol = 2e-5 (different matmul and summation orders).  Covers the
eight paper models and the rest of the zoo (xDeepFM, AutoInt, MIND,
BERT4Rec)."""
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
ZOO = ["xdeepfm", "autoint", "mind", "bert4rec"]
TOL = dict(rtol=2e-5, atol=2e-5)
NO_LAUNCH = {"embedding_bag": 0, "dot_interaction": 0, "cin_layer": 0, "decode_attention": 0}


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _both(name: str, seed: int = 0, edit=None):
    """(JAX config, port config, JAX params, the same params in the port);
    ``edit`` may change the JAX tree before it is converted."""
    jcfg = jax_configs.get(name).smoke_config
    cfg = configs.get(name).smoke_config
    jparams = jax_recsys.init(jax.random.PRNGKey(seed), jcfg)
    if edit is not None:
        jparams = edit(jparams)
    params = compat.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", MODELS + ZOO)
def test_configs_equal_the_reference(name):
    for kind in ("config", "smoke_config"):
        want = dataclasses.asdict(getattr(jax_configs.get(name), kind))
        got = dataclasses.asdict(getattr(configs.get(name), kind))
        assert got == want
    spec, jspec = configs.get(name), jax_configs.get(name)
    assert (spec.family, spec.source, spec.notes) == (jspec.family, jspec.source, jspec.notes)
    assert name in configs.list_archs("recsys")
    if name in MODELS:
        assert SLA_TARGETS[name].medium_ms == jax_configs.paper_models.SLA_TARGETS[name].medium_ms
        assert BOTTLENECK[name] == jax_configs.paper_models.BOTTLENECK[name]
        assert name in PAPER_MODELS
    else:                                  # neither package gives the zoo an SLA target
        assert name not in SLA_TARGETS and name not in jax_configs.paper_models.SLA_TARGETS


def test_recsys_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.RECSYS_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.RECSYS_SHAPES.items()}


@pytest.mark.parametrize("name", MODELS + ZOO)
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


@pytest.mark.parametrize("name", MODELS + ZOO)
def test_forward_matches_the_reference(name):
    jcfg, cfg, jparams, params = _both(name)
    batch = syn.recsys_batch(np.random.default_rng(1), cfg, 7, with_label=False)
    want = np.asarray(jax_recsys.forward(jparams, jcfg, _jax(batch)))
    ops.reset_launch_counts()
    got = recsys.forward(params, cfg, _tensors(batch))
    assert got.shape == want.shape == ((7, 4) if name == "mt-wnd" else (7,))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ops.launch_counts() == NO_LAUNCH                      # CPU tensors


@pytest.mark.parametrize("name", MODELS + ZOO)
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


def test_unknown_interaction_raises():
    cfg = recsys.RecConfig(name="t", interaction="no-such-op", n_tables=0, embed_dim=4)
    with pytest.raises(ValueError, match="unknown interaction"):
        recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown interaction"):
        recsys.forward({}, cfg, {})


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("no-such-model")


def test_xdeepfm_structure_and_linear_logit():
    """No predict heads; lin_w starts at zeros; the linear logit is
    divided by embed_dim (checked with a non-zero lin_w)."""
    cfg = configs.get("xdeepfm").smoke_config
    own = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert "predict" not in own and not own["lin_w"].any()
    assert [tuple(w.shape) for w in own["cin"]] == [(6 * 6, 16), (16 * 6, 16)]
    lin = np.linspace(-1.0, 1.0, cfg.n_tables).astype(np.float32)
    jcfg, cfg, jparams, params = _both("xdeepfm", edit=lambda p: {**p, "lin_w": jnp.asarray(lin)})
    batch = syn.recsys_batch(np.random.default_rng(6), cfg, 5, with_label=False)
    want = np.asarray(jax_recsys.forward(jparams, jcfg, _jax(batch)))
    got = recsys.forward(params, cfg, _tensors(batch))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    zeroed = recsys.forward({**params, "lin_w": torch.zeros(cfg.n_tables)}, cfg, _tensors(batch))
    ids = torch.from_numpy(batch["sparse"][..., 0]).long()                 # hotness 1
    emb = params["tables"][torch.arange(cfg.n_tables)[None, :], ids]       # (B, F, D)
    linear_logit = torch.einsum("bfd,f->b", emb, torch.from_numpy(lin)) / cfg.embed_dim
    np.testing.assert_allclose((got - zeroed).numpy(), linear_logit.numpy(), **TOL)


def test_autoint_width_grows_after_the_first_layer():
    cfg = configs.get("autoint").smoke_config
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    width = cfg.n_heads * cfg.d_attn
    assert [lp["wq"]["w"].shape for lp in params["attn"]] == \
        [(cfg.embed_dim, width)] + [(width, width)] * (cfg.n_attn_layers - 1)
    assert params["predict"][0][0]["w"].shape[0] == cfg.n_tables * width


def test_bulk_forward_equals_forward():
    """xdeepfm-smoke, 32 rows in chunks of 8, as tests/test_models.py."""
    jcfg, cfg, jparams, params = _both("xdeepfm")
    batch = _tensors(syn.recsys_batch(np.random.default_rng(0), cfg, 32, with_label=False))
    direct = recsys.forward(params, cfg, batch)
    chunked = recsys.bulk_forward(params, cfg, batch, chunk=8)
    np.testing.assert_allclose(chunked.numpy(), direct.numpy(), rtol=1e-5, atol=1e-5)
    want = jax_recsys.bulk_forward(jparams, jcfg, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                                   chunk=8)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,chunk,n_chunks", [(30, 8, 5), (32, 8, 4), (7, 3, 7), (8, 8, 1)])
def test_bulk_forward_rounds_the_chunk_to_a_divisor(b, chunk, n_chunks, monkeypatch):
    """The reference's rule: the fewest chunks n >= ceil(B/chunk) with B % n == 0."""
    seen = []
    monkeypatch.setattr(recsys, "forward", lambda p, c, batch: seen.append(
        batch["x"].shape[0]) or batch["x"].float())
    out = recsys.bulk_forward({}, None, {"x": torch.arange(b)}, chunk=chunk)
    assert torch.equal(out, torch.arange(b).float())
    assert seen == [b // n_chunks] * n_chunks


@pytest.mark.parametrize("name", ["mind", "bert4rec"])
def test_score_candidates_matches_the_reference(name):
    jcfg, cfg, jparams, params = _both(name, seed=4)
    batch = syn.recsys_batch(np.random.default_rng(7), cfg, 3, n_candidates=40, with_label=False)
    want = np.asarray(jax_recsys.score_candidates(jparams, jcfg, _jax(batch)))
    got = recsys.score_candidates(params, cfg, _tensors(batch))
    assert got.shape == want.shape == (3, 40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_score_candidates_needs_a_retrieval_head():
    cfg = configs.get("xdeepfm").smoke_config
    with pytest.raises(ValueError, match="retrieval head"):
        recsys.score_candidates({"item_table": torch.zeros((4, 2))}, cfg,
                                {"candidates": torch.zeros((1, 3), dtype=torch.int32)})


def test_bert4rec_ignores_hist_mask():
    _, cfg, _, params = _both("bert4rec")
    batch = _tensors(syn.recsys_batch(np.random.default_rng(8), cfg, 4, with_label=False))
    assert not batch["hist_mask"].all()
    full = {**batch, "hist_mask": torch.ones_like(batch["hist_mask"])}
    assert torch.equal(recsys.forward(params, cfg, batch), recsys.forward(params, cfg, full))


def test_mind_routing_is_symmetric_as_in_the_reference():
    """The reference starts the routing logits at zero, so every interest
    gets the same weights, the same capsule and the same logit update: the
    K capsules stay identical and the history mask (uniform over K at a
    masked position) cannot change them.  The port keeps that, and both
    packages agree on it."""
    jcfg, cfg, jparams, params = _both("mind")
    batch = syn.recsys_batch(np.random.default_rng(8), cfg, 4, with_label=False)
    caps = recsys._mind_interests(params, cfg, _tensors(batch))
    assert torch.equal(caps[:, :1].expand_as(caps), caps)
    full = {**batch, "hist_mask": np.ones_like(batch["hist_mask"])}
    np.testing.assert_allclose(recsys._mind_interests(params, cfg, _tensors(full)).numpy(),
                               caps.numpy(), rtol=0, atol=0)
    want = jax_recsys._mind_interests(jparams, jcfg, _jax(batch))
    np.testing.assert_allclose(caps.numpy(), np.asarray(want), **TOL)
