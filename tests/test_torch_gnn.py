"""The port's GCN against the JAX package's on the CPU, at
tests/test_models.py's sizes: weights initialised in JAX and converted
(compat.from_jax_params), graphs made by both packages' builders from the
same numpy seed.

The graph builders and the neighbour sampler are host numpy in both
packages and must give equal arrays.  The model's outputs, losses and
gradients hold at rtol 1e-5 / atol 1e-6, float32: the port sums each
destination's messages in edge order, as the reference's segment_sum does
here, but its gradient sums by source in another order, and XLA fuses the
normalisation into the gather."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data import synthetic as jax_syn
from repro.models import gnn as jax_gnn
from repro_torch import compat, configs
from repro_torch.data import synthetic as syn
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.train import optim
from repro_torch.train.loop import train
from repro_torch.train.microbatch import value_and_grad
from repro_torch.utils import leaves_with_paths

TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_configs.get("gcn-cora").smoke_config, **kw)
    cfg = dataclasses.replace(configs.get("gcn-cora").smoke_config, **kw)
    return jcfg, cfg


def _both_params(jcfg, seed: int = 0):
    jparams = jax_gnn.init(jax.random.PRNGKey(seed), jcfg)
    return jparams, compat.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _assert_grads_close(got, want_jax):
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(want_jax)[0]}
    got = dict(leaves_with_paths(got))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)


# ------------------------------------------------------------ graph builders


@pytest.mark.parametrize("n,e,d,c", [(60, 240, 8, 3), (200, 1600, 8, 3), (100, 500, 33, 7)])
def test_random_graph_and_csr_equal_the_reference(n, e, d, c):
    got = syn.random_graph(np.random.default_rng(n), n, e, d, c)
    want = jax_syn.random_graph(np.random.default_rng(n), n, e, d, c)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for a, b in zip(syn.graph_to_csr(n, got["edge_index"]),
                    jax_syn.graph_to_csr(n, np.asarray(want["edge_index"]))):
        np.testing.assert_array_equal(a, b)


def test_molecule_batch_equals_the_reference():
    got = syn.molecule_batch(np.random.default_rng(0), 8, 10, 20, 8, 3)
    want = jax_syn.molecule_batch(np.random.default_rng(0), 8, 10, 20, 8, 3)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("fanouts", [(4, 3), (2, 2, 2), (50,)])
def test_sample_neighbors_gives_the_references_blocks(fanouts):
    g = syn.random_graph(np.random.default_rng(0), 100, 500, 8, 3)
    indptr, indices = syn.graph_to_csr(100, g["edge_index"])
    got_blocks, got_ids = gnn.sample_neighbors(indptr, indices, np.arange(16), fanouts,
                                               np.random.default_rng(1))
    want_blocks, want_ids = jax_gnn.sample_neighbors(indptr, indices, np.arange(16), fanouts,
                                                     np.random.default_rng(1))
    np.testing.assert_array_equal(got_ids, want_ids)
    assert len(got_blocks) == len(want_blocks) == len(fanouts)
    for (ge, gs, gd), (we, ws, wd), fan in zip(got_blocks, want_blocks, fanouts[::-1]):
        assert (gs, gd) == (ws, wd)
        np.testing.assert_array_equal(ge, we)
        assert np.bincount(ge[1], minlength=gd).max() <= fan


# ----------------------------------------------------------------- the model


@pytest.mark.parametrize("norm", ["sym", "mean"])
def test_gcn_aggregate_matches_jax(norm):
    g = syn.random_graph(np.random.default_rng(3), 60, 240, 8, 3)
    want = jax_gnn.gcn_aggregate(jnp.asarray(g["x"]), jnp.asarray(g["edge_index"]), 60,
                                 norm=norm)
    got = gnn.gcn_aggregate(torch.from_numpy(g["x"]), torch.from_numpy(g["edge_index"]), 60,
                            norm=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gcn_aggregation_averages_neighbors():
    """A node whose neighbours all carry feature v aggregates toward v."""
    x = torch.zeros((4, 4))
    x[1:] = 1.0
    agg = gnn.gcn_aggregate(x, torch.tensor([[1, 2, 3], [0, 0, 0]]), 4, norm="mean")
    assert float(agg[0, 0]) > 0.7
    want = jax_gnn.gcn_aggregate(jnp.asarray(x.numpy()), jnp.array([[1, 2, 3], [0, 0, 0]]), 4,
                                 norm="mean")
    np.testing.assert_allclose(agg.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_layers,n,e", [(2, 60, 240), (3, 200, 1600)])
def test_forward_loss_and_grads_match_jax(n_layers, n, e):
    jcfg, cfg = _cfgs(n_layers=n_layers)
    jparams, params = _both_params(jcfg)
    g = syn.random_graph(np.random.default_rng(0), n, e, cfg.d_feat, cfg.n_classes)
    want = jax_gnn.forward(jparams, jcfg, jnp.asarray(g["x"]), jnp.asarray(g["edge_index"]))
    got = gnn.forward(params, cfg, torch.from_numpy(g["x"]), torch.from_numpy(g["edge_index"]))
    assert got.shape == (n, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    want_loss, want_grads = jax.value_and_grad(
        lambda p: jax_gnn.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, g)))(jparams)
    loss, grads = value_and_grad(lambda p, b: gnn.loss_fn(p, cfg, b), params, _t(g))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    _assert_grads_close(grads, want_grads)


def test_forward_blocks_matches_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _both_params(jcfg)
    g = syn.random_graph(np.random.default_rng(0), 100, 500, cfg.d_feat, cfg.n_classes)
    indptr, indices = syn.graph_to_csr(100, g["edge_index"])
    blocks, input_nodes = gnn.sample_neighbors(indptr, indices, np.arange(16), [4, 3],
                                               np.random.default_rng(0))
    x_in = g["x"][input_nodes]
    want = jax_gnn.forward_blocks(jparams, jcfg, jnp.asarray(x_in), blocks)
    got = gnn.forward_blocks(params, cfg, torch.from_numpy(x_in), blocks)
    assert got.shape == (16, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # gradients through both blocks' sums, a cross-entropy on the seeds
    labels = g["labels"][:16]

    def jloss(p):
        logp = jax.nn.log_softmax(jax_gnn.forward_blocks(p, jcfg, jnp.asarray(x_in), blocks))
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], axis=-1).mean()

    def loss(p, _):
        logp = torch.log_softmax(gnn.forward_blocks(p, cfg, torch.from_numpy(x_in), blocks), -1)
        return -logp.gather(-1, torch.from_numpy(labels).long()[:, None]).mean()

    got_loss, grads = value_and_grad(loss, params, None)
    want_loss, want_grads = jax.value_and_grad(jloss)(jparams)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)
    _assert_grads_close(grads, want_grads)


def test_forward_batched_and_graph_loss_match_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _both_params(jcfg)
    mb = syn.molecule_batch(np.random.default_rng(0), 8, 10, 20, cfg.d_feat, cfg.n_classes)
    mb["node_mask"][2, 7:] = False                      # a graph of 7 nodes
    mb["node_mask"][5, :] = False                       # an empty one: readout over max(0, 1)
    jmb = jax.tree.map(jnp.asarray, mb)
    want = jax_gnn.forward_batched(jparams, jcfg, jmb["x"], jmb["edge_index"], jmb["node_mask"])
    got = gnn.forward_batched(params, cfg, *(torch.from_numpy(mb[k])
                                            for k in ("x", "edge_index", "node_mask")))
    assert got.shape == (8, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    loss, grads = value_and_grad(lambda p, b: gnn.graph_loss_fn(p, cfg, b), params, _t(mb))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jax_gnn.graph_loss_fn(p, jcfg, jmb))(jparams)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    _assert_grads_close(grads, want_grads)


def test_chunked_sums_give_the_same_bits(monkeypatch):
    """Chunks of whole destinations (and, for the gradient, whole sources)
    leave every sum's order unchanged: the same loss and gradients to the
    bit as one chunk, here with chunks of a few edges."""
    cfg = configs.get("gcn-cora").smoke_config
    params = gnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = _t(syn.random_graph(np.random.default_rng(0), 200, 1600, cfg.d_feat, cfg.n_classes))
    whole = value_and_grad(lambda p, b: gnn.loss_fn(p, cfg, b), params, g)
    monkeypatch.setattr(gnn, "MAX_CHUNK_ELEMENTS", 37 * cfg.d_feat)
    edges = gnn._prepare(g["edge_index"], 200, 200, cfg.d_feat)
    assert len(edges.dst_chunks) > 20 and len(edges.src_chunks) > 20
    chunked = value_and_grad(lambda p, b: gnn.loss_fn(p, cfg, b), params, g)
    assert torch.equal(whole[0], chunked[0])
    for (k, a), (_, b) in zip(leaves_with_paths(whole[1]), leaves_with_paths(chunked[1])):
        assert torch.equal(a, b), k


def test_edge_sum_gradient_is_the_transposed_sum():
    """The aggregation's gradient with respect to x equals autograd's
    through a gather and index_add_ (float64, so the orders agree to 1e-12)."""
    rng = np.random.default_rng(4)
    ei = torch.from_numpy(rng.integers(0, 30, size=(2, 200)))
    x = torch.from_numpy(rng.normal(size=(30, 5))).requires_grad_(True)
    w = torch.from_numpy(rng.random(200))
    edges = gnn._prepare(ei, 30, 30, 5)
    order = torch.argsort(ei[1], stable=True)
    out = gnn._EdgeSum.apply(x, w[order], edges)
    ref = torch.zeros(30, 5, dtype=torch.float64).index_add_(0, ei[1], x[ei[0]] * w[:, None])
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)
    g = torch.from_numpy(rng.normal(size=(30, 5)))
    (got,) = torch.autograd.grad(out, x, g)
    (want,) = torch.autograd.grad(ref, x, g)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ training


def test_train_gnn_accuracy_improves():
    """tests/test_system.py's test_train_gnn_accuracy_improves on the port."""
    cfg = configs.get("gcn-cora").smoke_config
    params = gnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = _t(syn.random_graph(np.random.default_rng(0), 200, 1600, cfg.d_feat, cfg.n_classes))

    def acc(p):
        with torch.no_grad():
            logits = gnn.forward(p, cfg, g["x"], g["edge_index"])
        return float((logits.argmax(-1) == g["labels"].long()).float().mean())

    a0 = acc(params)
    state = train(lambda p, b: gnn.loss_fn(p, cfg, b), optim.adamw(5e-2), params,
                  iter(lambda: g, None), num_steps=40, log_every=0)
    assert acc(state.params) > max(a0 + 0.2, 0.5)


def test_launch_train_gcn_runs_on_the_cpu(capsys):
    state = launch_train.main(["--arch", "gcn-cora", "--steps", "6", "--device", "cpu"])
    assert state.step == 6
    assert all(torch.isfinite(p).all() for _, p in leaves_with_paths(state.params))
    out = capsys.readouterr().out
    assert "[train] gcn-cora (gnn) on cpu" in out and "done at step 6" in out


def test_launch_train_gcn_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher trains on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "gcn-cora", "--steps", "1"])


def test_gnn_shapes_and_config_equal_the_reference():
    from repro.configs import gcn_cora as jax_gcn_cora
    from repro_torch.configs import gcn_cora
    assert configs.GNN_SHAPES.keys() == jax_configs.GNN_SHAPES.keys()
    for name, want in jax_configs.GNN_SHAPES.items():
        assert dataclasses.asdict(configs.GNN_SHAPES[name]) == dataclasses.asdict(want)
        assert (dataclasses.asdict(gcn_cora.config_for_shape(configs.GNN_SHAPES[name]))
                == dataclasses.asdict(jax_gcn_cora.config_for_shape(want)))
    assert configs.shapes_for_family("gnn") is configs.GNN_SHAPES
    assert configs.list_archs("gnn") == ["gcn-cora"]
