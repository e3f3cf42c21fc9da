"""The LM prefill and decode cells and the GNN cells of ``launch/steps.py``
on DTensors in a gloo world of 4 CPU ranks, against the same steps on one
device.

LM (float32 smoke configs, 4 sequences, a prompt of 6 tokens, then 4
decode steps against caches of 16 slots):

* qwen2 on (2, 2) and (1, 4): 1 KV head, so the caches are split over
  time, in slices of 8 and 4 slots, and the steps' positions 6..9 cross a
  slice's end (K4's log-sum-exp, the ranks merged in rank order);
* phi3 on (2, 2): 4 KV heads, split by heads;
* granite-moe on (2, 2) (split by heads, each data shard's tokens
  dispatched by ``make_sharded_moe`` at its own capacity, so the one-device
  meaning is ``moe_fn`` applying the layer to each half of the batch apart,
  in both packages) and on (1, 4) (2 KV heads over 4 ranks: split over
  time, one data shard).

Each prefill cell's logits and caches, and each decode step's logits and
the caches after the last, are held to the one-device ``prefill`` /
``decode_step`` with the gradient gate's TOL = 2e-5 (|got − want| ≤
TOL·|want| + TOL·max|want|); the caches come out of the prefill cell at the
decode cell's placements; a second decode run from the same caches gives
the same bits.  The one-device steps are held to the JAX package's
``prefill`` and ``decode_step`` on the same weights at rtol = atol = 1e-4
(tests/test_torch_lm.py's tolerance), the MoE hook included.

GNN (gcn smoke config, AdamW(1e-2), one step): a full graph of 300 nodes
and 1,000 edges padded to 512 and 1,024 (``pad_graph``), the same with the
mean norm, a sampled minibatch of 8 seeds with fanouts (3, 2), and 8
molecules of 5 nodes and 7 edges, on (2, 2).  The loss within rtol 1e-5 of
the unpadded plain step's and every parameter and AdamW leaf within TOL;
the padded plain step against the unpadded one the same way; a second
sharded step the same bits."""
import copy
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_ranks as ranks
from repro import configs as jax_configs
from repro.layers import moe as jax_moe
from repro.models import gnn as jax_gnn
from repro.models import lm as jax_lm
from repro_torch import compat, configs
from repro_torch.configs import GNNShape
from repro_torch.data import synthetic as syn
from repro_torch.launch import steps
from repro_torch.layers import moe as moe_lib
from repro_torch.models import gnn, lm
from repro_torch.train import optim
from repro_torch.utils import leaves_with_paths

WORLD = 4
TOL = 2e-5                      # the gradient gate's (chip_smoke.py)
LOSS_RTOL = 1e-5
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(3)
BATCH, PROMPT, SLOTS, STEPS = 4, 6, 16, 4

LM_CASES = [
    dict(name="qwen2_2x2", arch="qwen2-0.5b", mesh=(2, 2), split="time"),
    dict(name="qwen2_1x4", arch="qwen2-0.5b", mesh=(1, 4), split="time"),
    dict(name="phi3_2x2", arch="phi3-mini-3.8b", mesh=(2, 2), split="heads"),
    dict(name="granite_2x2", arch="granite-moe-1b-a400m", mesh=(2, 2), split="heads"),
    dict(name="granite_1x4", arch="granite-moe-1b-a400m", mesh=(1, 4), split="time"),
]
GNN_CASES = [
    dict(name="full", arch="gcn-cora", mesh=(2, 2),
         shape=GNNShape("full", "full", n_nodes=300, n_edges=1000)),
    dict(name="full_mean", arch="gcn-mean", base="gcn-cora", variant={"norm": "mean"},
         mesh=(2, 2), shape=GNNShape("full", "full", n_nodes=300, n_edges=1000)),
    dict(name="minibatch", arch="gcn-cora", mesh=(2, 2),
         shape=GNNShape("minibatch", "minibatch", batch_nodes=8, fanouts=(3, 2))),
    dict(name="molecule", arch="gcn-cora", mesh=(2, 2),
         shape=GNNShape("molecule", "batched", batch=8, nodes_per_graph=5, edges_per_graph=7)),
]
CASES = LM_CASES + GNN_CASES


def _cfgs(case):
    base = case.get("base", case["arch"])
    cfg, jcfg = configs.get(base).smoke_config, jax_configs.get(base).smoke_config
    if "variant" in case:
        cfg = dataclasses.replace(cfg, **case["variant"])
        jcfg = dataclasses.replace(jcfg, **case["variant"])
    return cfg, jcfg


def _gnn_batch(case, cfg, rng) -> dict:
    shape = case["shape"]
    if shape.kind == "full":
        g = syn.random_graph(rng, shape.n_nodes, shape.n_edges, cfg.d_feat, cfg.n_classes)
        return {k: np.asarray(v) for k, v in g.items()}
    if shape.kind == "batched":
        return syn.molecule_batch(rng, shape.batch, shape.nodes_per_graph,
                                  shape.edges_per_graph, cfg.d_feat, cfg.n_classes)
    x_spec, blocks = syn.minibatch_block_specs(cfg, shape.batch_nodes, shape.fanouts)
    eis = [np.stack([rng.integers(0, n_src, e.shape[1]),
                     rng.integers(0, n_dst, e.shape[1])]).astype(np.int32)
           for e, n_src, n_dst in blocks]
    return {"x": rng.normal(size=x_spec.shape).astype(np.float32), "eis": eis,
            "labels": rng.integers(0, cfg.n_classes, shape.batch_nodes).astype(np.int32)}


def _inputs(case) -> dict:
    cfg, jcfg = _cfgs(case)
    rng = np.random.default_rng(0)
    if "shape" in case:
        params = jax.tree.map(np.asarray, jax_gnn.init(KEY, jcfg))
        return {**case, "family": "gnn", "params": params, "batch": _gnn_batch(case, cfg, rng)}
    params = jax.tree.map(np.asarray, jax.jit(lambda: jax_lm.init(KEY, jcfg))())
    toks = syn.lm_batch(rng, cfg, BATCH, PROMPT + STEPS)["tokens"]
    return {**case, "family": "lm", "params": params, "tokens": toks, "prompt": PROMPT,
            "slots": SLOTS}


def _per_shard_moe(n: int, top_k: int, apply, cat, mean):
    """The MoE layer applied to each of n batch shards apart, aux losses
    averaged: what a data shard's local dispatch computes."""
    def fn(lp, x):
        outs = [apply(lp, xb, top_k=top_k) for xb in (x.chunk(n) if cat is torch.cat
                                                      else jnp.split(x, n))]
        return cat([o[0] for o in outs]), {"aux_loss": mean([o[1]["aux_loss"] for o in outs])}
    return fn


def _lm_one_device(case, inp) -> dict:
    cfg, jcfg = _cfgs(case)
    params = compat.from_jax_params(inp["params"], device="cpu")
    toks = torch.from_numpy(inp["tokens"])
    moe_fn = jmoe_fn = None
    if cfg.is_moe and case["mesh"][0] > 1:
        n = case["mesh"][0]
        moe_fn = _per_shard_moe(n, cfg.top_k, moe_lib.apply_moe, torch.cat,
                                lambda xs: torch.stack(xs).mean())
        jmoe_fn = _per_shard_moe(n, cfg.top_k, jax_moe.apply_moe, jnp.concatenate,
                                 lambda xs: jnp.stack(xs).mean())
    logits, caches = lm.prefill(params, cfg, toks[:, :PROMPT], PROMPT, moe_fn=moe_fn)
    out = {"prefill_logits": logits.numpy(),
           "prefill_caches": {p: t.numpy() for p, t in leaves_with_paths(caches)}}
    _, caches = lm.prefill(params, cfg, toks[:, :PROMPT], SLOTS, moe_fn=moe_fn)
    out["start_caches"] = [{k: t.numpy().copy() for k, t in c.items()} for c in caches]
    jparams = jax.tree.map(jnp.asarray, inp["params"])
    jprefill = jax.jit(lambda p, t: jax_lm.prefill(p, jcfg, t, SLOTS, moe_fn=jmoe_fn))
    jdecode = jax.jit(lambda p, t, c: jax_lm.decode_step(p, jcfg, t, c, moe_fn=jmoe_fn))
    jlogits, jcaches = jprefill(jparams, jnp.asarray(inp["tokens"][:, :PROMPT]))
    step_logits, jax_logits = [], [np.asarray(jlogits)]
    out["prefill_slots_logits"] = lm.prefill(params, cfg, toks[:, :PROMPT], SLOTS,
                                             moe_fn=moe_fn)[0].numpy()
    for t in range(PROMPT, PROMPT + STEPS):
        logits, caches = lm.decode_step(params, cfg, toks[:, t], caches, moe_fn=moe_fn)
        jl, jcaches = jdecode(jparams, jnp.asarray(inp["tokens"][:, t]), jcaches)
        step_logits.append(logits.numpy())
        jax_logits.append(np.asarray(jl))
    out.update(decode_logits=step_logits, jax_logits=jax_logits,
               caches={p: t.numpy() for p, t in leaves_with_paths(caches)})
    return out


def _gnn_step(cfg, params, args, shape: GNNShape):
    """One AdamW(1e-2) step of the plain GCN on ``args`` (after the state)."""
    opt = optim.adamw(1e-2)
    if shape.kind == "minibatch":
        sizes = [(b[1], b[2]) for b in syn.minibatch_block_specs(
            cfg, shape.batch_nodes, shape.fanouts)[1]]
        loss_fn = lambda p, b: steps._minibatch_loss(p, cfg, *b, sizes)  # noqa: E731
    elif shape.kind == "full":
        loss_fn = lambda p, b: gnn.loss_fn(p, cfg, b)  # noqa: E731
    else:
        loss_fn = lambda p, b: gnn.graph_loss_fn(p, cfg, b)  # noqa: E731
    p = copy.deepcopy(params)
    new_p, new_o, loss = steps._train_step(loss_fn, opt)(p, opt.init(p), *args)
    return {"loss": float(loss), "params": {k: t.numpy() for k, t in leaves_with_paths(new_p)},
            "state": {k: t.numpy() for k, t in leaves_with_paths(new_o)}}


def _gnn_one_device(case, inp, sent) -> dict:
    """The plain step on the case's graph and, for a full graph, on the
    padded graph the ranks were sent."""
    cfg, _ = _cfgs(case)
    params = compat.from_jax_params(inp["params"], device="cpu")
    out = {"unpadded": _gnn_step(cfg, params, ranks._gnn_args(inp), case["shape"]),
           "before": {k: t.numpy() for k, t in leaves_with_paths(params)}}
    if case["shape"].kind == "full":
        out["padded"] = _gnn_step(cfg, params, ranks._gnn_args(sent), case["shape"])
    return out


def _padded(case, inp) -> dict:
    """A full-graph case's batch padded to the cell's multiples of 512."""
    b = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    shape = case["shape"]
    pb = steps.pad_graph(b, steps._pad_up(shape.n_nodes), steps._pad_up(shape.n_edges))
    return {**inp, "batch": {k: v.numpy() for k, v in pb.items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{case: (what the 4 gloo ranks' cells gave, the one-device results)}."""
    base = tmp_path_factory.mktemp("serving_cells")
    inputs = [_inputs(c) for c in CASES]
    one = {c["name"]: _lm_one_device(c, i) for c, i in zip(CASES, inputs)
           if i["family"] == "lm"}
    # the decode cells start from the one-device prefill's caches
    sent = [_padded(c, i) if i["family"] == "gnn" and c["shape"].kind == "full" else
            {**i, "start_caches": one[c["name"]]["start_caches"]} if i["family"] == "lm" else i
            for c, i in zip(CASES, inputs)]
    with open(base / "in.pkl", "wb") as f:
        pickle.dump(sent, f)
    ctx = mp.spawn(ranks.serving_cells_rank, args=(WORLD, str(base / "rdzv"),
                                                   str(base / "in.pkl"), str(base)),
                   nprocs=WORLD, join=False)
    for c, inp, s in zip(CASES, inputs, sent):
        if inp["family"] == "gnn":
            one[c["name"]] = _gnn_one_device(c, inp, s)
    while not ctx.join():
        pass
    with open(base / "serving_cells.pkl", "rb") as f:
        got = pickle.load(f)
    return {name: (got[name], one[name]) for name in one}


def _gate(name: str, got: np.ndarray, want: np.ndarray) -> None:
    bound = TOL * np.abs(want) + TOL * np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= bound).all(), (name, float(err.max()), float(bound.max()))


@pytest.mark.parametrize("case", LM_CASES, ids=[c["name"] for c in LM_CASES])
def test_the_prefill_cell_matches_one_device(world, case):
    got, one = world[case["name"]]
    _gate("prefill logits", got["prefill_logits"], one["prefill_logits"])
    assert got["prefill_caches"].keys() == one["prefill_caches"].keys()
    for p, want in one["prefill_caches"].items():
        _gate(f"prefill cache {p}", got["prefill_caches"][p], want)


@pytest.mark.parametrize("case", LM_CASES, ids=[c["name"] for c in LM_CASES])
def test_the_prefill_cells_caches_are_the_decode_cells(world, case):
    """The prefill cell's caches come out where the decode cell wants them:
    split over time (dim 1) or by heads (dim 2) on ``model``, as
    ``lm_cache_pspecs`` says, so the decode cell takes them as they are."""
    got, _ = world[case["name"]]
    assert got["prefill_placements"] == got["cache_placements"]
    split = "Shard(dim=1)" if case["split"] == "time" else "Shard(dim=2)"
    for p, pl in got["cache_placements"].items():
        model = "Replicate()" if p.endswith("['pos']") else split
        assert pl == f"(Shard(dim=0), {model})", (p, pl)


@pytest.mark.parametrize("case", LM_CASES, ids=[c["name"] for c in LM_CASES])
def test_the_decode_cell_matches_one_device_and_repeats(world, case):
    got, one = world[case["name"]]
    first, second = got["decode"]
    assert len(first["logits"]) == STEPS
    for i, (g, want) in enumerate(zip(first["logits"], one["decode_logits"])):
        _gate(f"decode step {i} logits", g, want)
    for p, want in one["caches"].items():
        _gate(f"cache {p}", first["caches"][p], want)
    for a, b in zip(first["logits"], second["logits"]):
        assert np.array_equal(a, b)
    for p, t in first["caches"].items():
        assert np.array_equal(t, second["caches"][p]), p


@pytest.mark.parametrize("case", LM_CASES, ids=[c["name"] for c in LM_CASES])
def test_one_device_prefill_and_decode_match_the_reference(world, case):
    """The one-device steps the cells are held to, against the JAX
    package's ``prefill`` and ``decode_step`` (the same ``moe_fn``)."""
    _, one = world[case["name"]]
    np.testing.assert_allclose(one["prefill_slots_logits"], one["jax_logits"][0], **JAX_TOL)
    for got, want in zip(one["decode_logits"], one["jax_logits"][1:]):
        np.testing.assert_allclose(got, want, **JAX_TOL)


@pytest.mark.parametrize("case", GNN_CASES, ids=[c["name"] for c in GNN_CASES])
def test_the_gnn_cell_matches_the_plain_step_and_repeats(world, case):
    got, one = world[case["name"]]
    first, second = got["runs"]
    want = one["unpadded"]
    np.testing.assert_allclose(first["loss"], want["loss"], rtol=LOSS_RTOL)
    assert first["params"].keys() == want["params"].keys()
    assert first["state"].keys() == want["state"].keys()
    for p, w in want["params"].items():
        _gate(f"params {p}", first["params"][p], w)
    for p, w in want["state"].items():
        _gate(f"state {p}", first["state"][p], w)
    assert any(not np.array_equal(t, one["before"][p]) for p, t in want["params"].items())
    assert first["loss"] == second["loss"]
    for p, t in first["params"].items():
        assert np.array_equal(t, second["params"][p]), p


@pytest.mark.parametrize("case", [c for c in GNN_CASES if c["shape"].kind == "full"],
                         ids=lambda c: c["name"])
def test_padding_a_graph_is_inert(world, case):
    """The padded graph's plain step against the unpadded one: the same
    loss, every parameter and AdamW leaf within TOL."""
    _, one = world[case["name"]]
    pad, want = one["padded"], one["unpadded"]
    np.testing.assert_allclose(pad["loss"], want["loss"], rtol=LOSS_RTOL)
    for p, w in want["params"].items():
        _gate(f"padded params {p}", pad["params"][p], w)
    for p, w in want["state"].items():
        _gate(f"padded state {p}", pad["state"][p], w)


def test_pad_graph_adds_self_loops_on_padded_nodes_only():
    g = {"x": torch.ones(5, 2), "edge_index": torch.tensor([[0, 1], [1, 2]], dtype=torch.int32),
         "labels": torch.ones(5, dtype=torch.int32), "train_mask": torch.ones(5, dtype=torch.bool)}
    p = steps.pad_graph(g, 8, 6)
    assert p["x"].shape == (8, 2) and not p["x"][5:].any()
    assert p["edge_index"][:, :2].tolist() == [[0, 1], [1, 2]]
    loops = p["edge_index"][:, 2:]
    assert torch.equal(loops[0], loops[1]) and bool((loops[0] >= 5).all())
    assert not p["train_mask"][5:].any() and p["labels"][5:].tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        steps.pad_graph(g, 5, 6)                     # padded edges need a padded node


def test_prefill_and_decode_with_no_moe_fn_are_those_of_before():
    """``moe_fn=None`` is ``apply_moe``, bit for bit, in ``prefill`` and
    ``decode_step``; a dense config never calls ``moe_fn``."""
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    for arch in ("granite-moe-1b-a400m", "qwen2-0.5b"):
        cfg = configs.get(arch).smoke_config
        params = lm.init(gen, cfg, device="cpu")
        toks = torch.from_numpy(syn.lm_batch(rng, cfg, 2, 8)["tokens"])
        if cfg.is_moe:
            hook = lambda lp, x: moe_lib.apply_moe(lp, x, top_k=cfg.top_k)  # noqa: E731
        else:
            def hook(lp, x):
                raise AssertionError("a dense layer called moe_fn")
        base, caches = lm.prefill(params, cfg, toks[:, :5], 8)
        hooked, hcaches = lm.prefill(params, cfg, toks[:, :5], 8, moe_fn=hook)
        assert torch.equal(base, hooked), arch
        for t in range(5, 8):
            base, caches = lm.decode_step(params, cfg, toks[:, t], caches)
            hooked, hcaches = lm.decode_step(params, cfg, toks[:, t], hcaches, moe_fn=hook)
            assert torch.equal(base, hooked), (arch, t)
        for c, h in zip(caches, hcaches):
            assert all(torch.equal(c[k], h[k]) for k in c), arch
