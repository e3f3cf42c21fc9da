"""The port's cell builder (``launch/steps.py``) against the reference's.

Metadata: ``ASSIGNED_ARCHS``, ``all_cells()`` and every ``*_specs`` builder
equal the JAX package's; every cell the port builds (all 35 the reference
does not skip: recsys, LM train, prefill and decode, GNN), built at smoke
size on a (2, 4) ``(data, model)`` mesh of a fake world of 8 ranks, has the
reference's kind, argument shapes and dtypes, partition specs (parameters,
optimiser state, batch, tokens, KV caches: split over time for the smoke
qwen2, yi and MoE configs, by heads for phi3's), ``model_flops`` and note;
the reference's cells are built once in a subprocess with 8 host devices
(``torch_reference_cells.reference_cells``).  The LM prefill and decode
cells and the GNN cells run in tests/test_torch_cells_lm_gnn.py.

Numbers: one module-scoped gloo world of 4 CPU ranks (``tests/
torch_dist_ranks.py::cells_rank``) runs each case's cell on DTensors from
the JAX package's weights (``compat``) and the same numpy batch; the test
holds what the step gives against the port's step on plain tensors and
against the JAX package's single-device loss or output (and, for the LM
cases at two microbatches, ``jax.grad`` of its loss).  Losses within
rtol 1e-5 (recommendation) and 2e-4 (the LMs, the reference's own
tolerance in tests/test_distributed.py); parameters and optimiser state
after one step within the gradient gate's TOL = 2e-5 (|got − want| ≤
TOL·|want| + TOL·max|want|).  The cases: xDeepFM (CIN) and DLRM-RMC2 (K1,
K2) training with column-sharded tables on (2, 2); xDeepFM with
``embed_dim`` 6, row-sharded, on (1, 4); MIND retrieval and AutoInt
serving on (2, 2); granite-moe through ``make_sharded_moe`` on (1, 4) and
(2, 2); qwen2, whose 7 query heads and 1 KV head do not divide the model
axis, on (2, 2); yi, whose do, on (2, 2) at 1,024 tokens a sequence.
On (2, 2) each data shard of granite-moe dispatches its
own tokens at its own capacity, so its one-device meaning applies the MoE
layer to each half of the batch apart (in both packages)."""
import dataclasses
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate, Shard

import torch_dist_ranks as ranks
from torch_reference_cells import built_cells, reference_cells  # noqa: F401  (a fixture)
from repro import configs as jax_configs
from repro.data import synthetic as jax_syn
from repro.launch import steps as jax_steps
from repro.layers import moe as jax_moe
from repro.models import lm as jax_lm
from repro.models import recsys as jax_recsys
from repro_torch import compat, configs
from repro_torch.data import synthetic as syn
from repro_torch.launch import steps
from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.models import lm, recsys
from repro_torch.train import optim
from repro_torch.train.microbatch import accumulated_grads
from repro_torch.utils import leaves_with_paths

KEY = jax.random.PRNGKey(0)
WORLD = 4
TOL = 2e-5                      # the gradient gate's (chip_smoke.py)
RECSYS_RTOL = 1e-5
LM_RTOL = 2e-4
META_CELLS = built_cells()


# ---------------------------------------------------------------- metadata


def test_assigned_archs_and_all_cells_equal_the_reference():
    assert configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    assert steps.all_cells() == jax_steps.all_cells()
    assert len(steps.all_cells()) == 40


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) else np.dtype(d).name


def _flat_specs(tree) -> dict:
    """{path: (shape, dtype name)} of a tree of Specs or ShapeDtypeStructs."""
    if isinstance(tree, (syn.Spec, jax.ShapeDtypeStruct)):
        return {"": (tuple(tree.shape), _dtype_name(tree.dtype))}
    if isinstance(tree, dict):
        return {f"[{k!r}]{p}": v for k in tree for p, v in _flat_specs(tree[k]).items()}
    if isinstance(tree, (list, tuple)):
        return {f"[{i}]{p}": v for i, t in enumerate(tree) for p, v in _flat_specs(t).items()}
    raise TypeError(type(tree))


@pytest.mark.parametrize("which", ["smoke_config", "config"])
@pytest.mark.parametrize("arch", ["xdeepfm", "mind", "bert4rec", "dlrm-rmc2", "din"])
def test_recsys_specs_equal_the_reference(arch, which):
    cfg, jcfg = getattr(configs.get(arch), which), getattr(jax_configs.get(arch), which)
    for kw in ({}, {"with_label": False}, {"n_candidates": 16, "with_label": False}):
        assert (_flat_specs(syn.recsys_specs(cfg, 8, **kw))
                == _flat_specs(jax_syn.recsys_specs(jcfg, 8, **kw))), kw
    # the batch builder makes what the specs say
    batch = syn.recsys_batch(np.random.default_rng(0), cfg if which == "smoke_config" else
                             dataclasses.replace(cfg, vocab=100, item_vocab=100), 8)
    for k, spec in syn.recsys_specs(cfg, 8).items():
        t = torch.from_numpy(np.asarray(batch[k]))
        assert (tuple(t.shape), t.dtype) == (spec.shape, spec.dtype), k


@pytest.mark.parametrize("which", ["smoke_config", "config"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m", "yi-34b"])
def test_lm_and_decode_specs_equal_the_reference(arch, which):
    cfg, jcfg = getattr(configs.get(arch), which), getattr(jax_configs.get(arch), which)
    assert _flat_specs(syn.lm_specs(cfg, 4, 32)) == _flat_specs(jax_syn.lm_specs(jcfg, 4, 32))
    assert (_flat_specs(list(syn.decode_specs(cfg, 4, 64)))
            == _flat_specs(list(jax_syn.decode_specs(jcfg, 4, 64))))
    caches = lm.init_caches(cfg, 4, 64, device="meta")
    assert _flat_specs(syn.decode_specs(cfg, 4, 64)[1]) == _flat_specs(
        [{k: syn.Spec.like(v) for k, v in c.items()} for c in caches])


@pytest.mark.parametrize("which", ["smoke_config", "config"])
def test_gnn_specs_equal_the_reference(which):
    cfg = getattr(configs.get("gcn-cora"), which)
    jcfg = getattr(jax_configs.get("gcn-cora"), which)
    for lab in (True, False):
        assert (_flat_specs(syn.gnn_full_specs(cfg, 100, 300, with_label=lab))
                == _flat_specs(jax_syn.gnn_full_specs(jcfg, 100, 300, with_label=lab)))
    assert (_flat_specs(syn.molecule_specs(cfg, 8, 30, 64))
            == _flat_specs(jax_syn.molecule_specs(jcfg, 8, 30, 64)))
    x, blocks = syn.minibatch_block_specs(cfg, 32, (15, 10))
    jx, jblocks = jax_syn.minibatch_block_specs(jcfg, 32, (15, 10))
    assert _flat_specs(x) == _flat_specs(jx)
    assert [(_flat_specs(e), s, d) for e, s, d in blocks] == \
        [(_flat_specs(e), s, d) for e, s, d in jblocks]


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 4) (data, model) mesh over a fake world of 8 ranks: building a
    cell needs a mesh, not a collective."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _normal(path: str) -> str:
    """optim.combined's state is keyed by parameter path: a leaf of it
    reads ['dense']['mu']["['predict'][0][0]['w']"]; the reference's tree
    reads ['dense']['mu']['predict'][0][0]['w']."""
    return re.sub(r'\["(\[.*?\])"\]', r"\1", path)


def _spec_leaves(tree) -> dict:
    out = {}
    steps._walk(lambda p, s: out.setdefault(_normal(p), [list(a) if isinstance(a, tuple) else a
                                                          for a in s]), tree)
    return out


def _arg_leaves(tree) -> dict:
    return {_normal(p): [list(s.shape), _dtype_name(s.dtype)]
            for p, s in leaves_with_paths(tree)}


def _combined_subset(want: dict) -> dict:
    """The reference's combined optimiser state keeps both sides' state for
    every leaf; the port keeps the tables' on the sparse side and the rest's
    on the dense side (``optim.combined``)."""
    def kept(path: str) -> bool:
        for side, prefix in (("sparse", "['sparse']"), ("dense", "['dense']['mu']"),
                             ("dense", "['dense']['nu']")):
            if path.startswith(prefix):
                return steps._is_table(path[len(prefix):]) == (side == "sparse")
        return path == "['dense']['count']"
    return {p: v for p, v in want.items() if kept(p)}


@pytest.mark.parametrize("arch,shape", META_CELLS)
def test_cell_metadata_equals_the_reference(arch, shape, reference_cells, fake_mesh):
    want = reference_cells[f"{arch}|{shape}"]
    cell = steps.build_cell(arch, shape, fake_mesh, smoke=True)
    assert (cell.kind, cell.note) == (want["kind"], want["note"])
    assert cell.model_flops == want["model_flops"]
    assert len(cell.args) == len(want["args"]) == len(cell.in_specs) == len(want["specs"])
    for i, (got_args, got_specs) in enumerate(zip(cell.args, cell.in_specs)):
        want_args, want_specs = want["args"][i], want["specs"][i]
        if cell.kind == "train" and i == 1 and configs.get(arch).family == "recsys":
            want_args, want_specs = _combined_subset(want_args), _combined_subset(want_specs)
        assert _arg_leaves(got_args) == want_args, (cell.name, i)
        assert _spec_leaves(got_specs) == want_specs, (cell.name, i)
    # the placements are the specs' on the mesh
    sh = {}
    steps._walk(lambda p, s: sh.setdefault(p, s), cell.in_shardings[0])
    specs = {}
    steps._walk(lambda p, s: specs.setdefault(p, s), cell.in_specs[0])
    for p, pl in sh.items():
        want_pl = [Replicate()] * 2
        for dim, axes in enumerate(specs[p]):
            for a in (axes,) if isinstance(axes, str) else (axes or ()):
                want_pl[("data", "model").index(a)] = Shard(dim)
        assert list(pl) == want_pl, p


@pytest.mark.parametrize("arch,shape,kind", [
    ("qwen2-0.5b", "long_500k", None),
    ("qwen2-0.5b", "prefill_32k", "prefill"),
    ("granite-moe-1b-a400m", "decode_32k", "decode"),
    ("gcn-cora", "full_graph_sm", "train"),
])
def test_cells_not_built_say_why(arch, shape, kind, fake_mesh):
    """The reference's skipped cells say why; every other cell builds (the
    LM prefill and decode cells and the GNN cells were not built before K4
    returned its log-sum-exp and the GNN's sums were split over ranks)."""
    if kind is None:
        with pytest.raises(steps.SkippedCell) as info:
            steps.build_cell(arch, shape, fake_mesh, smoke=True)
        assert shape in str(info.value) and "full-attention" in str(info.value)
        return
    cell = steps.build_cell(arch, shape, fake_mesh, smoke=True)
    assert (cell.arch, cell.shape, cell.kind) == (arch, shape, kind)
    assert len(cell.args) == len(cell.in_specs) == len(cell.in_shardings)


def test_lm_loss_with_no_moe_fn_is_the_loss_of_before():
    """moe_fn=None is apply_moe, bit for bit; a dense config never calls
    moe_fn; the token lookup (F.embedding now) gives indexing's bits."""
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    for arch in ("granite-moe-1b-a400m", "qwen2-0.5b"):
        cfg = configs.get(arch).smoke_config
        params = lm.init(gen, cfg, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in syn.lm_batch(rng, cfg, 2, 16).items()}
        base = lm.loss_fn(params, cfg, batch)
        if cfg.is_moe:
            hook = lambda lp, x: moe_lib.apply_moe(lp, x, top_k=cfg.top_k)  # noqa: E731
        else:
            def hook(lp, x):
                raise AssertionError("a dense layer called moe_fn")
        assert torch.equal(lm.loss_fn(params, cfg, batch, moe_fn=hook), base), arch
        assert torch.equal(lm.forward(params, cfg, batch["tokens"], moe_fn=hook),
                           lm.forward(params, cfg, batch["tokens"])), arch
        assert torch.equal(emb_lib.lookup(params["embed"], batch["tokens"]),
                           params["embed"][batch["tokens"].long()])


# ------------------------------------------------- sharded against one device

REC_TRAIN = ("train_batch", 16, "train")
LM_TRAIN = ("train_4k", 16, 4, "train")
CASES = [
    dict(name="xdeepfm_train", arch="xdeepfm", family="recsys", mesh=(2, 2), shape=REC_TRAIN),
    dict(name="rmc2_train", arch="dlrm-rmc2", family="recsys", mesh=(2, 2), shape=REC_TRAIN),
    dict(name="xdeepfm_rows_train", arch="xdeepfm-rows", base="xdeepfm", embed_dim=6,
         family="recsys", mesh=(1, 4), shape=REC_TRAIN),
    dict(name="mind_retrieval", arch="mind", family="recsys", mesh=(2, 2),
         shape=("retrieval_cand", 1, "retrieval", 64)),
    dict(name="autoint_serve", arch="autoint", family="recsys", mesh=(2, 2),
         shape=("serve_p99", 8, "serve")),
    dict(name="granite_train_1x4", arch="granite-moe-1b-a400m", family="lm", mesh=(1, 4),
         shape=LM_TRAIN),
    dict(name="granite_train_2x2", arch="granite-moe-1b-a400m", family="lm", mesh=(2, 2),
         shape=LM_TRAIN),
    dict(name="qwen2_train", arch="qwen2-0.5b", family="lm", mesh=(2, 2), shape=LM_TRAIN,
         microbatches=2),
    # heads that divide the model axis: the dense products split over two
    # model ranks; 1,024 tokens: two cross-entropy chunks
    dict(name="yi_train", arch="yi-34b", family="lm", mesh=(2, 2),
         shape=("train_4k", 1024, 4, "train"), microbatches=2),
]
BY_NAME = {c["name"]: c for c in CASES}


def _configs(case):
    base = case.get("base", case["arch"])
    cfg, jcfg = configs.get(base).smoke_config, jax_configs.get(base).smoke_config
    if "embed_dim" in case:
        cfg = dataclasses.replace(cfg, embed_dim=case["embed_dim"])
        jcfg = dataclasses.replace(jcfg, embed_dim=case["embed_dim"])
    return cfg, jcfg


_JAX_PARAMS: dict = {}


def _jax_params(case, jcfg):
    """The JAX package's weights of the case's config, numpy, made once."""
    if jcfg not in _JAX_PARAMS:
        init = jax_lm.init if case["family"] == "lm" else jax_recsys.init
        _JAX_PARAMS[jcfg] = jax.tree.map(np.asarray, jax.jit(lambda: init(KEY, jcfg))())
    return _JAX_PARAMS[jcfg]


def _inputs(case) -> dict:
    """The JAX package's weights and one numpy batch, as numpy trees."""
    cfg, jcfg = _configs(case)
    rng = np.random.default_rng(0)
    params = _jax_params(case, jcfg)
    if case["family"] == "lm":
        batch = syn.lm_batch(rng, cfg, case["shape"][2], case["shape"][1])
    else:
        name, b, kind = case["shape"][:3]
        kw = ({"n_candidates": case["shape"][3], "with_label": False} if kind == "retrieval"
              else {"with_label": kind == "train"})
        batch = syn.recsys_batch(rng, cfg, b, **kw)
    return {**case, "params": params, "batch": {k: np.asarray(v) for k, v in batch.items()}}


def _per_shard_moe(n: int, top_k: int, apply, cat, stack_mean):
    """The MoE layer applied to each of n batch shards apart (what a data
    shard's local dispatch computes), aux losses averaged."""
    def fn(lp, x):
        outs = [apply(lp, xb, top_k=top_k) for xb in (x.chunk(n) if cat is torch.cat
                                                      else jnp.split(x, n))]
        return cat([o[0] for o in outs]), {"aux_loss": stack_mean([o[1]["aux_loss"]
                                                                   for o in outs])}
    return fn


def _one_device(case, inp) -> dict:
    """The port's step on plain tensors and the JAX package's loss or
    output, from the same weights and batch."""
    cfg, jcfg = _configs(case)
    params = compat.from_jax_params(inp["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    jparams = jax.tree.map(jnp.asarray, inp["params"])
    jbatch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    kind = case["shape"][-1] if case["family"] == "lm" else case["shape"][2]
    if kind == "serve":
        return {"out": recsys.bulk_forward(params, cfg, batch).numpy(),
                "jax_out": np.asarray(jax_recsys.bulk_forward(jparams, jcfg, jbatch))}
    if kind == "retrieval":
        return {"out": recsys.score_candidates(params, cfg, batch).numpy(),
                "jax_out": np.asarray(jax_recsys.score_candidates(jparams, jcfg, jbatch))}
    if case["family"] == "lm":
        n_data = case["mesh"][0]
        moe_fn = jmoe_fn = None
        if cfg.is_moe and n_data > 1:
            moe_fn = _per_shard_moe(n_data, cfg.top_k, moe_lib.apply_moe, torch.cat,
                                    lambda xs: torch.stack(xs).mean())
            jmoe_fn = _per_shard_moe(n_data, cfg.top_k, jax_moe.apply_moe, jnp.concatenate,
                                     lambda xs: jnp.stack(xs).mean())
        loss_fn = lambda p, b: lm.loss_fn(p, cfg, b, moe_fn=moe_fn)  # noqa: E731
        opt = optim.adamw(3e-4)
        jloss = jax.jit(lambda p, b: jax_lm.loss_fn(p, jcfg, b, moe_fn=jmoe_fn))(jparams, jbatch)
    else:
        loss_fn = lambda p, b: recsys.loss_fn(p, cfg, b)  # noqa: E731
        opt = optim.combined(steps._is_table, optim.adagrad(0.01), optim.adamw(1e-3))
        jloss = jax.jit(lambda p, b: jax_recsys.loss_fn(p, jcfg, b))(jparams, jbatch)
    out = {}
    if case.get("microbatches"):
        mloss, mgrads = accumulated_grads(loss_fn, params, batch, case["microbatches"])
        jgrads = jax.jit(jax.grad(lambda p, b: jax_lm.loss_fn(p, jcfg, b)))(jparams, jbatch)
        out = {"micro_loss": float(mloss),
               "micro_grads": {p: t.numpy() for p, t in leaves_with_paths(mgrads)},
               "jax_grads": {p: t.numpy() for p, t in leaves_with_paths(
                   compat.from_jax_params(jax.tree.map(np.asarray, jgrads), device="cpu"))}}
    state = opt.init(params)
    new_p, new_o, loss = steps._train_step(loss_fn, opt)(params, state, batch)
    return {**out, "loss": float(loss), "jax_loss": float(jloss),
            "params": {p: t.numpy() for p, t in leaves_with_paths(new_p)},
            "state": {p: t.numpy() for p, t in leaves_with_paths(new_o)}}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{case: (what the 4 gloo ranks' cell gave, the one-device results)}."""
    base = tmp_path_factory.mktemp("cells")
    inputs = [_inputs(c) for c in CASES]
    with open(base / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = mp.spawn(ranks.cells_rank, args=(WORLD, str(base / "rdzv"), str(base / "in.pkl"),
                                           str(base)), nprocs=WORLD, join=False)
    one = {c["name"]: _one_device(c, inp) for c, inp in zip(CASES, inputs)}
    while not ctx.join():
        pass
    with open(base / "cells.pkl", "rb") as f:
        got = pickle.load(f)
    for c, inp in zip(CASES, inputs):
        one[c["name"]]["params_before"] = {
            p: t.numpy() for p, t in leaves_with_paths(compat.from_jax_params(inp["params"],
                                                                              device="cpu"))}
    return {name: (got[name], one[name]) for name in one}


def _gate(name: str, got: np.ndarray, want: np.ndarray) -> None:
    if not want.size:
        return
    bound = TOL * np.abs(want) + TOL * np.abs(want).max()
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), (name, float(err.max()), float(bound.max()))


@pytest.mark.parametrize("name,rtol", [("xdeepfm_train", RECSYS_RTOL),
                                       ("rmc2_train", RECSYS_RTOL),
                                       ("xdeepfm_rows_train", RECSYS_RTOL),
                                       ("granite_train_1x4", LM_RTOL),
                                       ("granite_train_2x2", LM_RTOL),
                                       ("qwen2_train", LM_RTOL), ("yi_train", LM_RTOL)])
def test_sharded_loss_matches_one_device_and_the_reference(sharded, name, rtol):
    """The port's tests/test_distributed.py pair (xDeepFM at 1e-5, the MoE
    LM at 2e-4) and the other train cells: the sharded loss against the
    port's loss on one device and the JAX package's."""
    got, one = sharded[name]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=rtol)
    np.testing.assert_allclose(got["loss"], one["jax_loss"], rtol=rtol)


@pytest.mark.parametrize("name", ["xdeepfm_train", "rmc2_train", "xdeepfm_rows_train",
                                  "granite_train_1x4", "granite_train_2x2", "qwen2_train",
                                  "yi_train"])
def test_sharded_step_matches_one_device(sharded, name):
    """Every optimiser leaf and every parameter after one step, gathered
    whole.  AdamW's first step moves a coordinate by lr·g/(|g| + 1e-8): where
    the one-device gradient is within 100 × eps of 0, the sum order of g
    alone moves it by a share of lr, so the LMs' parameters (AdamW on every
    leaf) are held to the gate where |g| ≥ 1e-6; their moments, linear and
    quadratic in g, are held everywhere."""
    got, one = sharded[name]
    assert got["params"].keys() == one["params"].keys()
    assert got["state"].keys() == one["state"].keys()
    for p, want in one["state"].items():
        _gate(f"{name} state {p}", got["state"][p], want)
    held = 0
    for p, want in one["params"].items():
        keep = np.ones(want.shape, bool)
        if BY_NAME[name]["family"] == "lm":
            keep = np.abs(one["state"][f"['mu']{p}"]) / 0.1 >= 1e-6   # mu = (1 - b1)·g
        _gate(f"{name} params {p}", got["params"][p][keep], want[keep])
        held += int(keep.sum())
    assert held > 0.5 * sum(t.size for t in one["params"].values()), held
    # the step moved the parameters
    assert any(not np.array_equal(t, one["params_before"][p]) for p, t in one["params"].items())


def test_microbatches_split_each_ranks_shard(sharded):
    """accumulated_grads on a DTensor batch takes each rank's i-th chunk of
    its own shard as microbatch i: another grouping of the rows than one
    device's, the same mean loss and gradients (qwen2, 2 microbatches on
    (2, 2))."""
    got, one = sharded["qwen2_train"]
    np.testing.assert_allclose(got["micro_loss"], one["micro_loss"], rtol=RECSYS_RTOL)
    np.testing.assert_allclose(got["micro_loss"], one["loss"], rtol=RECSYS_RTOL)
    assert got["micro_grads"].keys() == one["micro_grads"].keys()
    for p, want in one["micro_grads"].items():
        _gate(f"microbatched grad {p}", got["micro_grads"][p], want)


@pytest.mark.parametrize("name", ["qwen2_train", "yi_train"])
def test_sharded_grads_match_one_device_and_the_reference(sharded, name):
    """The gradients ``accumulated_grads`` hands over on DTensors (two
    microbatches on (2, 2)), gathered whole: the tied (qwen2) and untied (yi)
    unembedding on each rank's rows and vocabulary shard, yi's dense
    products split over two model ranks.  Against the port's plain
    gradients (the gate) and ``jax.grad`` of the reference's loss (the LM
    tolerance of tests/test_torch_lm.py); each weight gradient lies at its
    parameter's split over ``model``."""
    got, one = sharded[name]
    assert got["micro_grads"].keys() == one["jax_grads"].keys()
    for p, want in one["jax_grads"].items():
        _gate(f"{name} grad {p}", got["micro_grads"][p], one["micro_grads"][p])
        np.testing.assert_allclose(got["micro_grads"][p], want, rtol=1e-4, atol=1e-4, err_msg=p)
    split = 0
    for p, placed in got["placements"].items():
        if "Shard" in placed.split(",")[-1]:
            assert got["micro_placements"][p].split(",")[-1] == placed.split(",")[-1], p
            split += 1
    assert split >= 8


@pytest.mark.parametrize("name,table,placements", [
    ("xdeepfm_train", "['tables']", "(Replicate(), Shard(dim=2))"),
    ("rmc2_train", "['tables']", "(Replicate(), Shard(dim=2))"),
    ("xdeepfm_rows_train", "['tables']", "(Replicate(), Shard(dim=1))"),
    ("mind_retrieval", "['item_table']", "(Replicate(), Shard(dim=1))"),
    ("qwen2_train", "['embed']", "(Replicate(), Shard(dim=0))"),
    ("granite_train_1x4", "['layers'][0]['moe']['wg']", "(Replicate(), Shard(dim=0))"),
])
def test_tables_are_split_as_the_rules_say(sharded, name, table, placements):
    """Column-sharded tables (D divides the model axis), row-sharded ones
    (xDeepFM at D = 6 on 4), a vocabulary split, expert parallelism."""
    assert sharded[name][0]["placements"][table] == placements


@pytest.mark.parametrize("name", ["mind_retrieval", "autoint_serve"])
def test_sharded_serving_matches_one_device_and_the_reference(sharded, name):
    got, one = sharded[name]
    np.testing.assert_allclose(got["out"], one["out"], rtol=RECSYS_RTOL, atol=1e-6)
    np.testing.assert_allclose(got["out"], one["jax_out"], rtol=RECSYS_RTOL, atol=1e-6)


def test_qwen2_heads_do_not_divide_the_model_axis():
    """The uneven-heads case is what it claims: 7 query heads and 1 KV head
    on a model axis of 2 (the attention gathers the heads)."""
    cfg = configs.get(BY_NAME["qwen2_train"]["arch"]).smoke_config
    m = BY_NAME["qwen2_train"]["mesh"][1]
    assert cfg.n_heads % m and cfg.n_kv_heads % m
