"""Cell programs: for an (arch × shape) pair, the step function, its
``Spec`` arguments, and where each argument's leaves lie on a
``DeviceMesh`` (the reference's ``launch/steps.py``).

A *cell* is one step of one workload: ``train_step`` for a training shape,
the serving step (bulk forward, retrieval scoring, an LM's prefill, one
decode token against a full KV cache) for an inference shape.
Its arguments are given as partition specs (the reference's, leaf for
leaf: ``distributed/sharding.py``) and as the DTensor placements they
make on the mesh.  ``Cell.place`` distributes concrete trees to those
placements; ``Cell.fn`` then runs the step on the DTensors, each rank on
its shards, through the hand-written kernels where the model calls them
(``kernels/ops.py`` takes DTensors).  The same ``fn`` on plain tensors is
the step on one device.

The port builds every cell the reference builds: the recommendation cells
(train, serve, retrieval), the LM cells (train, prefill, decode) and the
GNN cells (full graph, sampled minibatch, batched small graphs).  A decode
cell's KV cache whose heads do not divide the model axis is split over
time; K4 returns each rank's log-sum-exp and the ranks are merged in rank
order (``kernels/ops.py::decode_attention``).  A GNN cell's edges are
split over the batch axes; each rank sums its own edges and the partial
sums are added in rank order (``models/gnn.py``).  The graphs are padded
to multiples of 512 nodes and edges (``pad_graph`` pads a batch inertly).

Layouts that differ from the reference's:

* the port's LM layers are a list, so a parameter's spec has no leading
  ``None`` for a stacked layer axis (``layers_override`` only sets the
  layer count);
* ``optim.combined`` keeps state only for the leaves each side owns, so
  the ``combined`` optimiser's specs follow that layout
  (``_opt_pspecs``);
* specs are tuples (``distributed/sharding.py``), ``()`` replicated;
* the minibatch GNN cell's edge indices are a list (a tuple is a leaf of
  the port's trees).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ASSIGNED_ARCHS, FULL_ATTENTION_SKIPS, get, shapes_for_family
from repro_torch.configs.shapes import GNNShape, LMShape, RecShape
from repro_torch.core import costs
from repro_torch.data import synthetic as syn
from repro_torch.data.synthetic import Spec
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import batch_axes
from repro_torch.layers import moe as moe_lib
from repro_torch.models import gnn, lm, recsys
from repro_torch.train import optim
from repro_torch.train.microbatch import accumulated_grads, value_and_grad

@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                        # train | serve | retrieval | prefill | decode
    fn: Callable                     # positional-args step function
    args: tuple                      # Spec trees
    in_specs: tuple                  # per argument, its tree of partition specs
    in_shardings: tuple              # the same trees of DTensor placements
    out_specs: Any                   # train: (params, opt state, loss); else None
    out_shardings: Any
    model_flops: float               # 6·N·D / 2·N·D convention, core/costs.py
    mesh: DeviceMesh
    note: str = ""
    init_state: Callable | None = None   # train: params → the optimiser's state
    n_micro: int = 1                 # LM train: microbatches a step

    @property
    def name(self) -> str:
        return f"{self.arch}×{self.shape}"

    def place(self, *trees) -> tuple:
        """Each argument's tensors as DTensors at ``in_shardings`` (the
        same values on every rank go in, so each rank cuts its own shards
        and nothing is sent; None stays None).  On a one-rank mesh every
        DTensor shares its tensor's storage (two copies of a decode_32k
        cache would not fit a card): pass a copy when the original must
        stay."""
        return tuple(None if tree is None else _walk(lambda _, t, pl: _place(t, self.mesh, pl),
                                                     tree, sh)
                     for tree, sh in zip(trees, self.in_shardings))


def _place(t: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    if mesh.size() == 1:
        return DTensor.from_local(t.detach(), mesh, list(placements),
                                  run_check=False).requires_grad_(t.requires_grad)
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


class SkippedCell(Exception):
    pass


# ------------------------------------------------------------------ trees


def _walk(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest's leaves)`` in ``tree``'s structure of dicts
    and lists; a tuple is a leaf (a spec, placements), and the paths are
    ``utils.leaves_with_paths``'."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, *(r[k] for r in rest), path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, *(r[i] for r in rest), path=f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _spec_tree(tree, flat: dict) -> Any:
    """A ``{path: spec}`` of ``distributed/sharding.py`` as a tree shaped
    like ``tree``."""
    return _walk(lambda path, _: flat[path], tree)


def _placements(mesh: DeviceMesh, specs) -> Any:
    return _walk(lambda _, s: tuple(shd.to_placements(mesh, s)), specs)


def _specs_of(tree) -> Any:
    return _walk(lambda _, t: Spec.like(t), tree)


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _opt_pspecs(opt_kind: str, param_pspecs, route: Callable[[str], bool] | None = None):
    """The optimiser state's spec tree for ``train/optim.py``'s layouts:
    adamw's moments and adagrad's sums as the parameters, adamw's count
    replicated; ``combined`` keeps each side's state in a dictionary from
    parameter path to leaf, for the leaves ``route`` gives it (True:
    the sparse side, adagrad; False: the dense side, adamw)."""
    if opt_kind == "adamw":
        return {"mu": param_pspecs, "nu": param_pspecs, "count": ()}
    if opt_kind == "adagrad":
        return param_pspecs
    if opt_kind == "combined":
        flat = {}
        _walk(lambda path, s: flat.setdefault(path, s), param_pspecs)
        dense = {p: s for p, s in flat.items() if not route(p)}
        return {"sparse": {p: s for p, s in flat.items() if route(p)},
                "dense": {"mu": dense, "nu": dict(dense), "count": ()}}
    raise ValueError(opt_kind)


def _zero1_pspecs(param_pspecs, params_shape, data_axis: str = "data",
                  data_size: int = 16):
    """ZeRO-1: split the optimiser's moments over ``data`` too, on the first
    dim free of any axis whose size ``data_size`` divides (AdamW's float32
    moments are 4× bf16 weights)."""
    def one(_, spec, leaf):
        if leaf.ndim == 0 or data_axis in spec:
            return spec
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, (d, sz) in enumerate(zip(dims, leaf.shape)):
            if d is None and sz % data_size == 0 and sz >= data_size:
                dims[i] = data_axis
                return tuple(dims)
        return spec
    return _walk(one, param_pspecs, params_shape)


def _settle(grads, params):
    """Each DTensor gradient at its parameter's placements: the partial
    sums that local gradients were declared as are added up here, one mesh
    axis at a time in a fixed order (``sharding.redistribute_in_order``).
    ``train/microbatch.py`` hands the gradients over at their parameters'
    split already, so what is left is the sum over the batch axes (and
    over ``model`` for a replicated parameter): one reduction a step."""
    return _walk(lambda _, g, p: shd.redistribute_in_order(g, p.placements)
                 if isinstance(g, DTensor) else g, grads, params)


def _replicated(x):
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


def _train_step(loss_fn, opt: optim.Optimizer, n_micro: int = 1):
    """``train_step(params, opt_state, *batch) → (params, opt_state, loss)``:
    gradients of ``loss_fn(params, batch)`` (accumulated over ``n_micro``
    microbatches), reduced to the parameters' placements, then the
    optimiser's in-place update; the loss replicated.  A batch of one
    argument is that argument, of several their tuple.  Constants the model
    makes meet DTensors as replicated."""
    def train_step(params, opt_state, *batch):
        batch = batch[0] if len(batch) == 1 else batch
        with implicit_replication():
            if n_micro > 1:
                loss, grads = accumulated_grads(loss_fn, params, batch, n_micro)
            else:
                loss, grads = value_and_grad(loss_fn, params, batch)
            new_p, new_o = opt.update(_settle(grads, params), opt_state, params)
        return new_p, new_o, _replicated(loss)
    return train_step


def _serving(fn):
    """The serving step ``fn(*args)``: no graph, constants the model makes
    meet DTensors as replicated."""
    def step(*args):
        with torch.no_grad(), implicit_replication():
            return fn(*args)
    return step


# ------------------------------------------------------------------- LM


def _lm_cell(arch: str, shape: LMShape, mesh: DeviceMesh, *, smoke: bool = False,
             fsdp: bool = False, layers_override: int | None = None,
             n_micro: int | None = None) -> Cell:
    spec = get(arch)
    cfg = spec.smoke_config if smoke else spec.config
    if layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers_override)
    if shape.name in FULL_ATTENTION_SKIPS:
        raise SkippedCell(
            f"{arch}×{shape.name}: pure full-attention arch; 524k decode "
            "needs sub-quadratic attention (DESIGN.md §Arch-applicability)")
    baxes = batch_axes(mesh)
    params_meta = lm.init(torch.Generator(), cfg, device="meta")
    p_specs = _spec_tree(params_meta, shd.lm_param_pspecs(
        params_meta, fsdp=fsdp, model_axis_size=_axis_size(mesh, "model")))
    # MoE layers dispatch locally on each batch shard, experts split over
    # ``model`` (expert parallelism): a global sort over DTensors would move
    # every token
    moe_fn = moe_lib.make_sharded_moe(mesh, top_k=cfg.top_k) if cfg.is_moe else None
    if shape.kind == "prefill":
        return _lm_prefill_cell(arch, shape, mesh, cfg, params_meta, p_specs, moe_fn)
    if shape.kind == "decode":
        return _lm_decode_cell(arch, shape, mesh, cfg, params_meta, p_specs, moe_fn)

    opt = optim.adamw(3e-4)
    moments = _zero1_pspecs(p_specs, params_meta, data_size=_axis_size(mesh, "data"))
    o_specs = {"mu": moments, "nu": moments, "count": ()}
    batch_specs = syn.lm_specs(cfg, shape.global_batch, shape.seq_len)
    b_specs = _spec_tree(batch_specs, shd.lm_batch_pspecs(batch_specs, baxes))
    # microbatch ladder: activation memory ∝ tokens a microbatch
    if n_micro is None:
        n_micro = 8 if cfg.param_count > 2e10 else (4 if cfg.param_count > 2e9 else 1)
    step = _train_step(lambda p, b: lm.loss_fn(p, cfg, b, moe_fn=moe_fn), opt, n_micro)

    tokens = shape.global_batch * shape.seq_len
    in_specs = (p_specs, o_specs, b_specs)
    out_specs = (p_specs, o_specs, ())
    return Cell(arch, shape.name, "train", step,
                (_specs_of(params_meta), _specs_of(opt.init(params_meta)), batch_specs),
                in_specs, tuple(_placements(mesh, s) for s in in_specs),
                out_specs, tuple(_placements(mesh, s) for s in out_specs),
                costs.lm_model_flops(cfg, tokens, train=True), mesh,
                note=f"microbatches={n_micro}", init_state=opt.init, n_micro=n_micro)


def _lm_prefill_cell(arch, shape: LMShape, mesh, cfg, params_meta, p_specs, moe_fn) -> Cell:
    """``prefill_step(params, tokens) → (last-token logits, caches)``: the
    prompt of ``seq_len`` tokens into caches of as many slots, which come
    out at ``lm_cache_pspecs``' placements (``models/lm.py::prefill``)."""
    tok = syn.lm_specs(cfg, shape.global_batch, shape.seq_len)["tokens"]
    t_spec = shd.lm_batch_pspecs({"tokens": tok}, batch_axes(mesh))["['tokens']"]
    step = _serving(lambda params, tokens: lm.prefill(params, cfg, tokens, shape.seq_len,
                                                      moe_fn=moe_fn))
    in_specs = (p_specs, t_spec)
    return Cell(arch, shape.name, "prefill", step, (_specs_of(params_meta), tok), in_specs,
                tuple(_placements(mesh, s) for s in in_specs), None, None,
                costs.lm_model_flops(cfg, shape.global_batch * shape.seq_len, train=False),
                mesh)


def _lm_decode_cell(arch, shape: LMShape, mesh, cfg, params_meta, p_specs, moe_fn) -> Cell:
    """``decode(params, token, caches) → (logits, caches)``: one new token a
    sequence against caches of ``seq_len`` slots at ``lm_cache_pspecs``'
    placements (split over time where the KV heads do not divide
    ``model``), each layer's attention through K4 on every rank's cache
    (``layers/attention.py::decode_attention``), the caches written in
    place."""
    baxes = batch_axes(mesh)
    tok, caches = syn.decode_specs(cfg, shape.global_batch, shape.seq_len)
    c_specs = _spec_tree(caches, shd.lm_cache_pspecs(
        caches, baxes, model_axis_size=_axis_size(mesh, "model")))
    step = _serving(lambda params, token, caches: lm.decode_step(params, cfg, token, caches,
                                                                 moe_fn=moe_fn))
    in_specs = (p_specs, (baxes if len(baxes) > 1 else baxes[0],), c_specs)
    return Cell(arch, shape.name, "decode", step, (_specs_of(params_meta), tok, caches),
                in_specs, tuple(_placements(mesh, s) for s in in_specs), None, None,
                costs.lm_flops_per_token(cfg, train=False) * shape.global_batch, mesh,
                note=f"KV cache len {shape.seq_len}")


# --------------------------------------------------------------- recsys


def _is_table(path: str) -> bool:
    return "table" in path


def _recsys_cell(arch: str, shape: RecShape, mesh: DeviceMesh, *, smoke: bool = False) -> Cell:
    spec = get(arch)
    cfg = spec.smoke_config if smoke else spec.config
    baxes = batch_axes(mesh)
    params_meta = recsys.init(torch.Generator(), cfg, device="meta")
    p_specs = _spec_tree(params_meta, shd.recsys_param_pspecs(
        params_meta, model_axis_size=_axis_size(mesh, "model")))
    per_sample = costs.recsys_flops_per_sample(cfg)

    def batch_of(batch_specs):
        return _spec_tree(batch_specs, shd.recsys_batch_pspecs(batch_specs, baxes))

    if shape.kind == "train":
        opt = optim.combined(_is_table, optim.adagrad(0.01), optim.adamw(1e-3))
        o_specs = _opt_pspecs("combined", p_specs, _is_table)
        batch_specs = syn.recsys_specs(cfg, shape.batch)
        in_specs = (p_specs, o_specs, batch_of(batch_specs))
        out_specs = (p_specs, o_specs, ())
        step = _train_step(lambda p, b: recsys.loss_fn(p, cfg, b), opt)
        return Cell(arch, shape.name, "train", step,
                    (_specs_of(params_meta), _specs_of(opt.init(params_meta)), batch_specs),
                    in_specs, tuple(_placements(mesh, s) for s in in_specs),
                    out_specs, tuple(_placements(mesh, s) for s in out_specs),
                    3 * per_sample * shape.batch, mesh, init_state=opt.init)

    if shape.kind == "retrieval":
        n_cand = shape.n_candidates
        if cfg.interaction in ("mind", "bidir-seq"):
            batch_specs = syn.recsys_specs(cfg, shape.batch, n_candidates=n_cand,
                                           with_label=False)
            fn = _serving(lambda params, batch: recsys.score_candidates(params, cfg, batch))
            flops = per_sample * shape.batch + 2 * cfg.embed_dim * n_cand
        else:
            # CTR rankers: bulk-score the candidate rows (a chunked batched
            # forward, never a loop over candidates)
            batch_specs = syn.recsys_specs(cfg, n_cand, with_label=False)
            fn = _serving(lambda params, batch: recsys.bulk_forward(params, cfg, batch))
            flops = per_sample * n_cand
        in_specs = (p_specs, batch_of(batch_specs))
        return Cell(arch, shape.name, "retrieval", fn, (_specs_of(params_meta), batch_specs),
                    in_specs, tuple(_placements(mesh, s) for s in in_specs), None, None,
                    flops, mesh)

    # serve (p99 / bulk)
    batch_specs = syn.recsys_specs(cfg, shape.batch, with_label=False)
    in_specs = (p_specs, batch_of(batch_specs))
    fn = _serving(lambda params, batch: recsys.bulk_forward(params, cfg, batch))
    return Cell(arch, shape.name, "serve", fn, (_specs_of(params_meta), batch_specs),
                in_specs, tuple(_placements(mesh, s) for s in in_specs), None, None,
                per_sample * shape.batch, mesh)


# ------------------------------------------------------------------ GNN


def _pad_up(n: int, mult: int = 512) -> int:
    return ((n + mult - 1) // mult) * mult


def pad_graph(batch: dict, n_nodes: int, n_edges: int) -> dict:
    """A full-graph batch (``data/synthetic.py::random_graph``'s leaves,
    tensors) padded to ``n_nodes`` nodes and ``n_edges`` edges, inertly:
    the padded nodes have zero features, label 0 and ``train_mask`` False,
    and the padded edges are self-loops on the padded nodes, so the loss
    and every parameter's gradient are the unpadded graph's."""
    n, e = batch["x"].shape[0], batch["edge_index"].shape[1]
    if n_nodes < n or n_edges < e or (n_edges > e and n_nodes == n):
        raise ValueError(f"cannot pad a graph of {n} nodes and {e} edges to {n_nodes} and "
                         f"{n_edges}: padded edges need a padded node")
    dev = batch["x"].device
    pad_nodes = torch.arange(n, n_nodes, device=dev, dtype=batch["edge_index"].dtype)
    loops = pad_nodes[torch.arange(n_edges - e, device=dev) % max(n_nodes - n, 1)]
    out = {"x": torch.cat([batch["x"], batch["x"].new_zeros((n_nodes - n, batch["x"].shape[1]))]),
           "edge_index": torch.cat([batch["edge_index"], torch.stack([loops, loops])], dim=1)}
    if "labels" in batch:
        out["labels"] = torch.cat([batch["labels"], batch["labels"].new_zeros(n_nodes - n)])
        out["train_mask"] = torch.cat([batch["train_mask"],
                                       batch["train_mask"].new_zeros(n_nodes - n)])
    return out


def _minibatch_loss(params, cfg, x_input, eis, labels, sizes) -> torch.Tensor:
    """The sampled minibatch's mean NLL of its seed nodes' labels."""
    blocks = [(ei, n_src, n_dst) for ei, (n_src, n_dst) in zip(eis, sizes)]
    logits = gnn.forward_blocks(params, cfg, x_input, blocks).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def _gnn_cell(arch: str, shape: GNNShape, mesh: DeviceMesh, *, smoke: bool = False) -> Cell:
    """A GCN training step, AdamW(1e-2), the weights replicated and the
    graph split over the batch axes (``gnn_batch_pspecs``): a full graph
    padded to multiples of 512 nodes and edges (``pad_graph``), a sampled
    minibatch's blocks at their largest, or a batch of small graphs."""
    from repro_torch.configs.gcn_cora import config_for_shape
    cfg = get(arch).smoke_config if smoke else config_for_shape(shape)
    baxes = batch_axes(mesh)
    bx = baxes if len(baxes) > 1 else baxes[0]
    opt = optim.adamw(1e-2)
    params_meta = gnn.init(torch.Generator(), cfg, device="meta")
    p_specs = _spec_tree(params_meta, shd.gnn_param_pspecs(params_meta))
    o_specs = _opt_pspecs("adamw", p_specs)
    head = (_specs_of(params_meta), _specs_of(opt.init(params_meta)))

    def batch_of(batch_specs):
        return _spec_tree(batch_specs, shd.gnn_batch_pspecs(batch_specs, baxes))

    if shape.kind == "minibatch":
        x_spec, blocks = syn.minibatch_block_specs(cfg, shape.batch_nodes, shape.fanouts)
        ei_specs = [b[0] for b in blocks]
        sizes = [(b[1], b[2]) for b in blocks]
        batch_specs = (x_spec, ei_specs, Spec((shape.batch_nodes,), torch.int32))
        b_specs = ((bx, None), [(None, bx) for _ in ei_specs], (bx,))
        step = _train_step(lambda p, b: _minibatch_loss(p, cfg, *b, sizes), opt)
        flops = 3 * costs.gcn_flops(cfg, x_spec.shape[0], sum(e.shape[1] for e in ei_specs))
        note = f"sampled fanout {tuple(shape.fanouts)}"
    elif shape.kind == "full":
        batch_specs = (syn.gnn_full_specs(cfg, _pad_up(shape.n_nodes), _pad_up(shape.n_edges)),)
        b_specs = (batch_of(batch_specs[0]),)
        step = _train_step(lambda p, b: gnn.loss_fn(p, cfg, b), opt)
        flops = 3 * costs.gcn_flops(cfg, shape.n_nodes, shape.n_edges)
        note = ""
    else:                                                            # batched small graphs
        batch_specs = (syn.molecule_specs(cfg, shape.batch, shape.nodes_per_graph,
                                          shape.edges_per_graph),)
        b_specs = (batch_of(batch_specs[0]),)
        step = _train_step(lambda p, b: gnn.graph_loss_fn(p, cfg, b), opt)
        flops = 3 * costs.gcn_flops(cfg, shape.nodes_per_graph,
                                    shape.edges_per_graph) * shape.batch
        note = ""
    in_specs = (p_specs, o_specs) + b_specs
    out_specs = (p_specs, o_specs, ())
    return Cell(arch, shape.name, "train", step, head + batch_specs, in_specs,
                tuple(_placements(mesh, s) for s in in_specs), out_specs,
                tuple(_placements(mesh, s) for s in out_specs), flops, mesh, note=note,
                init_state=opt.init)


# ---------------------------------------------------------------- public


def build_cell(arch: str, shape_name: str, mesh: DeviceMesh, *, smoke: bool = False,
               fsdp: bool = False, layers_override: int | None = None,
               n_micro: int | None = None) -> Cell:
    """The cell of ``arch`` at ``shape_name`` on ``mesh`` (axes ``data`` and
    ``model``, ``launch/mesh.py``).  Raises ``SkippedCell`` where the
    reference skips (``long_500k``).
    ``n_micro`` sets an LM training cell's microbatches (by default the
    reference's ladder on the config's size, after ``layers_override``)."""
    spec = get(arch)
    shape = shapes_for_family(spec.family)[shape_name]
    if spec.family == "lm":
        return _lm_cell(arch, shape, mesh, smoke=smoke, fsdp=fsdp,
                        layers_override=layers_override, n_micro=n_micro)
    if spec.family == "recsys":
        return _recsys_cell(arch, shape, mesh, smoke=smoke)
    if spec.family == "gnn":
        return _gnn_cell(arch, shape, mesh, smoke=smoke)
    raise ValueError(spec.family)


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch × shape) pairs, in registry order."""
    return [(arch, shape_name) for arch in ASSIGNED_ARCHS
            for shape_name in shapes_for_family(get(arch).family)]
