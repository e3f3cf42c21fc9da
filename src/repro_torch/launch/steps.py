"""Cell programs: for an (arch × shape) pair, the step function, its
``Spec`` arguments, and where each argument's leaves lie on a
``DeviceMesh`` (the reference's ``launch/steps.py``).

A *cell* is one step of one workload: ``train_step`` for a training shape,
the serving step (bulk forward, retrieval scoring) for an inference shape.
Its arguments are given as partition specs (the reference's, leaf for
leaf: ``distributed/sharding.py``) and as the DTensor placements they
make on the mesh.  ``Cell.place`` distributes concrete trees to those
placements; ``Cell.fn`` then runs the step on the DTensors, each rank on
its shards, through the hand-written kernels where the model calls them
(``kernels/ops.py`` takes DTensors).  The same ``fn`` on plain tensors is
the step on one device.

The port builds the recommendation cells (train, serve, retrieval) and the
LM training cells.  The LM prefill and decode cells raise ``NotBuilt``
(a ``NotImplementedError``): a KV cache whose heads do not divide the model
axis is split over time, and K4 returns no log-sum-exp to merge the
ranks' softmaxes.  The GNN cells raise it too: their sums over edges split
across ranks need a fixed-order design of their own.  Both are the next
items of ``ROADMAP.md`` queue 1.

Layouts that differ from the reference's:

* the port's LM layers are a list, so a parameter's spec has no leading
  ``None`` for a stacked layer axis (``layers_override`` only sets the
  layer count);
* ``optim.combined`` keeps state only for the leaves each side owns, so
  the ``combined`` optimiser's specs follow that layout
  (``_opt_pspecs``);
* specs are tuples (``distributed/sharding.py``), ``()`` replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ASSIGNED_ARCHS, FULL_ATTENTION_SKIPS, get, shapes_for_family
from repro_torch.configs.shapes import LMShape, RecShape
from repro_torch.core import costs
from repro_torch.data import synthetic as syn
from repro_torch.data.synthetic import Spec
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import batch_axes
from repro_torch.layers import moe as moe_lib
from repro_torch.models import lm, recsys
from repro_torch.train import optim
from repro_torch.train.microbatch import accumulated_grads, value_and_grad

_NEXT = "ROADMAP.md queue 1 item 2"


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                        # train | serve | retrieval
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
        same values on every rank go in; each rank keeps its shards; None
        stays None).  A tensor a one-rank mesh keeps whole may share its
        storage with the DTensor made of it: pass a copy when the original
        must stay."""
        return tuple(None if tree is None else
                     _walk(lambda _, t, pl: distribute_tensor(t, self.mesh, list(pl)), tree, sh)
                     for tree, sh in zip(trees, self.in_shardings))


class SkippedCell(Exception):
    pass


class NotBuilt(NotImplementedError):
    """A cell the port does not build yet (the LM prefill and decode cells,
    the GNN cells): ``launch/dryrun.py`` counts these apart from skipped and
    failed cells."""


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
    sums that local gradients were declared as are added up here."""
    return _walk(lambda _, g, p: g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g, grads, params)


def _replicated(x):
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


def _train_step(loss_fn, opt: optim.Optimizer, n_micro: int = 1):
    """``train_step(params, opt_state, batch) → (params, opt_state, loss)``:
    gradients (accumulated over ``n_micro`` microbatches), reduced to the
    parameters' placements, then the optimiser's in-place update; the loss
    replicated.  Constants the model makes meet DTensors as replicated."""
    def train_step(params, opt_state, batch):
        with implicit_replication():
            if n_micro > 1:
                loss, grads = accumulated_grads(loss_fn, params, batch, n_micro)
            else:
                loss, grads = value_and_grad(loss_fn, params, batch)
            new_p, new_o = opt.update(_settle(grads, params), opt_state, params)
        return new_p, new_o, _replicated(loss)
    return train_step


def _serving(fn):
    def step(params, batch):
        with implicit_replication():
            return fn(params, batch)
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
    if shape.kind != "train":
        raise NotBuilt(
            f"{arch}×{shape.name}: the LM {shape.kind} cells are not built yet ({_NEXT}): "
            "a KV cache whose heads do not divide the model axis is split over time, "
            "and K4 returns no log-sum-exp to merge the ranks' softmaxes")
    baxes = batch_axes(mesh)
    params_meta = lm.init(torch.Generator(), cfg, device="meta")
    p_specs = _spec_tree(params_meta, shd.lm_param_pspecs(
        params_meta, fsdp=fsdp, model_axis_size=_axis_size(mesh, "model")))
    # MoE layers dispatch locally on each batch shard, experts split over
    # ``model`` (expert parallelism): a global sort over DTensors would move
    # every token
    moe_fn = moe_lib.make_sharded_moe(mesh, top_k=cfg.top_k) if cfg.is_moe else None

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


# ---------------------------------------------------------------- public


def build_cell(arch: str, shape_name: str, mesh: DeviceMesh, *, smoke: bool = False,
               fsdp: bool = False, layers_override: int | None = None,
               n_micro: int | None = None) -> Cell:
    """The cell of ``arch`` at ``shape_name`` on ``mesh`` (axes ``data`` and
    ``model``, ``launch/mesh.py``).  Raises ``SkippedCell`` where the
    reference skips (``long_500k``), ``NotBuilt`` (a ``NotImplementedError``)
    for the LM prefill/decode and GNN cells (see the module's docstring).
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
        raise NotBuilt(
            f"{arch}×{shape_name}: the GNN cells are not built yet ({_NEXT}): their sums "
            "over edges split across ranks need a fixed-order design of their own")
    raise ValueError(spec.family)


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch × shape) pairs, in registry order."""
    return [(arch, shape_name) for arch in ASSIGNED_ARCHS
            for shape_name in shapes_for_family(get(arch).family)]
