"""Where a train step's gradients lie (``train/microbatch.py``,
``launch/steps.py::_settle``), on the CPU: each ``train_4k`` smoke cell at
one layer and 16 sequences of 4,096 tokens is stepped on fake tensors (as
the dry run counts it) on the (2, 4) ``(data, model)`` mesh of
``tests/test_torch_dryrun_lm.py``'s fake world of 8 ranks, at 1 and 8
microbatches, with ``remat`` off and on, and what ``value_and_grad`` or
``accumulated_grads`` hands to ``_settle`` is recorded.  Every DTensor
weight gradient must lie at its parameter's split over ``model``, at the
parameter's local shape: the local bytes of the gradients are those of
the parameters.  The recommendation and GCN train cells, whose tables'
gradients ``kernels/ops.py`` places, and the MoE expert stacks
(``make_sharded_moe``) keep the placements autograd gives them without
the rule.  The cross-entropy's placements (``models/lm.py::_chunk_nll``) are
counted here too."""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from torch_reference_cells import built_cells
from test_torch_dryrun_lm import LM_CELLS, mesh8  # noqa: F401  (a fixture)
from repro_torch import flags
from repro_torch.configs import LMShape, registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, steps
from repro_torch.models import lm
from repro_torch.roofline import analysis as roofline
from repro_torch.train import microbatch
from repro_torch.utils import leaves_with_paths, tree_map

OTHER_TRAIN_CELLS = [(a, s) for a, s in built_cells()
                     if s == "train_batch" or a == "gcn-cora"]
# train_4k's 4,096 tokens a sequence (flash_sdpa's chunks, two cross-entropy
# chunks) in 16 sequences: one a rank a microbatch at eight on (2, 4)
SMALL_TRAIN = LMShape("train_4k", 4096, 16, "train")
EXPERT_STACKS = ("['moe']['wg']", "['moe']['wu']", "['moe']['wd']")


def _unhooked_grads(loss_fn, params, batch):
    """The gradients autograd gives without ``value_and_grad``'s rule."""
    aliases = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(aliases, batch)
    paths, xs = zip(*leaves_with_paths(aliases))
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    return {k: g for k, g in zip(paths, gs)}


def _stepped(monkeypatch, cell, *, unhooked: bool = False) -> list[dict]:
    """Run ``cell``'s step once on fake arguments; for each call of the
    gradient function: {"params", "grads"} as {path: tensor}, and with
    ``unhooked`` the gradients without the rule ("raw")."""
    calls = []

    def record(fn):
        def wrapped(loss_fn, params, batch, *rest):
            loss, grads = fn(loss_fn, params, batch, *rest)
            call = {"params": dict(leaves_with_paths(params)),
                    "grads": dict(leaves_with_paths(grads))}
            if unhooked:
                call["raw"] = _unhooked_grads(loss_fn, params, batch)
            calls.append(call)
            return loss, grads
        return wrapped

    monkeypatch.setattr(steps, "value_and_grad", record(microbatch.value_and_grad))
    monkeypatch.setattr(steps, "accumulated_grads", record(microbatch.accumulated_grads))
    with flags.unrolled_scans():
        roofline.count(cell.fn, dryrun.fake_args(cell, FakeTensorMode()), memory=False)
    assert len(calls) == 1
    return calls


def _remat(monkeypatch, arch: str, on: bool) -> None:
    spec = registry.get(arch)
    monkeypatch.setitem(registry._REGISTRY, arch, dataclasses.replace(
        spec, smoke_config=dataclasses.replace(spec.smoke_config, remat=on)))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_micro", [1, 8])
@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_lm_weight_grads_lie_at_their_parameters_split(arch, shape, n_micro, remat, mesh8,
                                                       monkeypatch):
    _remat(monkeypatch, arch, remat)
    cell = steps._lm_cell(arch, SMALL_TRAIN, mesh8, smoke=True, layers_override=1,
                          n_micro=n_micro)
    (call,) = _stepped(monkeypatch, cell)
    model = mesh8.mesh_dim_names.index("model")
    split = 0
    for path, g in call["grads"].items():
        p = call["params"][path]
        assert isinstance(g, DTensor), path
        if p.placements[model].is_shard():
            assert g.placements[model] == p.placements[model], (path, g.placements)
            split += 1
        assert g.to_local().shape == p.to_local().shape, (path, g.to_local().shape)
        assert g.to_local().dtype == (torch.float32 if n_micro > 1 else p.dtype)
    assert split >= 8        # the embedding, the unembedding or tied, q k v o, the FFN or experts
    local_bytes = [sum(t.to_local().numel() * t.to_local().element_size() for t in tree.values())
                   for tree in (call["grads"], call["params"])]
    assert local_bytes[0] == local_bytes[1]


@pytest.mark.parametrize("arch,shape", OTHER_TRAIN_CELLS + [
    ("granite-moe-1b-a400m", "train_4k"), ("qwen3-moe-30b-a3b", "train_4k")])
def test_placed_grads_keep_their_placements(arch, shape, mesh8, monkeypatch):
    """The rule is a no-op where a gradient is already at its parameter's
    split: every recommendation and GCN train cell's gradients, and the MoE
    expert stacks', are those autograd gives without it."""
    cell = (steps._lm_cell(arch, SMALL_TRAIN, mesh8, smoke=True, layers_override=1)
            if shape == "train_4k" else steps.build_cell(arch, shape, mesh8, smoke=True))
    (call,) = _stepped(monkeypatch, cell, unhooked=True)
    checked = 0
    for path, g in call["grads"].items():
        if shape == "train_4k" and not path.endswith(EXPERT_STACKS):
            continue
        raw = call["raw"][path]
        if raw is None:
            continue
        assert isinstance(g, DTensor) and g.placements == raw.placements, (path, g.placements,
                                                                           raw.placements)
        assert g.to_local().shape == raw.to_local().shape, path
        checked += 1
    assert checked >= (3 if shape == "train_4k" else 1)


def test_grad_placements_rule():
    from torch.distributed.tensor import Partial, Replicate, Shard
    assert shd.grad_placements([Partial(), Partial()], [Replicate(), Shard(1)]) == \
        [Partial(), Shard(1)]
    assert shd.grad_placements([Partial(), Replicate()], [Shard(0), Shard(1)]) == \
        [Shard(0), Shard(1)]
    assert shd.grad_placements([Partial(), Partial()], [Replicate(), Replicate()]) == \
        [Partial(), Partial()]


class _Largest(TorchDispatchMode):
    """The most elements of any tensor a rank's local operation makes
    (DTensor operations are handed back, as ``StepCounter`` does, so that
    their local operations are seen)."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("tied", [True, False])
def test_cross_entropy_runs_on_each_ranks_rows_and_vocabulary(tied, mesh8):
    """``_chunk_nll`` on DTensors: no tensor a rank makes is larger than its
    own logits, its rows by its vocabulary shard; no collective moves
    logits; the hidden states' gradient keeps their rows' split, and the
    weight's comes out at the weight's split over ``model``, a partial sum
    over ``data``.  The weight is put at the vocabulary split whichever dim
    the rules split: an unembedding split by its hidden dim (granite's
    vocabulary of 49,155 on 16 ranks) is cut by vocabulary first, and
    DTensor adds its gradient up over ``data`` as it undoes the cut."""
    b, s, d, v = 16, 64, 32, 256
    cfg = lm.LMConfig("ce", 1, d, 4, 4, 64, v, tie_embeddings=tied)
    data, model = mesh8.shape
    local_logits = (b // data) * s * (v // model)
    rows = shd.to_placements(mesh8, ("data",))
    for w_spec in ((("model", None) if tied else (None, "model")),
                   ((None, "model") if tied else ("model", None))):
        fm = FakeTensorMode()
        with fm:
            x = torch.empty(b, s, d)
            labels = torch.zeros(b, s, dtype=torch.int32)
            w = torch.empty((v, d) if tied else (d, v))
            wd = distribute_tensor(w, mesh8, shd.to_placements(mesh8, w_spec), src_data_rank=None)
            wa = wd.detach().requires_grad_(True)
            xa = distribute_tensor(x, mesh8, rows, src_data_rank=None).requires_grad_(True)
            la = distribute_tensor(labels, mesh8, rows, src_data_rank=None)
        params = {"embed": wa} if tied else {"embed": None, "unembed": {"w": wa}}
        with roofline.counting(fm) as c, _Largest() as largest:
            loss = lm._chunk_nll(params, cfg, xa, la)
            gw, gx = torch.autograd.grad(loss, [wa, xa])
        assert largest.numel == local_logits, (w_spec, largest.numel)
        assert max(n for (_, n, _) in c.collectives) < local_logits * 4
        assert gx.to_local().shape == xa.to_local().shape and gx.placements[0] == rows[0]
        assert gw.to_local().shape == wd.to_local().shape, w_spec
        assert gw.placements[1] == wd.placements[1], w_spec
        if w_spec[0 if tied else 1] == "model":
            assert gw.placements[0].is_partial(), w_spec


def test_multi_pod_logits_are_each_ranks_rows_and_vocabulary(mesh8):
    """qwen2's smoke train_4k step (tied unembedding) on a (2, 2, 2)
    ``(pod, data, model)`` mesh of the same fake world: every tensor of the
    cross-entropy chunk's shape, (rows, 512, vocabulary), a rank makes holds
    its own rows (split over ``pod`` and ``data``) by its vocabulary shard.
    The rules left the rows split over ``pod`` alone before: a float32
    (128, 512, 151,936) copy, 37.09 GiB a rank, in the published cell's
    backward on the multi-pod mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    cfg = registry.get("qwen2-0.5b").smoke_config
    shape = LMShape("train_4k", 1024, 16, "train")
    cell = steps._lm_cell("qwen2-0.5b", shape, mesh, smoke=True, layers_override=1)
    seen = []

    class Chunks(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            seen.extend(tuple(t.shape) for t in pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor) and t.ndim == 3
                        and t.shape[1] == lm._LOSS_CHUNK and t.shape[2] not in (1, cfg.d_model))
            return out

    args = dryrun.fake_args(cell, FakeTensorMode())
    with flags.unrolled_scans(), roofline.counting(roofline.fake_mode_of(args)), Chunks():
        cell.fn(*args)
    assert seen and set(seen) == {(shape.global_batch // 4, lm._LOSS_CHUNK, cfg.vocab // 2)}
