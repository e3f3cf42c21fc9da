"""The ranks of tests/test_torch_distributed.py's and
tests/test_torch_cells.py's gloo worlds: each a process that
``torch.multiprocessing.spawn`` starts, importing torch and the port only
(no JAX), so that a world starts in seconds."""
import copy
import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import compat
from repro_torch.configs import LMShape, RecShape, get
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import pipeline as pipe
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.layers import moe
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gc
from repro_torch.train.microbatch import accumulated_grads
from repro_torch.utils import leaves_with_paths


def _init(rank: int, world: int, rdzv: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)


def cases_rank(rank: int, world: int, rdzv: str, in_path: str, out_dir: str) -> None:
    """The port's side of every case on one rank of a world of 4: results
    to ``out_dir/<rank>.npz``; then arange(64) as (8, 8), rows sharded over
    the 4 ranks, saved to ``out_dir/ckpt`` at step 3."""
    _init(rank, world, rdzv)
    try:
        with np.load(in_path) as f:
            inp = {k: torch.from_numpy(v) for k, v in f.items()}
        out = {}
        xs = inp["mm_x"].chunk(world)[rank]
        out["gathered"] = coll.ring_all_gather(xs).numpy()
        out["overlapped"] = coll.overlapped_all_gather_matmul(xs, inp["mm_w"]).numpy()
        out["reduce_scatter"] = coll.reduce_scatter_matmul(
            inp["rs_x"].chunk(world, dim=1)[rank].contiguous(),
            inp["rs_w"].chunk(world)[rank]).numpy()
        fwd = pipe.make_pipelined_fn(lambda w, h: torch.tanh(h @ w), num_microbatches=4)
        out["pipeline"] = fwd(inp["pipe_w"], inp["pipe_x"]).numpy()
        mean, res = gc.compressed_psum({"w": inp["psum_g"][rank]}, None,
                                       {"w": inp["psum_res"][rank]})
        out["psum_mean"], out["psum_new_res"] = mean["w"].numpy(), res["w"].numpy()

        mesh = mesh_lib.make_host_mesh(2, 2, device="cpu")
        experts = shd.to_placements(mesh, ("model", None, None))
        params = {"router": {"w": inp["moe_router"]},
                  **{k: distribute_tensor(inp[f"moe_{k}"], mesh, experts)
                     for k in ("wg", "wu", "wd")}}
        fn = moe.make_sharded_moe(mesh, top_k=int(inp["moe_top_k"]))
        y, aux = fn(params, inp["moe_x"].chunk(2)[mesh.get_local_rank("data")])
        out["moe_y"] = y.numpy()
        out["moe_aux"], out["moe_dropped"] = float(aux["aux_loss"]), float(aux["dropped_frac"])
        out["placements"] = np.array([str(shd.to_placements(mesh, s)) for s in
                                      [("model", None, None), (None, "data"), (),
                                       (("data", "model"), None)]])
        np.savez(os.path.join(out_dir, f"{rank}.npz"), **out)

        row_mesh = mesh_lib.make_host_mesh(1, world, device="cpu")
        w = distribute_tensor(torch.arange(64.0).reshape(8, 8), row_mesh,
                              shd.to_placements(row_mesh, ("model", None)))
        assert tuple(w.to_local().shape) == (8 // world, 8)
        ckpt.save(os.path.join(out_dir, "ckpt"), 3, {"w": w, "b": torch.full((3,), 3.0)})
    finally:
        dist.destroy_process_group()


def restore_rank(rank: int, world: int, rdzv: str, ckpt_dir: str, out_dir: str) -> None:
    """Restore the newest checkpoint onto a mesh of ``world`` ranks, rows
    sharded; write what this rank holds, then save it again at step +
    world."""
    _init(rank, world, rdzv)
    try:
        mesh = mesh_lib.make_host_mesh(1, world, device="cpu")
        target = {"w": torch.zeros(8, 8), "b": torch.zeros(3)}
        placements = {"['w']": shd.to_placements(mesh, ("model", None)),
                      "['b']": shd.to_placements(mesh, ())}
        got, step = ckpt.restore(ckpt_dir, target, mesh=mesh, placements=placements)
        np.savez(os.path.join(out_dir, f"restored_{world}_{rank}.npz"), step=step,
                 local=got["w"].to_local().numpy(), full=got["w"].full_tensor().numpy(),
                 b=got["b"].full_tensor().numpy())
        ckpt.save(ckpt_dir, step + world, got)
    finally:
        dist.destroy_process_group()


def _full(tree) -> dict:
    """{path: numpy array} of a tree of DTensors (collectives: every rank
    calls it)."""
    return {p: t.full_tensor().detach().numpy() for p, t in leaves_with_paths(tree)}


def cells_rank(rank: int, world: int, rdzv: str, in_path: str, out_dir: str) -> None:
    """Every case of tests/test_torch_cells.py's sharded cells on one rank:
    the cell built by ``_recsys_cell`` / ``_lm_cell`` on the case's mesh,
    its arguments placed from the same weights and batch on every rank,
    one call of its step.  Rank 0 writes what the step gave, whole, to
    ``out_dir/cells.pkl``: for a train cell the loss, the parameters and the
    optimiser state after the step; for the others the output."""
    _init(rank, world, rdzv)
    try:
        with open(in_path, "rb") as f:
            cases = pickle.load(f)
        out = {}
        for case in cases:
            arch = case["arch"]
            if "embed_dim" in case:                 # a row-sharded variant of a smoke config
                base = get(case["base"])
                cfg = dataclasses.replace(base.smoke_config, embed_dim=case["embed_dim"])
                register(ArchSpec(arch, base.family, cfg, cfg, base.source))
            mesh = mesh_lib.make_host_mesh(*case["mesh"], device="cpu")
            if case["family"] == "lm":
                cell = steps._lm_cell(arch, LMShape(*case["shape"]), mesh, smoke=True)
            else:
                cell = steps._recsys_cell(arch, RecShape(*case["shape"]), mesh, smoke=True)
            params = compat.from_jax_params(case["params"], device="cpu")
            batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
            res = {}
            if case.get("microbatches"):
                # the DTensor batch split on each rank (train/microbatch.py)
                cfg = get(arch).smoke_config
                with implicit_replication():
                    loss, grads = accumulated_grads(
                        lambda p, b: lm.loss_fn(p, cfg, b),
                        cell.place(copy.deepcopy(params))[0],
                        cell.place(params, None, batch)[2], case["microbatches"])
                res["micro_loss"] = float(loss.full_tensor())
                res["micro_grads"] = _full(grads)
                res["micro_placements"] = {p: str(t.placements)
                                           for p, t in leaves_with_paths(grads)}
            if cell.kind == "train":
                state = cell.init_state(params)
                new_p, new_o, loss = cell.fn(*cell.place(params, copy.deepcopy(state), batch))
                res.update(loss=float(loss.full_tensor()), params=_full(new_p), state=_full(new_o))
            else:
                res["out"] = cell.fn(*cell.place(params, batch)).full_tensor().numpy()
            res["placements"] = {p: str(t.placements) for p, t in
                                 leaves_with_paths(cell.place(params)[0])}
            out[case["name"]] = res
        if rank == 0:
            with open(os.path.join(out_dir, "cells.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _gnn_args(case: dict) -> tuple:
    """A GNN case's step arguments after the parameters and optimiser state,
    as tensors (the minibatch cell's edge indices a list)."""
    b = case["batch"]
    if case["shape"].kind == "minibatch":
        return (torch.from_numpy(b["x"]), [torch.from_numpy(e) for e in b["eis"]],
                torch.from_numpy(b["labels"]))
    return ({k: torch.from_numpy(v) for k, v in b.items()},)


def serving_cells_rank(rank: int, world: int, rdzv: str, in_path: str, out_dir: str) -> None:
    """tests/test_torch_cells_lm_gnn.py's cases on one rank of a world of 4.

    An LM case: its prefill cell on the prompt (logits, the caches whole,
    the caches' placements), then its decode cell from the case's
    ``start_caches`` (a one-device prefill into caches of ``slots`` slots),
    a step a token (logits, and the caches whole after the last step), run
    twice from the same caches.  A GNN
    case: one step of its cell (loss, parameters, optimiser state), twice
    from the same state.  Rank 0 writes ``out_dir/serving_cells.pkl``."""
    _init(rank, world, rdzv)
    try:
        with open(in_path, "rb") as f:
            cases = pickle.load(f)
        out = {}
        for case in cases:
            mesh = mesh_lib.make_host_mesh(*case["mesh"], device="cpu")
            if "variant" in case:                      # a smoke config changed in one field
                base = get(case["base"])
                cfg = dataclasses.replace(base.smoke_config, **case["variant"])
                register(ArchSpec(case["arch"], base.family, cfg, cfg, base.source))
            params = compat.from_jax_params(case["params"], device="cpu")
            res = {}
            if case["family"] == "lm":
                toks = torch.from_numpy(case["tokens"])
                b, s = toks.shape[0], case["prompt"]
                pre = steps._lm_cell(case["arch"], LMShape("prefill", s, b, "prefill"), mesh,
                                     smoke=True)
                logits, caches = pre.fn(*pre.place(params, toks[:, :s]))
                res["prefill_logits"] = logits.full_tensor().numpy()
                res["prefill_caches"] = _full(caches)
                res["prefill_placements"] = {p: str(t.placements)
                                             for p, t in leaves_with_paths(caches)}
                dec = steps._lm_cell(case["arch"], LMShape("decode", case["slots"], b, "decode"),
                                     mesh, smoke=True)
                start = [{k: torch.from_numpy(v) for k, v in c.items()}
                         for c in case["start_caches"]]
                runs = []
                for _ in range(2):
                    p_d, _, c_d = dec.place(params, None, copy.deepcopy(start))
                    steps_out = []
                    for t in range(s, toks.shape[1]):
                        logits, c_d = dec.fn(p_d, dec.place(None, toks[:, t])[1], c_d)
                        steps_out.append(logits.full_tensor().numpy())
                    runs.append({"logits": steps_out, "caches": _full(c_d)})
                res["decode"] = runs
                res["cache_placements"] = {p: str(t.placements)
                                           for p, t in leaves_with_paths(c_d)}
            else:
                cell = steps._gnn_cell(case["arch"], case["shape"], mesh, smoke=True)
                runs = []
                for _ in range(2):
                    p = copy.deepcopy(params)
                    new_p, new_o, loss = cell.fn(*cell.place(p, cell.init_state(p),
                                                             *_gnn_args(case)))
                    runs.append({"loss": float(loss.full_tensor()), "params": _full(new_p),
                                 "state": _full(new_o)})
                res["runs"] = runs
            out[case["name"]] = res
        if rank == 0:
            with open(os.path.join(out_dir, "serving_cells.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
