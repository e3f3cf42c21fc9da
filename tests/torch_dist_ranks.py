"""The ranks of tests/test_torch_distributed.py's gloo worlds: each a
process that ``torch.multiprocessing.spawn`` starts, importing torch and
the port only (no JAX), so that a world starts in seconds."""
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import pipeline as pipe
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.layers import moe
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gc


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
