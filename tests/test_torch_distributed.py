"""The port's distributed runtime against the JAX package's on the CPU.

Sharding rules: the port's ``{path: spec}`` for every registered config's
smoke and published parameter shapes (torch ``meta`` tensors) equals the
reference's ``PartitionSpec`` tree over ``jax.eval_shape``, leaf by leaf;
so do the batch and KV-cache specs.  No process is started for these.

Collectives, GPipe, ``compressed_psum`` and the expert-parallel MoE: one
JAX subprocess with 4 host devices (``conftest.run_in_devices``) runs the
cases of tests/test_distributed.py and writes its inputs and outputs to an
``.npz``; one ``torch.multiprocessing`` spawn of 4 gloo ranks (a
``file://`` rendezvous, so files that xdist runs side by side never meet)
runs the port on the same inputs.  Float32; matrix products and the
pipeline within rtol 1e-5 / atol 1e-6 (sum orders differ), the ring
all-gather exact, ``compressed_psum``'s mean within rtol 1e-6 / atol 1e-7
(the int32 sum is exact, so only the dequantisation rounds) and its
residual within 2 float32 ulps of the largest gradient (it is the
difference of two nearly equal numbers), the MoE as tests/test_torch_moe.py
holds it.  Elastic restore: a checkpoint saved from
4 ranks restores onto 2 and then onto 1, and the JAX package reads it."""
import dataclasses
import re
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as ranks
from conftest import run_in_devices
from repro import configs as jax_configs
from repro.data import synthetic as jax_syn
from repro.distributed import sharding as jax_shd
from repro.layers import moe as jax_moe
from repro.models import gnn as jax_gnn
from repro.models import lm as jax_lm
from repro.models import recsys as jax_recsys
from repro.train import checkpoint as jax_ckpt
from repro_torch import configs
from repro_torch.data import synthetic as syn
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import gnn, lm, recsys
from repro_torch.train import checkpoint as ckpt

KEY = jax.random.PRNGKey(0)
MM_TOL = dict(rtol=1e-5, atol=1e-6)
PSUM_TOL = dict(rtol=1e-6, atol=1e-7)
MOE_TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4


# ------------------------------------------------------------ sharding rules


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(k): tuple(v) for k, v in flat}


def _params_both(arch: str, which: str):
    spec, jspec = configs.get(arch), jax_configs.get(arch)
    cfg, jcfg = getattr(spec, which), getattr(jspec, which)
    gen = torch.Generator()
    init, jinit = {"lm": (lm.init, jax_lm.init), "recsys": (recsys.init, jax_recsys.init),
                   "gnn": (gnn.init, jax_gnn.init)}[spec.family]
    return spec.family, cfg, jcfg, init(gen, cfg, device="meta"), \
        jax.eval_shape(lambda: jinit(KEY, jcfg))


@pytest.mark.parametrize("which", ["smoke_config", "config"])
@pytest.mark.parametrize("arch", sorted(configs.list_archs()))
def test_param_specs_equal_the_reference(arch, which):
    family, cfg, jcfg, params, jshapes = _params_both(arch, which)
    got = shd.param_pspecs(family, cfg, params)
    want = _jax_specs(jax_shd.param_pspecs(family, jcfg, jshapes))
    if getattr(jcfg, "scan_layers", False):
        # the reference stacks the layers on a leading L axis: its spec of
        # ['layers']... is the port's spec of each ['layers'][i]... after a
        # None for L (or () for a replicated leaf)
        for p, spec in got.items():
            stacked = re.sub(r"^\['layers'\]\[\d+\]", "['layers']", p)
            if stacked != p:
                assert want[stacked] == ((None,) + spec if spec else ()), p
            else:
                assert want[p] == spec, p
        unstacked = _jax_specs(jax_shd.param_pspecs(
            family, dataclasses.replace(jcfg, scan_layers=False),
            jax.eval_shape(lambda: jax_lm.init(KEY, dataclasses.replace(jcfg,
                                                                       scan_layers=False)))))
        assert got == unstacked
    else:
        assert got == want
    if family == "lm":
        fsdp = shd.lm_param_pspecs(params, fsdp=True)
        jfsdp = _jax_specs(jax_shd.lm_param_pspecs(
            jax.eval_shape(lambda: jax_lm.init(KEY, dataclasses.replace(jcfg, scan_layers=False))),
            scan_layers=False, fsdp=True))
        assert fsdp == jfsdp


def test_granite_vocab_moves_the_model_axis():
    """49,155 does not divide 16: the embedding's model axis moves to d."""
    params = lm.init(torch.Generator(), configs.get("granite-moe-1b-a400m").config,
                     device="meta")
    specs = shd.lm_param_pspecs(params)
    assert specs["['embed']"] == (None, "model")
    assert specs["['layers'][0]['moe']['wg']"] == ("model", None, None)
    assert specs["['layers'][0]['moe']['router']['w']"] == ()


@pytest.mark.parametrize("baxes", [("data",), ("pod", "data")])
def test_batch_and_cache_specs_equal_the_reference(baxes):
    rng = np.random.default_rng(0)
    for arch in ("dlrm-rmc2", "mind", "xdeepfm"):
        cfg, jcfg = configs.get(arch).smoke_config, jax_configs.get(arch).smoke_config
        for kw in ({}, {"n_candidates": 64}):
            b = 1 if kw else 8
            got = shd.recsys_batch_pspecs(syn.recsys_batch(rng, cfg, b, **kw), baxes)
            want = _jax_specs(jax_shd.recsys_batch_pspecs(
                jax_syn.recsys_batch(np.random.default_rng(0), jcfg, b, **kw), baxes))
            assert got == want, (arch, kw)
    lcfg = configs.get("qwen2-0.5b").smoke_config
    tok = syn.lm_batch(rng, lcfg, 4, 16)
    assert shd.lm_batch_pspecs(tok, baxes) == _jax_specs(jax_shd.lm_batch_pspecs(tok, baxes))
    for hkv, m in ((2, 16), (16, 16), (4, 0)):
        caches = [{"k": np.zeros((4, 32, hkv, 8)), "v": np.zeros((4, 32, hkv, 8)),
                   "pos": np.zeros(4, np.int32)} for _ in range(2)]
        assert (shd.lm_cache_pspecs(caches, baxes, model_axis_size=m)
                == _jax_specs(jax_shd.lm_cache_pspecs(caches, baxes, model_axis_size=m)))
    for g in (syn.random_graph(rng, 30, 90, 8, 3), syn.molecule_batch(rng, 4, 5, 6, 8, 3)):
        assert shd.gnn_batch_pspecs(g, baxes) == _jax_specs(jax_shd.gnn_batch_pspecs(g, baxes))


def test_mesh_constructors_need_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_host_mesh(device="cpu")
    assert mesh_lib.SINGLE_POD == (16, 16) and mesh_lib.MULTI_POD == (2, 16, 16)


# ------------------------------------------------ the cases, on both sides

JAX_CASES = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed import collectives as coll, pipeline as pipe
from repro.layers import moe
from repro.train import grad_compress as gc

AUTO = jax.sharding.AxisType.Auto
with np.load(IN) as f:
    inp = dict(f)
out = {}
mesh = jax.make_mesh((4,), ("model",), axis_types=(AUTO,))
# each case compiled whole (jit): op by op the shard_maps take seconds
f = jax.jit(jax.shard_map(lambda xs, w: coll.overlapped_all_gather_matmul(xs, w, "model"),
                          mesh=mesh, in_specs=(P("model"), P()), out_specs=P(), check_vma=False))
out["overlapped"] = np.asarray(f(inp["mm_x"], inp["mm_w"]))
g = jax.jit(jax.shard_map(lambda xs: coll.ring_all_gather(xs, "model"), mesh=mesh,
                          in_specs=(P("model"),), out_specs=P(), check_vma=False))
out["gathered"] = np.asarray(g(inp["mm_x"]))
h = jax.jit(jax.shard_map(lambda xs, ws: coll.reduce_scatter_matmul(xs, ws, "model"),
                          mesh=mesh, in_specs=(P(None, "model"), P("model", None)),
                          out_specs=P("model"), check_vma=False))
out["reduce_scatter"] = np.asarray(h(inp["rs_x"], inp["rs_w"]))

pmesh = jax.make_mesh((4,), ("pipe",), axis_types=(AUTO,))
fwd = jax.jit(pipe.make_pipelined_fn(lambda w, x: jnp.tanh(x @ w), pmesh, num_microbatches=4))
out["pipeline"] = np.asarray(fwd(inp["pipe_w"], inp["pipe_x"]))

cmesh = jax.make_mesh((4,), ("data",), axis_types=(AUTO,))
cm = jax.jit(jax.shard_map(
    lambda gs, rs: gc.compressed_psum({"w": gs[0]}, "data", {"w": rs[0]}), mesh=cmesh,
    in_specs=(P("data"), P("data")), out_specs=(P(), P("data")), check_vma=False))
mean, new_res = cm(inp["psum_g"], inp["psum_res"])
out["psum_mean"] = np.asarray(mean["w"])
out["psum_new_res"] = np.asarray(new_res["w"]).reshape(inp["psum_g"].shape)

mmesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AUTO, AUTO))
fn = moe.make_sharded_moe(mmesh, top_k=int(inp["moe_top_k"]), batch_axes=("data",))
params = {"router": {"w": inp["moe_router"]}, "wg": inp["moe_wg"], "wu": inp["moe_wu"],
          "wd": inp["moe_wd"]}
y, aux = jax.jit(fn)(params, jnp.asarray(inp["moe_x"]))
out.update({"moe_y": np.asarray(y), "moe_aux": np.asarray(aux["aux_loss"]),
            "moe_dropped": np.asarray(aux["dropped_frac"])})
np.savez(OUT, **out)
print("OK")
"""


def _inputs() -> dict:
    """The cases' inputs, numpy from one seed; the MoE weights initialised
    by the JAX package at granite-moe-1b-a400m's smoke widths."""
    rng = np.random.default_rng(0)
    cfg = jax_configs.get("granite-moe-1b-a400m").smoke_config
    params = jax_moe.init_moe(KEY, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k)
    f32 = np.float32
    return {"mm_x": rng.normal(size=(32, 6)).astype(f32),
            "mm_w": rng.normal(size=(6, 3)).astype(f32),
            "rs_x": rng.normal(size=(16, 12)).astype(f32),
            "rs_w": rng.normal(size=(12, 5)).astype(f32),
            "pipe_w": (rng.normal(size=(4, 6, 6)) * 0.3).astype(f32),
            "pipe_x": rng.normal(size=(16, 6)).astype(f32),
            "psum_g": rng.normal(size=(WORLD, 700)).astype(f32),
            "psum_res": (rng.normal(size=(WORLD, 700)) * 1e-3).astype(f32),
            "moe_x": rng.normal(size=(4, 8, cfg.d_model)).astype(f32),
            "moe_top_k": np.asarray(cfg.top_k),
            "moe_router": np.asarray(params["router"]["w"]),
            **{f"moe_{k}": np.asarray(params[k]) for k in ("wg", "wu", "wd")}}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(inputs, the reference's outputs, each port rank's outputs, the
    checkpoint directory the 4 port ranks saved step 3 to).  The JAX
    subprocess and the 4 gloo ranks run at the same time."""
    base = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(base / "in.npz", **inp)
    jax_done: dict = {}

    def run_jax():
        try:
            jax_done["stdout"] = run_in_devices(
                f"IN = {str(base / 'in.npz')!r}\nOUT = {str(base / 'jax.npz')!r}\n" + JAX_CASES,
                n_devices=WORLD)
        except BaseException as e:                  # re-raised in the test's thread
            jax_done["error"] = e

    thread = threading.Thread(target=run_jax)
    thread.start()
    try:
        mp.spawn(ranks.cases_rank, args=(WORLD, str(base / "rdzv"), str(base / "in.npz"),
                                         str(base)), nprocs=WORLD, join=True)
    finally:
        thread.join(timeout=600)
    if "error" in jax_done:
        raise jax_done["error"]
    assert "OK" in jax_done["stdout"]
    with np.load(base / "jax.npz") as f:
        ref = dict(f)
    port = []
    for r in range(WORLD):
        with np.load(base / f"{r}.npz") as f:
            port.append(dict(f))
    return inp, ref, port, str(base / "ckpt")


def test_ring_all_gather_matches_jax(cases):
    inp, reference, port, _ = cases
    for out in port:
        np.testing.assert_array_equal(out["gathered"], reference["gathered"])
        np.testing.assert_array_equal(out["gathered"], inp["mm_x"])


def test_overlapped_all_gather_matmul_matches_jax(cases):
    inp, reference, port, _ = cases
    for out in port:
        np.testing.assert_allclose(out["overlapped"], reference["overlapped"], **MM_TOL)
        np.testing.assert_allclose(out["overlapped"], inp["mm_x"] @ inp["mm_w"],
                                   **MM_TOL)


def test_reduce_scatter_matmul_matches_jax(cases):
    inp, reference, port, _ = cases
    got = np.concatenate([out["reduce_scatter"] for out in port])
    np.testing.assert_allclose(got, reference["reduce_scatter"], **MM_TOL)
    np.testing.assert_allclose(got, inp["rs_x"] @ inp["rs_w"], **MM_TOL)


def test_gpipe_four_stages_match_jax(cases):
    inp, reference, port, _ = cases
    want = inp["pipe_x"]
    for i in range(4):
        want = np.tanh(want @ inp["pipe_w"][i])
    for out in port:
        np.testing.assert_allclose(out["pipeline"], reference["pipeline"], **MM_TOL)
        np.testing.assert_allclose(out["pipeline"], want, **MM_TOL)


def test_compressed_psum_matches_jax(cases):
    inp, reference, port, _ = cases
    g = inp["psum_g"] + inp["psum_res"]
    scale = np.abs(g).reshape(4, -1).max(axis=0).max() / 127
    for r, out in enumerate(port):
        np.testing.assert_allclose(out["psum_mean"], reference["psum_mean"], **PSUM_TOL)
        # the residual is tgt − dequantised tgt, a difference of nearly equal
        # numbers: it carries their rounding, 2 float32 ulps of the largest
        np.testing.assert_allclose(out["psum_new_res"], reference["psum_new_res"][r],
                                   rtol=0, atol=2 * np.spacing(np.abs(g).max()))
        assert np.abs(out["psum_mean"] - g.mean(0)).max() <= scale + 1e-6


def test_sharded_moe_on_a_data_model_mesh_matches_jax(cases):
    _, reference, port, _ = cases
    # rank = data · 2 + model: the data index picks the batch shard
    for r, out in enumerate(port):
        np.testing.assert_allclose(out["moe_y"], reference["moe_y"][(r // 2) * 2:(r // 2 + 1) * 2],
                                   **MOE_TOL)
        np.testing.assert_allclose(out["moe_aux"], reference["moe_aux"], rtol=1e-6, atol=0)
        np.testing.assert_allclose(out["moe_dropped"], reference["moe_dropped"], rtol=0,
                                   atol=1e-7)
    assert float(reference["moe_dropped"]) > 0             # the capacity is reached


def test_to_placements_on_a_data_model_mesh(cases):
    port = cases[2]
    assert list(port[0]["placements"]) == [
        "[Replicate(), Shard(dim=0)]", "[Shard(dim=1), Replicate()]",
        "[Replicate(), Replicate()]", "[Shard(dim=0), Shard(dim=0)]"]


# -------------------------------------------------------- elastic restore


def test_elastic_restore_four_to_two_to_one(cases, tmp_path):
    """The 4 ranks saved arange(64) as (8, 8), rows sharded over 4, at step
    3; 2 ranks restore it sharded over 2 and save it at step 5; 1 rank
    restores that and saves it at step 6."""
    ck = cases[3]
    assert ckpt.all_steps(ck) == [3]
    mp.spawn(ranks.restore_rank, args=(2, str(tmp_path / "r2"), ck, str(tmp_path)), nprocs=2,
             join=True)
    assert ckpt.all_steps(ck) == [3, 5]
    mp.spawn(ranks.restore_rank, args=(1, str(tmp_path / "r1"), ck, str(tmp_path)), nprocs=1,
             join=True)
    assert ckpt.all_steps(ck) == [3, 5, 6]
    want = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for world, step in ((2, 3), (1, 5)):
        for rank in range(world):
            with np.load(tmp_path / f"restored_{world}_{rank}.npz") as f:
                assert int(f["step"]) == step
                np.testing.assert_array_equal(f["full"], want)
                np.testing.assert_array_equal(f["local"], want.reshape(world, -1, 8)[rank])
                np.testing.assert_array_equal(f["b"], np.full(3, 3.0, np.float32))
    # the format is the reference's: the JAX package reads what 4, 2 and 1
    # ranks wrote
    for step in (3, 5, 6):
        restored, got_step = jax_ckpt.restore(ck, {"w": np.zeros((8, 8), np.float32),
                                                   "b": np.zeros(3, np.float32)}, step=step)
        assert got_step == step
        np.testing.assert_array_equal(np.asarray(restored["w"]), want)
