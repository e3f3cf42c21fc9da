"""The port's accounting (``roofline/analysis.py``, ``flags.py``,
``launch/roofline_sweep.py``, the kernels' accounting entries) on the CPU.

* ``Roofline`` gives the reference's ``to_dict()`` for the same fields and
  peaks; the ring costs of recorded collectives equal the reference's
  ``collective_bytes`` on HLO text of the same (kind, dtype, shape, group)
  list, its own test's three lines included;
* a DTensor product is counted at a rank's shapes: (2048, 4096) @ (4096,
  4096) on a 16 × 16 fake world, x split by rows over ``data`` and w by
  columns over ``model``, is 2·128·4096·256 = 268,435,456 FLOPs a rank
  (``FlopCounterMode`` reports the global 68.7e9);
* each kernel wrapper on fake tensors returns the kernel's output shape and
  records its module's ``work()``, with no launch and no build;
* eager loops are counted whole: a two-chunk ``bulk_forward`` counts twice
  one chunk's work, and an LM's count at L = 1 and 2 extrapolates exactly
  to a direct count at L = 3 (the sweep's terms), at L = 2 and 3 to one at
  L = 4 (the dry run's terms and memory);
* ``flags`` keeps the reference's names for what the port reads,
  ``unrolled_scans()`` restores the flag, and under it ``flash_sdpa`` walks
  the accounting chunks, with the same FLOPs and values."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro import flags as jax_flags
from repro.roofline import analysis as jax_analysis
from repro_torch import configs, flags
from repro_torch.configs import registry
from repro_torch.data import synthetic as syn
from repro_torch.kernels import _build, ops
from repro_torch.kernels import cin as cin_kernel
from repro_torch.kernels import decode_attention as da_kernel
from repro_torch.kernels import embedding_bag as eb_kernel
from repro_torch.kernels import interaction as ix_kernel
from repro_torch.layers import attention
from repro_torch.launch import dryrun, roofline_sweep, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import recsys
from repro_torch.roofline import analysis

# --------------------------------------------------------------- Roofline

REF_KEYS = ("flops", "bytes_accessed", "collective_bytes", "chips", "model_flops",
            "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
            "useful_flops_ratio", "roofline_fraction")


@pytest.mark.parametrize("fields", [
    dict(flops=3.2e12, bytes_accessed=4.1e10, coll={"all-gather": 10 ** 9, "all-reduce": 0},
         chips=256, model_flops=6.0e14),
    dict(flops=0.0, bytes_accessed=8.0e9, coll={"all-reduce": 0}, chips=1, model_flops=0.0),
    dict(flops=0.0, bytes_accessed=0.0, coll={"reduce-scatter": 0}, chips=8, model_flops=1e9),
    dict(flops=1e15, bytes_accessed=1.0, coll={"all-to-all": 5 * 10 ** 11}, chips=512,
         model_flops=2e17),
])
@pytest.mark.parametrize("peaks", [None, (197e12, 819e9, 50e9),
                                   (analysis.BF16_FLOPS, analysis.HBM_BW, analysis.NVLINK_BW)])
def test_roofline_equals_the_reference(fields, peaks):
    kw = {} if peaks is None else dict(peak_flops=peaks[0], hbm_bw=peaks[1], ici_bw=peaks[2])
    if peaks is None:       # the reference's defaults are the TPU's: give the port's
        kw_ref = dict(peak_flops=analysis.PEAK_FLOPS, hbm_bw=analysis.HBM_BW,
                      ici_bw=analysis.ICI_BW)
    else:
        kw_ref = kw
    args = (fields["flops"], fields["bytes_accessed"], fields["coll"], fields["chips"],
            fields["model_flops"])
    got = analysis.Roofline(*args, **kw).to_dict()
    want = jax_analysis.Roofline(*args, **kw_ref).to_dict()
    assert {k: got[k] for k in REF_KEYS} == want


def test_roofline_sums_each_unit_over_its_own_peak():
    r = analysis.Roofline(flops=3e12, bytes_accessed=0.0, coll_bytes={}, chips=1,
                          model_flops=0.0, flops_by_unit={"fp32": 1e12, "tf32": 2e12})
    assert r.t_compute == pytest.approx(1e12 / 67e12 + 2e12 / 494.7e12)
    assert r.to_dict()["flops_by_unit"] == {"fp32": 1e12, "tf32": 2e12}
    # a group that spans nodes moves its bytes over the network
    r = analysis.Roofline(flops=0.0, bytes_accessed=0.0, coll_bytes={"all-reduce": 10 ** 9},
                          chips=16, model_flops=0.0, network_bytes=4 * 10 ** 8)
    assert r.t_collective == pytest.approx(6e8 / 450e9 + 4e8 / 50e9)


COLLECTIVE_LISTS = [
    # the reference's own three lines (tests/test_system.py)
    [("all-reduce", "f32", (1024, 256), 8), ("all-gather", "bf16", (512, 128), 4),
     ("collective-permute", "f32", (64,), 2)],
    [("reduce-scatter", "f32", (128, 4096), 16), ("all-to-all", "bf16", (8, 512, 1024), 16),
     ("all-gather", "f32", (3, 5, 7), 3)],
    [("all-reduce", "s32", (), 256), ("all-reduce", "bf16", (2, 3), 1),
     ("all-gather", "f32", (16,), 16), ("reduce-scatter", "bf16", (9, 9), 2)],
]
_DTYPE_BYTES = {"f32": 4, "bf16": 2, "s32": 4}


def _hlo(records) -> str:
    lines = []
    for i, (kind, dt, shape, s) in enumerate(records):
        dims = ",".join(map(str, shape))
        groups = "" if kind == "collective-permute" else f", replica_groups=[{512 // s},{s}]<=[512]"
        lines.append(f"  %c{i} = {dt}[{dims}]{{0}} {kind}(%x{i}){groups}")
    return "\n".join(lines)


@pytest.mark.parametrize("records", COLLECTIVE_LISTS)
def test_ring_costs_equal_the_reference(records):
    want = jax_analysis.collective_bytes(_hlo(records))
    got = analysis.collective_bytes(
        [(kind, int(np.prod(shape, dtype=np.int64)) * _DTYPE_BYTES[dt], s)
         for kind, dt, shape, s in records])
    assert got == want


# ------------------------------------------------------------- per rank


def test_a_dtensor_product_is_counted_at_a_ranks_shapes():
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(2048, 4096), mesh, [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(4096, 4096), mesh, [Replicate(), Shard(1)])
        rf = analysis.from_step(lambda a, b: a @ b, (x, w), 256, 2 * 2048 * 4096 * 4096)
        assert rf.flops == 2 * 128 * 4096 * 256 == 268_435_456
        assert rf.flops_by_unit == {"fp32": 268_435_456}
        assert rf.model_flops_per_chip == rf.flops           # no waste, no shadow count
        # the trap: a flop counter on DTensors counts the global product
        with x.to_local().fake_mode, FlopCounterMode(display=False) as fc:
            x @ w
        assert fc.get_total_flops() == 2 * 2048 * 4096 * 4096 == 68_719_476_736
        # a redistribution is a collective of a rank's bytes over its group
        _, c = analysis.count(lambda a: a.redistribute(mesh, [Replicate(), Replicate()]), (x,))
        assert c.collectives == [("all-gather", 2048 * 4096 * 4, tuple(range(0, 256, 16)))]


@pytest.mark.parametrize("arch,shape", [("dlrm-rmc2", "train_batch"),
                                        ("xdeepfm", "serve_p99"), ("autoint", "serve_bulk")])
def test_one_ranks_count_is_the_plain_steps_and_the_flop_counters(arch, shape):
    """On a (1, 1) mesh a rank holds everything: the step on DTensors counts
    what the same step on plain tensors counts, and its FLOPs outside the
    kernels are ``FlopCounterMode``'s (which cannot see a kernel's work)."""
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        cell = steps.build_cell(arch, shape, mesh, smoke=True)
        mode = torch.enable_grad() if cell.kind == "train" else torch.inference_mode()
        with mode:
            _, sharded = analysis.count(cell.fn, dryrun.fake_args(cell, FakeTensorMode()))
            fm = FakeTensorMode()
            with fm:
                plain = tuple(steps._walk(lambda _, s: torch.empty(s.shape, dtype=s.dtype), t)
                              for t in cell.args)
            _, c = analysis.count(cell.fn, plain)
            with fm, FlopCounterMode(display=False) as fc:
                cell.fn(*plain)
    assert (sharded.flops_by_unit, sharded.bytes) == (c.flops_by_unit, c.bytes)
    kernel_flops = sum(sum(k["flops_by_unit"].values()) for k in c.kernels.values())
    assert sum(c.flops_by_unit.values()) - kernel_flops == fc.get_total_flops() > 0
    assert c.kernels                                  # K1 at least


# ----------------------------------------------------- kernels, accounted


def _fake(*shapes_dtypes):
    with FakeTensorMode():
        return [torch.empty(s, dtype=d) for s, d in shapes_dtypes]


F32, I32 = torch.float32, torch.int32
KERNEL_CASES = {
    "embedding_bag": (lambda t, i: ops.embedding_bag(t, i), [((3, 50, 8), F32), ((6, 3, 4), I32)],
                      (6, 3, 8), lambda: eb_kernel.work(6, 3, 4, 8, 4)),
    "embedding_bag_backward": (lambda g, i: ops.embedding_bag_backward(g, i, 50),
                               [((6, 3, 8), F32), ((6, 3, 4), I32)], (3, 50, 8),
                               lambda: eb_kernel.backward_work(6, 3, 4, 8, 4)),
    "dot_interaction": (ops.dot_interaction, [((5, 7, 16), torch.bfloat16)], (5, 21),
                        lambda: ix_kernel.work(5, 7, 16, 2)),
    "dot_interaction_backward": (ops.dot_interaction_backward,
                                 [((5, 21), F32), ((5, 7, 16), F32)], (5, 7, 16),
                                 lambda: ix_kernel.backward_work(5, 7, 16, 4)),
    "cin_layer": (ops.cin_layer, [((4, 6, 10), F32), ((4, 5, 10), F32), ((30, 9), F32)],
                  (4, 9, 10), lambda: cin_kernel.work(4, 6, 5, 9, 10, 4)),
    "decode_attention": (ops.decode_attention,
                         [((2, 14, 64), F32), ((2, 32, 2, 64), F32), ((2, 32, 2, 64), F32),
                          ((2,), I32)], (2, 14, 64), lambda: da_kernel.work(2, 14, 2, 64, 32, 4)),
}


@pytest.fixture
def no_build(monkeypatch):
    def refuse():
        raise AssertionError("a fake tensor built or loaded the kernels")
    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_a_wrapper_on_fake_tensors_records_its_kernels_work(name, no_build):
    fn, inputs, out_shape, work = KERNEL_CASES[name]
    args = _fake(*inputs)
    ops.reset_launch_counts()
    _, c = analysis.count(fn, tuple(args))
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    flops, nbytes = work()
    assert list(c.kernels) == [name]
    k = c.kernels[name]
    assert (k["calls"], dict(k["flops_by_unit"]), k["bytes"]) == (1, flops, nbytes)
    out = fn(*args)
    assert tuple(out.shape) == out_shape
    # the kernel's work is in the step's totals
    assert c.bytes >= nbytes and all(c.flops_by_unit[u] >= f for u, f in flops.items())


def test_autograd_on_fake_tensors_counts_both_kernels(no_build):
    table, idx = _fake(((3, 50, 8), F32), ((6, 3, 4), I32))
    table.requires_grad_()

    def loss(t, i):
        feats = ops.embedding_bag(t, i)
        return ops.dot_interaction(feats).sum().backward()

    _, c = analysis.count(loss, (table, idx))
    assert {k: v["calls"] for k, v in c.kernels.items()} == {
        "embedding_bag": 1, "dot_interaction": 1, "dot_interaction_backward": 1,
        "embedding_bag_backward": 1}
    assert c.kernels["dot_interaction_backward"]["bytes"] == ix_kernel.backward_work(6, 3, 8, 4)[1]


def test_a_cin_layer_that_needs_a_gradient_counts_k3_and_k3_bwd(no_build):
    """A gradient step through K3 on fake tensors counts one K3 and one
    K3-bwd at their ``work()``: no plain version's operations stand in for
    either."""
    x0, xk, w = _fake(((4, 6, 10), F32), ((4, 5, 10), F32), ((30, 9), F32))
    w.requires_grad_()
    _, c = analysis.count(lambda a, b, m: ops.cin_layer(a, b, m).sum().backward(), (x0, xk, w))
    assert {k: v["calls"] for k, v in c.kernels.items()} == {"cin_layer": 1,
                                                              "cin_layer_backward": 1}
    for name, work in (("cin_layer", cin_kernel.work(4, 6, 5, 9, 10, 4)),
                       ("cin_layer_backward", cin_kernel.backward_work(4, 6, 5, 9, 10, 4))):
        assert (c.kernels[name]["flops_by_unit"], c.kernels[name]["bytes"]) == work


# -------------------------------------------------------- eager loops


def test_two_chunk_bulk_forward_counts_twice_one_chunk():
    cfg = configs.get("dlrm-rmc2").smoke_config
    fm = FakeTensorMode()
    with fm, torch.inference_mode():
        params = recsys.init(torch.Generator(), cfg, device="cpu")
        batches = {n: {k: torch.empty(s.shape, dtype=s.dtype) for k, s in
                       syn.recsys_specs(cfg, n, with_label=False).items()} for n in (8, 16)}
    one, c1 = analysis.count(lambda p, b: recsys.bulk_forward(p, cfg, b, chunk=8),
                             (params, batches[8]))
    two, c2 = analysis.count(lambda p, b: recsys.bulk_forward(p, cfg, b, chunk=8),
                             (params, batches[16]))
    assert c2.flops_by_unit == {u: 2 * f for u, f in c1.flops_by_unit.items()}
    assert {k: v["calls"] for k, v in c2.kernels.items()} == \
        {k: 2 * v["calls"] for k, v in c1.kernels.items()}
    assert {k: v["bytes"] for k, v in c2.kernels.items()} == \
        {k: 2 * v["bytes"] for k, v in c1.kernels.items()}
    # and the concatenation of the two chunks' scores: read both, write one
    assert c2.bytes == 2 * c1.bytes + 2 * two.numel() * two.element_size()


def test_an_in_place_scatter_counts_the_rows_it_writes():
    """A decode step's K/V write (``write_kv``: ``index_put_`` of B rows
    into a cache) counts the rows read and written, the values and the
    indices, not the whole cache; an out-of-place ``index_put`` writes a
    whole new tensor and counts it."""
    b, t, h, d = 4, 4096, 2, 64
    fm = FakeTensorMode()
    with fm:
        cache = {"k": torch.empty((b, t, h, d)), "v": torch.empty((b, t, h, d)),
                 "pos": torch.empty((b,), dtype=torch.int32)}
        new = torch.empty((b, h, d))
    _, c = analysis.count(lambda c_, n_: attention.write_kv(c_, n_, n_), (cache, new))
    row = b * h * d * 4
    assert c.op_bytes["aten.index_put_"] == 2 * (3 * row + 2 * b * 8)
    assert c.bytes < 20 * row
    _, c = analysis.count(lambda x, n_: x.index_put((torch.arange(b),), n_[:, 0, 0]),
                          (cache["k"][:, :, 0, 0], new))
    assert c.op_bytes["aten.index_put"] >= 2 * b * t * 4


def _lm_extrapolation(first: int, n: int) -> tuple[dict, dict]:
    """``dryrun.count_lm_layers`` from L = ``first``, ``first`` + 1 to ``n``
    layers, and a direct count at ``n``, of phi3's smoke ``train_4k`` cell
    on a (2, 4) fake mesh."""
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        arch = "phi3-mini-3.8b"
        got = dryrun.count_lm_layers(arch, "train_4k", mesh, smoke=True, n_layers=n,
                                     first=first)
        want = dryrun.count_cell(steps.build_cell(arch, "train_4k", mesh, smoke=True,
                                                  layers_override=n))
    r, w = got["roofline"].to_dict(), want["roofline"].to_dict()
    for k in ("flops", "bytes_accessed", "collective_bytes", "flops_by_unit",
              "network_collective_bytes", "model_flops"):
        assert r[k] == w[k], k
    assert r["flops"] > 0 and sum(r["collective_bytes"].values()) > 0
    assert got["note"] == f"L-extrapolated from L={first},{first + 1} (full L={n})"
    assert got["cell"].n_micro == 1
    return got, want


def test_lm_counts_at_one_and_two_layers_extrapolate_to_three():
    """Eager counting sees every layer, so the sweep's L = 1, 2
    extrapolation (``dryrun.count_lm_layers``) equals a direct count at
    L = 3 in every roofline term."""
    _lm_extrapolation(1, 3)


def test_dry_run_counts_at_two_and_three_layers_extrapolate_to_four():
    """The dry run's L = 2, 3 extrapolation equals a direct count at L = 4
    in every roofline term and every memory key.  From L = 1 the peak is
    not linear at this size: with the accounting flash chunks it grows by
    1.36 GB from L = 1 to 2 and by 0.61 GB a layer after."""
    got, want = _lm_extrapolation(2, 4)
    assert got["memory"] == want["memory"]


def test_dry_run_extrapolation_to_four_holds_with_remat(monkeypatch):
    """The same with ``remat``: each layer checkpointed, the peak grows by
    its input alone (0.25 MB a layer at this size), and L = 2, 3 still give
    L = 4 exactly."""
    spec = registry.get("phi3-mini-3.8b")
    monkeypatch.setitem(registry._REGISTRY, spec.arch_id, dataclasses.replace(
        spec, smoke_config=dataclasses.replace(spec.smoke_config, remat=True)))
    got, want = _lm_extrapolation(2, 4)
    assert got["memory"] == want["memory"]


def test_the_sweep_counts_a_recommendation_cell_directly():
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        rec = roofline_sweep.account_cell("xdeepfm", "serve_p99", mesh, smoke=True)
        want = dryrun.count_cell(steps.build_cell("xdeepfm", "serve_p99", mesh, smoke=True),
                                 memory=False)["roofline"].to_dict()
    assert rec["roofline"] == want and rec["chips"] == 8
    assert rec["roofline"]["flops_by_unit"]["tf32"] > 0              # K3 on the tensor cores


# ----------------------------------------------------------------- flags


def test_flags_keep_the_reference_names():
    for name in ("SCAN_UNROLL", "ACCOUNTING_FLASH_CHUNKS", "flash_chunks", "unrolled_scans"):
        assert hasattr(flags, name) and hasattr(jax_flags, name), name
    assert (flags.SCAN_UNROLL, flags.ACCOUNTING_FLASH_CHUNKS) == \
        (jax_flags.SCAN_UNROLL, jax_flags.ACCOUNTING_FLASH_CHUNKS)
    assert flags.flash_chunks(256, 512) == (256, 512)


def test_unrolled_scans_restores_the_flag():
    with flags.unrolled_scans():
        assert flags.SCAN_UNROLL is True
        assert flags.flash_chunks(256, 512) == flags.ACCOUNTING_FLASH_CHUNKS
        with flags.unrolled_scans():
            pass
        assert flags.SCAN_UNROLL is True
    assert flags.SCAN_UNROLL is False
    with pytest.raises(RuntimeError):
        with flags.unrolled_scans():
            raise RuntimeError("inside")
    assert flags.SCAN_UNROLL is False


def test_flash_sdpa_takes_the_accounting_chunks_while_counting():
    """Under ``unrolled_scans()`` (what ``dryrun.count_cell`` enters)
    ``flash_sdpa`` walks the accounting chunks: at S = T = 4,096 two chunk
    pairs in place of 128, the same FLOPs, and the same values."""
    fm = FakeTensorMode()
    with fm:
        q, k, v = (torch.empty(1, 4096, h, 8, dtype=torch.bfloat16) for h in (2, 1, 1))
    counts = {}
    for name, mode in (("default", contextlib.nullcontext()), ("accounting", flags.unrolled_scans())):
        with mode:
            _, counts[name] = analysis.count(
                lambda q_, k_, v_: attention.flash_sdpa(q_, k_, v_, causal=True), (q, k, v))
    assert counts["default"].ops["aten.bmm"] == 2 * 128
    assert counts["accounting"].ops["aten.bmm"] == 2 * 2
    assert counts["accounting"].flops_by_unit == counts["default"].flops_by_unit
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4096, h, 8), dtype=np.float32))
               for h in (2, 1, 1))
    with flags.unrolled_scans():
        wide = attention.flash_sdpa(q, k, v, causal=True)
    torch.testing.assert_close(wide, attention.flash_sdpa(q, k, v, causal=True),
                               rtol=1e-5, atol=1e-5)


def test_eight_microbatches_count_on_the_production_mesh():
    """yi-34b's smoke ``train_4k`` at two layers and eight microbatches on
    the (16, 16) mesh of a fake world of 256 ranks: two rows a rank a
    microbatch, fewer than the model axis, which sent the FFN's
    activations to a sequence split and a ``_StridedShard`` redistribution
    that read a fake tensor's value (torch 2.13).  With the residual stream
    at its rule's placements (``models/lm.py::_residual``) it counts."""
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        cell = steps.build_cell("yi-34b", "train_4k", mesh, smoke=True, layers_override=2,
                                n_micro=8)
        rec = dryrun.count_cell(cell)
    assert rec["memory"]["peak_bytes_per_device"] > 0
    assert rec["roofline"].flops > 0
