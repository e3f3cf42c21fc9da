"""K3's gradient on the CPU: the plain backward (``ref.cin_layer_backward``,
what ``ops.cin_layer``'s backward runs for a CPU tensor) against ``jax.vjp``
of the JAX package's ``cin_layer`` and ``cin``, which on the CPU take the
reference's plain path (a ``pallas_call`` in interpret mode has no
transpose).  Inputs are made with numpy from a seed and handed to both
packages.  Also K3-bwd's plan and its accounting on fake tensors, and the
dry run of ``xdeepfm × train_batch``.

Tolerance: float32 rtol = atol = 1e-4, the forward's
(``tests/test_torch_kernels.py::test_cin_layer_matches_pallas``): both sides
sum in float32, in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jax_ops
from repro.layers import interactions as jax_ix
from repro_torch.kernels import cin as cin_kernel
from repro_torch.kernels import ops, ref
from repro_torch.layers import interactions as ix
from repro_torch.roofline import analysis

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, F, H, N, D): B = 1 with an odd D, F = 1, H = 1, xDeepFM-smoke's two
# layers (F = 6, H = 6 then 16, N = 16, D = 8), the forward's sweep
SHAPES = [(1, 3, 4, 5, 7), (5, 1, 4, 3, 9), (4, 6, 1, 5, 3), (3, 6, 6, 16, 8),
          (3, 6, 16, 16, 8), (8, 6, 5, 7, 128), (4, 3, 8, 16, 130), (2, 1, 1, 1, 1)]


def _inputs(seed, b, f, h, n, d):
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(b, f, d)) / d ** 0.5).astype(np.float32)
    xk = (rng.normal(size=(b, h, d)) / d ** 0.5).astype(np.float32)
    w = rng.normal(size=(h * f, n)).astype(np.float32)
    g = rng.normal(size=(b, n, d)).astype(np.float32)
    return x0, xk, w, g


def _jax_vjp(x0, xk, w, g):
    _, vjp = jax.vjp(lambda a, b, c: jax_ops.cin_layer(a, b, c), jnp.asarray(x0),
                     jnp.asarray(xk), jnp.asarray(w))
    return [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("b,f,h,n,d", SHAPES)
def test_cin_layer_backward_matches_jax_vjp(b, f, h, n, d):
    """dx0, dxk, dw of the plain backward, and of ``ops.cin_layer`` through
    autograd on CPU tensors, against ``jax.vjp`` of the JAX package's layer."""
    x0, xk, w, g = _inputs(31, b, f, h, n, d)
    want = _jax_vjp(x0, xk, w, g)
    got = ref.cin_layer_backward(*(torch.from_numpy(t) for t in (g, x0, xk, w)))
    for name, a, e in zip(("dx0", "dxk", "dw"), got, want):
        assert a.dtype == torch.float32 and a.shape == e.shape, name
        np.testing.assert_allclose(a.numpy(), e, **TOL, err_msg=name)
    ts = [torch.from_numpy(t).requires_grad_() for t in (x0, xk, w)]
    ops.reset_launch_counts()
    auto = torch.autograd.grad(ops.cin_layer(*ts), ts, torch.from_numpy(g))
    for name, a, e in zip(("dx0", "dxk", "dw"), auto, want):
        np.testing.assert_allclose(a.numpy(), e, **TOL, err_msg=name)
    assert not any(ops.launch_counts().values())                  # CPU tensors


def test_cin_layer_backward_against_float64():
    """The plain backward in float32 against the same sums in float64."""
    x0, xk, w, g = _inputs(32, 4, 6, 16, 16, 8)
    got = ref.cin_layer_backward(*(torch.from_numpy(t) for t in (g, x0, xk, w)))
    exact = ref.cin_layer_backward(*(torch.from_numpy(t).double() for t in (g, x0, xk, w)))
    for a, e in zip(got, exact):
        assert e.dtype == torch.float64
        np.testing.assert_allclose(a.double().numpy(), e.numpy(), rtol=1e-5, atol=1e-5)


def test_the_float64_bound_holds_a_float32_sum_and_refuses_a_dropped_sample():
    """``backward_error_bound``, the card's float64 check of K3-bwd, holds the
    plain backward's float32 sums (another order than the kernel's) at
    xDeepFM's K = 7,800, and refuses the gradients of a batch with one
    sample's terms left out."""
    b, f, h, n, d = 16, 39, 200, 200, 10
    x0, xk, w, g = (torch.from_numpy(t) for t in _inputs(36, b, f, h, n, d))
    w = w / (h * f) ** 0.5
    got = ref.cin_layer_backward(g, x0, xk, w)
    exact = ref.cin_layer_backward(g.double(), x0.double(), xk.double(), w.double())
    mag = ref.cin_layer_backward(g.double().abs(), x0.double().abs(), xk.double().abs(),
                                 w.double().abs())
    bound = cin_kernel.backward_error_bound(b, f, h, n, d)
    for name, a, e, m in zip(("dx0", "dxk", "dw"), got, exact, mag):
        assert bool(((a.double() - e).abs() <= bound[name] * m).all()), name
    dropped = ref.cin_layer_backward(g[1:], x0[1:], xk[1:], w)[2]
    assert not bool(((dropped.double() - exact[2]).abs() <= bound["dw"] * mag[2]).all())


def test_cin_layer_backward_bfloat16_is_the_float32_result_cast_down():
    """bfloat16 in, each gradient the float32 value of the bfloat16 inputs
    rounded once, through the plain backward and through autograd."""
    x0, xk, w, g = (torch.from_numpy(t).bfloat16() for t in _inputs(33, 3, 5, 4, 6, 10))
    want = ref.cin_layer_backward(g.float(), x0.float(), xk.float(), w.float())
    got = ops.cin_layer_backward(g, x0, xk, w)
    for a, e in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, e.bfloat16())
    ts = [t.clone().requires_grad_() for t in (x0, xk, w)]
    auto = torch.autograd.grad(ops.cin_layer(*ts), ts, g)
    for a, e in zip(auto, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, e.bfloat16())


def test_cin_layer_backward_refuses_mismatched_shapes():
    x0, xk, w, g = (torch.from_numpy(t) for t in _inputs(34, 2, 3, 4, 5, 6))
    with pytest.raises(ValueError, match="one CIN layer"):
        ops.cin_layer_backward(g[:, :4], x0, xk, w)
    with pytest.raises(TypeError, match="one dtype"):
        ops.cin_layer_backward(g.double(), x0, xk, w)


@pytest.mark.parametrize("layers", [(16, 16), (7, 5, 3)])
def test_two_cin_layers_match_jax_vjp(layers):
    """``layers.interactions.cin`` (the first layer with xk = x0, whose two
    gradients autograd adds), against ``jax.vjp`` of the JAX package's
    ``cin`` with the same numpy weights: x0's and every weight's gradient."""
    rng = np.random.default_rng(35)
    b, f, d = 3, 6, 8
    x0 = (rng.normal(size=(b, f, d)) / d ** 0.5).astype(np.float32)
    ws, h = [], f
    for hn in layers:
        ws.append((rng.normal(size=(h * f, hn)) / (h * f) ** 0.5).astype(np.float32))
        h = hn
    g = rng.normal(size=(b, sum(layers))).astype(np.float32)
    out, vjp = jax.vjp(lambda p, x: jax_ix.cin(p, x), [jnp.asarray(w) for w in ws],
                       jnp.asarray(x0))
    want_w, want_x = vjp(jnp.asarray(g))
    params = [torch.from_numpy(w).requires_grad_() for w in ws]
    x = torch.from_numpy(x0).requires_grad_()
    got = ix.cin(params, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    grads = torch.autograd.grad(got, [x] + params, torch.from_numpy(g))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x), **TOL)
    for a, e in zip(grads[1:], want_w):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL)


@pytest.mark.parametrize("b,f,h,n,d", [(512, 39, 200, 200, 10), (65536, 39, 200, 200, 10),
                                       (65536, 39, 39, 200, 10), (1, 39, 200, 200, 10),
                                       (3, 1, 1, 1, 1), (1600, 40, 600, 8, 10)])
def test_cin_backward_plan_makes_whole_runs(b, f, h, n, d):
    """The runs cover H and the B·D rows exactly once, none empty, a row
    run a multiple of the stage; the data gradient and the weight gradient
    are cut until their blocks reach the target (or run out of H, or of
    rows); the plan depends on the shapes alone."""
    p = cin_kernel.backward_plan(b, f, h, n, d)
    m = b * d
    assert (p.data_splits - 1) * p.h_run < h <= p.data_splits * p.h_run
    assert p.row_run % cin_kernel.BWD_STAGE == 0
    assert (p.weight_splits - 1) * p.row_run < m <= p.weight_splits * p.row_run
    row_tiles = -(-m // cin_kernel.BWD_TILE)
    assert row_tiles * p.data_splits >= min(cin_kernel.BWD_TARGET_BLOCKS, row_tiles * h) or \
        p.data_splits == h
    scratch = cin_kernel.backward_scratch(p, b, f, h, n, d)
    assert ("dx0_partial" in scratch) == (p.data_splits > 1)
    assert ("dw_partial" in scratch) == (p.weight_splits > 1)
    if p.weight_splits > 1:
        assert scratch["dw_partial"][0] == (p.weight_splits, h * f, n)
    assert cin_kernel.backward_plan(b, f, h, n, d) == p


def test_cin_backward_plan_refuses_what_does_not_fit():
    """x0's tile and dx0's sums take F × 128 floats each: F = 176 fits a
    block's shared memory, 177 does not."""
    assert cin_kernel.backward_shared_bytes(176) <= cin_kernel.SMEM_LIMIT
    cin_kernel.backward_plan(4, 176, 2, 8, 10)
    for f in (177, 500):
        with pytest.raises(ValueError, match="shared memory"):
            cin_kernel.backward_plan(4, f, 2, 8, 10)


def test_cin_backward_constants_match_the_source():
    """The plan and the shared memory it checks come from the kernel's
    tile: the Python constants must be csrc/cin_backward.cu's."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "cin_backward.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["TILE"]) == cin_kernel.BWD_TILE and int(consts["KS"]) == cin_kernel.BWD_STAGE
    assert consts["LD"] == "TILE + 4" and cin_kernel.BWD_LD == cin_kernel.BWD_TILE + 4
    assert consts["PS"] == "HALF + 4" and cin_kernel.BWD_PS == cin_kernel.BWD_TILE // 2 + 4
    assert int(consts["SMEM_LIMIT"]) == cin_kernel.SMEM_LIMIT
    assert "cin_layer_backward_launch" in src and "atomic" not in src.replace("No atomics", "")


def test_cin_backward_work_counts_both_products():
    """Float32 on the CUDA cores: 2·M·N·K and 4·M·K for the data gradient,
    2·M·K·N and M·K for the weight gradient; every input read and every
    result written once."""
    b, f, h, n, d = 512, 39, 200, 200, 10
    m, k = b * d, h * f
    flops, nbytes = cin_kernel.backward_work(b, f, h, n, d, 4)
    assert flops == {"fp32": 4 * m * n * k + 5 * m * k}
    assert nbytes == 4 * (b * n * d + b * f * d + b * h * d + k * n) + 4 * (
        b * f * d + b * h * d + k * n)
    assert abs(2 * m * n * k / 1e9 - 16.0) < 0.05               # 16.0 GFLOP a product


def test_a_cin_layer_on_fake_tensors_counts_k3_and_k3_bwd():
    """A gradient step on fake tensors counts one K3 and one K3-bwd at
    their ``work()``, and no launch."""
    fm = FakeTensorMode()
    with fm:
        x0, xk = torch.empty((4, 6, 10)), torch.empty((4, 5, 10))
        w = torch.empty((30, 9)).requires_grad_()
    ops.reset_launch_counts()
    _, c = analysis.count(lambda a, b, m: ops.cin_layer(a, b, m).sum().backward(), (x0, xk, w))
    assert {k: v["calls"] for k, v in c.kernels.items()} == {"cin_layer": 1,
                                                              "cin_layer_backward": 1}
    flops, nbytes = cin_kernel.backward_work(4, 6, 5, 9, 10, 4)
    assert c.kernels["cin_layer_backward"]["flops_by_unit"] == flops
    assert c.kernels["cin_layer_backward"]["bytes"] == nbytes
    assert not any(ops.launch_counts().values())


def test_xdeepfm_train_batch_dry_run_counts_three_k3_bwd():
    """The dry run of ``xdeepfm × train_batch`` at published size on the
    single-pod fake world of 256 ranks (fake tensors: nothing allocated):
    one microbatch a step, three K3 and three K3-bwd in it, each at its
    ``work()`` for the rank's 256 rows; the (B, H·F, D) maps are never
    materialised, so the peak stays under 1 GB a rank."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, mesh as mesh_lib
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    cfg = configs.get("xdeepfm").config
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh(device="cpu")
        rec = dryrun.run_cell("xdeepfm", "train_batch", mesh, "single_pod_16x16", verbose=False)
    kernels = rec["kernels"]
    assert kernels["cin_layer"]["calls"] == kernels["cin_layer_backward"]["calls"] == 3
    b = configs.RECSYS_SHAPES["train_batch"].batch // mesh_lib.SINGLE_POD[0]
    hs = (cfg.n_tables,) + tuple(cfg.cin_layers[:-1])
    works = [cin_kernel.backward_work(b, cfg.n_tables, h, n, cfg.embed_dim, 4)
             for h, n in zip(hs, cfg.cin_layers)]
    assert kernels["cin_layer_backward"]["flops_by_unit"] == {
        "fp32": sum(w[0]["fp32"] for w in works)}
    assert kernels["cin_layer_backward"]["bytes"] == sum(w[1] for w in works)
    assert rec["memory"]["peak_bytes_per_device"] < 1e9


def test_xdeepfm_train_cell_on_dtensors_is_its_plain_step_to_the_bit(tmp_path):
    """``xdeepfm × train_batch`` at smoke size, B = 256, in a gloo world of
    one rank on a (1, 1) mesh: the step on DTensors and on plain tensors
    from the same weights, state and batch give the same bits (loss, every
    parameter and optimiser leaf).  The embeddings feed the CIN's every
    layer, the DNN and the linear logit, and their gradients are added in
    a fixed order (``layers.interactions.fan_out``): left to autograd,
    DTensor's nodes change that order and the tables' update moved by an
    ulp."""
    from repro_torch import configs
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.utils import leaves_with_paths, tree_map
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, device="cpu")
        cfg = configs.get("xdeepfm").smoke_config
        cell = steps._recsys_cell("xdeepfm", configs.RecShape("train_batch", 256, "train"), mesh,
                                  smoke=True)
        params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        state = cell.init_state(params)
        batch = {k: torch.from_numpy(v)
                 for k, v in syn.recsys_batch(np.random.default_rng(0), cfg, 256).items()}
        sharded = cell.place(tree_map(torch.clone, params), tree_map(torch.clone, state), batch)
        loss_s = cell.fn(*sharded)[2].to_local()
        loss = cell.fn(params, state, batch)[2]
        assert torch.equal(loss_s, loss)
        for got_tree, want_tree in ((sharded[0], params), (sharded[1], state)):
            got = dict(leaves_with_paths(got_tree))
            for k, want in leaves_with_paths(want_tree):
                assert torch.equal(got[k].to_local(), want), k
    finally:
        dist.destroy_process_group()
