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
from test_torch_kernels import _split

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


def _stages(a: np.ndarray, b: np.ndarray, passes: str) -> np.ndarray:
    """a (rows, R) times b (R, cols) as K3-bwd sums it, emulated on the CPU:
    the reduction in stages of ``BWD_STAGE`` values, each stage's TF32
    passes (``passes`` "3": hi·lo + lo·hi + hi·hi; "1": hi·hi) summed in
    float32 from zero, then added to a float32 total in order."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for s in range(0, a.shape[1], cin_kernel.BWD_STAGE):
        k = slice(s, s + cin_kernel.BWD_STAGE)
        stage = a_hi[:, k] @ b_hi[k]
        if passes == "3":
            stage = (a_hi[:, k] @ b_lo[k] + a_lo[:, k] @ b_hi[k]) + stage
        total += stage
    return total


def _emulated_backward(g, x0, xk, w, passes):
    """K3-bwd's arithmetic on numpy float32 arrays: P = g·wᵀ and dw = Aᵀ·g
    through ``_stages``, the contractions with x0 and xk in float32."""
    b, f, d = x0.shape
    h, n = xk.shape[1], w.shape[1]
    rows = g.transpose(0, 2, 1).reshape(b * d, n)                     # r = (b, d)
    p = _stages(rows, w.T, passes).reshape(b, d, h, f)
    dxk = np.einsum("bdhf,bfd->bhd", p, x0)
    dx0 = np.einsum("bdhf,bhd->bfd", p, xk)
    a = np.einsum("bhd,bfd->bdhf", xk, x0).reshape(b * d, h * f)    # float32 products
    return dx0, dxk, _stages(a.T, rows, passes)


def test_the_float64_bound_holds_the_kernels_3xtf32_stages_and_refuses_one_pass():
    """``backward_error_bound`` against K3-bwd's own arithmetic at xDeepFM's
    K = 7,800 (F = 39, H = N = 200, D = 10) and B = 4: both products
    emulated in 3xTF32 (``tests/test_torch_kernels.py``'s TF32 rounding),
    in the kernel's stages, lie within the bound of the float64 value; one
    TF32 pass, in the same stages, is at least 10× further off in each
    gradient."""
    b, f, h, n, d = 4, 39, 200, 200, 10
    x0, xk, w, g = _inputs(37, b, f, h, n, d)
    w = (w / (h * f) ** 0.5).astype(np.float32)
    t64 = [torch.from_numpy(t).double() for t in (g, x0, xk, w)]
    exact = ref.cin_layer_backward(*t64)
    mag = ref.cin_layer_backward(*(t.abs() for t in t64))
    bound = cin_kernel.backward_error_bound(b, f, h, n, d)
    three = _emulated_backward(g, x0, xk, w, "3")
    one = _emulated_backward(g, x0, xk, w, "1")
    for name, a, c, e, m in zip(("dx0", "dxk", "dw"), three, one, exact, mag):
        assert a.dtype == np.float32, name
        err3 = np.abs(a - e.numpy())
        assert (err3 <= bound[name] * m.numpy()).all(), name
        assert np.abs(c - e.numpy()).max() >= 10 * err3.max(), name


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
    row_tiles = -(-m // cin_kernel.BWD_BLOCK)
    assert row_tiles * p.data_splits >= min(cin_kernel.BWD_TARGET_BLOCKS, row_tiles * h) or \
        p.data_splits == h
    scratch = cin_kernel.backward_scratch(p, b, f, h, n, d)
    r_stages = -(-m // cin_kernel.BWD_STAGE)
    nt = cin_kernel.n_tile(n)
    assert p.chunk == next(c for c in cin_kernel.BWD_CHUNKS
                           if cin_kernel.backward_shared_bytes(f, h, n, c) <= cin_kernel.SMEM_LIMIT)
    assert scratch["w_planes"][0] == (p.data_splits, -(-p.h_run * f // p.chunk),
                                      -(-n // cin_kernel.BWD_STAGE), 2, cin_kernel.BWD_STAGE,
                                      p.chunk)
    assert scratch["g_planes"][0] == (-(-n // nt), r_stages, 2, cin_kernel.BWD_STAGE, nt)
    assert scratch["x_rows"][0] == (r_stages, h + f, cin_kernel.BWD_X_STRIDE)
    assert ("dx0_partial" in scratch) == (p.data_splits > 1)
    assert ("dw_partial" in scratch) == (p.weight_splits > 1)
    if p.weight_splits > 1:
        assert scratch["dw_partial"][0] == (p.weight_splits, h * f, n)
    assert cin_kernel.backward_plan(b, f, h, n, d) == p


def test_cin_backward_plan_refuses_what_does_not_fit():
    """The data kernel's x0 tile and dx0's sums take F × 128 floats each, its
    g tile N (in whole stages) × 136 and P's tile a chunk's columns × 132:
    xDeepFM's layers take chunks of 64 columns; at N = 8, F = 176 takes
    chunks of 32, F = 191 still fits a block's shared memory and 192 does
    not; at N = 200, F = 64 is the last with chunks of 64 and 89 the last
    that fits; N = 300 fits at F = 5, not at F = 39."""
    assert cin_kernel.backward_plan(4, 39, 200, 200, 10).chunk == 64
    assert cin_kernel.backward_plan(4, 176, 2, 8, 10).chunk == 32
    assert cin_kernel.backward_plan(4, 191, 2, 8, 10).chunk == 32
    assert cin_kernel.backward_plan(4, 64, 3, 200, 10).chunk == 64
    assert cin_kernel.backward_plan(4, 65, 3, 200, 10).chunk == 32
    assert cin_kernel.backward_plan(4, 89, 3, 200, 10).chunk == 32
    cin_kernel.backward_plan(4, 5, 7, 300, 3)
    for f, n in ((192, 8), (500, 8), (90, 200), (39, 300)):
        with pytest.raises(ValueError, match="shared memory"):
            cin_kernel.backward_plan(4, f, 2, n, 10)


def test_cin_backward_constants_match_the_source():
    """The plan, the workspaces and the shared memory it checks come from
    the kernel's tiles: the Python constants must be csrc/cin_backward.cu's;
    both products go through wgmma in TF32, the weight product at every
    column tile of K3's."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "cin_backward.cu").read_text()
    assert '#include "wgmma_tf32.cuh"' in src
    helpers = (_build.CSRC / "wgmma_tf32.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert (int(consts["BM"]), int(consts["BS"])) == (cin_kernel.BWD_BLOCK, cin_kernel.BWD_STAGE)
    chunks = re.search(r"constexpr int CHUNKS\[\] = \{([^}]*)\};", src).group(1)
    assert tuple(int(c) for c in chunks.split(",")) == cin_kernel.BWD_CHUNKS
    assert consts["XS"] == "BM + 8" and cin_kernel.BWD_G_STRIDE == cin_kernel.BWD_BLOCK + 8
    assert consts["PS"] == "BM + 4" and cin_kernel.BWD_P_STRIDE == cin_kernel.BWD_BLOCK + 4
    assert consts["RS"] == "BS + 4" and cin_kernel.BWD_X_STRIDE == cin_kernel.BWD_STAGE + 4
    assert (int(consts["MIN_STAGES"]), int(consts["BARRIER_BYTES"]), int(consts["SMEM_LIMIT"])) \
        == (cin_kernel.MIN_STAGES, cin_kernel.BARRIER_BYTES, cin_kernel.SMEM_LIMIT)
    tiles = re.search(r"constexpr int N_TILES\[\] = \{([^}]*)\};", src).group(1)
    assert tuple(int(t) for t in tiles.split(",")) == cin_kernel.N_TILES
    for nt in set(cin_kernel.N_TILES) | set(cin_kernel.BWD_CHUNKS):
        assert f"m64n{nt}k8.f32.tf32.tf32" in helpers
    for nt in cin_kernel.N_TILES:
        assert f"case {nt}: return launch_weight<T, {nt}>" in src
    for c in cin_kernel.BWD_CHUNKS:
        assert f"case {c}: err = launch_data<T, {c}>" in src
    assert "cin_layer_backward_launch" in src and "atomic" not in src.replace("No atomics", "")
    assert "atomic" not in helpers


def test_cin_backward_work_counts_both_products():
    """Each product, 2·M·N·K, in three TF32 passes on the tensor cores; the
    data gradient's contractions 4·M·K and forming A, M·K, float32 on the
    CUDA cores; every input read and every result written once."""
    b, f, h, n, d = 512, 39, 200, 200, 10
    m, k = b * d, h * f
    flops, nbytes = cin_kernel.backward_work(b, f, h, n, d, 4)
    assert flops == {"tf32": 3 * 2 * (2 * m * n * k), "fp32": 5 * m * k}
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
        u: sum(w[0][u] for w in works) for u in ("tf32", "fp32")}
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
