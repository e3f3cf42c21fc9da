"""The port's training path against the JAX package on the CPU: the plain
backward versions of K1 and K2, the recsys and LM losses and every leaf's
gradient, the optimisers, microbatching, checkpoints, gradient compression,
the loop and the launcher.  Weights are initialised in JAX and converted
(compat.from_jax_params); batches come from the same numpy generator.

Tolerances, float32: the plain backward versions and the recsys gradients
rtol = 1e-5, atol = 1e-6 (scatter-add and matmul orders differ); the LM loss
and its gradients rtol = atol = 1e-4, as tests/test_torch_lm.py holds the LM
forward; optimiser updates rtol = 1e-6, atol = 1e-7 (the same arithmetic,
with fused multiply-adds and adagrad's step in another rounding order); five
training steps rtol = 1e-4, atol = 1e-5 (the gradients' differences carried
through adagrad's per-coordinate rates)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import ref as jax_ref
from repro.models import lm as jax_lm
from repro.models import recsys as jax_recsys
from repro.train import checkpoint as jax_ckpt
from repro.train import grad_compress as jax_gc
from repro.train import optim as jax_optim
from repro.train.loop import train as jax_train
from repro.train.microbatch import accumulated_grads as jax_accumulated_grads
from repro_torch import compat, configs
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import lm, recsys
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gc
from repro_torch.train import optim
from repro_torch.train.loop import make_train_step, train
from repro_torch.train.microbatch import accumulated_grads, value_and_grad
from repro_torch.utils import leaves_with_paths, tree_map

MODELS = ["ncf", "wnd", "mt-wnd", "dlrm-rmc1", "dlrm-rmc2", "dlrm-rmc3", "din", "dien"]
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
LM_TOL = dict(rtol=1e-4, atol=1e-4)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
STEPS_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _flat_jax(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat(tree) -> dict:
    return {k: _np(v) for k, v in leaves_with_paths(tree)}


def _assert_trees_close(got, want_jax, **tol):
    got, want = _flat(got), _flat_jax(want_jax)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _convert(jtree):
    return compat.from_jax_params(jax.tree.map(np.asarray, jtree), device="cpu")


def _both_recsys(name: str, seed: int = 0):
    jcfg, cfg = jax_configs.get(name).smoke_config, configs.get(name).smoke_config
    jparams = jax_recsys.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jparams, _convert(jparams)


# ------------------------------------------------- plain backward versions


@pytest.mark.parametrize("f,v,b,h,d", [(3, 11, 6, 5, 8), (2, 4, 7, 9, 3), (1, 50, 3, 1, 130)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_matches_jax_grad(f, v, b, h, d, mode):
    """Few rows and many lookups, so indices repeat within and across bags."""
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(f, v, d)).astype(np.float32)
    idx = rng.integers(0, v, size=(b, f, h)).astype(np.int32)
    g = rng.normal(size=(b, f, d)).astype(np.float32)

    def pooled(t):
        return jnp.stack([jax_ref.embedding_bag(t[i], idx[:, i], mode=mode) for i in range(f)], 1)

    want = np.asarray(jax.grad(lambda t: jnp.vdot(pooled(t), g))(jnp.asarray(tables)))
    g_t, idx_t = torch.from_numpy(g), torch.from_numpy(idx)
    np.testing.assert_allclose(ref.embedding_bag_backward(g_t, idx_t, v, mode=mode).numpy(),
                               want, **GRAD_TOL)
    ops.reset_launch_counts()
    t = torch.from_numpy(tables).requires_grad_()
    (ops.embedding_bag(t, idx_t, mode=mode) * g_t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, **GRAD_TOL)
    t1 = torch.from_numpy(tables[0]).requires_grad_()             # the (V, D) form
    (ops.embedding_bag(t1, idx_t[:, 0].contiguous(), mode=mode) * g_t[:, 0]).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), want[0], **GRAD_TOL)
    assert set(ops.launch_counts().values()) == {0}               # CPU: plain versions


def test_embedding_bag_grad_of_bf16_tables_is_bf16():
    """bfloat16 tables: the gradient is accumulated in float32 and cast once."""
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.normal(size=(2, 6, 4)).astype(np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 6, size=(5, 2, 3)).astype(np.int32))
    t.requires_grad_()
    ops.embedding_bag(t, idx).float().sum().backward()
    want = ref.embedding_bag_backward(torch.ones((5, 2, 4)), idx, 6)
    assert t.grad.dtype == torch.bfloat16
    torch.testing.assert_close(t.grad, want.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("b,f,d", [(4, 2, 3), (5, 7, 16), (3, 11, 32)])
def test_dot_interaction_backward_matches_jax_grad(b, f, d):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    g = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    want = np.asarray(jax.grad(lambda z: jnp.vdot(jax_ref.dot_interaction_packed(z), g))(
        jnp.asarray(x)))
    x_t, g_t = torch.from_numpy(x), torch.from_numpy(g)
    np.testing.assert_allclose(ref.dot_interaction_backward(g_t, x_t).numpy(), want, **GRAD_TOL)
    np.testing.assert_allclose(ops.dot_interaction_backward(g_t, x_t).numpy(), want, **GRAD_TOL)
    xr = x_t.clone().requires_grad_()
    (ops.dot_interaction(xr) * g_t).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), want, **GRAD_TOL)


def test_serving_builds_no_graph():
    """Without a tensor that needs a gradient the forward alone runs, and a
    forward under no_grad with trainable tables builds no graph either."""
    cfg = configs.get("dlrm-rmc1").smoke_config
    params = recsys.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             syn.recsys_batch(np.random.default_rng(0), cfg, 4, with_label=False).items()}
    assert recsys.forward(params, cfg, batch).grad_fn is None
    trainable = tree_map(lambda p: p.detach().requires_grad_(), params)
    assert recsys.forward(trainable, cfg, batch).grad_fn is not None
    with torch.no_grad():
        assert recsys.forward(trainable, cfg, batch).grad_fn is None
    with torch.inference_mode():
        assert recsys.bulk_forward(trainable, cfg, batch).grad_fn is None


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("name", MODELS + ["xdeepfm", "autoint", "mind", "bert4rec"])
def test_recsys_loss_and_grads_match_jax(name):
    jcfg, cfg, jparams, params = _both_recsys(name)
    batch = syn.recsys_batch(np.random.default_rng(1), cfg, 7)
    want_loss, want_grads = jax.value_and_grad(jax_recsys.loss_fn)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(lambda p, b: recsys.loss_fn(p, cfg, b), params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), **GRAD_TOL)
    _assert_trees_close(grads, want_grads, **GRAD_TOL)
    assert not any(p.requires_grad for _, p in leaves_with_paths(params))


@pytest.mark.parametrize("seq", [64, 1024])
def test_lm_loss_and_grads_match_jax(seq):
    """S = 64 computes the cross-entropy whole; S = 1,024 in two chunks of
    512, each under activation checkpointing (JAX: lax.scan of
    jax.checkpoint)."""
    jcfg, cfg = jax_configs.get("qwen2-0.5b").smoke_config, configs.get("qwen2-0.5b").smoke_config
    jparams = jax_lm.init(jax.random.PRNGKey(3), jcfg)
    params = _convert(jparams)
    batch = syn.lm_batch(np.random.default_rng(4), cfg, 2, seq)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_lm.loss_fn), static_argnums=1)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b), params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), **LM_TOL)
    _assert_trees_close(grads, want_grads, **LM_TOL)
    if seq == 1024:
        hidden, _ = lm.forward_hidden(params, cfg, torch.from_numpy(batch["tokens"]))
        whole = lm._chunk_nll(params, cfg, hidden, torch.from_numpy(batch["labels"])) / (2 * seq)
        np.testing.assert_allclose(float(loss), float(whole), rtol=1e-6)


# -------------------------------------------------------------- optimisers


def _opt_tree(rng):
    return {"tables": rng.normal(size=(3, 5, 4)).astype(np.float32),
            "predict": [{"w": rng.normal(size=(4, 3)).astype(np.float32),
                         "b": rng.normal(size=(3,)).astype(np.float32)}]}


OPTS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "adagrad": lambda m: m.adagrad(0.5),
    "adamw": lambda m: m.adamw(0.05, weight_decay=0.01),
    "combined": lambda m: m.combined(lambda path: "table" in str(path), m.adagrad(0.02),
                                     m.adamw(1e-3)),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_updates_match_the_reference(name):
    rng = np.random.default_rng(5)
    p_np = _opt_tree(rng)
    jopt, opt = OPTS[name](jax_optim), OPTS[name](optim)
    jp = jax.tree.map(jnp.asarray, p_np)
    p = _convert(p_np)
    jstate, state = jopt.init(jp), opt.init(p)
    for _ in range(3):
        g_np = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), p_np)
        jp, jstate = jopt.update(jax.tree.map(jnp.asarray, g_np), jstate, jp)
        p, state = opt.update(_convert(g_np), state, p)
    _assert_trees_close(p, jp, **OPT_TOL)
    if name == "combined":           # the port keeps each side's state for its own leaves
        for side, sparse in (("sparse", True), ("dense", False)):
            want = {k: v for k, v in _flat_jax(jstate[side]).items()
                    if ("table" in k) == sparse or "count" in k}
            got = {k.replace("[\"", "").replace("\"]", ""): v
                   for k, v in _flat(state[side]).items()}
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **OPT_TOL)
    else:
        _assert_trees_close(state, jstate, **OPT_TOL)


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(6)
    g_np = _opt_tree(rng)
    want = jax_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), 1.5)
    np.testing.assert_allclose(float(optim.global_norm(_convert(g_np))),
                               float(jax_optim.global_norm(jax.tree.map(jnp.asarray, g_np))),
                               rtol=1e-6)
    _assert_trees_close(optim.clip_by_global_norm(_convert(g_np), 1.5), want, **OPT_TOL)
    small = optim.clip_by_global_norm(_convert(g_np), 1e6)           # below the limit: unchanged
    _assert_trees_close(small, jax.tree.map(jnp.asarray, g_np), rtol=0, atol=0)


# ------------------------------------------------------------- microbatches


def test_accumulated_grads_match_the_full_batch_and_the_reference():
    jcfg, cfg, jparams, params = _both_recsys("dlrm-rmc1")
    batch = syn.recsys_batch(np.random.default_rng(7), cfg, 8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_fn = lambda p, b: recsys.loss_fn(p, cfg, b)                 # noqa: E731
    l1, g1 = accumulated_grads(loss_fn, params, tb, 1)
    l4, g4 = accumulated_grads(loss_fn, params, tb, 4)
    wl, wg = jax_accumulated_grads(lambda p, b: jax_recsys.loss_fn(p, jcfg, b), jparams,
                                   {k: jnp.asarray(v) for k, v in batch.items()}, 4)
    np.testing.assert_allclose(float(l4), float(wl), **GRAD_TOL)
    _assert_trees_close(g4, wg, **GRAD_TOL)
    # the mean over microbatches of each one's mean loss is the batch's mean
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-6)
    for k, v in _flat(g1).items():
        np.testing.assert_allclose(_flat(g4)[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError, match="microbatches"):
        accumulated_grads(loss_fn, params, tb, 3)


# ------------------------------------------------------------- checkpoints


def _tree():
    return {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3, dtype=torch.bfloat16),
            "nested": {"t": torch.zeros((4,), dtype=torch.int32), "c": torch.tensor(7)}}


def test_checkpoint_round_trip_and_retention(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5] and ckpt.latest_step(str(tmp_path)) == 5
    restored, step = ckpt.restore(str(tmp_path), t)
    assert step == 5
    for (k, a), (k2, b) in zip(leaves_with_paths(t), leaves_with_paths(restored)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b)
    restored, step = ckpt.restore(str(tmp_path), t, step=4)
    assert step == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), t)


def test_checkpoint_detects_corruption_and_mismatch(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 1, t)
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), {**t, "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {**t, "w": torch.zeros(3, 2)})
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["leaf_00000"] = data["leaf_00000"] + 1
    np.savez(npz, **data)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), t)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A parameter tree the JAX package saved restores here, leaf for leaf,
    and one saved here restores there."""
    jcfg, cfg, jparams, params = _both_recsys("dlrm-rmc1")
    jax_ckpt.save(str(tmp_path / "jax"), 3, jparams)
    target = recsys.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    restored, step = ckpt.restore(str(tmp_path / "jax"), target)
    assert step == 3
    _assert_trees_close(restored, jparams, rtol=0, atol=0)
    ckpt.save(str(tmp_path / "torch"), 4, params)
    back, step = jax_ckpt.restore(str(tmp_path / "torch"), jparams)
    assert step == 4
    _assert_trees_close(params, back, rtol=0, atol=0)


# ------------------------------------------------------------ grad compress


def test_grad_compression_matches_the_reference():
    rng = np.random.default_rng(8)
    g_np = {"w": (rng.normal(size=(300,)) * 5).astype(np.float32),
            "m": rng.normal(size=(17, 33)).astype(np.float32)}
    q, s = gc.quantize_int8(torch.from_numpy(g_np["m"]))
    jq, js = jax_gc.quantize_int8(jnp.asarray(g_np["m"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(gc.dequantize_int8(q, s, (17, 33), torch.float32).numpy(),
                                  np.asarray(jax_gc.dequantize_int8(jq, js, (17, 33), jnp.float32)))
    res, jres = gc.init_error_feedback(_convert(g_np)), jax_gc.init_error_feedback(g_np)
    for _ in range(3):
        qt, res = gc.compress_grads(_convert(g_np), res)
        jqt, jres = jax_gc.compress_grads(jax.tree.map(jnp.asarray, g_np), jres)
        _assert_trees_close(res, jres, rtol=0, atol=1e-7)
        _assert_trees_close(gc.decompress_grads(qt, _convert(g_np)),
                            jax_gc.decompress_grads(jqt, g_np), rtol=0, atol=1e-7)


# -------------------------------------------------------------------- loop


def _recsys_steps(pkg_train, loss_fn, opt, params, batches, n):
    losses = []
    state = pkg_train(loss_fn, opt, params, iter(batches), num_steps=n, log_every=0,
                      clip_norm=10.0, hooks=[lambda s, p, m: losses.append(float(m["loss"]))])
    return state, losses


def test_five_training_steps_match_the_reference():
    """DLRM-RMC1 smoke, the production optimiser split, clip 10: losses and
    final parameters of both packages from the same weights and batches."""
    jcfg, cfg, jparams, params = _both_recsys("dlrm-rmc1")
    rng = np.random.default_rng(9)
    batches = [syn.recsys_batch(rng, cfg, 16) for _ in range(5)]
    route = lambda path: "table" in str(path)                        # noqa: E731
    jstate, jlosses = _recsys_steps(
        jax_train, lambda p, b: jax_recsys.loss_fn(p, jcfg, b),
        jax_optim.combined(route, jax_optim.adagrad(0.02), jax_optim.adamw(1e-3)), jparams,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], 5)
    state, losses = _recsys_steps(
        train, lambda p, b: recsys.loss_fn(p, cfg, b),
        optim.combined(route, optim.adagrad(0.02), optim.adamw(1e-3)), params,
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches], 5)
    np.testing.assert_allclose(losses, jlosses, **STEPS_TOL)
    _assert_trees_close(state.params, jstate.params, **STEPS_TOL)
    assert np.isfinite(losses).all()
    _assert_trees_close(params, jparams, rtol=0, atol=0)          # the caller's weights survive


def _quadratic():
    def batches():
        rng = np.random.default_rng(42)
        while True:
            x = rng.normal(size=(16, 4)).astype(np.float32)
            yield {"x": torch.from_numpy(x), "y": torch.from_numpy(x.sum(1, keepdims=True))}

    def loss(params, b):
        return ((b["x"] @ params["w"] - b["y"]) ** 2).mean()

    return batches, loss, {"w": torch.zeros((4, 1))}


def test_preemption_resume_is_bit_exact(tmp_path):
    """Kill training at step 7 (checkpoint at 5), resume, reach the same
    state as an uninterrupted run, bit for bit."""
    batches, loss, init = _quadratic()
    opt = optim.adamw(0.01)
    full = train(loss, opt, init, batches(), num_steps=12, log_every=0)
    d = str(tmp_path / "ck")
    train(loss, opt, init, batches(), num_steps=7, ckpt_dir=d, ckpt_every=5, log_every=0)
    assert ckpt.all_steps(d) == [5, 7]

    def batches_from(start):
        g = batches()
        for _ in range(start):
            next(g)
        return g

    resumed = train(loss, opt, init, batches_from(7), num_steps=12, ckpt_dir=d, ckpt_every=5,
                    log_every=0)
    assert torch.equal(full.params["w"], resumed.params["w"])
    assert int(resumed.opt_state["count"]) == 12
    assert ckpt.all_steps(d) == [7, 10, 12]
    # a run whose last step is a checkpoint step saves it once
    train(loss, opt, init, batches(), num_steps=10, ckpt_dir=str(tmp_path / "c2"),
          ckpt_every=5, log_every=0)
    assert ckpt.all_steps(str(tmp_path / "c2")) == [5, 10]


def test_nan_guard_keeps_the_state_and_aborts_after_three():
    def loss(params, b):
        v = (params["w"] ** 2).sum()
        return v * float("nan") if b["bad"] else v

    step = make_train_step(loss, optim.adamw(0.1))
    params = {"w": torch.tensor([1.0, -2.0])}
    state = optim.adamw(0.1).init(params)
    p2, s2, m = step(params, state, {"bad": True})
    assert not m["finite"] and torch.equal(p2["w"], torch.tensor([1.0, -2.0]))
    assert int(s2["count"]) == 0 and torch.equal(s2["mu"]["w"], torch.zeros(2))
    p3, s3, m = step(p2, s2, {"bad": False})
    assert m["finite"] and int(s3["count"]) == 1
    assert not torch.equal(p3["w"], torch.tensor([1.0, -2.0]))
    params = {"w": torch.tensor([1.0, -2.0])}
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        train(loss, optim.sgd(0.1), params, iter(lambda: {"bad": True}, None), num_steps=5,
              log_every=0)
    seen = []
    pattern = iter([True, True, False, True, True, False])
    train(loss, optim.sgd(0.1), params, iter(lambda: {"bad": next(pattern)}, None),
          num_steps=6, log_every=0, hooks=[lambda s, p, m: seen.append(m["finite"])])
    assert seen == [False, False, True, False, False, True]


# ---------------------------------------------------------------- launcher


@pytest.mark.parametrize("arch", ["dlrm-rmc2", "qwen2-0.5b", "granite-moe-1b-a400m"])
def test_launch_train_runs_on_the_cpu(arch, capsys):
    state = launch_train.main(["--arch", arch, "--steps", "4", "--batch", "8", "--seq", "16",
                               "--device", "cpu"])
    assert state.step == 4
    assert all(torch.isfinite(p).all() for _, p in leaves_with_paths(state.params))
    out = capsys.readouterr().out
    assert f"[train] {arch}" in out and "on cpu" in out and "done at step 4" in out


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", "dlrm-rmc1", "--steps", "3", "--batch", "8", "--device", "cpu",
            "--ckpt", str(tmp_path), "--microbatches", "2"]
    launch_train.main(argv)
    state = launch_train.main(argv[:3] + ["6"] + argv[4:])
    assert state.step == 6 and ckpt.all_steps(str(tmp_path)) == [3, 6]
    assert "resumed from step 3" in capsys.readouterr().out


def test_utils_match_the_reference():
    """Accounting, casting and the finite check agree with repro.utils on the
    same tree; rng_seq yields distinct seeded generators."""
    from repro import utils as jax_utils
    from repro_torch import utils
    jcfg, cfg, jparams, params = _both_recsys("dlrm-rmc2")
    assert utils.param_count(params) == jax_utils.param_count(jparams)
    assert utils.param_bytes(params) == jax_utils.param_bytes(jparams)
    half = utils.tree_cast(params, torch.bfloat16)
    assert utils.param_bytes(half) == jax_utils.param_bytes(jax_utils.tree_cast(jparams,
                                                                                jnp.bfloat16))
    assert bool(utils.check_finite(params)) and bool(jax_utils.check_finite(jparams))
    params["tables"][0, 0, 0] = float("inf")
    assert not bool(utils.check_finite(params))
    assert utils.human_bytes(3 * 1024 ** 3) == jax_utils.human_bytes(3 * 1024 ** 3) == "3.00GiB"
    seq = utils.rng_seq(0)
    a, b = next(seq), next(seq)
    assert not torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert torch.equal(torch.rand(4, generator=next(utils.rng_seq(0))),
                       torch.rand(4, generator=next(utils.rng_seq(0))))
    assert utils.timeit(lambda: None, iters=2, warmup=1) >= 0
