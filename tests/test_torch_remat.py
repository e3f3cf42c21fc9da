"""Activation checkpointing in the port, against the JAX package on the CPU:
``flash_sdpa``'s two checkpointed loop bodies (the reference's
``jax.checkpoint`` of ``q_body`` and ``kv_body``) and ``LMConfig.remat``
(each layer under ``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of ``_layer_fwd``).

float32, rtol = atol = 1e-4 against JAX, tests/test_torch_lm.py's
tolerance.  With and without the checkpoints the port gives the same bits:
a non-reentrant checkpoint keeps the forward's graph and recomputes only
the tensors it saves, with the same operations in the same order.  The
bytes autograd keeps are counted through ``saved_tensors_hooks`` (distinct
storages, the parameters' left out)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.layers import attention as jax_attn
from repro.models import lm as jax_lm
from repro_torch import compat, configs
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.layers import attention
from repro_torch.models import lm
from repro_torch.train.microbatch import value_and_grad
from repro_torch.utils import leaves_with_paths, tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(11)
ARCHS = ["qwen2-0.5b", "phi3-mini-3.8b", "granite-moe-1b-a400m"]
jax_value_and_grad = jax.jit(jax.value_and_grad(jax_lm.loss_fn), static_argnums=1)


def _no_checkpoint(fn, *args, use_reentrant, preserve_rng_state):
    return fn(*args)


@contextlib.contextmanager
def saved_bytes(skip: set[int] = frozenset()):
    """Count the distinct storages autograd saves within (a dict's
    ``bytes``), leaving out the storages in ``skip``."""
    seen: dict[int, int] = {}
    out = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield out
    out["bytes"] = sum(seen.values())


def _storages(tree) -> set[int]:
    return {t.untyped_storage().data_ptr() for _, t in leaves_with_paths(tree)}


# --------------------------------------------------------------- flash_sdpa


def _qkv(seed: int, b=2, s=64, hq=4, hkv=2, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    w = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    return q, k, v, w


def _flash_grads(q, k, v, w, **kw):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attention.flash_sdpa(*ts, causal=True, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), [t.grad for t in ts]


def test_flash_sdpa_grads_match_jax():
    """S = T = 64, query chunks of 8, KV chunks of 16, two query heads a KV
    head: the output and q's, k's and v's gradients against ``jax.grad`` of
    the reference's ``flash_sdpa`` at the same chunks."""
    q, k, v, w = _qkv(0)
    kw = dict(q_chunk=8, kv_chunk=16)

    def ref(q_, k_, v_):
        out = jax_attn.flash_sdpa(q_, k_, v_, causal=True, **kw)
        return (out * w).sum(), out

    (_, want), want_g = jax.value_and_grad(ref, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    got, got_g = _flash_grads(q, k, v, w, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name, g, wg in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), err_msg=name, **TOL)


def test_flash_sdpa_checkpoints_keep_the_bits(monkeypatch):
    q, k, v, w = _qkv(1)
    kw = dict(q_chunk=8, kv_chunk=16)
    got, got_g = _flash_grads(q, k, v, w, **kw)
    monkeypatch.setattr(attention, "checkpoint", _no_checkpoint)
    want, want_g = _flash_grads(q, k, v, w, **kw)
    assert torch.equal(got, want)
    for g, wg in zip(got_g, want_g):
        assert torch.equal(g, wg)


def _flash_saved(q, k, v, **kw) -> int:
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with saved_bytes() as n:
        attention.flash_sdpa(*ts, causal=True, **kw)
    return n["bytes"]


def test_flash_sdpa_keeps_q_k_v_and_no_chunk_scores(monkeypatch):
    """What autograd keeps after the forward is q, k and v, whatever the
    number of chunk pairs (nq × nk = 32, 8 or 1 here); without the
    checkpoints it grows with the pairs."""
    q, k, v, _ = _qkv(2)
    qkv = sum(x.nbytes for x in (q, k, v))
    kept = [_flash_saved(q, k, v, q_chunk=qc, kv_chunk=kc)
            for qc, kc in ((8, 16), (16, 32), (64, 64))]
    assert kept == [qkv] * 3
    monkeypatch.setattr(attention, "checkpoint", _no_checkpoint)
    unchecked = [_flash_saved(q, k, v, q_chunk=qc, kv_chunk=kc)
                 for qc, kc in ((8, 16), (16, 32))]
    assert unchecked[0] > unchecked[1] > 4 * qkv


# ------------------------------------------------------------------ the LM


def _remat(arch: str, on: bool = True):
    """(the port's smoke config, the reference's), ``remat`` set to ``on``."""
    return (dataclasses.replace(configs.get(arch).smoke_config, remat=on),
            dataclasses.replace(jax_configs.get(arch).smoke_config, remat=on))


def _loss_and_grads(params, cfg, batch):
    loss, grads = value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b), params, batch)
    return loss, dict(leaves_with_paths(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_with_remat_matches_jax_and_keeps_the_bits(arch):
    """``loss_fn`` with ``remat`` at S = 1,024 (the chunked cross-entropy
    runs): loss and every leaf's gradient against ``jax.value_and_grad`` of
    the reference's loss with its ``remat``; and the same bits as the port
    without ``remat``."""
    cfg, cfg_j = _remat(arch)
    params_j = jax_lm.init(KEY, cfg_j)
    params = compat.from_jax_params(jax.tree.map(np.asarray, params_j), device="cpu")
    batch = syn.lm_batch(np.random.default_rng(3), cfg, 2, 1024)
    want_loss, want_grads = jax_value_and_grad(params_j, cfg_j,
                                               {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = _loss_and_grads(params, cfg, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].float().numpy(), want[k], err_msg=k, **TOL)
    loss_off, grads_off = _loss_and_grads(params, dataclasses.replace(cfg, remat=False), tb)
    assert torch.equal(loss, loss_off)
    for k, g in grads.items():
        assert torch.equal(g, grads_off[k]), k


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_remat_keeps_the_layer_inputs_only(arch):
    """After ``loss_fn``'s forward with ``remat`` autograd keeps each
    layer's input and the loss chunks' input (the final hidden state),
    within a margin of two more hidden states (the final norm's input and
    its float32 rows) and 32 bytes a token (the ids, their NaN mask, the
    labels and the norm's statistics: 21 bytes); without ``remat`` it keeps
    several times more."""
    cfg, _ = _remat(arch)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), params)
    b, s = 2, 1024
    tb = {k: torch.from_numpy(v) for k, v in syn.lm_batch(np.random.default_rng(4), cfg,
                                                           b, s).items()}
    hidden = b * s * cfg.d_model * 4
    kept = {}
    for on in (True, False):
        with saved_bytes(_storages(params)) as n:
            lm.loss_fn(params, dataclasses.replace(cfg, remat=on), tb)
        kept[on] = n["bytes"]
    assert kept[True] <= (cfg.n_layers + 1) * hidden + 2 * hidden + 32 * b * s
    assert kept[True] >= (cfg.n_layers + 1) * hidden
    assert kept[False] > 3 * kept[True]


def test_no_checkpoint_without_grad(monkeypatch):
    """Under ``no_grad`` and ``inference_mode`` neither ``forward_hidden``
    (with ``remat``) nor ``flash_sdpa`` checkpoints anything."""
    def refuse(*a, **k):
        raise AssertionError("checkpointed without grad")

    monkeypatch.setattr(lm, "checkpoint", refuse)
    monkeypatch.setattr(attention, "checkpoint", refuse)
    cfg, _ = _remat("qwen2-0.5b")
    params = lm.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(5), cfg, 1, 2560)["tokens"])
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            x, _ = lm.forward_hidden(params, cfg, toks)
        assert x.shape == (1, 2560, cfg.d_model) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
def test_prefill_and_decode_ignore_remat(arch):
    """``prefill`` then three ``decode_step``s with a ``remat`` config: the
    same bits and launch counts as without it."""
    cfg_on, _ = _remat(arch)
    cfg_off = dataclasses.replace(cfg_on, remat=False)
    params = lm.init(torch.Generator().manual_seed(2), cfg_on, device="cpu")
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(6), cfg_on, 2, 9)["tokens"])
    runs = []
    for cfg in (cfg_on, cfg_off):
        ops.reset_launch_counts()
        with torch.no_grad():
            logits, caches = lm.prefill(params, cfg, toks[:, :6], 12)
            outs = [logits]
            for t in range(6, 9):
                logits, caches = lm.decode_step(params, cfg, toks[:, t], caches)
                outs.append(logits)
        runs.append((outs, [c[k] for c in caches for k in ("k", "v", "pos")],
                     ops.launch_counts()))
    (outs_on, caches_on, n_on), (outs_off, caches_off, n_off) = runs
    assert n_on == n_off
    for a, b in zip(outs_on + caches_on, outs_off + caches_off):
        assert torch.equal(a, b)
