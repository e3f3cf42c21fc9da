"""The port's LM serving path (prefill, decode_step), dense and
mixture-of-experts, against the JAX package on the CPU: weights initialised
in JAX and converted (compat.from_jax_params), tokens from the same numpy
generator.

float32 throughout, rtol = atol = 1e-4: the JAX decode step attends
through ``_sdpa`` with its ``t <= pos`` mask, the port's through
``ops.decode_attention`` (the plain version of K4 on the CPU) with
``pos + 1``, and the two frameworks' matmuls, exponentials and RoPE angles
round differently in the last bits.  The MoE loss and its gradients are
held at the same tolerance, tests/test_torch_train.py's for the LM.

An MoE config's prefill then decode is not its forward (each call's
capacity depends on its number of tokens, as in the reference), so the
MoE configs are held against the reference call by call and are not in
``test_prefill_then_decode_equals_forward``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data import synthetic as jax_syn
from repro.models import lm as jax_lm
from repro_torch import compat, configs
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.train.microbatch import value_and_grad
from repro_torch.utils import leaves_with_paths

DENSE = ["qwen2-0.5b", "phi3-mini-3.8b", "yi-34b"]
MOE = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(5)
# compiled once per config: op-by-op dispatch of the JAX step costs seconds
jax_prefill = jax.jit(jax_lm.prefill, static_argnums=(1, 3))
jax_decode_step = jax.jit(jax_lm.decode_step, static_argnums=(1,))
jax_value_and_grad = jax.jit(jax.value_and_grad(jax_lm.loss_fn), static_argnums=1)


def _convert(params):
    return compat.from_jax_params(jax.tree.map(np.asarray, params), device="cpu")


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_prefill_and_decode_match_jax(arch):
    """prefill of 6 tokens into caches of 12 slots, then 4 teacher-forced
    decode steps; logits of every step against JAX's.  The decode mask
    (the layer's ``t <= pos`` after its write, the kernel's ``t < pos + 1``)
    is checked end to end here; qwen2-smoke also carries the QKV bias and
    the tied unembedding (``x @ embed.T``).  The MoE smoke configs route
    18 prompt tokens at capacity 5 and each step's 3 at capacity 1
    (8 experts, top-2), so both calls drop assignments."""
    cfg_j = jax_configs.get(arch).smoke_config
    cfg = configs.get(arch).smoke_config
    params_j = jax_lm.init(KEY, cfg_j)
    params = _convert(params_j)
    toks = syn.lm_batch(np.random.default_rng(1), cfg, 3, 10)["tokens"]
    want, caches_j = jax_prefill(params_j, cfg_j, jnp.asarray(toks[:, :6]), 12)
    got, caches = lm.prefill(params, cfg, torch.from_numpy(toks[:, :6]), 12)
    assert got.shape == (3, cfg.vocab) and len(caches) == cfg.n_layers
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    ops.reset_launch_counts()
    for t in range(6, 10):
        want, caches_j = jax_decode_step(params_j, cfg_j, jnp.asarray(toks[:, t]), caches_j)
        got, caches = lm.decode_step(params, cfg, torch.from_numpy(toks[:, t]), caches)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for c, cj in zip(caches, caches_j):
        np.testing.assert_allclose(_np(c["k"]), _np(cj["k"]), **TOL)
        np.testing.assert_allclose(_np(c["v"]), _np(cj["v"]), **TOL)
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(cj["pos"]))
    assert ops.launch_counts()["decode_attention"] == 0        # CPU: the plain version


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_equals_forward(arch):
    """prefill(t[:k]) + decode(t[k]) logits == forward(t[:k+1])'s last
    logits, after tests/test_models.py's LM check."""
    cfg = configs.get(arch).smoke_config
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(0), cfg, 2, 8)["tokens"])
    full = lm.forward(params, cfg, toks)
    pre, caches = lm.prefill(params, cfg, toks[:, :7], 8)
    torch.testing.assert_close(pre, full[:, 6], **TOL)
    dec, caches = lm.decode_step(params, cfg, toks[:, 7], caches)
    torch.testing.assert_close(dec, full[:, 7], **TOL)
    assert caches[0]["pos"].tolist() == [8, 8]


def test_decode_past_the_cache_matches_jax():
    """A step at pos = T drops the write and attends to every slot, as the
    JAX package's functional write does."""
    arch = "yi-34b"
    cfg_j = jax_configs.get(arch).smoke_config
    cfg = configs.get(arch).smoke_config
    params_j = jax_lm.init(KEY, cfg_j)
    params = _convert(params_j)
    toks = syn.lm_batch(np.random.default_rng(2), cfg, 2, 6)["tokens"]
    _, caches_j = jax_prefill(params_j, cfg_j, jnp.asarray(toks[:, :5]), 5)
    _, caches = lm.prefill(params, cfg, torch.from_numpy(toks[:, :5]), 5)
    k_before = caches[0]["k"].clone()
    want, caches_j = jax_decode_step(params_j, cfg_j, jnp.asarray(toks[:, 5]), caches_j)
    got, caches = lm.decode_step(params, cfg, torch.from_numpy(toks[:, 5]), caches)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert torch.equal(caches[0]["k"], k_before)
    assert caches[0]["pos"].tolist() == [6, 6]


def test_stacked_jax_tree_converts_to_a_layer_list():
    """The published configs stack their layers (scan_layers=True): every
    layer leaf has a leading L axis.  compat unstacks it into the port's
    list, and the logits are JAX's."""
    cfg = configs.get("qwen2-0.5b").smoke_config
    cfg_s = dataclasses.replace(jax_configs.get("qwen2-0.5b").smoke_config, scan_layers=True)
    params_s = jax_lm.init(KEY, cfg_s)
    assert isinstance(params_s["layers"], dict)
    params = _convert(params_s)
    assert isinstance(params["layers"], list) and len(params["layers"]) == cfg.n_layers
    assert params["layers"][1]["attn"]["wq"]["b"].shape == (cfg.n_heads * cfg.hd,)
    toks = syn.lm_batch(np.random.default_rng(3), cfg, 2, 7)["tokens"]
    want, _ = jax_lm.forward(params_s, cfg_s, jnp.asarray(toks))
    got = lm.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_configs_and_param_count_match_jax(arch):
    """Every field the port keeps is the JAX package's; the analytic
    parameter counts agree, and so do the trees' sizes at smoke size."""
    for which in ("config", "smoke_config"):
        cfg_j = getattr(jax_configs.get(arch), which)
        cfg = getattr(configs.get(arch), which)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(cfg_j, f.name), (which, f.name)
        assert cfg.param_count == cfg_j.param_count
        assert cfg.active_param_count == cfg_j.active_param_count
    cfg = configs.get(arch).smoke_config
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    n_port = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(jax_lm.init(KEY, jax_configs.get(arch).smoke_config)))
    assert n_port == n_jax
    assert configs.get(arch).family == "lm"


def test_published_qwen2_size():
    """qwen2-0.5b at its published widths: ~494 M parameters, 0.99 GB in
    bfloat16, and a decode_32k KV cache of 51.5 GB."""
    cfg = configs.get("qwen2-0.5b").config
    assert 490e6 < cfg.param_count < 500e6 and cfg.tdtype == torch.bfloat16
    shape = configs.LM_SHAPES["decode_32k"]
    cache_bytes = 2 * cfg.n_layers * shape.global_batch * shape.seq_len * cfg.n_kv_heads * cfg.hd * 2
    assert cache_bytes == 51_539_607_552
    assert configs.FULL_ATTENTION_SKIPS == {"long_500k"}


@pytest.mark.parametrize("batch,seq", [(3, 10), (1, 33)])
def test_lm_batch_matches_jax(batch, seq):
    cfg = configs.get("qwen2-0.5b").smoke_config
    want = jax_syn.lm_batch(np.random.default_rng(9), jax_configs.get("qwen2-0.5b").smoke_config,
                            batch, seq)
    got = syn.lm_batch(np.random.default_rng(9), cfg, batch, seq)
    for key in ("tokens", "labels"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


@pytest.mark.parametrize("arch,seq", [("granite-moe-1b-a400m", 64),
                                      ("granite-moe-1b-a400m", 1024),
                                      ("qwen3-moe-30b-a3b", 64)])
def test_moe_loss_and_grads_match_jax(arch, seq):
    """Cross-entropy plus 0.01 times the layers' auxiliary loss, and every
    leaf's gradient (the router's through the renormalised top-k weights
    and the auxiliary loss), against jax.value_and_grad of the reference's
    loss; S = 1,024 takes the chunked path."""
    cfg_j = jax_configs.get(arch).smoke_config
    cfg = configs.get(arch).smoke_config
    params_j = jax_lm.init(KEY, cfg_j)
    params = _convert(params_j)
    batch = syn.lm_batch(np.random.default_rng(6), cfg, 2, seq)
    want_loss, want_grads = jax_value_and_grad(params_j, cfg_j,
                                               {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b), params, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    got = {k: _np(v.detach()) for k, v in leaves_with_paths(grads)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert np.abs(got["['layers'][0]['moe']['router']['w']"]).max() > 0
    _, aux = lm.forward_hidden(params, cfg, tb["tokens"])
    _, aux_j = jax_lm.forward_hidden(params_j, cfg_j, jnp.asarray(batch["tokens"]))
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6)


def test_stacked_moe_tree_converts_to_a_layer_list():
    """The published MoE configs stack their layers: the router and the
    three expert stacks gain a leading L axis (wg: (L, E, d, f)).  compat
    unstacks them, and the logits are JAX's."""
    arch = "granite-moe-1b-a400m"
    cfg = configs.get(arch).smoke_config
    cfg_s = dataclasses.replace(jax_configs.get(arch).smoke_config, scan_layers=True)
    params_s = jax_lm.init(KEY, cfg_s)
    assert params_s["layers"]["moe"]["wg"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                                     cfg.d_ff)
    params = _convert(params_s)
    assert isinstance(params["layers"], list) and len(params["layers"]) == cfg.n_layers
    moe = params["layers"][1]["moe"]
    assert set(moe) == {"router", "wg", "wu", "wd"}
    assert moe["router"]["w"].shape == (cfg.d_model, cfg.n_experts)
    assert moe["wd"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    np.testing.assert_array_equal(moe["wu"].numpy(), np.asarray(params_s["layers"]["moe"]["wu"][1]))
    toks = syn.lm_batch(np.random.default_rng(3), cfg, 2, 7)["tokens"]
    want, _ = jax_lm.forward(params_s, cfg_s, jnp.asarray(toks))
    got = lm.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_entry_points_need_a_device_or_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = configs.get("qwen2-0.5b").smoke_config
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_caches(cfg, 1, 4)


def test_chunk_nll_picks_the_gathered_bits():
    """The cross-entropy chunk picks each row's label by a mask and a sum
    over the vocabulary: the loss and every gradient the same bits as with
    ``gather`` (the chunk is ``logsumexp(z) − z[label]``, its backward
    written out as ``softmax − one-hot``)."""
    cfg = configs.get("qwen2-0.5b").smoke_config
    params = lm.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))

    def gathered(p, x_):
        z = lm._unembed(p, cfg, x_).float()
        return (torch.logsumexp(z, dim=-1) - z.gather(-1, labels.long()[..., None])[..., 0]).sum()

    runs = []
    for fn in (lambda p, x_: lm._chunk_nll(p, cfg, x_, labels), gathered):
        loss, grads = value_and_grad(lambda a, _: fn(a["p"], a["x"]), {"p": params, "x": x}, None)
        runs.append((loss, dict(leaves_with_paths(grads))))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][k]), k
