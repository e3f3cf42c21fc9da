#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port: the quickest proof that the port
builds its kernels and serves on a card.

    python3 chip_smoke.py            # needs one CUDA GPU and nvcc; ~5 minutes

What it does, one JSON line per phase:

  env            card name and power limit (nvidia-smi), torch/CUDA versions
  build          compiles src/repro_torch/csrc/*.cu with nvcc, seconds taken
  kernel_checks  each hand-written kernel (K1 embedding bag, K2 dot
                 interaction, K3 CIN layer, K4 flash-decode attention)
                 against its plain PyTorch version on the card: the shape x
                 dtype sweep of the CPU tests plus the shapes the models
                 give it, and timings at the DLRM-RMC2 (and for K2 also
                 RMC1/RMC3), xDeepFM and qwen2-0.5b shapes (kernel,
                 bound, plain version, library call)
  parity         forward of every recsys smoke config (paper models and
                 zoo), and prefill + 4 decode steps of every dense LM smoke
                 config, on the card (kernels) against the same weights and
                 inputs on the CPU (plain versions), and the launches each
                 must make
  serve          DLRM-RMC2 at its published size behind ServingRuntime and
                 OnlineController, fed a Poisson stream of production-sized
                 queries; launch counts are zeroed just before and read just
                 after, and must be exactly one K1 and one K2 per request;
                 one request's logits are held against the plain versions
  sched          DeepRecSched on the card: the eight paper models at their
                 published sizes, one at a time; each one's latency curve on
                 the card through the serving worker's steps (pad, copy,
                 forward, wait; median of 20 requests a bucket, exactly its
                 kernels per request, finite logits of the bucket's rows,
                 the DLRMs' against the plain versions) and on the host's
                 CPU, on all its threads and on one; the curve files go to
                 $REPRO_ARTIFACTS, else build/artifacts (never the
                 committed artifacts/); then at the medium SLA, on each CPU
                 curve, the static baseline's queries per second, the
                 tuner's on the CPU alone and the tuner's with the card's
                 curve as the accelerator (simulated, 40 executors)
  zoo            xDeepFM, AutoInt, MIND and BERT4Rec at their published
                 sizes: forward at serve_p99 (batch 512), xDeepFM's
                 bulk_forward, MIND's and BERT4Rec's score_candidates over
                 10^6 candidates, each held against a plain-only run and
                 timed; launch counts zeroed before and read after
  serve_xdeepfm  xDeepFM at its published size behind ServingRuntime at a
                 fixed batch size of 512 (no SLA target exists for it, so
                 no controller); exactly one K1 and three K3 per request
  lm_generate    qwen2-0.5b at its published size (bf16, seeded weights):
                 prefill of 8 prompts of 512 tokens into 1,024-slot caches,
                 then 32 teacher-forced decode steps, each held against the
                 same step with the plain attention on its own caches,
                 beside the library attention's (the bf16 noise's witness);
                 exactly 24 K4 launches a step and no K1-K3; one step with
                 every K4 call held against the plain version, and one with
                 a zeroed attention (the control the logits gate must fail)
  lm_decode_32k  qwen2-0.5b at LM_SHAPES["decode_32k"]: B = 128 against
                 caches of 32,768 slots (51.5 GB) filled from the seed; one
                 step with every K4 call held against the plain version and
                 its logits against the plain, library and zeroed
                 attentions', then 8 decode steps timed against the step's
                 bound; exactly 24 K4 launches a step
  kernels        per kernel: launches over the driven paths, max error, and
                 at its main-path shape its time on the card (CUDA-graph
                 replay, no host time between launches), the host's time for
                 one eager call, the bound, and the plain and library
                 versions' times

then the card line and, last, {"ok": true, "device": {...}}.  Any failed
phase raises: the script exits non-zero and prints no result.  It also
exits non-zero when no CUDA device is present.

    python3 chip_smoke.py --k2-timings   # K2's timing line alone, then stop

times only K2 at the DLRM shapes and prints no result line; a copy of this
script run from another tree's root times that tree's K2 the same way (how
a change is held against its parent on one card).

    python3 chip_smoke.py --k4-timings   # K4's timing line alone, then stop

does the same for K4 at its four shapes (decode_32k at pos = T and with pos
uniform, B = 1 at 32,768 slots, lm_generate's step), with main kernel and
combine timed apart by torch.profiler and other run lengths than the plan's
timed beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.paper_models import PAPER_MODELS, SLA_TARGETS  # noqa: E402
from repro_torch.core import infra  # noqa: E402
from repro_torch.core.infra import card_line  # noqa: E402
from repro_torch.core.query_gen import PRODUCTION, generate_queries, query_stream  # noqa: E402
from repro_torch.core.scheduler import static_baseline, tune  # noqa: E402
from repro_torch.core.simulator import SchedulerConfig, max_qps_under_sla, simulate  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import cin as cin_kernel  # noqa: E402
from repro_torch.kernels import decode_attention as da_kernel  # noqa: E402
from repro_torch.kernels import interaction as ix_kernel  # noqa: E402
from repro_torch.layers import interactions as ix  # noqa: E402
from repro_torch.layers.mlp import linear, mlp  # noqa: E402
from repro_torch.models import lm, recsys  # noqa: E402
from repro_torch.serve.batching import pad_batch  # noqa: E402
from repro_torch.serve.runtime import (OnlineController, ServingRuntime,  # noqa: E402
                                       to_device)

# published peaks of one H100 SXM (NVIDIA data sheet): the bound's yardstick
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12           # dense, on the tensor cores

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}       # rtol = atol, as the CPU sweep
CIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # K3: tests/test_kernels.py's 1e-4
BUCKETS = (1, 4, 16, 64, 256, 1024)
MAIN_BATCHES = (1, 64, 1024)
SERVE_ARCH = "dlrm-rmc2"
ZOO = ("xdeepfm", "autoint", "mind", "bert4rec")
ZOO_BATCHES = (1, 64, 512)                               # 512: RECSYS_SHAPES serve_p99
BULK_ROWS = 65_536              # cut from serve_bulk's 262,144 rows to fit the script's time
BULK_CHUNK = 16_384            # bulk_forward's default; divides BULK_ROWS, so no rounding
KERNELS = ("embedding_bag", "dot_interaction", "cin_layer", "decode_attention")
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # K4: tests/test_kernels.py's values
# the logits of a bf16 LM step through K4 against the same step through the
# plain attention: ||got - want|| / ||want||.  Set between the spread of
# two correct attentions (K4 and the library's, both against the plain one:
# up to 0.037 on an H100) and that of an attention that returns zeros
# (above 1.2), which every run checks the gate would refuse (PERF.md)
LOGITS_L2_TOL = 0.1
# the sched phase: the simulated node's executors, as the reference's
# SchedulerConfig and tune default to (a 40-core CPU)
SCHED_EXECUTORS = 40
LM_ARCH = "qwen2-0.5b"
GEN_BATCH, GEN_PROMPT, GEN_CACHE, GEN_STEPS = 8, 512, 1024, 32
DECODE_32K_STEPS = 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def call_ms(fn, n_iter: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn(i)`` over ``n_iter`` back-to-back eager calls, on the
    device's clock.  For a small kernel this is the host's cost of a call
    (Python wrapper, allocation, launch), not the kernel's run time."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n_iter


def device_ms(fn, n_iter: int = 20, replays: int = 5) -> float:
    """Mean time on the card of ``fn(i)``: ``n_iter`` calls are captured into
    one CUDA graph and the graph is replayed, so no host time between
    launches is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)                                            # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_iter):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (n_iter * replays)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float) -> float:
    """Max abs error; fails unless |got - want| <= atol + rtol*|want| everywhere."""
    if got.is_cuda:
        torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite values")
    err = (g - w).abs()
    if not bool((err <= atol + rtol * w.abs()).all()):
        fail(f"{name}: max abs err {float(err.max()):.3e} outside rtol={rtol}, atol={atol}")
    return float(err.max()) if err.numel() else 0.0


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------- kernel checks


def zipf_ids(rng: np.random.Generator, shape, vocab: int, dev) -> torch.Tensor:
    """int32 ids with the serving data's popularity skew, on the card."""
    return torch.from_numpy(syn._zipf_ids(rng, shape, vocab).astype(np.int32)).to(dev)


def check_embedding_bag(rng, gen, dev, tables32: torch.Tensor) -> tuple[list, float]:
    checks, main_err = [], 0.0
    # the CPU tests' sweep (vocab, batch, hot, dim) x dtype, incl. D = 130 (scalar path)
    for vocab, batch, hot, dim in [(64, 8, 4, 128), (128, 16, 1, 128),
                                   (1000, 8, 16, 256), (37, 4, 3, 130)]:
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn((vocab, dim), generator=gen, device=dev).to(dtype)
            idx = torch.from_numpy(rng.integers(0, vocab, (batch, hot)).astype(np.int32)).to(dev)
            got = ops.embedding_bag(table, idx, check_indices=True)
            err = compare(f"embedding_bag {vocab, batch, hot, dim} {dtype}", got,
                          ref.embedding_bag(table, idx), TOL[dtype], TOL[dtype])
            checks.append({"shape": [vocab, batch, hot, dim], "dtype": str(dtype),
                           "max_abs_err": err, "tol": TOL[dtype]})
    # Kahan accumulation: float32 result against the float64 pooled value
    table = torch.randn((50, 128), generator=gen, device=dev)
    idx = torch.from_numpy(rng.integers(0, 50, (8, 5)).astype(np.int32)).to(dev)
    for mode in ("sum", "mean"):
        want = table.double()[idx.long()].sum(dim=1)
        want = want / idx.shape[1] if mode == "mean" else want
        err = compare(f"embedding_bag {mode} vs float64",
                      ops.embedding_bag(table, idx, mode=mode), want, 1e-5, 1e-6)
        checks.append({"shape": [50, 8, 5, 128], "mode": mode, "against": "float64",
                       "max_abs_err": err, "rtol": 1e-5, "atol": 1e-6})
    # shapes the eight paper models give the stacked form, V = 10^6, Zipf ids
    v = tables32.shape[1]
    tables64 = torch.randn((8, v, 64), generator=gen, device=dev)
    tol = TOL[torch.float32]
    for name, tables, f, h in [("dlrm-rmc1", tables32, 10, 80), ("dlrm-rmc2", tables32, 40, 80),
                               ("dlrm-rmc3", tables32, 10, 20), ("wnd/mt-wnd", tables32, 20, 1),
                               ("ncf", tables64, 4, 1), ("din/dien", tables64, 8, 1)]:
        for batch in MAIN_BATCHES:
            idx = zipf_ids(rng, (batch, f, h), v, dev)
            got = ops.embedding_bag(tables[:f], idx, check_indices=True)
            err = compare(f"embedding_bag {name} B={batch}", got,
                          ref.embedding_bag_stacked(tables[:f], idx), tol, tol)
            main_err = max(main_err, err)
            checks.append({"model": name, "shape": [batch, f, h, tables.shape[2]],
                           "max_abs_err": err, "tol": tol})
    del tables64
    # the zoo's table shapes: xDeepFM's D = 10 (a 40-byte row, the scalar
    # path) and AutoInt's D = 16 (64 bytes, the vector path)
    for name in ("xdeepfm", "autoint"):
        cfg = configs.get(name).config
        tables = torch.randn((cfg.n_tables, cfg.vocab, cfg.embed_dim), generator=gen, device=dev)
        for batch in ZOO_BATCHES:
            idx = zipf_ids(rng, (batch, cfg.n_tables, cfg.hotness), cfg.vocab, dev)
            got = ops.embedding_bag(tables, idx, check_indices=True)
            err = compare(f"embedding_bag {name} B={batch}", got,
                          ref.embedding_bag_stacked(tables, idx), tol, tol)
            checks.append({"model": name, "shape": [batch, cfg.n_tables, cfg.hotness,
                                                    cfg.embed_dim],
                           "max_abs_err": err, "tol": tol})
    return checks, main_err


def check_dot_interaction(gen, dev) -> tuple[list, float]:
    checks, main_err = [], 0.0
    for batch, fields, dim in [(32, 8, 32), (64, 27, 16), (8, 4, 64), (10, 5, 130)]:
        for dtype in (torch.float32, torch.bfloat16):
            feats = (torch.randn((batch, fields, dim), generator=gen, device=dev)
                     / dim ** 0.5).to(dtype)
            for fn, plain in ((ops.dot_interaction, ref.dot_interaction_packed),
                              (ops.gram, ref.gram)):
                err = compare(f"{fn.__name__} {batch, fields, dim} {dtype}", fn(feats),
                              plain(feats), TOL[dtype], TOL[dtype])
                checks.append({"fn": fn.__name__, "shape": [batch, fields, dim],
                               "dtype": str(dtype), "max_abs_err": err, "tol": TOL[dtype]})
    tol = TOL[torch.float32]
    for name, fields in [("dlrm-rmc1/3", 11), ("dlrm-rmc2", 41)]:
        for batch in MAIN_BATCHES:
            feats = torch.randn((batch, fields, 32), generator=gen, device=dev) / 32 ** 0.5
            err = compare(f"dot_interaction {name} B={batch}", ops.dot_interaction(feats),
                          ref.dot_interaction_packed(feats), tol, tol)
            main_err = max(main_err, err)
            checks.append({"model": name, "shape": [batch, fields, 32],
                           "max_abs_err": err, "tol": tol})
    return checks, main_err


def time_embedding_bag(rng, dev, tables: torch.Tensor, batch: int, ids: str,
                       h: int = PAPER_MODELS[SERVE_ARCH].hotness) -> dict:
    """Times at one model's shape (DLRM-RMC2's unless the tables and the
    hotness ``h`` say otherwise).  ``ids`` is 'zipf' (the serving data's
    skew: hot rows repeat and sit in L2) or 'uniform' (every lookup a
    different row, the gather at its coldest).  Eight index sets rotate so
    consecutive launches do not repeat a request."""
    f, v, d = tables.shape
    if ids == "zipf":
        sets = [zipf_ids(rng, (batch, f, h), v, dev) for _ in range(8)]
    else:
        sets = [torch.from_numpy(rng.integers(0, v, (batch, f, h)).astype(np.int32)).to(dev)
                for _ in range(8)]
    # the bound reads every distinct row once (a row looked up twice is still
    # one input row), the indices once, and writes the output once
    offs = (torch.arange(f, device=dev, dtype=torch.int64) * v)[None, :, None]
    flat_sets = [(s.long() + offs).reshape(batch * f, h) for s in sets]
    distinct = statistics.mean(int(torch.unique(fs).numel()) for fs in flat_sets)
    es = tables.element_size()
    out_bytes = batch * f * d * es
    idx_bytes = batch * f * h * 4
    bytes_moved = distinct * d * es + idx_bytes + out_bytes
    gathered_bytes = batch * f * h * d * es + idx_bytes + out_bytes
    flops = 4 * batch * f * h * d                        # Kahan: four adds a row element
    flat_table = tables.view(f * v, d)
    res = {
        "batch": batch, "ids": ids, "distinct_rows": distinct, "lookups": batch * f * h,
        "kernel_ms": device_ms(lambda i: ops.embedding_bag(tables, sets[i % 8])),
        "kernel_call_ms": call_ms(lambda i: ops.embedding_bag(tables, sets[i % 8])),
        "plain_ms": device_ms(lambda i: ref.embedding_bag_stacked(tables, sets[i % 8])),
        "library_ms": device_ms(lambda i: torch.nn.functional.embedding_bag(
            flat_sets[i % 8], flat_table, mode="sum")),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
        else "operations",
        # the same bound if every lookup had to come from device memory
        "gathered_bound_ms": gathered_bytes / HBM_BYTES_PER_S * 1e3,
    }
    return res


def time_dot_interaction(gen, dev, batch: int, arch: str = SERVE_ARCH,
                         other_store: bool = True) -> dict:
    """K2 at one DLRM model's shape (F = 41 for RMC2, 11 for RMC1 and RMC3;
    D = 32, float32).  Eight input sets rotate.  The bound reads the input
    once and writes the packed output once; its operations are 2·D a pair.
    ``other_store`` also times the launch with the plan's store flipped
    (staged in shared memory or straight out), the evidence for the plan's
    choice."""
    f = recsys._num_feature_rows(PAPER_MODELS[arch])
    d = PAPER_MODELS[arch].embed_dim
    sets = [torch.randn((batch, f, d), generator=gen, device=dev) / d ** 0.5 for _ in range(8)]
    pairs = torch.from_numpy(ref.tril_pairs(f)).to(dev)
    n_out = f * (f - 1) // 2
    bytes_moved = batch * (f * d + n_out) * 4
    flops = 2 * batch * n_out * d

    def library(i):
        x = sets[i % 8]
        return torch.bmm(x, x.transpose(1, 2)).reshape(batch, f * f)[:, pairs]

    res = {
        "arch": arch, "batch": batch, "shape": [batch, f, d],
        "kernel_ms": device_ms(lambda i: ops.dot_interaction(sets[i % 8])),
        "kernel_call_ms": call_ms(lambda i: ops.dot_interaction(sets[i % 8])),
        "plain_ms": device_ms(lambda i: ref.dot_interaction_packed(sets[i % 8])),
        "library_ms": device_ms(library),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
        else "operations",
    }
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    if other_store:
        p = ix_kernel.plan(batch, f, d, 4, True, ix_kernel.sm_count(dev.index or 0))
        slab = ix_kernel.slab_bytes(f, d, 4, p.samples)
        flip = (p._replace(stage_at=-1, smem=slab) if p.stage_at >= 0 else
                p._replace(stage_at=-(-slab // 16) * 16,
                           smem=ix_kernel.staged_bytes(f, d, 4, p.samples, n_out)))
        outs = [torch.empty((batch, n_out), device=dev) for _ in range(8)]
        res["plan"] = p._asdict()
        res["other_store_ms"] = device_ms(
            lambda i: ix_kernel.launch(sets[i % 8], outs[i % 8], flip, packed=True))
    return res


def time_dot_interactions(gen, dev, other_store: bool = True) -> list[dict]:
    return [time_dot_interaction(gen, dev, b, arch, other_store)
            for arch in (SERVE_ARCH, "dlrm-rmc1") for b in MAIN_BATCHES]


def cin_inputs(gen, dev, b: int, f: int, h: int, hn: int, d: int,
               dtype=torch.float32) -> tuple:
    """x0, xk at the embeddings' scale and w at init_cin's, on the card."""
    x0 = (torch.randn((b, f, d), generator=gen, device=dev) / d ** 0.5).to(dtype)
    xk = (torch.randn((b, h, d), generator=gen, device=dev) / d ** 0.5).to(dtype)
    w = (torch.randn((h * f, hn), generator=gen, device=dev) / (h * f) ** 0.5).to(dtype)
    return x0, xk, w


def xdeepfm_cin_shapes() -> list[tuple[int, int, int]]:
    """(F, H, Hn) of each of xDeepFM's CIN layers (the last two coincide)."""
    cfg = configs.get("xdeepfm").config
    shapes, h = [], cfg.n_tables
    for hn in cfg.cin_layers:
        shapes.append((cfg.n_tables, h, hn))
        h = hn
    return sorted(set(shapes))


def cin_float64_bound(k: int) -> float:
    """The factor c of K3's float64 check, |got - exact| <= c · Σ|xk·x0·w|
    at K = H·F.  Per term: the product a = xk·x0 is rounded once to float32
    (2^-24 |term|); a = a_hi + a_lo + δa and w = w_hi + w_lo + δw, with
    x_hi = tf32(x), x_lo = tf32(x - x_hi) (10 mantissa bits each, round to
    nearest: |x - x_hi| <= 2^-11 |x|, |δx| <= 2^-11 |x - x_hi| <= 2^-22 |x|);
    the dropped a_lo·w_lo and the two remainders a·δw, δa·w are each at most
    2^-22 |a·w|, so the three passes represent a term within
    (3·2^-22 + 2^-24)(1 + 2^-10) of it.  Their products are exact in
    float32 (11 by 11 bits); the tensor cores add them 3K times into the
    accumulator (and a split adds its runs' sums once more each, fewer
    than K additions), each addition with at most 2^-23 relative error (the
    adder aligns by truncation): gamma_4K with u = 2^-23."""
    u = 2.0 ** -23
    gamma = 4 * k * u / (1 - 4 * k * u)
    return (3 * 2.0 ** -22 + 2.0 ** -24) * (1 + 2.0 ** -10) + gamma


def one_pass_tf32(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The witness: the CIN layer as one TF32 pass (the materialised
    (B·D, H·F) products times w through cuBLAS with TF32 allowed, here and
    nowhere else), the result a lost lo pass would give."""
    b, f, d = x0.shape
    h, n = xk.shape[1], w.shape[1]
    a = torch.einsum("bhd,bfd->bdhf", xk, x0).reshape(b * d, h * f)
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = torch.matmul(a, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    return out.reshape(b, d, n).transpose(1, 2)


def check_cin_layer(gen, dev) -> tuple[list, float]:
    """K3 against ref.cin_layer: float32 within 1e-4 and bfloat16 within
    2e-2 (rtol = atol).  At xDeepFM's full K = H·F = 7800, float32, also:
    against the float64 value within ``cin_float64_bound``'s c · Σ|terms|,
    and, for the history, the share of the bound a float32 recursive sum
    was held to before K3 ran on the tensor cores (gamma_{K+1}, u = 2^-24);
    a second launch on the same inputs gives the same bits (B = 1, K split
    over blocks, and B = 512); and at B = 512 the one-pass TF32 witness is
    at least 10× further from the float64 value than K3, which shows the
    check can see a lost pass."""
    checks, main_err = [], 0.0
    d_xdfm = configs.get("xdeepfm").config.embed_dim
    k_max = max(hh * ff for ff, hh, _ in xdeepfm_cin_shapes())
    sweep = [((b, f, h, hn, d), False) for b, f, h, hn, d in
             [(8, 6, 5, 7, 128), (16, 10, 10, 4, 64), (4, 3, 8, 16, 130)]]
    sweep += [((b, f, h, hn, d_xdfm), True) for b in ZOO_BATCHES
              for f, h, hn in xdeepfm_cin_shapes()]
    for (b, f, h, hn, d), main in sweep:
        for dtype in (torch.float32, torch.bfloat16):
            x0, xk, w = cin_inputs(gen, dev, b, f, h, hn, d, dtype)
            tol = CIN_TOL[dtype]
            got = ops.cin_layer(x0, xk, w)
            err = compare(f"cin_layer {b, f, h, hn, d} {dtype}", got, ref.cin_layer(x0, xk, w),
                          tol, tol)
            row = {"shape": [b, f, h, hn, d], "dtype": str(dtype), "max_abs_err": err,
                   "tol": tol}
            if main and dtype == torch.float32:
                main_err = max(main_err, err)
            if main and dtype == torch.float32 and h * f == k_max:
                k = h * f
                exact = ref.cin_layer(x0.double(), xk.double(), w.double())
                mag = ref.cin_layer(x0.double().abs(), xk.double().abs(), w.double().abs())
                dev64 = (got.double() - exact).abs()
                bound = cin_float64_bound(k)
                if not bool((dev64 <= bound * mag).all()):
                    fail(f"cin_layer {b, f, h, hn, d}: float32 result outside "
                         f"{bound:.3e}·Σ|terms| of the float64 value")
                u = 2.0 ** -24
                gamma_old = (k + 1) * u / (1 - (k + 1) * u)
                row.update({"against_float64_max_abs_err": float(dev64.max()),
                            "float64_bound": f"{bound:.4e}*sum|xk*x0*w| (3xTF32: "
                                             f"(3*2^-22+2^-24)(1+2^-10) + gamma_4K, u=2^-23)",
                            "largest_share_of_bound": float((dev64 / (bound * mag)).max()),
                            "largest_share_of_fp32_bound": float((dev64 / (gamma_old * mag)).max()),
                            "fp32_bound": f"gamma_{k + 1}*sum|xk*x0*w|, u=2^-24"})
                again = ops.cin_layer(x0, xk, w)
                torch.cuda.synchronize()
                if b in (1, ZOO_BATCHES[-1]):
                    if not torch.equal(again, got):
                        fail(f"cin_layer {b, f, h, hn, d}: a second launch gave other bits")
                    row["same_bits_on_relaunch"] = True
                if b == ZOO_BATCHES[-1]:
                    one = (one_pass_tf32(x0, xk, w).double() - exact).abs().max()
                    ratio = float(one) / max(float(dev64.max()), 1e-30)
                    if ratio < 10:
                        fail(f"cin_layer {b, f, h, hn, d}: the one-pass TF32 witness is only "
                             f"{ratio:.2f}x further from float64 than K3 (needs 10x)")
                    row.update({"one_pass_tf32_against_float64_max_abs_err": float(one),
                                "witness_ratio": ratio})
                del exact, mag, dev64
            checks.append(row)
    return checks, main_err


def time_cin_layer(gen, dev, b: int, f: int, h: int, hn: int, d: int) -> dict:
    """K3 at one layer's shape.  Four input sets rotate; w is one matrix
    (a model has one per layer), read again by every block from L2.  The
    bound is the 3xTF32 tensor-core one, max(bytes / 3.35e12, 3·2·M·K·N /
    495e12); the float32 CUDA-core bound the first K3 was held to is kept
    beside it.  ``prepass_ms`` times K3's pre-pass (w into TF32 planes)
    alone; in a launch the main kernel starts while it runs, so its share
    is an upper bound."""
    sets = [cin_inputs(gen, dev, b, f, h, hn, d) for _ in range(4)]
    w = sets[0][2]
    k = h * f
    flops = 2 * b * d * k * hn + b * d * k          # the FMAs, plus forming each product once
    tc_flops = 3 * 2 * b * d * k * hn               # three TF32 passes on the tensor cores
    bytes_moved = (b * f * d + b * h * d + k * hn + b * hn * d) * 4

    def kernel(i):
        return ops.cin_layer(sets[i % 4][0], sets[i % 4][1], w)

    def plain(i):
        return ref.cin_layer(sets[i % 4][0], sets[i % 4][1], w)

    def materialised(i):
        x0, xk, _ = sets[i % 4]
        return torch.einsum("bhd,bfd->bdhf", xk, x0).reshape(b * d, k)

    a0 = materialised(0)
    res = {
        "shape": [b, f, h, hn, d], "flops": flops, "tensor_core_flops": tc_flops,
        "bytes": bytes_moved, "splits": cin_kernel.plan(
            b, f, h, hn, d, torch.cuda.get_device_properties(dev).multi_processor_count)[0],
        "kernel_ms": device_ms(kernel), "kernel_call_ms": call_ms(kernel),
        "prepass_ms": device_ms(lambda i: cin_kernel.split_w(w)),
        "plain_ms": device_ms(plain),
        # the library reference: the (B·D, H·F) operand materialised, then
        # one cuBLAS SGEMM with w (TF32 off, as device.py sets it)
        "library_ms": device_ms(lambda i: torch.matmul(materialised(i), w)),
        "library_matmul_only_ms": device_ms(lambda i: torch.matmul(a0, w)),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, tc_flops / TF32_FLOP_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= tc_flops / TF32_FLOP_PER_S
        else "operations",
        "bound_of": "3xTF32 tensor-core operations at 495 TFLOP/s, or bytes at 3.35 TB/s",
        "fp32_cuda_core_bound_ms": max(bytes_moved / HBM_BYTES_PER_S,
                                       flops / FP32_FLOP_PER_S) * 1e3,
    }
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    res["prepass_share"] = res["prepass_ms"] / res["kernel_ms"]
    return res


def decode_inputs(gen, dev, b: int, hq: int, hkv: int, d: int, t: int,
                  dtype=torch.bfloat16) -> tuple:
    """q (B, Hq, D), k and v (B, T, Hkv, D) of unit normals, on the card."""
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def decode_positions(rng, b: int, t: int, kind, dev) -> torch.Tensor:
    """pos (B,) int32 on the card: 'uniform' in [1, T], 'runs' one slot
    either side of and on K4's run boundaries (sequence i at
    (i // 3 + 1)·run_slots + i % 3 - 1, within [1, T]), or one value for all."""
    if kind == "uniform":
        pos = rng.integers(1, t + 1, size=b)
    elif kind == "runs":
        run = k4_run_slots(b, t, *k4_heads())
        pos = np.clip([(i // 3 + 1) * run + i % 3 - 1 for i in range(b)], 1, t)
    else:
        pos = np.full(b, kind)
    return torch.from_numpy(np.asarray(pos).astype(np.int32)).to(dev)


def k4_heads() -> tuple[int, int, int]:
    """(Hq, Hkv, D) of the main path's K4: qwen2-0.5b's heads."""
    cfg = configs.get(LM_ARCH).config
    return cfg.n_heads, cfg.n_kv_heads, cfg.hd


def k4_run_slots(b: int, t: int, hq: int, hkv: int, d: int, element_size: int = 2) -> int | None:
    """K4's run length on this card at a shape (None for a tree whose K4
    has no plan: the copy of this script timing a parent's kernel)."""
    if not hasattr(da_kernel, "plan"):
        return None
    return da_kernel.plan(b, hkv, t, d, element_size,
                          torch.cuda.get_device_properties(0).multi_processor_count).run_slots


def same_bits(name: str, q, k, v, pos) -> None:
    """K4 gives the same bits on a second eager call and on a CUDA graph's
    replay (no atomics, and the combine's order is fixed)."""
    first = ops.decode_attention(q, k, v, pos)
    if not torch.equal(ops.decode_attention(q, k, v, pos), first):
        fail(f"{name}: a second launch gave other bits")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, pos)               # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.decode_attention(q, k, v, pos)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(replayed, first):
        fail(f"{name}: a CUDA graph's replay gave other bits")


def decode_compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """K4 against its plain version: rtol the JAX sweep's value for the
    dtype, atol the same times the plain result's largest magnitude (never
    more than the sweep's atol).  At a long cache every output is far below
    1 (unit normals over 32,768 slots: ~0.01), so a fixed atol would pass
    a kernel that zeroes its output or drops a run of slots; this does not."""
    tol = DECODE_TOL[want.dtype]
    return compare(name, got, want, tol, tol * min(1.0, float(want.abs().max())))


def check_decode_attention(rng, gen, dev) -> tuple[list, float]:
    """K4 against ref.decode_attention (``decode_compare``: float32 1e-4,
    bfloat16 3e-2), each shape at pos uniform in [1, T] and at 0, 1 and T;
    the main path's long caches (decode_32k, and B = 1, split into runs)
    in float32; at qwen2-0.5b's heads also pos on and one slot either side
    of the run boundaries, and the same bits on a second launch and on a
    CUDA graph's replay where the slots are split into runs.  Returns the
    checks and the largest error at qwen2-0.5b's heads (G = 7, D = 64) in
    bfloat16, the main path's."""
    checks, main_err = [], 0.0
    qwen = configs.get(LM_ARCH).config
    t32k = configs.LM_SHAPES["decode_32k"]
    shapes = [("test_kernels", 2, 8, 2, 64, 256), ("test_kernels", 4, 4, 4, 32, 128),
              ("test_kernels", 1, 16, 8, 128, 512),
              (LM_ARCH, GEN_BATCH, qwen.n_heads, qwen.n_kv_heads, qwen.hd, GEN_CACHE),
              (LM_ARCH, 3, qwen.n_heads, qwen.n_kv_heads, qwen.hd, 1000),    # T not a tile multiple
              (LM_ARCH, 3, qwen.n_heads, qwen.n_kv_heads, qwen.hd, 1)]       # T = 1
    for name in ("qwen2-0.5b", "phi3-mini-3.8b", "yi-34b"):                 # D 8, 16 and phi3's 96
        for cfg in (configs.get(name).smoke_config, configs.get(name).config):
            if cfg.hd != qwen.hd:
                shapes.append((cfg.name, 5, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 77))
    dtypes = {s: (torch.float32, torch.bfloat16) for s in shapes}
    for b in (t32k.global_batch, 1):          # bf16 here: time_decode_attention's checks
        dtypes[("decode_32k", b, qwen.n_heads, qwen.n_kv_heads, qwen.hd, t32k.seq_len)] = (
            torch.float32,)
    for (name, b, hq, hkv, d, t), kinds in dtypes.items():
        for dtype in kinds:
            q, k, v = decode_inputs(gen, dev, b, hq, hkv, d, t, dtype)
            positions = ("uniform", 0, 1, t) + (("runs",) if (hq, hkv, d) == k4_heads() else ())
            for kind in positions:
                pos = decode_positions(rng, b, t, kind, dev)
                want = ref.decode_attention(q, k, v, pos)
                err = decode_compare(f"decode_attention {name} {b, hq, hkv, d, t} pos={kind} "
                                     f"{dtype}", ops.decode_attention(q, k, v, pos), want)
                checks.append({"shape": [b, hq, hkv, d, t], "from": name, "pos": kind,
                               "dtype": str(dtype), "max_abs_err": err,
                               "max_abs_want": float(want.abs().max()),
                               "tol": DECODE_TOL[dtype]})
                if name == LM_ARCH and dtype == torch.bfloat16:
                    main_err = max(main_err, err)
                run = k4_run_slots(b, t, hq, hkv, d, q.element_size())
                if kind in ("uniform", "runs") and run is not None and run < t:
                    same_bits(f"decode_attention {name} {b, hq, hkv, d, t} pos={kind} {dtype}",
                              q, k, v, pos)
            del q, k, v
    return checks, main_err


def decode_mask(t: int, pos: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1, T) boolean: slot t of sequence b is attended iff t < pos[b]."""
    return (torch.arange(t, device=pos.device)[None] < pos[:, None])[:, None, None]


def library_decode(q, k, v, pos, mask=None) -> torch.Tensor:
    """ref.decode_attention as one PyTorch library call: each KV head's G
    query heads as G query rows, on transposed views of the cache.  A
    yardstick and a witness, used nowhere in the port; pos >= 1 (a row
    with every slot masked gives NaN here, not the mean of V)."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.view(b, hkv, hq // hkv, d), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=decode_mask(t, pos) if mask is None else mask)
    return out.reshape(b, hq, d)


def kernel_device_ms(fn, names: tuple[str, ...], n_iter: int = 20) -> dict:
    """Device time of a call's kernels by name, from torch.profiler over
    ``n_iter`` eager calls: the mean per call of every kernel whose name
    holds each of ``names`` (0.0 for one not launched; None for all when two
    traces saw no device time).  A programmatic dependent's time runs from
    its launch, so it overlaps the tail of the kernel before it."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n_iter):
                fn(i)
            torch.cuda.synchronize()
        us = dict.fromkeys(names, 0.0)
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            t = getattr(e, "cuda_time_total", 0.0) if t is None else t
            for name in names:
                if name in e.key:
                    us[name] += t
        if any(us.values()):
            return {name: t / 1e3 / n_iter for name, t in us.items()}
    return dict.fromkeys(names)


def k4_shapes() -> list[tuple]:
    """K4's timed shapes, (name, B, T, pos, cache sets): decode_32k at full
    caches (the kernels line's main row) and with pos uniform in [1, T],
    B = 1 at T = 32,768, and lm_generate's step halfway (last).  Rotating
    sets keep small shapes' K/V out of the 50 MB L2, as a step's 24 layers do."""
    t32k = configs.LM_SHAPES["decode_32k"]
    return [("decode_32k", t32k.global_batch, t32k.seq_len, t32k.seq_len, 1),
            ("decode_32k_uniform", t32k.global_batch, t32k.seq_len, "uniform", 1),
            ("b1_32k", 1, t32k.seq_len, t32k.seq_len, 8),
            ("lm_generate", GEN_BATCH, GEN_CACHE, GEN_PROMPT + GEN_STEPS // 2, 24)]


# run lengths timed beside the plan's by --k4-timings, at each shape's T
K4_OTHER_RUNS = {1024: (32, 64, 128, 256, 1024),
                 32768: (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)}


def time_decode_attention(seed: int, gen, dev, name: str, b: int, t: int, pos_kind,
                          n_sets: int = 1, other_runs: bool = False) -> dict:
    """K4 at qwen2-0.5b's heads, bf16, B sequences against T slots.
    ``n_sets`` caches rotate so that consecutive launches do not find the
    last one's K/V in the 50 MB L2 (a decode step reads 24 layers' caches
    in turn).  pos comes from its own generator of ``seed``, so every run
    of the script times the same positions.  The bound reads K and V up to
    each sequence's pos once, q and pos once, and writes the output once;
    its operations are 4·Hq·D per valid slot (q·k and p·v).  Main kernel
    and combine are timed apart by torch.profiler; ``other_runs`` also
    times other run lengths than the plan's (the evidence for the plan)."""
    hq, hkv, d = k4_heads()
    sets = [decode_inputs(gen, dev, b, hq, hkv, d, t) for _ in range(n_sets)]
    pos = decode_positions(np.random.default_rng(seed), b, t, pos_kind, dev)
    n_valid = int(pos.clamp(max=t).sum())
    es = sets[0][0].element_size()
    bytes_moved = n_valid * hkv * d * es * 2 + 2 * b * hq * d * es + 4 * b
    flops = 4 * n_valid * hq * d
    mask = decode_mask(t, pos)

    def kernel(i):
        q, k, v = sets[i % n_sets]
        return ops.decode_attention(q, k, v, pos)

    def plain(i):
        q, k, v = sets[i % n_sets]
        return ref.decode_attention(q, k, v, pos)

    def library(i):
        q, k, v = sets[i % n_sets]
        return library_decode(q, k, v, pos, mask)

    err = decode_compare(f"decode_attention timing shape B={b} T={t} pos={pos_kind}",
                         kernel(0), plain(0))
    lib_err = float((library(0).float() - plain(0).float()).abs().max())
    big = b * t >= 1 << 20                               # the plain version moves GBs a call
    split = kernel_device_ms(kernel, ("decode_attention_kernel", "decode_attention_combine"),
                             n_iter=max(20, n_sets))
    res = {
        "name": name, "batch": b, "slots": t, "pos": pos_kind, "valid_slots": n_valid,
        "bytes": bytes_moved, "flops": flops, "run_slots": k4_run_slots(b, t, hq, hkv, d, es),
        "max_abs_err_vs_plain": err, "library_max_abs_err_vs_plain": lib_err,
        "kernel_ms": device_ms(kernel, n_iter=max(20, n_sets)),
        "kernel_call_ms": call_ms(kernel, n_iter=max(20, n_sets)),
        "main_ms": split["decode_attention_kernel"],
        "combine_ms": split["decode_attention_combine"],
        "plain_ms": device_ms(plain, n_iter=3 if big else 20, replays=2 if big else 5),
        "library_ms": device_ms(library, n_iter=5 if big else 20, replays=2 if big else 5),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
        else "operations",
    }
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    res["achieved_tb_per_s"] = bytes_moved / res["kernel_ms"] / 1e9
    if other_runs and res["run_slots"] is not None:
        outs = [torch.empty_like(s[0]) for s in sets]
        cuts = {run: da_kernel.cut(b, hkv, t, d, es, run)
                for run in K4_OTHER_RUNS.get(t, ()) if run != res["run_slots"]}
        res["other_runs_ms"] = {
            run: device_ms(lambda i, c=c: da_kernel.launch(*sets[i % n_sets], pos,
                                                           outs[i % n_sets], c),
                           n_iter=max(20, n_sets))
            for run, c in cuts.items()}
    del sets
    return res


def time_decode_attentions(seed: int, gen, dev, other_runs: bool = False) -> list[dict]:
    return [time_decode_attention(seed, gen, dev, name, b, t, pos, n_sets, other_runs)
            for name, b, t, pos, n_sets in k4_shapes()]


# ----------------------------------------------------------------------- parity


def forward_launches(cfg) -> dict[str, int]:
    """The launches one ``recsys.forward`` of ``cfg`` makes on the card: K1
    once for the sparse fields (sum/mean pooling), K2 once for the DLRM dot
    interaction, K3 once per CIN layer."""
    return {"embedding_bag": int(bool(cfg.n_tables) and cfg.pooling in ("sum", "mean")),
            "dot_interaction": int(cfg.interaction == "dot"),
            "cin_layer": len(cfg.cin_layers) if cfg.interaction == "cin" else 0,
            "decode_attention": 0}


def decode_launches(cfg, steps: int) -> dict[str, int]:
    """The launches ``steps`` decode steps of an LM make: K4 once per layer
    a step, nothing else (prefill runs no kernel)."""
    return {**dict.fromkeys(KERNELS, 0), "decode_attention": cfg.n_layers * steps}


def check_parity(seed: int, dev) -> list:
    """Smoke configs: kernels on the card against plain versions on the CPU.
    float32, rtol = atol = 1e-4: the two sum in different orders (Kahan in
    index order against torch.sum; cuBLAS against the CPU's matmul)."""
    rows = []
    for name in configs.list_archs("recsys"):
        cfg = configs.get(name).smoke_config
        cpu_params = recsys.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
        batch = syn.recsys_batch(np.random.default_rng(seed), cfg, 13, with_label=False)
        want = recsys.forward(cpu_params, cfg, to_device(batch, torch.device("cpu")))
        ops.reset_launch_counts()
        got = recsys.forward(tree_to(cpu_params, dev), cfg, to_device(batch, dev))
        err = compare(f"parity {cfg.name}", got.cpu(), want, 1e-4, 1e-4)
        launches = ops.launch_counts()
        if launches != forward_launches(cfg):
            fail(f"parity {cfg.name}: forward on the card launched {launches}, "
                 f"expected {forward_launches(cfg)}")
        rows.append({"config": cfg.name, "shape": list(got.shape), "max_abs_err": err,
                     "launches": launches})
    for name in configs.list_archs("lm"):
        rows.append(check_lm_parity(seed, dev, configs.get(name).smoke_config))
    return rows


def check_lm_parity(seed: int, dev, cfg, prompt: int = 6, steps: int = 4) -> dict:
    """prefill + ``steps`` teacher-forced decode steps of an LM smoke
    config on the card (K4) against the CPU (plain attention), float32,
    rtol = atol = 1e-4; K4 launches must be exactly n_layers × steps."""
    cpu_params = lm.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(seed), cfg, 3,
                                         prompt + steps)["tokens"])
    want, caches = lm.prefill(cpu_params, cfg, toks[:, :prompt], prompt + steps)
    wants = [want]
    for i in range(steps):
        want, caches = lm.decode_step(cpu_params, cfg, toks[:, prompt + i], caches)
        wants.append(want)
    params, toks = tree_to(cpu_params, dev), toks.to(dev)
    ops.reset_launch_counts()
    got, caches = lm.prefill(params, cfg, toks[:, :prompt], prompt + steps)
    gots = [got]
    for i in range(steps):
        got, caches = lm.decode_step(params, cfg, toks[:, prompt + i], caches)
        gots.append(got)
    launches = ops.launch_counts()
    err = max(compare(f"parity {cfg.name} step {i}", g.cpu(), w, 1e-4, 1e-4)
              for i, (g, w) in enumerate(zip(gots, wants)))
    if launches != decode_launches(cfg, steps):
        fail(f"parity {cfg.name}: prefill + {steps} steps launched {launches}, "
             f"expected {decode_launches(cfg, steps)}")
    return {"config": cfg.name, "prefill": prompt, "decode_steps": steps, "max_abs_err": err,
            "launches": launches}


# ------------------------------------------------------------------------ serve


def plain_forward_dot(params, cfg, batch: dict) -> torch.Tensor:
    """DLRM forward through the plain versions only (no kernel launch)."""
    dense = mlp(params["dense_mlp"], batch["dense"], act="relu", final_act="relu")
    emb = ref.embedding_bag_stacked(params["tables"], batch["sparse"], mode=cfg.pooling)
    feats = torch.cat([dense[:, None, :], emb], dim=1)
    z = torch.cat([ref.dot_interaction_packed(feats), dense], dim=-1)
    return mlp(params["predict"][0], z, act="relu")[..., 0]


def plain_forward_cin(params, cfg, batch: dict) -> torch.Tensor:
    """xDeepFM forward through the plain versions only (no kernel launch)."""
    emb = ref.embedding_bag_stacked(params["tables"], batch["sparse"], mode=cfg.pooling)
    outs, xk = [], emb
    for w in params["cin"]:
        xk = ref.cin_layer(emb, xk, w)
        outs.append(xk.sum(dim=-1))
    logit_cin = linear(params["cin_linear"], torch.cat(outs, dim=-1))[..., 0]
    logit_dnn = mlp(params["dnn"], emb.reshape(emb.shape[0], -1), act="relu")[..., 0]
    logit_lin = torch.einsum("bfd,f->b", emb, params["lin_w"]) / cfg.embed_dim
    return logit_cin + logit_dnn + logit_lin


def plain_forward_autoint(params, cfg, batch: dict) -> torch.Tensor:
    """AutoInt forward through the plain versions only (no kernel launch)."""
    x = ref.embedding_bag_stacked(params["tables"], batch["sparse"], mode=cfg.pooling)
    for lp in params["attn"]:
        x = ix.autoint_layer(lp, x, n_heads=cfg.n_heads, d_attn=cfg.d_attn)
    return mlp(params["predict"][0], x.reshape(x.shape[0], -1), act="relu")[..., 0]


PLAIN_FORWARD = {"dot": plain_forward_dot, "cin": plain_forward_cin,
                 "self-attn": plain_forward_autoint}


def serve(seed: int, dev, params, cfg, *, qps: float, seconds: float, batch_size: int,
          sla_ms: float | None = None, curve: bool = False) -> dict:
    """``cfg`` at its published size behind ServingRuntime (2 workers),
    fed ``query_stream`` for ``seconds``; an OnlineController climbs the
    batch size when the model has an SLA target.  Launch counts are zeroed
    just before the stream and read just after; they must be exactly
    ``forward_launches(cfg)`` per request, so only the kernels this path
    runs are required.  With ``curve``, one request per bucket is timed
    through the worker's steps."""
    rng = np.random.default_rng(seed)
    # one pool of Zipf-id items made up front; a query is a window of it, so
    # the feeder thread paces arrivals instead of generating data
    pool_n = 8192
    pool = syn.recsys_batch(rng, cfg, pool_n, with_label=False)

    def query_batch(size: int) -> dict:
        lo = int(rng.integers(0, pool_n - size + 1))
        return {k: v[lo:lo + size] for k, v in pool.items()}

    def forward(batch: dict) -> torch.Tensor:
        return recsys.forward(params, cfg, batch)

    n_requests, lock = [0], threading.Lock()

    def apply_fn(batch: dict) -> torch.Tensor:
        with lock:
            n_requests[0] += 1
        return forward(batch)

    # one request's logits against the plain versions, and a warm-up of cuBLAS
    probe = to_device(pad_batch(query_batch(200), 256), dev)
    logit_err = compare(f"serve {cfg.name} logits vs plain", forward(probe),
                        PLAIN_FORWARD[cfg.interaction](params, cfg, probe), 1e-4, 1e-4)

    rt = ServingRuntime(apply_fn, n_workers=2, batch_size=batch_size, device=dev)
    ctl = None if sla_ms is None else OnlineController(rt, sla_ms=sla_ms, window=50)
    ops.reset_launch_counts()
    n_submitted = 0
    t0 = time.monotonic()
    try:
        for q in query_stream(seed, qps=qps, size_dist=PRODUCTION):
            if q.arrival > seconds:
                break
            delay = q.arrival - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            rt.submit(q.qid, query_batch(q.size), q.size)
            n_submitted += 1
            if ctl is not None:
                ctl.step()
        rt.drain(timeout=120)
        wall = time.monotonic() - t0
        done = rt.completed()
    finally:
        rt.shutdown()
    launches = ops.launch_counts()

    errors = [r.error for r in done if r.error is not None]
    if errors:
        fail(f"serve {cfg.name}: {len(errors)} queries errored, first: {errors[0]}")
    if len(done) != n_submitted or n_submitted == 0:
        fail(f"serve {cfg.name}: {len(done)} of {n_submitted} queries completed")
    want = {k: n * n_requests[0] for k, n in forward_launches(cfg).items()}
    if launches != want:
        fail(f"serve {cfg.name}: {n_requests[0]} requests launched {launches}, expected {want}")
    lats = [r.latency_ms for r in done]
    if not all(np.isfinite(lats)) or min(lats) <= 0:
        fail(f"serve {cfg.name}: non-positive or non-finite latencies")

    out = {"phase": "serve" if curve else f"serve_{cfg.name}", "arch": cfg.name,
           "qps_offered": qps, "seconds": wall, "queries": len(done),
           "items": int(sum(r.size for r in done)), "requests": n_requests[0], "errors": 0,
           "p50_ms": float(np.percentile(lats, 50)), "p95_ms": float(np.percentile(lats, 95)),
           "sla_ms": sla_ms, "batch_size": batch_size, "final_batch_size": rt.batch_size,
           "controller_history": None if ctl is None else ctl.history, "launches": launches,
           "logits_max_abs_err_vs_plain": logit_err}
    if not curve:
        return out

    # median request latency per bucket through the worker's own steps, each
    # on the host's clock: pad on the host, move to the card, forward and
    # wait for the device (a one-item query pads nothing: 3 items into 4 do)
    medians, steps = {}, {}
    for bucket in BUCKETS:
        ts = []
        for _ in range(12):
            req = query_batch(max(1, bucket * 3 // 4))
            t0 = time.monotonic()
            padded = pad_batch(req, bucket)
            t1 = time.monotonic()
            on_card = to_device(padded, dev)
            torch.cuda.synchronize()
            t2 = time.monotonic()
            res = forward(on_card)
            torch.cuda.synchronize()
            t3 = time.monotonic()
            ts.append(((t3 - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        if res.shape != (bucket,) or not bool(torch.isfinite(res).all()):
            fail(f"serve: bucket {bucket} gave shape {tuple(res.shape)} or non-finite logits")
        total, pad, copy, fwd = (statistics.median(col) for col in zip(*ts[2:]))
        medians[str(bucket)] = total
        steps[str(bucket)] = {"pad_ms": pad, "copy_ms": copy, "forward_ms": fwd}
    out.update({"bucket_median_ms": medians, "bucket_steps_ms": steps})
    return out


# ------------------------------------------------------------------------ sched


def check_curve(name: str, ms: dict) -> None:
    """A latency curve in ms by bucket: every bucket of ``BUCKETS`` there,
    nothing else, each finite and positive."""
    if sorted(ms) != list(BUCKETS):
        fail(f"{name}: curve has buckets {sorted(ms)}, expected {list(BUCKETS)}")
    bad = {b: v for b, v in ms.items() if not (np.isfinite(v) and v > 0)}
    if bad:
        fail(f"{name}: non-finite or non-positive latencies {bad}")


def monotone(ms: dict) -> bool:
    """True when the curve never falls from one bucket to the next.  The
    tuner's climb stops at the first bump, so a curve that is not monotone
    is flagged, not smoothed."""
    v = [ms[b] for b in sorted(ms)]
    return all(a <= b for a, b in zip(v, v[1:]))


def sched_artifacts() -> Path:
    """Where the sched phase writes its curve files: ``$REPRO_ARTIFACTS``
    when the caller names it, else ``build/artifacts`` in the checkout
    (git-ignored), so a run never rewrites the committed curves."""
    named = os.environ.get("REPRO_ARTIFACTS")
    return Path(named) if named else Path(__file__).resolve().parent / "build" / "artifacts"


def tune_three(arch: str, cpu, card, sla: float, seed: int) -> dict:
    """At ``sla``: the static baseline's capacity, the tuner's on the CPU
    executors alone and the tuner's with ``card`` as the accelerator, with
    the card's share of the work at 70 % of the last one's capacity."""
    b0 = static_baseline(1000, SCHED_EXECUTORS)
    q0 = max_qps_under_sla(cpu, SchedulerConfig(batch_size=b0, n_executors=SCHED_EXECUTORS),
                           sla)
    cpu_only = tune(cpu, sla, n_executors=SCHED_EXECUTORS)
    with_card = tune(cpu, sla, accel=card, n_executors=SCHED_EXECUTORS)
    for what, q in (("static", q0), ("cpu_only", cpu_only.qps), ("with_card", with_card.qps)):
        if not (np.isfinite(q) and q > 0):
            fail(f"sched {arch}: {what} capacity {q} QPS")
    at70 = simulate(generate_queries(np.random.default_rng(seed), 0.7 * with_card.qps, 3000),
                    cpu, SchedulerConfig(batch_size=with_card.batch_size,
                                         offload_threshold=with_card.offload_threshold,
                                         n_executors=SCHED_EXECUTORS),
                    accel=card)
    return {"static": {"batch": b0, "qps": q0},
            "cpu_only": {"batch": cpu_only.batch_size, "qps": cpu_only.qps},
            "with_card": {"batch": with_card.batch_size,
                          "threshold": with_card.offload_threshold, "qps": with_card.qps,
                          "accel_frac_work_at_70pct": at70.accel_frac_work,
                          "p95_ms_at_70pct": at70.p95_ms},
            # the reference's rule at work on a bumpy CPU curve: reported, not refused
            "tuned_below_static": min(cpu_only.qps, with_card.qps) < q0}


def sched(seed: int, dev) -> dict:
    """DeepRecSched on the card: for each of the eight paper models at its
    published size, one at a time, the card's latency curve through the
    serving worker's steps (``infra.measure_card_curve``: pad, copy,
    forward, wait; exactly ``forward_launches(cfg)`` a request) and the
    host CPU's curve (``infra.measure_cpu_curve``) twice: on all its
    threads, the reference's method and the one the curve file keeps, and
    on one thread, what one of the simulated node's executors (a core) has.
    Both files go to ``sched_artifacts()``.  Then, on each CPU curve at the
    model's medium SLA, ``tune_three`` (40 executors, one accelerator, the
    simulator's request overhead: the reference's constants)."""
    out_dir = sched_artifacts()
    rows, total = [], dict.fromkeys(KERNELS, 0)
    for arch, cfg in PAPER_MODELS.items():
        t0 = time.monotonic()
        params = recsys.init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
        ops.reset_launch_counts()
        card = infra.measure_card_curve(arch, cfg=cfg, params=params, seed=seed)
        launches = ops.launch_counts()
        want = {k: n * card.requests for k, n in forward_launches(cfg).items()}
        if launches != want:
            fail(f"sched {arch}: {card.requests} requests launched {launches}, expected {want}")
        total = {k: total[k] + launches[k] for k in KERNELS}
        card_ms = {int(b): s * 1e3 for b, s in zip(card.curve.batches, card.curve.seconds)}
        check_curve(f"sched {arch} card curve", card_ms)
        logit_err = None
        if cfg.interaction in PLAIN_FORWARD:
            probe = to_device(syn.recsys_batch(np.random.default_rng(seed), cfg, 256,
                                               with_label=False), dev)
            logit_err = compare(f"sched {arch} logits vs plain", recsys.forward(params, cfg, probe),
                                PLAIN_FORWARD[cfg.interaction](params, cfg, probe), 1e-4, 1e-4)
            del probe
        del params
        torch.cuda.empty_cache()
        card_s = time.monotonic() - t0

        cpu = infra.measure_cpu_curve(arch)
        cpu_ms = {int(b): s * 1e3 for b, s in zip(cpu.batches, cpu.seconds)}
        check_curve(f"sched {arch} CPU curve", cpu_ms)
        cpu1 = infra.measure_cpu_curve(arch, threads=1)
        cpu1_ms = {int(b): s * 1e3 for b, s in zip(cpu1.batches, cpu1.seconds)}
        check_curve(f"sched {arch} one-thread CPU curve", cpu1_ms)
        infra.store_curves(out_dir / infra.CARD_CURVES, {arch: card.curve},
                           {arch: infra.card_meta(arch, card, cfg=cfg)})
        infra.store_curves(out_dir / infra.CPU_CURVES, {arch: cpu}, {arch: infra.cpu_meta(arch)})

        t1 = time.monotonic()
        rows.append({
            "arch": arch, "sla_ms": SLA_TARGETS[arch].medium_ms,
            "card_ms": card_ms, "card_steps_ms": card.steps_ms, "card_monotone": monotone(card_ms),
            "cpu_ms": cpu_ms, "cpu_monotone": monotone(cpu_ms),
            "cpu_1t_ms": cpu1_ms, "cpu_1t_monotone": monotone(cpu1_ms),
            **tune_three(arch, cpu, card.curve, SLA_TARGETS[arch].medium_ms, seed),
            "one_thread": tune_three(arch, cpu1, card.curve, SLA_TARGETS[arch].medium_ms, seed),
            "launches": launches, "requests": card.requests,
            "logits_max_abs_err_vs_plain": logit_err,
            "seconds": {"card": card_s, "cpu_curves": t1 - t0 - card_s,
                        "tuning": time.monotonic() - t1}})
    return {"phase": "sched", "executors": SCHED_EXECUTORS, "cpu_curve_iters": infra.CPU_ITERS,
            "cpu": infra.cpu_model(),
            "cpu_threads": torch.get_num_threads(), "card_reps": infra.CARD_REPS,
            "card_warmup": infra.CARD_WARMUP, "artifacts": str(out_dir),
            "models": rows, "launches": total}


# -------------------------------------------------------------------------- zoo


def host_ms(fn, n: int = 5) -> tuple[float, object]:
    """Median host-clock time of ``fn()`` ended by a synchronise, after one
    warm-up call; returns it with the last result."""
    res = fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return statistics.median(times), res


def zoo(seed: int, dev, gen) -> tuple[dict, dict]:
    """The four zoo models at their published sizes on the card, weights
    from the seed.  Returns the phase's line and xDeepFM's parameters for
    the serve phase that follows."""
    shapes = configs.RECSYS_SHAPES
    serve_b = shapes["serve_p99"].batch
    n_cand = shapes["retrieval_cand"].n_candidates
    rng = np.random.default_rng(seed)
    rows, kept = [], {}
    expected = dict.fromkeys(ops.launch_counts(), 0)

    def counted(fn, cfg, forwards: int = 1):
        """``fn`` that adds the launches of its ``forwards`` forwards of
        ``cfg`` to what the phase must have launched, each time it runs."""
        def run():
            for k, n in forward_launches(cfg).items():
                expected[k] += n * forwards
            return fn()
        return run

    assert BULK_ROWS % BULK_CHUNK == 0
    ops.reset_launch_counts()
    for name in ZOO:
        cfg = configs.get(name).config
        params = recsys.init(gen, cfg, device=dev)
        if cfg.interaction == "cin":
            # lin_w starts at zero; a draw from the seed exercises the linear logit
            params["lin_w"].normal_(generator=gen)
        row = {"arch": name}
        batch = to_device(syn.recsys_batch(rng, cfg, serve_b, with_label=False), dev)
        row["forward_ms"], got = host_ms(counted(lambda: recsys.forward(params, cfg, batch), cfg))
        if got.shape != (serve_b,):
            fail(f"zoo {name}: forward gave shape {tuple(got.shape)}")
        if cfg.interaction in PLAIN_FORWARD:          # against the plain versions on the card
            want, against = PLAIN_FORWARD[cfg.interaction](params, cfg, batch), "plain on the card"
        else:                                         # no kernel on this path: against the CPU
            want = recsys.forward(tree_to(params, "cpu"), cfg, to_device(batch, "cpu"))
            against = "the same forward on the CPU"
        row.update({"batch": serve_b, "against": against,
                    "max_abs_err": compare(f"zoo {name} forward", got.cpu(), want.cpu(),
                                           1e-4, 1e-4)})
        if name == "xdeepfm":
            bulk = to_device(syn.recsys_batch(rng, cfg, BULK_ROWS, with_label=False), dev)
            row["bulk_ms"], out = host_ms(counted(
                lambda: recsys.bulk_forward(params, cfg, bulk, chunk=BULK_CHUNK), cfg,
                forwards=BULK_ROWS // BULK_CHUNK), n=1)
            if out.shape != (BULK_ROWS,):
                fail(f"zoo {name}: bulk_forward gave shape {tuple(out.shape)}")
            head = counted(lambda: recsys.forward(params, cfg,
                                                  {k: v[:serve_b] for k, v in bulk.items()}),
                           cfg)()
            row.update({"bulk_rows": BULK_ROWS, "bulk_chunk": BULK_CHUNK,
                        "bulk_cut": f"{BULK_ROWS} of serve_bulk's {shapes['serve_bulk'].batch} rows",
                        "bulk_rows_per_s": BULK_ROWS / row["bulk_ms"] * 1e3,
                        "bulk_head_max_abs_err_vs_forward": compare(
                            "zoo xdeepfm bulk vs forward", out[:serve_b], head, 1e-5, 1e-5)})
            kept = params
        if cfg.interaction in ("mind", "bidir-seq"):
            cand = to_device(syn.recsys_batch(rng, cfg, 1, n_candidates=n_cand,
                                              with_label=False), dev)
            # retrieval runs no kernel: a launch here breaks the count below
            row["score_ms"], scores = host_ms(lambda: recsys.score_candidates(params, cfg, cand))
            if scores.shape != (1, n_cand):
                fail(f"zoo {name}: score_candidates gave shape {tuple(scores.shape)}")
            want = recsys.score_candidates(tree_to(params, "cpu"), cfg, to_device(cand, "cpu"))
            row.update({"candidates": n_cand, "score_max_abs_err_vs_cpu": compare(
                f"zoo {name} scores", scores.cpu(), want, 1e-4, 1e-4)})
        rows.append(row)
        if name != "xdeepfm":
            del params
    launches = ops.launch_counts()
    if launches != expected or not (launches["embedding_bag"] and launches["cin_layer"]):
        fail(f"zoo: launched {launches}, expected {expected} (K1 and K3 at least once)")
    return {"phase": "zoo", "rtol": 1e-4, "atol": 1e-4, "models": rows,
            "launches": launches}, kept


# --------------------------------------------------------------------------- lm


@contextlib.contextmanager
def attention_as(fn):
    """Within it, the layers' decode attention calls ``fn`` in place of
    ``ops.decode_attention``."""
    kernel = ops.decode_attention
    ops.decode_attention = fn
    try:
        yield
    finally:
        ops.decode_attention = kernel


def checked(errors: list):
    """K4 as the layers call it, each call held against the plain version
    on the same inputs (``decode_compare``); the errors are appended to
    ``errors``."""
    kernel = ops.decode_attention

    def run(q, k, v, pos):
        got = kernel(q, k, v, pos)
        errors.append(decode_compare(f"decode_attention in the model, B={q.shape[0]} "
                                     f"T={k.shape[1]}", got, ref.decode_attention(q, k, v, pos)))
        return got
    return run


def zero_attention(q, k, v, pos):
    """A broken attention that returns zeros: the control the logits gate
    must be able to fail."""
    return torch.zeros_like(q)


def gate_logits(name: str, agree: dict, control: dict) -> None:
    """Fails unless the kernel path's logits are within ``LOGITS_L2_TOL``
    of the plain path's and the zeroed attention's are not."""
    if agree["l2_rel"] > LOGITS_L2_TOL:
        fail(f"{name}: logits differ from the plain path by {agree['l2_rel']:.3e} of their norm")
    if control["l2_rel"] <= LOGITS_L2_TOL:
        fail(f"{name}: a zeroed attention's logits are within {control['l2_rel']:.3e} of the "
             f"plain path's: the gate cannot see a broken kernel")


def copy_caches(caches: list[dict]) -> list[dict]:
    return [{k: t.clone() for k, t in c.items()} for c in caches]


def logits_against(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel path's logits against the plain path's: max |got - want|
    and the L2 difference, each relative to the plain logits' scale (max
    |want|, ||want||), and the share of rows whose top-1 token agrees.
    Both paths are bf16 networks of 24 layers: a 1-ulp difference in one
    attention output changes the rounding of everything after it, so this
    measures the network's own bf16 noise as much as the kernel (the
    library attention in the kernel's place is the witness of that noise)."""
    if got.is_cuda:
        torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        fail(f"{name}: logits of shape {tuple(g.shape)} (want {tuple(w.shape)}) or non-finite")
    return {"max_rel": float((g - w).abs().max() / w.abs().max()),
            "l2_rel": float((g - w).norm() / w.norm()),
            "top1": float((g.argmax(-1) == w.argmax(-1)).float().mean())}


def lm_generate(seed: int, dev, gen) -> dict:
    """qwen2-0.5b at its published size, bf16: prefill GEN_BATCH prompts of
    GEN_PROMPT tokens into caches of GEN_CACHE slots, then GEN_STEPS
    teacher-forced decode steps, each timed on the host's clock and its
    logits held against the same step through the plain attention on its
    own copy of the caches (``LOGITS_L2_TOL``); the library attention runs
    the same steps on a third copy, the witness of the bf16 network's
    noise.  Launch counts are zeroed before the prefill and read after the
    last step (the plain and library steps launch nothing).  Then the last
    step is run again with every K4 call held against the plain version on
    its inputs, once with a zeroed attention (the control the gate must
    fail), and once as a CUDA graph for the device's time of a step."""
    cfg = configs.get(LM_ARCH).config
    params = lm.init(gen, cfg, device=dev)
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(seed), cfg, GEN_BATCH,
                                         GEN_PROMPT + GEN_STEPS)["tokens"]).to(dev)
    prompt = toks[:, :GEN_PROMPT]
    lm.prefill(params, cfg, prompt, GEN_CACHE)                # warm-up: cuBLAS plans
    ops.reset_launch_counts()
    prefill_ms, (logits, caches) = host_ms(lambda: lm.prefill(params, cfg, prompt, GEN_CACHE),
                                           n=3)
    if logits.shape != (GEN_BATCH, cfg.vocab) or not bool(torch.isfinite(logits.float()).all()):
        fail(f"lm_generate: prefill gave shape {tuple(logits.shape)} or non-finite logits")
    plain_caches, lib_caches = copy_caches(caches), copy_caches(caches)
    step_ms, agree, lib_agree = [], [], []
    for i in range(GEN_STEPS):
        tok = toks[:, GEN_PROMPT + i]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got, caches = lm.decode_step(params, cfg, tok, caches)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        with attention_as(ref.decode_attention):
            want, plain_caches = lm.decode_step(params, cfg, tok, plain_caches)
        with attention_as(library_decode):
            lib, lib_caches = lm.decode_step(params, cfg, tok, lib_caches)
        agree.append(logits_against(f"lm_generate step {i}", got, want))
        lib_agree.append(logits_against(f"lm_generate library step {i}", lib, want))
    launches = ops.launch_counts()
    if launches != decode_launches(cfg, GEN_STEPS):
        fail(f"lm_generate: {GEN_STEPS} steps launched {launches}, "
             f"expected {decode_launches(cfg, GEN_STEPS)}")
    del lib_caches
    last = [dict(c, pos=c["pos"] - 1) for c in caches]        # rewound: the write repeats
    k4_errs = []
    with attention_as(checked(k4_errs)):
        lm.decode_step(params, cfg, toks[:, -1], last)
    with attention_as(zero_attention):
        zeroed, _ = lm.decode_step(params, cfg, toks[:, -1], last)
    control = logits_against("lm_generate zeroed attention", zeroed, want)
    gate_logits("lm_generate", max(agree, key=lambda a: a["l2_rel"]), control)
    graph_ms = device_ms(lambda i: lm.decode_step(params, cfg, toks[:, -1], last), n_iter=1)
    decode_ms = statistics.median(step_ms[1:])
    return {"phase": "lm_generate", "arch": LM_ARCH, "dtype": cfg.dtype,
            "params": cfg.param_count, "batch": GEN_BATCH, "prompt": GEN_PROMPT,
            "cache_slots": GEN_CACHE, "steps": GEN_STEPS, "prefill_ms": prefill_ms,
            "prefill_tokens_per_s": GEN_BATCH * GEN_PROMPT / prefill_ms * 1e3,
            "decode_ms_per_step": decode_ms, "decode_ms_first_step": step_ms[0],
            "decode_tokens_per_s": GEN_BATCH / decode_ms * 1e3,
            "decode_device_ms_per_step_graph": graph_ms,
            "logits_max_rel_err_vs_plain": max(a["max_rel"] for a in agree),
            "logits_l2_rel_err_vs_plain": max(a["l2_rel"] for a in agree),
            "logits_l2_tol": LOGITS_L2_TOL,
            "top1_agreement": statistics.mean(a["top1"] for a in agree),
            "library_logits_max_rel_err_vs_plain": max(a["max_rel"] for a in lib_agree),
            "library_logits_l2_rel_err_vs_plain": max(a["l2_rel"] for a in lib_agree),
            "library_top1_agreement": statistics.mean(a["top1"] for a in lib_agree),
            "zeroed_attention_vs_plain": control,
            "k4_calls_checked": len(k4_errs), "k4_max_abs_err_in_model": max(k4_errs),
            "launches": launches}


def lm_decode_32k(seed: int, dev, gen) -> dict:
    """qwen2-0.5b at LM_SHAPES["decode_32k"]: B sequences against caches of
    T slots, filled from the seed (a prefill of B·T tokens through the
    plain quadratic attention would take minutes; the JAX package's decode
    cell is defined the same way, one token against a full cache), pos =
    T - DECODE_32K_STEPS.  A first step holds every K4 call against the
    plain version on its inputs, and its logits are held against the same
    step through the plain attention (``LOGITS_L2_TOL``), beside the
    library attention's and a zeroed attention's (the caches rewound
    between them).
    Then K4 alone over the 24 layers' caches, the step as a CUDA graph, and
    DECODE_32K_STEPS steps on the host's clock, launch counts zeroed before
    those and read after."""
    cfg = configs.get(LM_ARCH).config
    shape = configs.LM_SHAPES["decode_32k"]
    b, t = shape.global_batch, shape.seq_len
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(gen, cfg, device=dev)
    caches = lm.init_caches(cfg, b, t, device=dev)
    start = t - DECODE_32K_STEPS
    for c in caches:
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(seed), cfg, b,
                                         DECODE_32K_STEPS + 1)["tokens"]).to(dev)

    def rewind():
        for c in caches:
            c["pos"].fill_(start)

    rewind()
    k4_errs = []
    with attention_as(checked(k4_errs)):
        got, _ = lm.decode_step(params, cfg, toks[:, 0], caches)
    rewind()
    with attention_as(ref.decode_attention):
        want, _ = lm.decode_step(params, cfg, toks[:, 0], caches)
    agree = {"k4": logits_against("lm_decode_32k", got, want)}
    for name, fn in (("library", library_decode), ("zeroed_attention", zero_attention)):
        rewind()
        with attention_as(fn):
            other, _ = lm.decode_step(params, cfg, toks[:, 0], caches)
        agree[name] = logits_against(f"lm_decode_32k {name}", other, want)
    gate_logits("lm_decode_32k", agree["k4"], agree["zeroed_attention"])
    del got, want, other

    # K4 alone at this step's shape, over the 24 layers' caches in turn
    q = torch.randn((b, cfg.n_heads, cfg.hd), generator=gen, device=dev).to(torch.bfloat16)
    n = torch.full((b,), start + 1, dtype=torch.int32, device=dev)
    k4_ms = device_ms(lambda i: ops.decode_attention(q, caches[i % cfg.n_layers]["k"],
                                                     caches[i % cfg.n_layers]["v"], n),
                      n_iter=cfg.n_layers, replays=3)
    rewind()
    graph_ms = device_ms(lambda i: lm.decode_step(params, cfg, toks[:, 0], caches), n_iter=1)

    rewind()
    ops.reset_launch_counts()
    step_ms = []
    for i in range(DECODE_32K_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, caches = lm.decode_step(params, cfg, toks[:, i + 1], caches)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
    launches = ops.launch_counts()
    if launches != decode_launches(cfg, DECODE_32K_STEPS):
        fail(f"lm_decode_32k: {DECODE_32K_STEPS} steps launched {launches}, "
             f"expected {decode_launches(cfg, DECODE_32K_STEPS)}")
    if logits.shape != (b, cfg.vocab) or not bool(torch.isfinite(logits.float()).all()):
        fail(f"lm_decode_32k: logits of shape {tuple(logits.shape)} or non-finite")
    if caches[0]["pos"].tolist() != [t] * b:
        fail("lm_decode_32k: the caches' pos did not reach T")
    # the step's bound: K and V up to pos + 1 of every layer, read once
    # (mean over the timed steps), and every weight read once
    valid = statistics.mean(start + 1 + i for i in range(DECODE_32K_STEPS))
    kv_bytes = cfg.n_layers * 2 * b * valid * cfg.n_kv_heads * cfg.hd * 2
    weight_bytes = cfg.param_count * 2
    step = statistics.median(step_ms)
    res = {"phase": "lm_decode_32k", "arch": LM_ARCH, "shape": "decode_32k", "batch": b,
           "cache_slots": t, "pos_start": start, "steps": DECODE_32K_STEPS,
           "cache_bytes": sum(c["k"].numel() * 4 for c in caches),
           "ms_per_step": step, "ms_per_step_all": step_ms, "device_ms_per_step_graph": graph_ms,
           "bound_ms_per_step": (kv_bytes + weight_bytes) / HBM_BYTES_PER_S * 1e3,
           "tokens_per_s": b / step * 1e3, "k4_ms_per_layer": k4_ms,
           "k4_share_of_step": cfg.n_layers * k4_ms / step,
           "k4_share_of_graph_step": cfg.n_layers * k4_ms / graph_ms,
           "k4_calls_checked": len(k4_errs), "k4_max_abs_err_in_model": max(k4_errs),
           "logits_vs_plain": agree, "logits_l2_tol": LOGITS_L2_TOL,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    del caches, params
    return res


# ------------------------------------------------------------------------- main


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qps", type=float, default=100.0, help="offered load of the serve phases")
    ap.add_argument("--seconds", type=float, default=4.0, help="length of each serve phase")
    ap.add_argument("--k2-timings", action="store_true",
                    help="only time K2 at the DLRM shapes, print that line and stop (no "
                         "result line): to time another tree's K2, run a copy of this "
                         "script from that tree's root")
    ap.add_argument("--k4-timings", action="store_true",
                    help="only time K4 at its four shapes (with other run lengths beside "
                         "the plan's), print that line and stop (no result line); a copy "
                         "of this script times another tree's K4 the same way")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on a GPU only", file=sys.stderr)
        raise SystemExit(1)
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    _build.load()
    emit({"phase": "build", "seconds": _build.build_seconds,
          "sources": sorted(p.name for p in _build.CSRC.glob("*.cu"))})

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.k2_timings:
        emit({"phase": "k2_timings", "card": card,
              "timings": time_dot_interactions(gen, dev, other_store=False)})
        return
    if args.k4_timings:
        emit({"phase": "k4_timings", "card": card,
              "timings": time_decode_attentions(args.seed, gen, dev, other_runs=True)})
        return
    cfg = PAPER_MODELS[SERVE_ARCH]
    params = recsys.init(gen, cfg, device=dev)           # 40 x 10^6 x 32 float32 on the card
    tables = params["tables"]

    eb_checks, eb_err = check_embedding_bag(rng, gen, dev, tables)
    ix_checks, ix_err = check_dot_interaction(gen, dev)
    cin_checks, cin_err = check_cin_layer(gen, dev)
    eb_times = [time_embedding_bag(rng, dev, tables, b, ids)
                for ids in ("zipf", "uniform") for b in MAIN_BATCHES]
    ix_times = time_dot_interactions(gen, dev)
    xdfm = configs.get("xdeepfm").config
    xdfm_tables = torch.randn((xdfm.n_tables, xdfm.vocab, xdfm.embed_dim), generator=gen,
                              device=dev)
    eb_times_xdfm = [time_embedding_bag(rng, dev, xdfm_tables, b, "zipf", h=xdfm.hotness)
                     for b in ZOO_BATCHES]
    del xdfm_tables
    cin_times = [time_cin_layer(gen, dev, b, f, h, hn, xdfm.embed_dim)
                 for b in ZOO_BATCHES for f, h, hn in xdeepfm_cin_shapes()]
    da_checks, da_err = check_decode_attention(rng, gen, dev)
    t32k = configs.LM_SHAPES["decode_32k"]
    da_times = time_decode_attentions(args.seed, gen, dev)
    da_main = da_times[0]                                # decode_32k, pos = T
    da_err = max([da_err] + [t["max_abs_err_vs_plain"] for t in da_times])
    emit({"phase": "kernel_checks", "card": card,
          "embedding_bag": {"checks": eb_checks, "timings_rmc2": eb_times,
                            "timings_xdeepfm": eb_times_xdfm},
          "dot_interaction": {"checks": ix_checks, "timings_rmc2_rmc1": ix_times},
          "cin_layer": {"checks": cin_checks, "timings_xdeepfm": cin_times},
          "decode_attention": {"checks": da_checks, "timings_qwen2": da_times}})

    emit({"phase": "parity", "rtol": 1e-4, "atol": 1e-4,
          "configs": check_parity(args.seed, dev)})

    served = serve(args.seed, dev, params, cfg, qps=args.qps, seconds=args.seconds,
                   batch_size=64, sla_ms=SLA_TARGETS[SERVE_ARCH].medium_ms, curve=True)
    served["card"] = card
    emit(served)
    del params, tables

    scheduled = sched(args.seed, dev)
    scheduled["card"] = card
    emit(scheduled)

    zoo_line, xdfm_params = zoo(args.seed, dev, gen)
    zoo_line["card"] = card
    emit(zoo_line)

    # neither package gives xDeepFM an SLA target: a fixed batch size of
    # serve_p99's 512 and no controller
    served_x = serve(args.seed, dev, xdfm_params, xdfm, qps=args.qps, seconds=args.seconds,
                     batch_size=configs.RECSYS_SHAPES["serve_p99"].batch)
    served_x["card"] = card
    emit(served_x)
    del xdfm_params

    generated = lm_generate(args.seed, dev, gen)
    generated["card"] = card
    emit(generated)

    # last, with the earlier phases' tensors freed: 51.5 GB of KV cache
    decoded = lm_decode_32k(args.seed, dev, gen)
    decoded["card"] = card
    emit(decoded)

    paths = (served["launches"], scheduled["launches"], zoo_line["launches"],
             served_x["launches"], generated["launches"], decoded["launches"])
    total = {k: sum(p[k] for p in paths) for k in KERNELS}
    eb_main = next(t for t in eb_times if t["ids"] == "zipf" and t["batch"] == MAIN_BATCHES[-1])
    ix_main = next(t for t in ix_times
                   if t["arch"] == SERVE_ARCH and t["batch"] == MAIN_BATCHES[-1])
    k_max = max(h * f for f, h, _ in xdeepfm_cin_shapes())
    cin_main = next(t for t in cin_times
                    if t["shape"][0] == ZOO_BATCHES[-1] and t["shape"][1] * t["shape"][2] == k_max)
    b, f, h, hn, d = cin_main["shape"]
    qwen = configs.get(LM_ARCH).config
    emit({"kernels": [
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag.py:23",
         "launches": total["embedding_bag"], "max_abs_err": eb_err,
         "ms": eb_main["kernel_ms"], "call_ms": eb_main["kernel_call_ms"], "plain_ms": eb_main["plain_ms"],
         "bound_ms": eb_main["bound_ms"], "bound_by": eb_main["bound_by"],
         "library_ms": eb_main["library_ms"],
         "shape": "tables (40, 1000000, 32) float32, idx (1024, 40, 80) Zipf ids"},
        {"name": "dot_interaction", "route": "cuda",
         "source": "src/repro_torch/csrc/interaction.cu",
         "replaces": "src/repro/kernels/interaction.py:24",
         "launches": total["dot_interaction"], "max_abs_err": ix_err,
         "ms": ix_main["kernel_ms"], "call_ms": ix_main["kernel_call_ms"], "plain_ms": ix_main["plain_ms"],
         "bound_ms": ix_main["bound_ms"], "bound_by": ix_main["bound_by"],
         "library_ms": ix_main["library_ms"], "share_of_bound": ix_main["share_of_bound"],
         "design": "S consecutive samples a block (plan), slab in by 16-byte cp.async, "
                   "4x4 float32 register tiles with 16-byte shared reads of rows laid out "
                   "by tile row; at small B lanes split d and halve their sums by shuffles, "
                   "on a full card results are staged and stored as one 16-byte range",
         "shape": "feats (1024, 41, 32) float32"},
        {"name": "cin_layer", "route": "cuda",
         "source": "src/repro_torch/csrc/cin.cu",
         "replaces": "src/repro/kernels/cin.py:20",
         "launches": total["cin_layer"], "max_abs_err": cin_err,
         "ms": cin_main["kernel_ms"], "call_ms": cin_main["kernel_call_ms"],
         "plain_ms": cin_main["plain_ms"],
         "bound_ms": cin_main["bound_ms"], "bound_by": cin_main["bound_by"],
         "library_ms": cin_main["library_ms"],
         "design": "3xTF32 wgmma on the tensor cores: A formed in registers, w's TF32 hi/lo "
                   "planes written by a pre-pass and brought in by cp.async.bulk",
         "bound_of": cin_main["bound_of"],
         "fp32_cuda_core_bound_ms": cin_main["fp32_cuda_core_bound_ms"],
         "share_of_bound": cin_main["share_of_bound"],
         "prepass_ms": cin_main["prepass_ms"], "prepass_share": cin_main["prepass_share"],
         "shape": f"x0 ({b}, {f}, {d}), xk ({b}, {h}, {d}), w ({h * f}, {hn}) float32"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:23",
         "launches": total["decode_attention"], "max_abs_err": da_err,
         "ms": da_main["kernel_ms"], "call_ms": da_main["kernel_call_ms"],
         "plain_ms": da_main["plain_ms"],
         "bound_ms": da_main["bound_ms"], "bound_by": da_main["bound_by"],
         "library_ms": da_main["library_ms"], "share_of_bound": da_main["share_of_bound"],
         "main_ms": da_main["main_ms"], "combine_ms": da_main["combine_ms"],
         "run_slots": da_main["run_slots"],
         "design": "a block per (sequence, KV head, run of run_slots slots) with all G query "
                   "heads, the run length planned on the host for full caches and the runs "
                   "counted from pos on the card; two-stage 16-byte cp.async tiles; runs "
                   "combined by a second kernel launched as a programmatic dependent, a "
                   "block per (sequence, query head, column block), sums in a fixed order",
         "shape": f"decode_32k: q ({t32k.global_batch}, {qwen.n_heads}, {qwen.hd}), "
                  f"k/v ({t32k.global_batch}, {t32k.seq_len}, {qwen.n_kv_heads}, {qwen.hd}) "
                  f"bfloat16, pos = T",
         **{t["name"]: {
             # the uneven and B = 1 shapes are timed only: no driven path runs them
             "launches": (generated["launches"]["decode_attention"]
                          if t["name"] == "lm_generate" else 0),
             "ms": t["kernel_ms"], "call_ms": t["kernel_call_ms"],
             "main_ms": t["main_ms"], "combine_ms": t["combine_ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"], "share_of_bound": t["share_of_bound"],
             "run_slots": t["run_slots"],
             "shape": f"q ({t['batch']}, {qwen.n_heads}, {qwen.hd}), k/v ({t['batch']}, "
                      f"{t['slots']}, {qwen.n_kv_heads}, {qwen.hd}) bfloat16, pos = {t['pos']}"}
            for t in da_times[1:]}},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
