#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port: the quickest proof that the port
builds its kernels and serves on a card.

    python3 chip_smoke.py            # needs one CUDA GPU and nvcc; ~6 minutes

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
  live           DLRM-RMC2 at its published size served live on the card by
                 one worker (cluster.live_node, the batch knob sched tuned
                 with the card, buckets to 1,024) and its simulated twin on
                 the curve calibrated through the runtime, both under
                 cluster.drive_fleet on one trace: capacity under the SLA on
                 a probe ladder (live/sim ratio gated to [0.5, 2]), p50/p95
                 at 0.6 of it with the live p95 split into span components
                 (which must close within 5 %), the capacity the sched
                 curve and the bucketed curve predict; then DLRM-RMC1 on
                 two live nodes, the card and the host CPU, hetero against
                 round_robin.  Every live run serves every query with no
                 error and exactly one K1 and one K2 a card request; the
                 phase must end within 150 s
  zoo            xDeepFM, AutoInt, MIND and BERT4Rec at their published
                 sizes: forward at serve_p99 (batch 512), xDeepFM's
                 bulk_forward, MIND's and BERT4Rec's score_candidates over
                 10^6 candidates, each held against a plain-only run and
                 timed; launch counts zeroed before and read after
  serve_xdeepfm  xDeepFM at its published size behind ServingRuntime at a
                 fixed batch size of 512 (no SLA target exists for it, so
                 no controller); exactly one K1 and three K3 per request
  train          DLRM-RMC2 at its published size, B = 1,024, the
                 reference's optimiser split (adagrad on the tables, AdamW
                 on the towers, clip 10): one step's gradients through the
                 kernels (K1, K1-bwd, K2, K2-bwd) against the plain backward
                 versions in float64, every leaf; 20 steps of train.loop
                 with exactly one K1, K1-bwd, K2 and K2-bwd a step; a run
                 stopped at step 10 with a checkpoint (build/train_ckpt,
                 removed after) and resumed, its losses against the
                 straight run's; a step's forward, backward and optimiser
                 times; K1-bwd and K2-bwd against their plain versions and
                 timed beside bound, plain and library versions; then
                 qwen2-0.5b at its published size (bf16, B = 4, S = 1,024):
                 the chunked loss against the whole one and 3 AdamW steps,
                 no kernel launched.  Frees all it holds
  gnn            the GCN (gcn-cora rebound to each shape) at the four
                 GNN_SHAPES, graphs built on the host by the port's
                 random_graph, graph_to_csr and molecule_batch: Cora's
                 shape (step 0's loss and gradients against float64 on the
                 CPU, 100 AdamW steps, train accuracy rising), the
                 molecule batch (20 steps), ogbn-products' full batch (the
                 edge layout, a forward and 3 steps timed, peak memory,
                 bytes a step against 3.35 TB/s), the Reddit-scale graph
                 (CSR and sampler on the host, 5 sampled minibatch steps on
                 the card); Cora's and the molecules' runs twice and
                 ogbn-products' first step twice, the same bits; no
                 kernel launched; within 150 s
  dist           the distributed runtime (ring all-gather, overlapped and
                 reduce-scatter matmuls, GPipe, compressed_psum,
                 make_sharded_moe at granite-moe-1b-a400m's layer width) in
                 an NCCL world of one rank on the card, each against its
                 single-device meaning; then in 4 gloo processes on the
                 host CPU (a (2, 2) mesh for the MoE), and compressed_psum's
                 4 ranks on the card's tensors through gloo where it takes
                 them; no process outlives it; within 60 s
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
  lm_moe         the two mixture-of-experts LMs at their published sizes
                 (bf16, seeded weights), each under lm_generate's traffic
                 (8 prompts of 512 tokens into 1,024-slot caches):
                 granite-moe-1b-a400m for 32 teacher-forced decode steps,
                 then qwen3-moe-30b-a3b (30.5 B parameters, 61 GB) for 8,
                 once every earlier phase has freed its tensors; exactly
                 n_layers K4 launches a step and no K1-K3; each step's
                 logits against the plain and library attentions', one step
                 with every K4 call held against the plain version, a
                 zeroed attention as the control; the MoE layers' dropped
                 share at prefill and at decode; K4 timed at each model's
                 heads
  remote         two worker processes of mlp:128:256:2 serving on the card
                 behind WorkerSupervisor (repro_torch.serve.remote): the
                 card's own account that both hold it (their pids among
                 nvidia-smi's compute apps or, where a pid namespace hides
                 them, one more compute app a worker while they serve and
                 none after, and each worker's open /dev/nvidiaN);
                 calibration in lockstep, a drive_fleet trace at half the calibrated
                 capacity with every query served, then a trace with a
                 SIGKILL of one worker mid-run whose queries re-route; no
                 worker outlives the phase, which must end within 60 s
  kernels        per kernel: launches over the driven paths, max error, and
                 at its main-path shape its time on the card (CUDA-graph
                 replay, no host time between launches), the host's time for
                 one eager call, the bound, and the plain and library
                 versions' times

then the card line and, last, {"ok": true, "device": {...}}.  Any failed
phase raises: the script exits non-zero and prints no result.  It also
exits non-zero when no CUDA device is present.

    python3 chip_smoke.py --only PHASE   # that phase's line alone, then stop

builds the kernels, runs only PHASE (a key of ONLY) and prints its line and
no result line:

  train        the train phase (backward kernels checked and timed)
  gnn          the gnn phase
  dist         the dist phase
  lm_moe       the lm_moe phase
  remote       the remote phase
  k2_timings   K2 timed at the DLRM shapes
  k4_timings   K4 timed at its four shapes (decode_32k at pos = T and with
               pos uniform, B = 1 at 32,768 slots, lm_generate's step), main
               kernel and combine timed apart by torch.profiler and other
               run lengths than the plan's timed beside it

A copy of this script run from another tree's root times that tree's K2 or
K4 the same way (how a change is held against its parent on one card).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import distribute_tensor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.cluster import (BucketedDeviceModel, FleetFaults, NodeKill,  # noqa: E402
                                 WallClock, WorkerSupervisor, boot_remote_fleet,
                                 calibrate_device, drive_fleet, live_node, make_router,
                                 sim_backends)
from repro_torch.cluster.fleet import NodeView  # noqa: E402
from repro_torch.configs.paper_models import PAPER_MODELS, SLA_TARGETS  # noqa: E402
from repro_torch.core import infra  # noqa: E402
from repro_torch.core.infra import card_line  # noqa: E402
from repro_torch.core.latency_model import TableDeviceModel  # noqa: E402
from repro_torch.core.query_gen import (PRODUCTION, SizeDist, generate_queries,  # noqa: E402
                                        query_stream, rescale_trace, sample_trace)
from repro_torch.core.scheduler import static_baseline, tune  # noqa: E402
from repro_torch.core.simulator import (SUSTAIN_FRACTION, SchedulerConfig,  # noqa: E402
                                        max_qps_under_sla, simulate)
from repro_torch.configs import gcn_cora  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import pipeline as pipe  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import cin as cin_kernel  # noqa: E402
from repro_torch.kernels import decode_attention as da_kernel  # noqa: E402
from repro_torch.kernels import embedding_bag as eb_kernel  # noqa: E402
from repro_torch.kernels import interaction as ix_kernel  # noqa: E402
from repro_torch.layers import interactions as ix  # noqa: E402
from repro_torch.layers import moe as moe_lib  # noqa: E402
from repro_torch.layers.mlp import linear, mlp  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import gnn, lm, recsys  # noqa: E402
from repro_torch.serve.batching import pad_batch  # noqa: E402
from repro_torch.serve.runtime import (OnlineController, ServingRuntime,  # noqa: E402
                                       to_device)
from repro_torch.train import grad_compress as gc  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402
from repro_torch.train.microbatch import value_and_grad  # noqa: E402
from repro_torch.utils import leaves_with_paths, param_bytes, tree_map  # noqa: E402

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
KERNELS = ("embedding_bag", "dot_interaction", "cin_layer", "decode_attention",
           "embedding_bag_backward", "dot_interaction_backward")
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # K4: tests/test_kernels.py's values
# the logits of a bf16 LM step through K4 against the same step through the
# plain attention: ||got - want|| / ||want||.  Set between the spread of
# two correct attentions (K4 and the library's, both against the plain one:
# up to 0.037 in the dense LMs and 0.075 in the MoE LMs, where a routing
# choice or a capacity drop can flip on a 1-ulp change, on an H100) and
# that of an attention that returns zeros (above 1.2), which every run
# checks the gate would refuse (PERF.md)
LOGITS_L2_TOL = 0.1
# the sched phase: the simulated node's executors, as the reference's
# SchedulerConfig and tune default to (a 40-core CPU)
SCHED_EXECUTORS = 40
# the live phase: one RMC2 node at buckets up to 1,024 against its twin on
# the probe ladder and agreement band of the JAX package's
# benchmarks/live_parity.py (rungs 1.17 apart around the twin's anchor; the
# 25 % band widened by half a rung), gated on a ratio that says the twin
# describes the same machine; then two RMC1 nodes, the card and the host
# CPU, at a knob of 256 (RMC1's batch tuned with the card on the committed
# curves), where a request costs the host several times what it costs the
# card and the host node's calibration still takes seconds
LIVE_MAX_BUCKET = 1024
LIVE_QUERIES = 600              # a run of the RMC2 node; the two-node part runs 3/5 as many
LIVE_STEP = 1.17
LIVE_RUNGS = tuple(0.35 * LIVE_STEP ** k for k in range(9))
LIVE_AGREE = (0.75 / 1.085, 1.25 * 1.085)
LIVE_RATIO_GATE = (0.5, 2.0)
LIVE_SECONDS = 150.0
LIVE_FLEET_ARCH = "dlrm-rmc1"
LIVE_FLEET_BATCH = 256
LM_ARCH = "qwen2-0.5b"
GEN_BATCH, GEN_PROMPT, GEN_CACHE, GEN_STEPS = 8, 512, 1024, 32
DECODE_32K_STEPS = 8
# the train phase: DLRM-RMC2 at its published size at the batch K1 and K2
# are timed at, the reference's optimiser split and clip; a checkpoint at
# TRAIN_RESUME_AT under build/ (about 10 GB: tables and their adagrad
# state), removed after the phase
TRAIN_ARCH = "dlrm-rmc2"
TRAIN_BATCH = 1024
TRAIN_STEPS = 20
TRAIN_RESUME_AT = 10
TRAIN_TIMED_STEPS = 5
TRAIN_CLIP = 10.0
# losses of a resumed run against the straight run's: K1-bwd's atomics add
# in another order every run, so not bit for bit
TRAIN_RESUME_RTOL = 1e-5
TRAIN_CKPT = Path(__file__).resolve().parent / "build" / "train_ckpt"
# qwen2-0.5b's training steps: S = 2 x lm._LOSS_CHUNK, so the chunked loss
# runs; chunked and whole sum the same float32 terms in other groupings
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 1024, 3
LM_CHUNK_RTOL = 1e-2
# the lm_moe phase: both MoE LMs at their published sizes under
# lm_generate's traffic; qwen3-moe (61 GB of weights) for fewer steps
MOE_STEPS = {"granite-moe-1b-a400m": GEN_STEPS, "qwen3-moe-30b-a3b": 8}
# the gnn phase: the GCN at its four graph shapes, AdamW at the reference
# launcher's rate, its clip; the phase must end within GNN_SECONDS
GNN_LR = 1e-2
GNN_CORA_STEPS, GNN_MINIBATCH_STEPS, GNN_PRODUCTS_STEPS, GNN_MOLECULE_STEPS = 100, 5, 3, 20
GNN_SECONDS = 150.0
# the dist phase: an NCCL world of one rank on the card, then DIST_WORLD
# gloo ranks on the host; the MoE at DIST_MOE's layer width
DIST_WORLD = 4
DIST_MOE = "granite-moe-1b-a400m"
DIST_SECONDS = 60.0
DIST_DIR = Path(__file__).resolve().parent / "build" / "dist_smoke"
# the remote phase: two card workers of the JAX package's live_parity
# MLP behind the supervisor, buckets to 64, each run HORIZON seconds of
# trace at half the lockstep-calibrated capacity
REMOTE_MODEL = "mlp:128:256:2"
REMOTE_NODES = 2
REMOTE_MAX_BUCKET = 64
REMOTE_LOAD = 0.5
REMOTE_HORIZON_S = 2.0
REMOTE_SECONDS = 60.0


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
    # D 8, 16 and phi3's 96; the MoE LMs' (D, G) (64, 2) and (128, 8)
    for name in ("qwen2-0.5b", "phi3-mini-3.8b", "yi-34b") + tuple(MOE_STEPS):
        for cfg in (configs.get(name).smoke_config, configs.get(name).config):
            if (cfg.n_heads, cfg.n_kv_heads, cfg.hd) != k4_heads():
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


# run lengths timed beside the plan's by --only k4_timings, at each shape's T
K4_OTHER_RUNS = {1024: (32, 64, 128, 256, 1024),
                 32768: (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)}


def time_decode_attention(seed: int, gen, dev, name: str, b: int, t: int, pos_kind,
                          n_sets: int = 1, other_runs: bool = False,
                          heads: tuple[int, int, int] | None = None) -> dict:
    """K4 at qwen2-0.5b's heads (or ``heads``, (Hq, Hkv, D)), bf16, B
    sequences against T slots.
    ``n_sets`` caches rotate so that consecutive launches do not find the
    last one's K/V in the 50 MB L2 (a decode step reads 24 layers' caches
    in turn).  pos comes from its own generator of ``seed``, so every run
    of the script times the same positions.  The bound reads K and V up to
    each sequence's pos once, q and pos once, and writes the output once;
    its operations are 4·Hq·D per valid slot (q·k and p·v).  Main kernel
    and combine are timed apart by torch.profiler; ``other_runs`` also
    times other run lengths than the plan's (the evidence for the plan)."""
    hq, hkv, d = heads or k4_heads()
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
        "name": name, "heads": [hq, hkv, d], "batch": b, "slots": t, "pos": pos_kind,
        "valid_slots": n_valid,
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
    return {**dict.fromkeys(KERNELS, 0),
            "embedding_bag": int(bool(cfg.n_tables) and cfg.pooling in ("sum", "mean")),
            "dot_interaction": int(cfg.interaction == "dot"),
            "cin_layer": len(cfg.cin_layers) if cfg.interaction == "cin" else 0}


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


# ------------------------------------------------------------------------- live


class LiveModel:
    """One model served live: ``apply`` runs ``recsys.forward`` on a padded
    request and counts the requests; ``make_batch`` slices one host
    template as large as the largest query and bucket, so the feeder
    thread paces arrivals instead of drawing Zipf ids per query."""

    def __init__(self, params, cfg, seed: int, dev):
        self.params, self.cfg, self.dev = params, cfg, torch.device(dev)
        self.label = f"{cfg.name} {'card' if self.dev.type == 'cuda' else 'host CPU'}"
        self.template = syn.recsys_batch(np.random.default_rng(seed), cfg,
                                         max(PRODUCTION.max_size, LIVE_MAX_BUCKET),
                                         with_label=False)
        self.requests = 0
        self.finished = 0                # requests whose forward returned
        self._lock = threading.Lock()

    def apply(self, batch: dict) -> torch.Tensor:
        with self._lock:
            self.requests += 1
        out = recsys.forward(self.params, self.cfg, batch)
        with self._lock:
            self.finished += 1
        return out

    def make_batch(self, size: int, model_id: int) -> dict:
        return {k: v[:size] for k, v in self.template.items()}


def probe_ladder(grid, run_at, sla_ms: float) -> float:
    """The highest rate of ``grid`` whose run meets the SLA and sustains the
    offered rate, a failed rung probed once more (the JAX package's
    ``benchmarks/live_parity.py::_probe_ladder``).  Rungs are probed from
    the top down and the first to pass ends the probe: the same rung the
    reference's bottom-up sweep keeps, without the long runs at the
    lowest rates."""
    for rate in sorted(grid, reverse=True):
        for _ in range(2):
            r = run_at(rate)
            if r.meets(sla_ms) and r.qps >= SUSTAIN_FRACTION * rate:
                return rate
    return 0.0


def check_ratio(ratio: float) -> None:
    """The live node's capacity over its simulated twin's must lie in
    ``LIVE_RATIO_GATE``: a twin that describes the same machine."""
    lo, hi = LIVE_RATIO_GATE
    if not (np.isfinite(ratio) and lo <= ratio <= hi):
        fail(f"live: live/sim capacity ratio {ratio} outside [{lo}, {hi}]")


def check_launches(what: str, launches: dict, per_request: dict[str, dict],
                   requests: dict) -> None:
    """Exactly each card model's kernels (``per_request[model]``) for every
    one of its requests (``requests[model]``), and nothing else."""
    want = dict.fromkeys(KERNELS, 0)
    for m, n in requests.items():
        for k, per in per_request[m].items():
            want[k] += per * n
    if launches != want:
        fail(f"live {what}: requests {requests} launched {launches}, expected {want}")


def check_served(what: str, r, offered: int) -> None:
    """Every offered query served, none errored or dropped."""
    if r.n_queries != offered or r.dropped or r.errors:
        fail(f"live {what}: {r.n_queries} of {offered} queries served, "
             f"{r.dropped} dropped, {r.errors} errored")


class LiveRuns:
    """Runs live work with the launch counts zeroed just before and read
    just after, each checked against the card models' requests in it, and
    keeps the phase's totals."""

    def __init__(self, models: list[LiveModel]):
        self.models = list(models)
        self.launches = dict.fromkeys(KERNELS, 0)
        self.runs = 0

    @property
    def requests(self) -> dict[str, int]:
        return {m.label: m.requests for m in self.models}

    def __call__(self, what: str, fn):
        on_card = [m for m in self.models if m.dev.type == "cuda"]
        before = [m.requests for m in on_card]
        ops.reset_launch_counts()
        out = fn()
        launches = ops.launch_counts()
        broken = {m.label: m.requests - m.finished for m in self.models
                  if m.requests != m.finished}
        if broken:
            fail(f"live {what}: requests whose forward raised: {broken}")
        check_launches(what, launches, {m.label: forward_launches(m.cfg) for m in on_card},
                       {m.label: m.requests - n0 for m, n0 in zip(on_card, before)})
        self.launches = {k: self.launches[k] + launches[k] for k in KERNELS}
        self.runs += 1
        return out


def live_builder(model: LiveModel, pool: str, curve, batch: int, max_bucket: int):
    def build(clock):
        return live_node(model.apply, model.make_batch, pool=pool, device=curve,
                         batch_size=batch, max_bucket=max_bucket, clock=clock,
                         torch_device=model.dev)
    return build


def live_fleet_run(runs: LiveRuns, what: str, times, sizes, builders, router: str,
                   telemetry: bool = False):
    """One live run: fresh nodes on one clock, the trace through
    ``drive_fleet``, every query served."""
    def run():
        clock = WallClock()
        backends = [build(clock) for build in builders]
        try:
            return drive_fleet(times, sizes, backends, make_router(router),
                               telemetry=telemetry)
        finally:
            for b in backends:
                b.close()
    r = runs(what, run)
    check_served(what, r, len(times))
    return r


def sim_fleet_run(times, sizes, views, router: str, telemetry: bool = False):
    return drive_fleet(times, sizes, sim_backends(views), make_router(router),
                       telemetry=telemetry)


def node_capacity(spec, sla_ms: float) -> float:
    """A one-node capacity under the SLA on ``spec``'s curve, as the JAX
    package's ``live_parity._node_capacity`` prices it."""
    return max_qps_under_sla(spec.cpu, spec.scheduler_config(), sla_ms,
                             size_dist=PRODUCTION, n_queries=400, seed=5)


def spec_of(build):
    probe = build(WallClock())
    spec = probe.spec
    probe.close()
    return spec


def live(seed: int, dev, params, cfg, batch: int, card_curve,
         queries: int = LIVE_QUERIES) -> dict:
    """DLRM-RMC2 served live on the card against its simulated twin under
    one driver (``drive_fleet``), the counterpart of the JAX package's
    ``benchmarks/live_parity.py``; then two live DLRM-RMC1 nodes, one on
    the card and one on the host CPU, behind ``hetero`` and
    ``round_robin``.  ``batch`` is the knob the sched phase tuned for RMC2
    with the card, ``card_curve`` the log-linear card curve it measured."""
    t_phase = time.monotonic()
    sla = SLA_TARGETS[cfg.name].medium_ms
    model = LiveModel(params, cfg, seed, dev)
    runs = LiveRuns([model])
    unit_times, sizes = sample_trace(np.random.default_rng(seed), queries, PRODUCTION)

    # 1. one node against its twin: calibrate, probe the live node on the
    # ladder around the twin's anchor, calibrate again, and probe the twin
    # on the geometric mean of the two curves; once more if outside the band
    best, attempts = None, []
    for attempt in (1, 2):
        cal1 = runs("calibrate", lambda: calibrate_device(
            model.apply, model.make_batch, max_bucket=LIVE_MAX_BUCKET, torch_device=dev))
        build = live_builder(model, "card", cal1, batch, LIVE_MAX_BUCKET)
        raw_spec = spec_of(build)
        anchor = node_capacity(raw_spec, sla)
        grid = [anchor * r for r in LIVE_RUNGS]
        cap_live = probe_ladder(grid, lambda rate: live_fleet_run(
            runs, f"node at {rate:.0f} qps", rescale_trace(unit_times, rate), sizes, [build],
            "round_robin"), sla)
        cal2 = runs("calibrate", lambda: calibrate_device(
            model.apply, model.make_batch, max_bucket=LIVE_MAX_BUCKET, torch_device=dev))
        blend = BucketedDeviceModel(cal1.buckets, np.sqrt(cal1.seconds * cal2.seconds))
        spec = dataclasses.replace(raw_spec, cpu=blend)
        views = [NodeView("card", 0, spec, max(anchor, 1e-9))]
        cap_sim = probe_ladder(grid, lambda rate: sim_fleet_run(
            rescale_trace(unit_times, rate), sizes, views, "round_robin"), sla)
        ratio = cap_live / cap_sim if cap_sim > 0 else 0.0
        attempts.append({"anchor_qps": anchor, "sim_qps": cap_sim, "live_qps": cap_live,
                         "ratio": ratio})
        key = abs(np.log(ratio)) if ratio > 0 else np.inf
        if best is None or key < best[0]:
            best = (key, cap_sim, cap_live, ratio, blend, views, build, spec)
        if LIVE_AGREE[0] <= ratio <= LIVE_AGREE[1]:
            break
    _, cap_sim, cap_live, ratio, blend, views, build, spec = best
    check_ratio(ratio)

    # 2. p50/p95 at 0.6 of the lower capacity, with telemetry: the live
    # p95 split into its span components, which must add up
    rate = 0.6 * min(cap_sim or 1.0, cap_live or 1.0)
    times = rescale_trace(unit_times, rate)
    r_sim = sim_fleet_run(times, sizes, views, "round_robin", telemetry=True)
    r_live = live_fleet_run(runs, "node at 0.6 capacity", times, sizes, [build],
                            "round_robin", telemetry=True)
    rep = r_live.telemetry.attribution((50.0, 95.0, 99.0))
    closes = {str(p.percentile): p.reconciles(0.05) for p in rep.percentiles}
    if not all(closes.values()):
        fail(f"live: the live attribution does not close within 5 %: {closes}")
    p95 = rep.at(95.0)

    # 3. what the sched phase's log-linear curve predicts for the same node,
    # beside the bucketed curve's prediction (and both at a knob of 1,024,
    # where every query up to 1,000 items is one padded request)
    at = {}
    for knob in sorted({spec.batch_size, LIVE_MAX_BUCKET}):
        s = dataclasses.replace(spec, batch_size=knob)
        at[str(knob)] = {
            "interpolated_qps": node_capacity(dataclasses.replace(s, cpu=card_curve), sla),
            "bucketed_qps": node_capacity(s, sla)}
    node_s = time.monotonic() - t_phase

    # 4. two live RMC1 nodes, the card and the host CPU, hetero against
    # round_robin, the two routers probed in turn at each rung
    fleet = live_fleet(seed, dev, runs, max(queries * 3 // 5, 100))

    seconds = time.monotonic() - t_phase
    lo, hi = LIVE_AGREE
    out = {
        "phase": "live", "arch": cfg.name, "sla_ms": sla, "batch_size": spec.batch_size,
        "max_bucket": LIVE_MAX_BUCKET, "workers": 1, "queries_a_run": queries,
        "sim_qps": cap_sim, "live_qps": cap_live, "ratio": ratio,
        "ratio_gate": list(LIVE_RATIO_GATE), "reference_band": [lo, hi],
        "within_reference_band": bool(lo <= ratio <= hi), "attempts": attempts,
        "calibrated_ms": {str(int(b)): s * 1e3 for b, s in zip(blend.buckets, blend.seconds)},
        "sub_capacity": {
            "qps": rate, "sim_p50_ms": r_sim.p50_ms, "sim_p95_ms": r_sim.p95_ms,
            "live_p50_ms": r_live.p50_ms, "live_p95_ms": r_live.p95_ms,
            "live_p99_ms": r_live.p99_ms, "attribution_closes": closes,
            "live_p95_components_ms": {c: v * 1e3 for c, v in p95.components_s.items()},
            "live_p95_band_ms": p95.band_latency_s * 1e3},
        "predicted_capacity": {
            **at, "live_qps": cap_live,
            "ms_at_700_items": {"interpolated": card_curve.latency(700) * 1e3,
                                "bucketed": blend.latency(700) * 1e3}},
        "fleet": fleet, "node_seconds": node_s, "seconds": seconds, "live_runs": runs.runs,
        "requests": runs.requests, "launches": runs.launches}
    if seconds > LIVE_SECONDS:
        emit(out)                       # what the phase measured, then the failure
        fail(f"live: the phase took {seconds:.1f} s, more than {LIVE_SECONDS:.0f} s")
    return out


def live_fleet(seed: int, dev, runs: LiveRuns, queries: int) -> dict:
    """``LIVE_FLEET_ARCH`` at its published size on two live nodes, one on
    the card and one on the host CPU with its own copy of the weights, at
    a batch knob of ``LIVE_FLEET_BATCH``.  torch's intra-op threads are
    cut to all cores but two for the part, so the card node's worker and
    the feeders keep a core each, and restored after."""
    cfg = PAPER_MODELS[LIVE_FLEET_ARCH]
    sla = SLA_TARGETS[LIVE_FLEET_ARCH].medium_ms
    threads = torch.get_num_threads()
    cpu_threads = max(1, (os.cpu_count() or 2) - 2)
    card_params = recsys.init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    card = LiveModel(card_params, cfg, seed, dev)
    host = LiveModel(tree_to(card_params, "cpu"), cfg, seed, "cpu")
    runs.models += [card, host]
    unit_times, sizes = sample_trace(np.random.default_rng(seed + 1), queries, PRODUCTION)
    t0 = time.monotonic()
    torch.set_num_threads(cpu_threads)
    try:
        nodes = {"card": card, "host": host}
        curves = {k: runs(f"calibrate {k}", lambda m=m: calibrate_device(
            m.apply, m.make_batch, max_bucket=LIVE_FLEET_BATCH, torch_device=m.dev))
            for k, m in nodes.items()}
        builders = [live_builder(m, k, curves[k], LIVE_FLEET_BATCH, LIVE_FLEET_BATCH)
                    for k, m in nodes.items()]
        specs = [spec_of(b) for b in builders]
        w_card, w_host = (node_capacity(s, sla) for s in specs)
        views = [NodeView("card", 0, specs[0], max(w_card, 1e-9)),
                 NodeView("host", 0, specs[1], max(w_host, 1e-9))]
        # the reference's grid: round_robin is pinned near twice the slower
        # node, hetero approaches the sum; rungs 1.17 apart up to 2.2x the sum
        grid, rate = [], max(2 * min(w_card, w_host) * 0.55, 1.0)
        while rate < 2.2 * (w_card + w_host):
            grid.append(rate)
            rate *= LIVE_STEP
        best_live = {"round_robin": 0.0, "hetero": 0.0}
        best_sim = dict(best_live)
        for name in best_sim:
            best_sim[name] = probe_ladder(grid, lambda q, n=name: sim_fleet_run(
                rescale_trace(unit_times, q), sizes, views, n), sla)
        # live: the two routers in turn at each rung, from the top down, each
        # done at its first passing rung (a failed rung probed once more) and
        # started two rungs above its twin's: with a host node 6-9x slower
        # than the card, the reference's grid spans 18-19 rungs, and an
        # overloaded run lasts as long as the slow node takes to drain it
        top = {n: best_sim[n] * LIVE_STEP ** 2 * (1 + 1e-9) if best_sim[n] else grid[-1]
               for n in best_live}
        for q in sorted(grid, reverse=True):
            for name in [n for n in best_live if not best_live[n] and q <= top[n]]:
                times = rescale_trace(unit_times, q)
                for _ in range(2):
                    r = live_fleet_run(runs, f"{name} at {q:.0f} qps", times, sizes, builders,
                                       name)
                    if r.meets(sla) and r.qps >= SUSTAIN_FRACTION * q:
                        best_live[name] = q
                        break
            if all(best_live.values()):
                break
    finally:
        torch.set_num_threads(threads)
    return {"arch": cfg.name, "sla_ms": sla, "batch_size": LIVE_FLEET_BATCH,
            "max_bucket": LIVE_FLEET_BATCH, "queries_a_run": queries,
            "host_threads": cpu_threads, "threads_restored_to": torch.get_num_threads(),
            "node_qps": {"card": w_card, "host": w_host},
            "calibrated_ms": {k: {str(int(b)): s * 1e3 for b, s in zip(c.buckets, c.seconds)}
                              for k, c in curves.items()},
            "grid_qps": grid, "sim_qps": best_sim, "live_qps": best_live,
            "seconds": time.monotonic() - t0,
            "hetero_over_round_robin_live":
                best_live["hetero"] / max(best_live["round_robin"], 1e-9)}


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


@contextlib.contextmanager
def moe_recorded(drops: list):
    """Within it, every MoE layer appends its dropped share (a 0-d tensor,
    read only after the timed work) to ``drops``."""
    apply = moe_lib.apply_moe

    def run(params, x, **kw):
        y, aux = apply(params, x, **kw)
        drops.append(aux["dropped_frac"])
        return y, aux
    moe_lib.apply_moe = run
    try:
        yield
    finally:
        moe_lib.apply_moe = apply


def check_moe_launches(arch: str, cfg, per_step: list[dict], total: dict) -> None:
    """Every decode step launched exactly n_layers K4 and nothing else, and
    the run (prefill included) nothing more."""
    want = decode_launches(cfg, 1)
    for i, step in enumerate(per_step):
        if step != want:
            fail(f"lm_moe {arch}: step {i} launched {step}, expected {want}")
    if total != decode_launches(cfg, len(per_step)):
        fail(f"lm_moe {arch}: prefill + {len(per_step)} steps launched {total}, "
             f"expected {decode_launches(cfg, len(per_step))}")


def mean_drop(drops: list) -> float:
    return float(torch.stack(drops).float().mean()) if drops else float("nan")


def lm_moe_run(seed: int, dev, gen, arch: str) -> dict:
    """One MoE LM at its published size, bf16, under lm_generate's traffic:
    K4 timed at its heads over n_layers rotating caches; prefill of
    GEN_BATCH prompts of GEN_PROMPT tokens into GEN_CACHE-slot caches, then
    ``MOE_STEPS[arch]`` teacher-forced decode steps, each timed on the
    host's clock with its launches counted, and its logits held against the
    same step through the plain attention and the library attention, each
    on its own copy of the caches; the layers' dropped shares recorded.
    Then the last step again with every K4 call held against the plain
    version, with a zeroed attention (the control) and as a CUDA graph for
    the device's time of a step."""
    cfg = configs.get(arch).config
    steps = MOE_STEPS[arch]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    k4 = time_decode_attention(seed, gen, dev, f"lm_moe {arch}", GEN_BATCH, GEN_CACHE,
                               GEN_PROMPT + GEN_STEPS // 2, n_sets=cfg.n_layers,
                               heads=(cfg.n_heads, cfg.n_kv_heads, cfg.hd))
    params = lm.init(gen, cfg, device=dev)
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(seed), cfg, GEN_BATCH,
                                         GEN_PROMPT + steps)["tokens"]).to(dev)
    prompt = toks[:, :GEN_PROMPT]
    ops.reset_launch_counts()
    prefill_drops: list = []
    with moe_recorded(prefill_drops):
        prefill_ms, (logits, caches) = host_ms(
            lambda: lm.prefill(params, cfg, prompt, GEN_CACHE), n=3)
    if logits.shape != (GEN_BATCH, cfg.vocab) or not bool(torch.isfinite(logits.float()).all()):
        fail(f"lm_moe {arch}: prefill gave shape {tuple(logits.shape)} or non-finite logits")
    prefill_drops = prefill_drops[-cfg.n_layers:]            # the last call's layers
    plain_caches, lib_caches = copy_caches(caches), copy_caches(caches)
    step_ms, agree, lib_agree, per_step, decode_drops = [], [], [], [], []
    for i in range(steps):
        tok = toks[:, GEN_PROMPT + i]
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with moe_recorded(decode_drops):
            got, caches = lm.decode_step(params, cfg, tok, caches)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        after = ops.launch_counts()
        per_step.append({k: after[k] - before[k] for k in KERNELS})
        with attention_as(ref.decode_attention):
            want, plain_caches = lm.decode_step(params, cfg, tok, plain_caches)
        with attention_as(library_decode):
            lib, lib_caches = lm.decode_step(params, cfg, tok, lib_caches)
        agree.append(logits_against(f"lm_moe {arch} step {i}", got, want))
        lib_agree.append(logits_against(f"lm_moe {arch} library step {i}", lib, want))
    launches = ops.launch_counts()
    del lib_caches, plain_caches
    last = [dict(c, pos=c["pos"] - 1) for c in caches]        # rewound: the write repeats
    k4_errs = []
    with attention_as(checked(k4_errs)):
        lm.decode_step(params, cfg, toks[:, -1], last)
    with attention_as(zero_attention):
        zeroed, _ = lm.decode_step(params, cfg, toks[:, -1], last)
    control = logits_against(f"lm_moe {arch} zeroed attention", zeroed, want)
    # the dispatch reads nothing back to the host, so the step captures
    graph_ms = device_ms(lambda i: lm.decode_step(params, cfg, toks[:, -1], last), n_iter=1)
    decode_ms = statistics.median(step_ms[1:])
    res = {"arch": arch, "dtype": cfg.dtype, "params": cfg.param_count,
           "active_params": cfg.active_param_count, "layers": cfg.n_layers,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd],
           "experts": cfg.n_experts, "top_k": cfg.top_k, "batch": GEN_BATCH,
           "prompt": GEN_PROMPT, "cache_slots": GEN_CACHE, "steps": steps,
           "capacity_prefill": moe_lib.moe_capacity(GEN_BATCH * GEN_PROMPT, cfg.n_experts,
                                                    cfg.top_k),
           "capacity_decode": moe_lib.moe_capacity(GEN_BATCH, cfg.n_experts, cfg.top_k),
           "dropped_frac_prefill": mean_drop(prefill_drops),
           "dropped_frac_decode": mean_drop(decode_drops),
           "dropped_frac_decode_max": float(torch.stack(decode_drops).max()),
           "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": GEN_BATCH * GEN_PROMPT / prefill_ms * 1e3,
           "decode_ms_per_step": decode_ms, "decode_ms_first_step": step_ms[0],
           "decode_tokens_per_s": GEN_BATCH / decode_ms * 1e3,
           "decode_device_ms_per_step_graph": graph_ms,
           "logits_l2_rel_err_vs_plain": [a["l2_rel"] for a in agree],
           "library_logits_l2_rel_err_vs_plain": [a["l2_rel"] for a in lib_agree],
           "top1_agreement": statistics.mean(a["top1"] for a in agree),
           "library_top1_agreement": statistics.mean(a["top1"] for a in lib_agree),
           "zeroed_attention_vs_plain": control,
           "logits_l2_tol": LOGITS_L2_TOL,
           "k4_calls_checked": len(k4_errs), "k4_max_abs_err_in_model": max(k4_errs),
           "k4": k4, "held_before_bytes": held,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_per_step": per_step[0]}
    del params, caches, last
    torch.cuda.empty_cache()
    emit({"phase": "lm_moe_run", **res})                  # the distances, before the gates
    check_moe_launches(arch, cfg, per_step, launches)
    if len(k4_errs) != cfg.n_layers:
        fail(f"lm_moe {arch}: {len(k4_errs)} K4 calls checked in a step of {cfg.n_layers} layers")
    gate_logits(f"lm_moe {arch}", max(agree, key=lambda a: a["l2_rel"]), control)
    return res


def lm_moe(seed: int, dev, gen) -> dict:
    """granite-moe-1b-a400m, then qwen3-moe-30b-a3b, each freeing what it
    holds before the next."""
    t0 = time.monotonic()
    runs = [lm_moe_run(seed, dev, gen, arch) for arch in MOE_STEPS]
    return {"phase": "lm_moe", "runs": runs, "seconds": time.monotonic() - t0,
            "launches": {k: sum(r["launches"][k] for r in runs) for k in KERNELS}}


# ----------------------------------------------------------------------- remote


def compute_apps() -> str:
    return subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout


def card_memory_mib() -> int:
    """The card's memory in use, MiB, by nvidia-smi: every process's."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30).stdout
    return int(out.split()[0])                             # one card: its line


def parse_compute_apps(smi: str) -> list[tuple[int, str]]:
    """(pid, used memory) of each process ``nvidia-smi --query-compute-apps=
    pid,used_memory --format=csv,noheader`` lists as holding the card."""
    rows = []
    for line in smi.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) >= 2 and parts[0].isdigit():
            rows.append((int(parts[0]), parts[1]))
    return rows


def device_files(pid: int) -> list[str]:
    """The device files under /dev/nvidia* that process ``pid`` holds open."""
    fd_dir = Path(f"/proc/{pid}/fd")
    out = []
    for fd in fd_dir.iterdir():
        with contextlib.suppress(OSError):
            target = os.readlink(fd)
            if target.startswith("/dev/nvidia"):
                out.append(target)
    return sorted(set(out))


def workers_on_the_card(pids: list[int], own_pid: int, before: str, during: str,
                        after: str, files: dict[int, list[str]],
                        memory_mib: tuple[int, int]) -> dict:
    """The card's own account that each worker holds it, from nvidia-smi's
    compute apps before the workers booted, while they serve and after they
    are gone.  Where nvidia-smi reports this process's own pid (one pid
    namespace), every worker's pid must be listed.  In a container with a
    pid namespace of its own nvidia-smi cannot name the container's pids
    (it lists another pid for every process): then the list must grow by
    exactly the workers while they serve and shrink back after, and each
    worker must hold a card's device file (/dev/nvidiaN) open.  A worker's
    device memory is then its share of what the card's use grew by while
    they serve (``memory_mib``, before and during): the per-app figures of
    a namespace that hides the pids are not the apps'."""
    b, d, a = (parse_compute_apps(x) for x in (before, during, after))
    listed = [pid for pid, _ in d]
    res = {"compute_apps_before": b, "compute_apps_during": d, "compute_apps_after": a,
           "device_files": {str(p): files.get(p, []) for p in pids}}
    if own_pid in listed:
        missing = [p for p in pids if p not in listed]
        if missing:
            fail(f"remote: worker pids {missing} are not among nvidia-smi's compute apps "
                 f"{sorted(set(listed))}")
        return {**res, "pids_listed": True,
                "device_memory": {str(p): m for p, m in d if p in pids}}
    if len(d) - len(b) != len(pids) or len(a) != len(b):
        fail(f"remote: nvidia-smi lists {len(b)} compute apps before the {len(pids)} workers, "
             f"{len(d)} while they serve and {len(a)} after: not one more a worker")
    off = [p for p in pids if not any(f[len("/dev/nvidia"):].isdigit() for f in files.get(p, []))]
    if off:
        fail(f"remote: workers {off} hold no card's device file open ({res['device_files']})")
    return {**res, "pids_listed": False,
            "device_memory_mib_each": (memory_mib[1] - memory_mib[0]) / len(pids)}


def check_remote_run(what: str, r, offered: int, killed: bool) -> None:
    """Every offered query served once, none dropped or errored; after a
    kill, some of the victim's queries re-routed."""
    if r.n_queries != offered or r.dropped or r.errors:
        fail(f"remote {what}: {r.n_queries} of {offered} queries served, "
             f"{r.dropped} dropped, {r.errors} errored")
    if killed and not r.rerouted:
        fail(f"remote {what}: the killed worker's queries were not re-routed")


def node_stats(backends) -> list[dict]:
    """Per node of a run: queries served, their QPS over the node's span
    (first arrival to last completion), p50 and p95 in ms."""
    rows = []
    for b in backends:
        recs = b.completed_records()
        lat = np.array([r.t_done - r.t_arrival for r in recs]) * 1e3
        span = (max(r.t_done for r in recs) - min(r.t_arrival for r in recs)) if recs else 0.0
        rows.append({"node": f"{b.pool}[{b.index_in_pool}]", "queries": len(recs),
                     "qps": len(recs) / span if span > 0 else 0.0,
                     "p50_ms": float(np.percentile(lat, 50)) if recs else None,
                     "p95_ms": float(np.percentile(lat, 95)) if recs else None})
    return rows


def remote_trace(rng, rate: float, kill_t: float | None):
    """REMOTE_HORIZON_S of production-sized queries at ``rate``; with a kill,
    a quarter of them in a flash crowd just before it, so that the victim
    dies holding a queue (examples/remote_fleet.py's trace)."""
    n = int(rate * REMOTE_HORIZON_S)
    sizes = SizeDist("production", max_size=REMOTE_MAX_BUCKET).sample(rng, n)
    if kill_t is None:
        return np.sort(rng.uniform(0.0, REMOTE_HORIZON_S, n)), sizes
    n_burst = n // 4
    times = np.sort(np.concatenate([
        rng.uniform(0.0, REMOTE_HORIZON_S, n - n_burst),
        rng.uniform(kill_t - 0.03 * REMOTE_HORIZON_S, kill_t - 1e-3, n_burst)]))
    return times, sizes


def remote(seed: int) -> dict:
    """Two card workers behind the supervisor: boot and calibrate in
    lockstep, prove with nvidia-smi that they hold the card, serve a clean
    trace, then one with a SIGKILL mid-run; every worker gone at the end."""
    t_phase = time.monotonic()
    rng = np.random.default_rng(seed)
    clock = WallClock()
    spawned = []
    before, mem_before = compute_apps(), card_memory_mib()
    with WorkerSupervisor() as sup:                       # workers on the card
        fleet = boot_remote_fleet(REMOTE_MODEL, REMOTE_NODES, supervisor=sup,
                                  batch_size=REMOTE_MAX_BUCKET, max_bucket=REMOTE_MAX_BUCKET,
                                  burst=16, reps=3, clock=clock)
        spawned = [b.handle for b in fleet]
        pids = [h.pid for h in spawned]
        devices = [sup.ping(h)["device"] for h in spawned]
        if devices != ["cuda"] * REMOTE_NODES:
            fail(f"remote: workers report devices {devices}, not the card")
        during, mem_during = compute_apps(), card_memory_mib()
        files = {p: device_files(p) for p in pids}
        boot_s = fleet[0].spec.boot_s
        b64_s = max(b.spec.cpu.latency(REMOTE_MAX_BUCKET) for b in fleet)
        rate = REMOTE_NODES * REMOTE_LOAD / b64_s
        runs = {}
        for what, kill_t in (("clean", None), ("sigkill", 0.5 * REMOTE_HORIZON_S)):
            times, sizes = remote_trace(rng, rate, kill_t)
            clock.origin = None                           # a fresh trace, a fresh anchor
            for b in fleet:
                b.reset_run()
            faults = FleetFaults(kills=(NodeKill(kill_t, "remote", 0),)) if kill_t else None
            r = drive_fleet(times, sizes, fleet, make_router("least_outstanding"),
                            window_s=REMOTE_HORIZON_S / 8, fleet_faults=faults,
                            drain_timeout=30)
            check_remote_run(what, r, len(times), killed=kill_t is not None)
            runs[what] = {"queries": len(times), "offered_qps": rate, "qps": r.qps,
                          "p50_ms": r.p50_ms, "p95_ms": r.p95_ms, "p99_ms": r.p99_ms,
                          "rerouted": r.rerouted, "dropped": r.dropped, "errors": r.errors,
                          "nodes": node_stats(fleet)}
        victim = fleet[0].handle
        if victim.proc.returncode != -9:
            fail(f"remote: the victim exited with {victim.proc.returncode}, not SIGKILL")
        reaped = [h.pid for h in sup.reap()]
        if reaped != [victim.pid]:
            fail(f"remote: the supervisor reaped {reaped}, expected [{victim.pid}]")
        for b in fleet:
            b.close()
    alive = [h.pid for h in spawned if h.proc.poll() is None]
    if alive:
        fail(f"remote: workers {alive} outlived the phase")
    after = compute_apps()
    for _ in range(50):                 # a process's context is let go within moments
        if len(parse_compute_apps(after)) <= len(parse_compute_apps(before)):
            break
        time.sleep(0.1)
        after = compute_apps()
    card = workers_on_the_card(pids, os.getpid(), before, during, after, files,
                               (mem_before, mem_during))
    seconds = time.monotonic() - t_phase
    if seconds > REMOTE_SECONDS:
        fail(f"remote: the phase took {seconds:.1f} s, past its {REMOTE_SECONDS:.0f} s")
    return {"phase": "remote", "model": REMOTE_MODEL, "workers": REMOTE_NODES, "pids": pids,
            "devices": devices, "on_the_card": card,
            "boot_and_calibrate_s": boot_s, "calibrated_ms": {
                str(k): [b.spec.cpu.latency(k) * 1e3 for b in fleet]
                for k in (1, 8, REMOTE_MAX_BUCKET)},
            "runs": runs, "victim_returncode": victim.proc.returncode, "reaped": reaped,
            "seconds": seconds}


# ------------------------------------------------------------------------- main


# ------------------------------------------------------------------------ train


def recsys_optimizer() -> optim.Optimizer:
    """The reference's split (src/repro/launch/train.py): adagrad on the
    tables, AdamW on the dense towers."""
    return optim.combined(lambda path: "table" in str(path), optim.adagrad(0.02),
                          optim.adamw(1e-3))


class _PlainBag(torch.autograd.Function):
    """The stacked bag's plain forward, and ``bwd`` in float64 as its
    backward, cast to the tables' dtype."""

    @staticmethod
    def forward(ctx, tables, idx, mode, bwd):
        ctx.save_for_backward(idx)
        ctx.mode, ctx.vocab, ctx.dtype, ctx.bwd = mode, tables.shape[1], tables.dtype, bwd
        return ref.embedding_bag_stacked(tables, idx, mode=mode)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return ctx.bwd(grad.double(), idx, ctx.vocab, mode=ctx.mode).to(ctx.dtype), None, None, None


class _PlainDot(torch.autograd.Function):
    """The dot interaction's plain forward, and ``bwd`` in float64 as its
    backward, cast to the features' dtype."""

    @staticmethod
    def forward(ctx, feats, bwd):
        ctx.save_for_backward(feats)
        ctx.bwd = bwd
        return ref.dot_interaction_packed(feats)

    @staticmethod
    def backward(ctx, grad):
        (feats,) = ctx.saved_tensors
        return ctx.bwd(grad.double(), feats.double()).to(feats.dtype), None


@contextlib.contextmanager
def plain_backward(k1_bwd=ref.embedding_bag_backward, k2_bwd=ref.dot_interaction_backward):
    """Inside, the model's pooling and dot interaction run their plain
    forwards, and ``k1_bwd`` / ``k2_bwd`` (the plain backward versions, in
    float64, unless a test hands in broken ones) as their backwards: no
    kernel launches."""
    kernels = ops.embedding_bag, ops.dot_interaction
    ops.embedding_bag = lambda tables, idx, mode="sum": _PlainBag.apply(tables, idx, mode, k1_bwd)
    ops.dot_interaction = lambda feats: _PlainDot.apply(feats, k2_bwd)
    try:
        yield
    finally:
        ops.embedding_bag, ops.dot_interaction = kernels


def step_grads(loss_fn, params, batch) -> tuple[float, dict]:
    """One step's loss and every leaf's gradient, by path."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    return float(loss), dict(leaves_with_paths(grads))


def compare_large(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
                  atol: float) -> float:
    """``compare`` over slices of 2^26 elements, so a 5 GB gradient is never
    widened to float64 whole."""
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    return max(compare(name, g, w, rtol, atol)
               for g, w in zip(got.reshape(-1).split(1 << 26), want.reshape(-1).split(1 << 26)))


def grad_compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A gradient against its float64 value: |got - want| <= TOL·|want| +
    TOL·max|want| with float32's TOL.  The atol scales with the gradient: a
    table's row sums thousands of terms under Zipf ids, in float32 and in
    no fixed order, and where they cancel the sum is far smaller than the
    partial sums whose rounding it carries; a term dropped or counted twice
    moves an element by a whole term's size, far outside."""
    tol = TOL[torch.float32]
    return compare_large(name, got, want, tol, tol * float(want.abs().max()))


def check_train_grads(what: str, got: dict, want: dict) -> float:
    """Every leaf of a step's gradients against the plain step's
    (``grad_compare``).  Returns the largest error."""
    if got.keys() != want.keys():
        fail(f"{what}: gradient leaves {sorted(got)} != {sorted(want)}")
    return max(grad_compare(f"{what} grad {k}", got[k], w) for k, w in want.items())


def expect_train_launches(what: str, launches: dict, steps: int) -> None:
    """Exactly one K1, K1-bwd, K2 and K2-bwd a step, and nothing else."""
    want = {**dict.fromkeys(KERNELS, 0), "embedding_bag": steps, "dot_interaction": steps,
            "embedding_bag_backward": steps, "dot_interaction_backward": steps}
    if launches != want:
        fail(f"train {what}: {steps} steps launched {launches}, expected {want}")


def check_backward_kernels(rng, gen, dev, vocab: int) -> tuple[list, float, float]:
    """K1-bwd and K2-bwd against their plain versions in float64 on the same
    inputs: small shapes of every path (mean pooling, bfloat16, D = 1 and
    130, H = 1), then the DLRMs' shapes at B = 1, 64 and 1,024, RMC2's
    tables at V = ``vocab``.  K1-bwd (float32 whatever its input) by
    ``grad_compare``; K2-bwd, which sums F terms in a fixed order, at
    float32's TOL, bfloat16's for a bfloat16 result."""
    checks, k1_err, k2_err = [], 0.0, 0.0
    for b, f, v, h, d, dtype, mode in [(9, 3, 50, 80, 1, torch.float32, "sum"),
                                       (33, 2, 100, 5, 130, torch.float32, "mean"),
                                       (65, 4, 1000, 1, 32, torch.bfloat16, "sum"),
                                       (17, 2, 64, 16, 128, torch.bfloat16, "mean")]:
        g = torch.randn((b, f, d), generator=gen, device=dev).to(dtype)
        idx = zipf_ids(rng, (b, f, h), v, dev)
        err = grad_compare(f"embedding_bag_backward {b, f, v, h, d} {dtype} {mode}",
                           ops.embedding_bag_backward(g, idx, v, mode=mode),
                           ref.embedding_bag_backward(g.double(), idx, v, mode=mode))
        checks.append({"fn": "embedding_bag_backward", "shape": [b, f, v, h, d],
                       "dtype": str(dtype), "mode": mode, "max_abs_err": err})
    for name, f, h in [("dlrm-rmc1", 10, 80), (TRAIN_ARCH, 40, 80)]:
        for b in MAIN_BATCHES:
            g = torch.randn((b, f, 32), generator=gen, device=dev)
            idx = zipf_ids(rng, (b, f, h), vocab, dev)
            got = ops.embedding_bag_backward(g, idx, vocab)
            err = grad_compare(f"embedding_bag_backward {name} B={b}", got,
                               ref.embedding_bag_backward(g.double(), idx, vocab))
            if not torch.equal(ops.embedding_bag_backward(g, idx, vocab), got):
                fail(f"embedding_bag_backward {name} B={b}: a second launch gave other bits")
            del got
            k1_err = max(k1_err, err)
            checks.append({"fn": "embedding_bag_backward", "model": name,
                           "shape": [b, f, vocab, h, 32], "max_abs_err": err})
            torch.cuda.empty_cache()
    for b, f, d, dtype in [(7, 2, 1, torch.float32), (33, 5, 130, torch.float32),
                           (64, 27, 16, torch.bfloat16), (9, 41, 32, torch.bfloat16)]:
        x = (torch.randn((b, f, d), generator=gen, device=dev) / d ** 0.5).to(dtype)
        g = torch.randn((b, f * (f - 1) // 2), generator=gen, device=dev).to(dtype)
        err = compare(f"dot_interaction_backward {b, f, d} {dtype}",
                      ops.dot_interaction_backward(g, x),
                      ref.dot_interaction_backward(g.double(), x.double()), TOL[dtype], TOL[dtype])
        checks.append({"fn": "dot_interaction_backward", "shape": [b, f, d], "dtype": str(dtype),
                       "max_abs_err": err})
    for name, f in [("dlrm-rmc1/3", 11), (TRAIN_ARCH, 41)]:
        for b in MAIN_BATCHES:
            x = torch.randn((b, f, 32), generator=gen, device=dev) / 32 ** 0.5
            g = torch.randn((b, f * (f - 1) // 2), generator=gen, device=dev)
            got = ops.dot_interaction_backward(g, x)
            err = compare(f"dot_interaction_backward {name} B={b}", got,
                          ref.dot_interaction_backward(g.double(), x.double()),
                          TOL[torch.float32], TOL[torch.float32])
            if not torch.equal(ops.dot_interaction_backward(g, x), got):
                fail(f"dot_interaction_backward {name} B={b}: a second launch gave other bits")
            k2_err = max(k2_err, err)
            checks.append({"fn": "dot_interaction_backward", "model": name, "shape": [b, f, 32],
                           "max_abs_err": err})
    return checks, k1_err, k2_err


def distinct_rows(sets: list[torch.Tensor], vocab: int) -> float:
    """Mean count of distinct (table, row) pairs an index set touches."""
    f = sets[0].shape[1]
    offs = (torch.arange(f, device=sets[0].device, dtype=torch.int64) * vocab)[None, :, None]
    return statistics.mean(int(torch.unique(s.long() + offs).numel()) for s in sets)


def time_embedding_bag_backward(rng, gen, dev, tables: torch.Tensor, batch: int, ids: str,
                                h: int = PAPER_MODELS[TRAIN_ARCH].hotness) -> dict:
    """K1-bwd at the tables' shape: the kernel alone into a standing float32
    buffer (the wrapper's zeroing timed apart), the wrapper's call (zeroing,
    kernel), the plain version, and the library's dense backward of
    ``F.embedding_bag`` over the same flat table and bags.  ``ids`` 'zipf'
    (the training data's skew: a table's hot rows fall to a few owning
    warps) or 'uniform'.  The bound reads the gradient rows and the indices once and
    reads and writes every touched row of the gradient once; zeroing the
    dense buffer has its own bound."""
    f, v, d = tables.shape
    if ids == "zipf":
        sets = [zipf_ids(rng, (batch, f, h), v, dev) for _ in range(8)]
    else:
        sets = [torch.from_numpy(rng.integers(0, v, (batch, f, h)).astype(np.int32)).to(dev)
                for _ in range(8)]
    gs = [torch.randn((batch, f, d), generator=gen, device=dev) for _ in range(8)]
    buf = torch.zeros((f, v, d), device=dev)
    log_w = eb_kernel.backward_warps(f, ix_kernel.sm_count(dev.index or 0))
    distinct = distinct_rows(sets, v)
    bytes_moved = batch * f * d * 4 + batch * f * h * 4 + 2 * distinct * d * 4
    flops = batch * f * h * d
    res = {
        "batch": batch, "ids": ids, "distinct_rows": distinct, "lookups": batch * f * h,
        "warps_a_table": 1 << log_w,
        "kernel_ms": device_ms(lambda i: eb_kernel.launch_backward(gs[i % 8], sets[i % 8], buf,
                                                                  mean=False, log_w=log_w)),
        "zero_ms": device_ms(lambda i: buf.zero_()),
        "kernel_call_ms": call_ms(lambda i: ops.embedding_bag_backward(gs[i % 8], sets[i % 8], v),
                                  n_iter=10),
        "plain_ms": call_ms(lambda i: ref.embedding_bag_backward(gs[i % 8], sets[i % 8], v),
                            n_iter=5, warmup=1),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
        else "operations",
        "zero_bound_ms": f * v * d * 4 / HBM_BYTES_PER_S * 1e3,
    }
    del buf
    flat = tables.view(f * v, d).detach().requires_grad_()
    offs = (torch.arange(f, device=dev, dtype=torch.int64) * v)[None, :, None]
    outs = [torch.nn.functional.embedding_bag((sets[j].long() + offs).reshape(batch * f, h), flat,
                                              mode="sum") for j in range(2)]
    res["library_ms"] = call_ms(lambda i: torch.autograd.grad(
        outs[i % 2], flat, gs[i % 2].view(batch * f, d), retain_graph=True), n_iter=5, warmup=1)
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    return res


def time_dot_interaction_backward(gen, dev, batch: int = TRAIN_BATCH,
                                  arch: str = TRAIN_ARCH) -> dict:
    """K2-bwd at a DLRM model's shape (float32), eight input sets rotating,
    beside its plain version and the library's: autograd's backward of the
    ``bmm`` and gather forward.  The bound reads features and gradients once
    and writes the result once; its operations are 2·D for each ordered
    pair (i, j), i != j."""
    f = recsys._num_feature_rows(PAPER_MODELS[arch])
    d = PAPER_MODELS[arch].embed_dim
    n_out = f * (f - 1) // 2
    xs = [torch.randn((batch, f, d), generator=gen, device=dev) / d ** 0.5 for _ in range(8)]
    gs = [torch.randn((batch, n_out), generator=gen, device=dev) for _ in range(8)]
    bytes_moved = batch * (2 * f * d + n_out) * 4
    flops = 2 * batch * f * (f - 1) * d
    pairs = torch.from_numpy(ref.tril_pairs(f)).to(dev)
    xr = [x.clone().requires_grad_() for x in xs[:2]]
    outs = [torch.bmm(x, x.transpose(1, 2)).reshape(batch, f * f)[:, pairs] for x in xr]
    res = {
        "arch": arch, "batch": batch, "shape": [batch, f, d],
        "plan": ix_kernel.backward_plan(batch, f, d)._asdict(),
        "kernel_ms": device_ms(lambda i: ops.dot_interaction_backward(gs[i % 8], xs[i % 8])),
        "kernel_call_ms": call_ms(lambda i: ops.dot_interaction_backward(gs[i % 8], xs[i % 8])),
        "plain_ms": device_ms(lambda i: ref.dot_interaction_backward(gs[i % 8], xs[i % 8])),
        "library_ms": call_ms(lambda i: torch.autograd.grad(outs[i % 2], xr[i % 2], gs[i % 2],
                                                            retain_graph=True)),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
        else "operations",
    }
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    return res


def train_step_ms(loss_fn, params, opt, opt_state, batches: list) -> dict:
    """Medians over ``batches`` (the first a warm-up) of a training step's
    parts on the device's clock, host issue included: forward (the loss),
    backward (every gradient), optimiser (clip and update)."""
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": [], "step_ms": []}
    for i, batch in enumerate(batches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

        def timed(p, b, ev=ev):
            loss = loss_fn(p, b)
            ev[1].record()
            return loss

        ev[0].record()
        _, grads = value_and_grad(timed, params, batch)
        ev[2].record()
        params, opt_state = opt.update(optim.clip_by_global_norm(grads, TRAIN_CLIP), opt_state,
                                       params)
        ev[3].record()
        torch.cuda.synchronize()
        del grads
        if i:
            for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3), (0, 3))):
                parts[k].append(ev[a].elapsed_time(ev[b]))
    return {k: statistics.median(v) for k, v in parts.items()}


def check_losses(what: str, losses: list, n: int) -> None:
    if len(losses) != n or not all(np.isfinite(losses)):
        fail(f"train {what}: losses {losses}, expected {n} finite ones")


def train_recsys(seed: int, dev, gen) -> dict:
    """DLRM-RMC2 at its published size: (a) one step's gradients through the
    kernels against the plain backward versions, then TRAIN_STEPS steps of
    ``train`` with exactly one K1, K1-bwd, K2 and K2-bwd a step; (c) a run
    stopped at TRAIN_RESUME_AT with a checkpoint and resumed from it, its
    losses against the straight run's; (b) a step's parts timed, and K1-bwd
    and K2-bwd checked against their plain versions and timed."""
    cfg = PAPER_MODELS[TRAIN_ARCH]
    rng = np.random.default_rng(seed)
    params = recsys.init(gen, cfg, device=dev)
    batches = [to_device(syn.recsys_batch(rng, cfg, TRAIN_BATCH), dev) for _ in range(TRAIN_STEPS)]

    def loss_fn(p, b):
        return recsys.loss_fn(p, cfg, b)

    ops.reset_launch_counts()
    loss_k, grads_k = step_grads(loss_fn, params, batches[0])
    expect_train_launches("gradient step", ops.launch_counts(), 1)
    before = ops.launch_counts()
    with plain_backward():
        loss_p, grads_p = step_grads(loss_fn, params, batches[0])
    if ops.launch_counts() != before:
        fail("train: the plain step launched a kernel")
    grad_err = check_train_grads("train", grads_k, grads_p)
    loss_err = compare("train loss", torch.tensor(loss_k), torch.tensor(loss_p), 1e-5, 0.0)
    del grads_k, grads_p
    torch.cuda.empty_cache()

    def run(steps, batch_list, losses, **kw):
        return train(loss_fn, recsys_optimizer(), params, iter(batch_list), num_steps=steps,
                     log_every=0, clip_norm=TRAIN_CLIP,
                     hooks=[lambda s, p, m: losses.append(float(m["loss"]))], **kw)

    straight = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = run(TRAIN_STEPS, batches, straight)
    torch.cuda.synchronize()
    straight_s = time.monotonic() - t0
    launches = ops.launch_counts()
    expect_train_launches(f"{TRAIN_STEPS} steps", launches, TRAIN_STEPS)
    check_losses("straight run", straight, TRAIN_STEPS)
    del state
    torch.cuda.empty_cache()

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    try:
        first, resumed = [], []
        t0 = time.monotonic()
        run(TRAIN_RESUME_AT, batches, first, ckpt_dir=str(TRAIN_CKPT),
            ckpt_every=TRAIN_RESUME_AT)
        save_s = time.monotonic() - t0
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        state = run(TRAIN_STEPS, batches[TRAIN_RESUME_AT:], resumed, ckpt_dir=str(TRAIN_CKPT),
                    ckpt_every=TRAIN_STEPS)
        resume_s = time.monotonic() - t0
        expect_train_launches("resumed run", ops.launch_counts(), TRAIN_STEPS - TRAIN_RESUME_AT)
        launches = {k: launches[k] + n for k, n in ops.launch_counts().items()}
        del state
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    check_losses("resumed run", resumed, TRAIN_STEPS - TRAIN_RESUME_AT)
    resume_err = compare("train resumed losses", torch.tensor(resumed),
                         torch.tensor(straight[TRAIN_RESUME_AT:]), TRAIN_RESUME_RTOL, 0.0)
    compare("train stopped run's losses", torch.tensor(first),
            torch.tensor(straight[:TRAIN_RESUME_AT]), TRAIN_RESUME_RTOL, 0.0)

    opt = recsys_optimizer()
    parts = train_step_ms(loss_fn, params, opt, opt.init(params),
                          batches[:TRAIN_TIMED_STEPS + 1])
    torch.cuda.empty_cache()
    checks, k1_err, k2_err = check_backward_kernels(rng, gen, dev, cfg.vocab)
    k1_times = [time_embedding_bag_backward(rng, gen, dev, params["tables"], TRAIN_BATCH, ids)
                for ids in ("zipf", "uniform")]
    k2_time = time_dot_interaction_backward(gen, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del params, batches
    torch.cuda.empty_cache()
    return {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
            "first_loss": straight[0], "last_loss": straight[-1], "losses": straight,
            "grad_max_abs_err": grad_err, "loss_abs_err": loss_err, "tol": TOL[torch.float32],
            "ms_a_step_host": straight_s / TRAIN_STEPS * 1e3, **parts,
            "resumed_from": TRAIN_RESUME_AT, "resumed_losses": resumed,
            "resume_max_abs_err": resume_err, "resume_rtol": TRAIN_RESUME_RTOL,
            "checkpoint_save_s": save_s, "resume_run_s": resume_s,
            "launches": launches, "backward_checks": checks,
            "embedding_bag_backward_max_abs_err": k1_err,
            "dot_interaction_backward_max_abs_err": k2_err,
            "timings_embedding_bag_backward": k1_times,
            "timing_dot_interaction_backward": k2_time, "peak_gb": peak / 1e9}


def train_lm(seed: int, dev, gen) -> dict:
    """qwen2-0.5b at its published size (bf16): the chunked loss against the
    whole one on the first batch, then LM_TRAIN_STEPS AdamW steps of
    ``train``, every loss finite and no kernel launched (the LM trains
    through plain attention)."""
    cfg = configs.get(LM_ARCH).config
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init(gen, cfg, device=dev)
    rng = np.random.default_rng(seed)
    batches = [to_device(syn.lm_batch(rng, cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ), dev)
               for _ in range(LM_TRAIN_STEPS)]
    b0 = batches[0]
    with torch.no_grad():
        chunked = float(lm.loss_fn(params, cfg, b0))
        hidden, _ = lm.forward_hidden(params, cfg, b0["tokens"])
        whole = float(lm._chunk_nll(params, cfg, hidden, b0["labels"])) / hidden.shape[:2].numel()
        del hidden
    compare("train_lm chunked loss vs whole", torch.tensor(chunked), torch.tensor(whole),
            LM_CHUNK_RTOL, 0.0)
    losses = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = train(lambda p, b: lm.loss_fn(p, cfg, b), optim.adamw(3e-4), params, iter(batches),
                  num_steps=LM_TRAIN_STEPS, log_every=0, clip_norm=TRAIN_CLIP,
                  hooks=[lambda s, p, m: losses.append(float(m["loss"]))])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    if any(launches.values()):
        fail(f"train_lm: launched {launches}; the LM trains through no kernel")
    check_losses("lm", losses, LM_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    del state, params, batches
    torch.cuda.empty_cache()
    return {"arch": LM_ARCH, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
            "steps": LM_TRAIN_STEPS, "losses": losses, "chunked_loss": chunked,
            "whole_loss": whole, "chunk_rtol": LM_CHUNK_RTOL,
            "ms_a_step_host": wall / LM_TRAIN_STEPS * 1e3, "launches": launches,
            "peak_gb": peak / 1e9}


def train_phase(seed: int, dev, gen) -> dict:
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    line = {"phase": "train", "recsys": train_recsys(seed, dev, gen)}
    line["lm"] = train_lm(seed, dev, gen)
    line["seconds"] = time.monotonic() - t0
    line["launches"] = line["recsys"]["launches"]
    return line


# ------------------------------------------------------------------ gnn


def gnn_run(loss_fn, params, batch: dict, steps: int):
    """``steps`` AdamW steps of train.loop on one batch, from ``params``
    (left unchanged): (losses, ms a step on the host's clock ended by a
    synchronise, the trained parameters)."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = train(loss_fn, optim.adamw(GNN_LR), params, iter(lambda: batch, None),
                  num_steps=steps, log_every=0, clip_norm=TRAIN_CLIP,
                  hooks=[lambda s, p, m: losses.append(float(m["loss"]))])
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / steps * 1e3
    check_losses("gnn", losses, steps)
    return losses, ms, state.params


def step_profile(fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of its
    ``top`` longest kernels (by name, summed over launches), the sum over all
    its kernels, and that sum's share of the call's wall time, the device's
    busy share (the kernels run on one stream, so they do not overlap).
    None where the trace saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((getattr(e, "device_time_total", 0.0) / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA), reverse=True)
    total = sum(ms for ms, _, _ in kernels)
    if not total:
        return {"wall_ms": wall_ms, "device_ms": None}
    return {"wall_ms": wall_ms, "device_ms": total, "busy_share": total / wall_ms,
            "launches": sum(n for _, n, _ in kernels),
            "top": [{"kernel": k[:90], "ms": ms, "launches": n} for ms, n, k in kernels[:top]]}


def check_same_bits(what: str, a: list, b: list) -> None:
    if a != b:
        fail(f"gnn {what}: a second run gave other losses: {a} vs {b}")


def gnn_cora(rng, gen, dev) -> dict:
    """full_graph_sm (Cora's shape): step 0's loss and every gradient against
    the same weights on the CPU in float64; GNN_CORA_STEPS AdamW steps, twice
    from the same weights (the same losses to the bit); train accuracy
    before and after (it must rise)."""
    shape = configs.GNN_SHAPES["full_graph_sm"]
    cfg = gcn_cora.config_for_shape(shape)
    t0 = time.monotonic()
    g = syn.random_graph(rng, shape.n_nodes, shape.n_edges, cfg.d_feat, cfg.n_classes)
    host_s = time.monotonic() - t0
    batch = to_device(g, dev)
    params = gnn.init(gen, cfg, device=dev)

    def loss_fn(p, b):
        return gnn.loss_fn(p, cfg, b)

    loss, grads = step_grads(loss_fn, params, batch)
    loss64, grads64 = step_grads(loss_fn, tree_map(lambda t: t.cpu().double(), params),
                                 {k: (v.cpu().double() if v.is_floating_point() else v.cpu())
                                  for k, v in batch.items()})
    loss_err = compare("gnn cora loss vs float64", torch.tensor(loss), torch.tensor(loss64),
                       TOL[torch.float32], 0.0)
    grad_err = check_train_grads("gnn cora", {k: v.cpu() for k, v in grads.items()}, grads64)

    def accuracy(p) -> float:
        with torch.no_grad():
            pred = gnn.forward(p, cfg, batch["x"], batch["edge_index"]).argmax(-1)
        m = batch["train_mask"]
        return float((pred[m] == batch["labels"][m].long()).float().mean())

    acc0 = accuracy(params)
    losses, ms, trained = gnn_run(loss_fn, params, batch, GNN_CORA_STEPS)
    check_same_bits("cora", losses, gnn_run(loss_fn, params, batch, GNN_CORA_STEPS)[0])
    acc1 = accuracy(trained)
    if not acc1 > acc0:
        fail(f"gnn cora: train accuracy did not rise ({acc0} -> {acc1})")
    return {"nodes": shape.n_nodes, "edges": shape.n_edges, "d_feat": cfg.d_feat,
            "classes": cfg.n_classes, "graph_host_s": host_s,
            "loss_abs_err_vs_float64": loss_err, "grad_max_abs_err_vs_float64": grad_err,
            "tol": TOL[torch.float32], "steps": GNN_CORA_STEPS, "first_loss": losses[0],
            "last_loss": losses[-1], "train_accuracy_before": acc0,
            "train_accuracy_after": acc1, "ms_a_step": ms, "second_run_same_bits": True}


def gnn_molecule(rng, gen, dev) -> dict:
    """molecule: 128 graphs of 30 nodes and 64 edges, GNN_MOLECULE_STEPS
    AdamW steps of graph_loss_fn, twice (the same losses to the bit)."""
    shape = configs.GNN_SHAPES["molecule"]
    cfg = gcn_cora.config_for_shape(shape)
    t0 = time.monotonic()
    mb = syn.molecule_batch(rng, shape.batch, shape.nodes_per_graph, shape.edges_per_graph,
                            cfg.d_feat, cfg.n_classes)
    host_s = time.monotonic() - t0
    batch = to_device(mb, dev)
    params = gnn.init(gen, cfg, device=dev)

    def loss_fn(p, b):
        return gnn.graph_loss_fn(p, cfg, b)

    losses, ms, _ = gnn_run(loss_fn, params, batch, GNN_MOLECULE_STEPS)
    check_same_bits("molecule", losses, gnn_run(loss_fn, params, batch, GNN_MOLECULE_STEPS)[0])
    return {"graphs": shape.batch, "nodes_per_graph": shape.nodes_per_graph,
            "edges_per_graph": shape.edges_per_graph, "graph_host_s": host_s,
            "steps": GNN_MOLECULE_STEPS, "first_loss": losses[0], "last_loss": losses[-1],
            "ms_a_step": ms, "second_run_same_bits": True}


def gnn_products(rng, gen, dev) -> dict:
    """ogb_products, full batch: the edge layout, a forward and the first
    step's loss and gradients timed (events); that step twice (the same
    bits); GNN_PRODUCTS_STEPS AdamW steps; peak memory; the bytes a step
    must move (inputs read once, parameters and AdamW state read and
    written) against 3.35 TB/s, and the message traffic of the reference's
    formulation (gather written and read, then summed: 3·E·width·4 bytes
    for layer 1's forward, layer 2's and its backward)."""
    shape = configs.GNN_SHAPES["ogb_products"]
    cfg = gcn_cora.config_for_shape(shape)
    t0 = time.monotonic()
    g = syn.random_graph(rng, shape.n_nodes, shape.n_edges, cfg.d_feat, cfg.n_classes)
    host_s = time.monotonic() - t0
    batch = to_device(g, dev)
    del g
    params = gnn.init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def loss_fn(p, b):
        return gnn.loss_fn(p, cfg, b)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    edges = gnn._prepare(batch["edge_index"], shape.n_nodes, shape.n_nodes,
                         max(cfg.d_feat, cfg.d_hidden))
    ev[1].record()
    del edges
    ev[2].record()
    with torch.no_grad():
        gnn.forward(params, cfg, batch["x"], batch["edge_index"])
    ev[3].record()
    loss_a, grads_a = step_grads(loss_fn, params, batch)
    ev[4].record()
    loss_b, grads_b = step_grads(loss_fn, params, batch)
    ev[5].record()
    torch.cuda.synchronize()
    if loss_a != loss_b or any(not torch.equal(grads_a[k], grads_b[k]) for k in grads_a):
        fail(f"gnn ogb_products: the first step twice gave other bits ({loss_a} vs {loss_b})")
    del grads_a, grads_b
    profiled = step_profile(lambda: step_grads(loss_fn, params, batch))
    losses, ms, _ = gnn_run(loss_fn, params, batch, GNN_PRODUCTS_STEPS)
    if losses[0] != loss_a:
        fail(f"gnn ogb_products: the training run's first loss {losses[0]} != {loss_a}")
    peak = torch.cuda.max_memory_allocated(dev)
    # the graph read once; the parameters read and written, AdamW's m and v
    # (float32, as the parameters) read and written
    step_bytes = sum(v.numel() * v.element_size() for v in batch.values()) \
        + 6 * param_bytes(params)
    width = cfg.d_feat + 2 * cfg.d_hidden
    message_bytes = 3 * shape.n_edges * width * 4
    del batch, params
    torch.cuda.empty_cache()
    return {"nodes": shape.n_nodes, "edges": shape.n_edges, "d_feat": cfg.d_feat,
            "classes": cfg.n_classes, "graph_host_s": host_s,
            "edge_layout_ms": ev[0].elapsed_time(ev[1]),
            "forward_ms": ev[2].elapsed_time(ev[3]),
            "first_step_ms": [ev[3].elapsed_time(ev[4]), ev[4].elapsed_time(ev[5])],
            "first_step_same_bits": True, "first_step_profile": profiled,
            "steps": GNN_PRODUCTS_STEPS, "losses": losses,
            "ms_a_step": ms, "peak_gb": peak / 1e9, "bytes_a_step": step_bytes,
            "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "message_bytes_a_step": message_bytes,
            "message_bound_ms": message_bytes / HBM_BYTES_PER_S * 1e3}


def gnn_minibatch(rng, gen, dev) -> dict:
    """minibatch_lg: the graph and its CSR on the host, x and the labels on
    the card; GNN_MINIBATCH_STEPS steps of 1,024 seeds, each sampled on the
    host (sample_neighbors, fanouts (15, 10)) and run on the card
    (forward_blocks, a cross-entropy on the seeds, AdamW): the sampler's
    host ms, the step's device ms, each block's nodes and edges."""
    shape = configs.GNN_SHAPES["minibatch_lg"]
    cfg = gcn_cora.config_for_shape(shape)
    t0 = time.monotonic()
    g = syn.random_graph(rng, shape.n_nodes, shape.n_edges, cfg.d_feat, cfg.n_classes)
    graph_s = time.monotonic() - t0
    t0 = time.monotonic()
    indptr, indices = syn.graph_to_csr(shape.n_nodes, g.pop("edge_index"))
    csr_s = time.monotonic() - t0
    x = torch.from_numpy(g["x"]).to(dev)
    labels = torch.from_numpy(g["labels"]).to(dev).long()
    del g
    params = gnn.init(gen, cfg, device=dev)
    opt = optim.adamw(GNN_LR)
    opt_state = opt.init(params)

    def loss_fn(p, b):
        logp = torch.log_softmax(gnn.forward_blocks(p, cfg, b["x"], b["blocks"]).float(), -1)
        return -logp.gather(-1, b["labels"][:, None]).mean()

    steps = []
    for _ in range(GNN_MINIBATCH_STEPS):
        seeds = rng.choice(shape.n_nodes, shape.batch_nodes, replace=False)
        t0 = time.perf_counter()
        blocks, input_nodes = gnn.sample_neighbors(indptr, indices, seeds, shape.fanouts, rng)
        sample_ms = (time.perf_counter() - t0) * 1e3
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        b = {"x": x[torch.from_numpy(input_nodes).to(dev)], "blocks": blocks,
             "labels": labels[torch.from_numpy(seeds).to(dev)]}
        loss, grads = value_and_grad(loss_fn, params, b)
        params, opt_state = opt.update(optim.clip_by_global_norm(grads, TRAIN_CLIP), opt_state,
                                       params)
        stop.record()
        torch.cuda.synchronize()
        steps.append({"sampler_host_ms": sample_ms, "step_device_ms": start.elapsed_time(stop),
                      "loss": float(loss),
                      "blocks": [{"n_src": n_src, "n_dst": n_dst, "edges": int(ei.shape[1])}
                                 for ei, n_src, n_dst in blocks]})
    check_losses("gnn minibatch_lg", [s["loss"] for s in steps], GNN_MINIBATCH_STEPS)
    del x, labels, params, opt_state
    torch.cuda.empty_cache()
    return {"nodes": shape.n_nodes, "edges": shape.n_edges, "d_feat": cfg.d_feat,
            "classes": cfg.n_classes, "seeds": shape.batch_nodes,
            "fanouts": list(shape.fanouts), "graph_host_s": graph_s, "csr_host_s": csr_s,
            "steps": steps, "reduced": None}


def gnn_phase(seed: int, dev, gen) -> dict:
    """The GCN (gcn-cora, rebound to each shape's features and classes) at
    the four GNN_SHAPES on the card, through no hand-written kernel."""
    t0 = time.monotonic()
    rng = np.random.default_rng(seed)
    ops.reset_launch_counts()
    line = {"phase": "gnn", "arch": "gcn-cora",
            "full_graph_sm": gnn_cora(rng, gen, dev),
            "molecule": gnn_molecule(rng, gen, dev),
            "ogb_products": gnn_products(rng, gen, dev),
            "minibatch_lg": gnn_minibatch(rng, gen, dev)}
    line["launches"] = ops.launch_counts()
    if any(line["launches"].values()):
        fail(f"gnn: launched {line['launches']}; the GCN runs through no kernel")
    line["graph_host_s"] = sum(line[k]["graph_host_s"] for k in configs.GNN_SHAPES)
    line["seconds"] = time.monotonic() - t0
    if line["seconds"] > GNN_SECONDS:
        fail(f"gnn: took {line['seconds']:.1f} s, past {GNN_SECONDS} s")
    return line


# ----------------------------------------------------------------- dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_checks(rank: int, world: int, dev) -> dict:
    """The distributed runtime on ``dev`` tensors, on one rank of a world of
    ``world``, each piece against its single-device meaning; the inputs are
    the same on every rank (one seed).  Fails on a disagreement; returns the
    errors."""
    tol = TOL[torch.float32]
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    x, w = randn(8 * world, 64), randn(64, 32)
    out = {}
    if not torch.equal(coll.ring_all_gather(x.chunk(world)[rank]), x):
        fail(f"dist rank {rank}/{world}: ring_all_gather is not the concatenation")
    out["overlapped_matmul"] = compare(
        "dist overlapped_all_gather_matmul",
        coll.overlapped_all_gather_matmul(x.chunk(world)[rank], w), x @ w, tol, tol)
    out["reduce_scatter_matmul"] = compare(
        "dist reduce_scatter_matmul",
        coll.reduce_scatter_matmul(x.chunk(world, dim=1)[rank].contiguous(),
                                   w.chunk(world)[rank]), (x @ w).chunk(world)[rank], tol, tol)
    ws = randn(world, 64, 64, scale=0.1)
    want = x
    for i in range(world):
        want = torch.tanh(want @ ws[i])
    fwd = pipe.make_pipelined_fn(lambda w_, h: torch.tanh(h @ w_), num_microbatches=4)
    out["pipeline"] = compare(f"dist gpipe of {world} stages", fwd(ws, x), want, tol, tol)

    gs = randn(world, 4096 + 100)                         # not whole blocks of 256
    mean, res = gc.compressed_psum({"g": gs[rank]}, None, {"g": torch.zeros_like(gs[rank])})
    scale = float(gs.abs().max()) / 127
    err = float((mean["g"] - gs.mean(0)).abs().max())
    if err > scale:
        fail(f"dist compressed_psum: {err} from the mean, past the block scale {scale}")
    out["compressed_psum"] = {"max_abs_err": err, "block_scale": scale}

    cfg = configs.get(DIST_MOE).config
    m = 1 if world == 1 else 2
    mesh = mesh_lib.make_host_mesh(world // m, m, device=dev.type)
    params = tree_map(lambda t: t.to(dev), moe_lib.init_moe(
        gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, device="cpu"))
    experts = shd.to_placements(mesh, ("model", None, None))
    sharded = {"router": params["router"],
               **{k: distribute_tensor(params[k], mesh, experts)
                  for k in ("wg", "wu", "wd")}}
    # each batch shard's 32 tokens: capacity 10 a expert for a mean load of 8
    xs = randn(world // m, 4, 8, cfg.d_model)
    y, aux = moe_lib.make_sharded_moe(mesh, top_k=cfg.top_k)(
        sharded, xs[mesh.get_local_rank("data")])
    wants = [moe_lib.apply_moe(params, xb, top_k=cfg.top_k) for xb in xs]
    out["moe"] = {"mesh": list(mesh.shape), "dropped_frac": float(aux["dropped_frac"]),
                  "y_max_abs_err": compare(
        "dist make_sharded_moe", y, wants[mesh.get_local_rank("data")][0], tol, tol)}
    for k in ("aux_loss", "dropped_frac"):
        out["moe"][f"{k}_abs_err"] = compare(f"dist make_sharded_moe {k}", aux[k],
                                torch.stack([a[k] for _, a in wants]).mean(), tol, 0.0)
    return out


def dist_rank(rank: int, world: int, rdzv: str, out_dir: str) -> None:
    """One gloo rank on the host: dist_checks on CPU tensors, then
    compressed_psum on the card's tensors where gloo takes them."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", world_size=world, rank=rank)
    try:
        res = {"rank": rank, "cpu": dist_checks(rank, world, torch.device("cpu"))}
        g = torch.randn((world, 4196), generator=torch.Generator().manual_seed(1)).cuda()
        try:
            mean, _ = gc.compressed_psum({"g": g[rank]}, None, {"g": torch.zeros_like(g[rank])})
            err = float((mean["g"] - g.mean(0)).abs().max())
            res["gloo_cuda_compressed_psum"] = {"ran": True, "max_abs_err": err,
                                                "block_scale": float(g.abs().max()) / 127}
        except RuntimeError as e:               # gloo refusing CUDA tensors is the finding
            res["gloo_cuda_compressed_psum"] = {"ran": False, "error": str(e)[:300]}
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def dist_phase(seed: int, dev) -> dict:
    """An NCCL process group of one rank on the card, every piece of the
    distributed runtime on CUDA tensors against its single-device meaning;
    then the same in DIST_WORLD gloo processes on the host CPU, and
    compressed_psum's ranks on the card through gloo where it takes CUDA
    tensors.  No process outlives the phase, which must end within
    DIST_SECONDS."""
    t0 = time.monotonic()
    ops.reset_launch_counts()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        nccl = dist_checks(0, 1, dev)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    nccl_s = time.monotonic() - t0
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    try:
        ctx = mp.start_processes(dist_rank, args=(DIST_WORLD, str(DIST_DIR / "rdzv"),
                                                  str(DIST_DIR)),
                                 nprocs=DIST_WORLD, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() - t0 > DIST_SECONDS:
                    fail(f"dist: the gloo ranks did not end within {DIST_SECONDS} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        if any(p.is_alive() for p in ctx.processes):
            fail("dist: a gloo rank outlived the phase")
        ranks = [json.loads((DIST_DIR / f"{r}.json").read_text()) for r in range(DIST_WORLD)]
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    gloo_cuda = [r["gloo_cuda_compressed_psum"] for r in ranks]
    for r in gloo_cuda:
        if r["ran"] and r["max_abs_err"] > r["block_scale"]:
            fail(f"dist: gloo compressed_psum on the card {r}")
    launches = ops.launch_counts()
    if any(launches.values()):
        fail(f"dist: launched {launches}; the runtime runs through no kernel")
    line = {"phase": "dist", "nccl_world_1": {"backend": backend, **nccl, "seconds": nccl_s},
            "gloo_host_world": DIST_WORLD, "gloo_host_ranks": [r["cpu"] for r in ranks],
            "gloo_cuda_compressed_psum_ran": all(r["ran"] for r in gloo_cuda),
            "gloo_cuda_compressed_psum": gloo_cuda, "launches": launches,
            "seconds": time.monotonic() - t0}
    if line["seconds"] > DIST_SECONDS:
        fail(f"dist: took {line['seconds']:.1f} s, past {DIST_SECONDS} s")
    return line


# the phases ``--only`` runs alone: (args, device, generator) -> its line
ONLY = {
    "train": lambda args, dev, gen: train_phase(args.seed, dev, gen),
    "lm_moe": lambda args, dev, gen: lm_moe(args.seed, dev, gen),
    "remote": lambda args, dev, gen: remote(args.seed),
    "gnn": lambda args, dev, gen: gnn_phase(args.seed, dev, gen),
    "dist": lambda args, dev, gen: dist_phase(args.seed, dev),
    "k2_timings": lambda args, dev, gen: {
        "phase": "k2_timings", "timings": time_dot_interactions(gen, dev, other_store=False)},
    "k4_timings": lambda args, dev, gen: {
        "phase": "k4_timings",
        "timings": time_decode_attentions(args.seed, gen, dev, other_runs=True)},
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qps", type=float, default=100.0, help="offered load of the serve phases")
    ap.add_argument("--seconds", type=float, default=4.0, help="length of each serve phase")
    ap.add_argument("--only", choices=sorted(ONLY),
                    help="only run this phase, print its line and stop (no result line); "
                         "a copy of this script times another tree's K2 or K4 the same way")
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
    if args.only:
        emit({**ONLY[args.only](args, dev, gen), "card": card})
        return
    held = {}                     # device memory still allocated after each phase

    def after(line: dict) -> None:
        line["card"] = card
        emit(line)
        torch.cuda.empty_cache()
        held[line["phase"]] = torch.cuda.memory_allocated()
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
    after({"phase": "kernel_checks",
          "embedding_bag": {"checks": eb_checks, "timings_rmc2": eb_times,
                            "timings_xdeepfm": eb_times_xdfm},
          "dot_interaction": {"checks": ix_checks, "timings_rmc2_rmc1": ix_times},
          "cin_layer": {"checks": cin_checks, "timings_xdeepfm": cin_times},
          "decode_attention": {"checks": da_checks, "timings_qwen2": da_times}})

    after({"phase": "parity", "rtol": 1e-4, "atol": 1e-4,
           "configs": check_parity(args.seed, dev)})

    served = serve(args.seed, dev, params, cfg, qps=args.qps, seconds=args.seconds,
                   batch_size=64, sla_ms=SLA_TARGETS[SERVE_ARCH].medium_ms, curve=True)
    after(served)

    scheduled = sched(args.seed, dev)
    after(scheduled)

    # RMC2 live against its twin, at the knob the sched phase just tuned
    # with the card and beside the card curve it measured; then everything
    # the phase held is freed for the LM phases
    row = next(r for r in scheduled["models"] if r["arch"] == SERVE_ARCH)
    card_curve = TableDeviceModel(list(BUCKETS), [row["card_ms"][b] / 1e3 for b in BUCKETS])
    lived = live(args.seed, dev, params, cfg, row["with_card"]["batch"], card_curve)
    after(lived)
    del params, tables
    torch.cuda.empty_cache()

    zoo_line, xdfm_params = zoo(args.seed, dev, gen)
    after(zoo_line)

    # neither package gives xDeepFM an SLA target: a fixed batch size of
    # serve_p99's 512 and no controller
    served_x = serve(args.seed, dev, xdfm_params, xdfm, qps=args.qps, seconds=args.seconds,
                     batch_size=configs.RECSYS_SHAPES["serve_p99"].batch)
    after(served_x)
    del xdfm_params
    torch.cuda.empty_cache()

    # before the LM serving phases, and freeing all it holds: lm_decode_32k
    # needs 58 GB of the card
    trained = train_phase(args.seed, dev, gen)
    after(trained)

    # the GCN's four graph shapes (ogb_products' full batch peaks at several
    # GB), then the distributed runtime; both free all they hold before
    # lm_decode_32k
    after(gnn_phase(args.seed, dev, gen))
    after(dist_phase(args.seed, dev))

    generated = lm_generate(args.seed, dev, gen)
    after(generated)

    # with the earlier phases' tensors freed: 51.5 GB of KV cache
    decoded = lm_decode_32k(args.seed, dev, gen)
    after(decoded)

    # the MoE LMs last but one: qwen3-moe's 61 GB of weights need the card
    # freed of every earlier phase's tensors; the device memory each phase
    # left allocated is reported beside it
    moe_line = lm_moe(args.seed, dev, gen)
    moe_line["held_after_phase_bytes"] = dict(held)
    after(moe_line)

    remoted = remote(args.seed)
    after(remoted)

    paths = (served["launches"], scheduled["launches"], lived["launches"], zoo_line["launches"],
             served_x["launches"], trained["launches"], generated["launches"],
             decoded["launches"], moe_line["launches"])
    total = {k: sum(p[k] for p in paths) for k in KERNELS}
    eb_main = next(t for t in eb_times if t["ids"] == "zipf" and t["batch"] == MAIN_BATCHES[-1])
    ix_main = next(t for t in ix_times
                   if t["arch"] == SERVE_ARCH and t["batch"] == MAIN_BATCHES[-1])
    k_max = max(h * f for f, h, _ in xdeepfm_cin_shapes())
    cin_main = next(t for t in cin_times
                    if t["shape"][0] == ZOO_BATCHES[-1] and t["shape"][1] * t["shape"][2] == k_max)
    b, f, h, hn, d = cin_main["shape"]
    qwen = configs.get(LM_ARCH).config
    rec = trained["recsys"]
    k1b_main, k1b_uniform = rec["timings_embedding_bag_backward"]
    k2b_main = rec["timing_dot_interaction_backward"]
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
        {"name": "embedding_bag_backward", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag.py:23",
         "of": "K1's gradient (the TPU kernel has no backward; XLA's autodiff of the "
               "reference's gather and sum gives it)",
         "launches": total["embedding_bag_backward"],
         "max_abs_err": rec["embedding_bag_backward_max_abs_err"],
         "ms": k1b_main["kernel_ms"], "call_ms": k1b_main["kernel_call_ms"],
         "plain_ms": k1b_main["plain_ms"], "bound_ms": k1b_main["bound_ms"],
         "bound_by": k1b_main["bound_by"], "library_ms": k1b_main["library_ms"],
         "share_of_bound": k1b_main["share_of_bound"], "zero_ms": k1b_main["zero_ms"],
         "zero_bound_ms": k1b_main["zero_bound_ms"],
         "uniform_ids": {k: k1b_uniform[k] for k in ("kernel_ms", "bound_ms", "plain_ms",
                                                     "library_ms", "distinct_rows")},
         "design": "owner-computes, no atomics: W warps a table, warp w owning the rows "
                   "r % W == w and scanning the table's lookups in order (32 a ballot, the "
                   "next bag in flight), lanes over D, a 4-row register cache summing runs "
                   "of a row before its read-add-write into the zeroed dense gradient; the "
                   "same bits every launch",
         "shape": "grad_out (1024, 40, 32) float32, idx (1024, 40, 80) Zipf ids, "
                  "grad (40, 1000000, 32) float32"},
        {"name": "dot_interaction_backward", "route": "cuda",
         "source": "src/repro_torch/csrc/interaction.cu",
         "replaces": "src/repro/kernels/interaction.py:47",
         "of": "K2's gradient (the TPU kernel has no backward; XLA's autodiff of the "
               "reference's Gram product and gather gives it)",
         "launches": total["dot_interaction_backward"],
         "max_abs_err": rec["dot_interaction_backward_max_abs_err"],
         "ms": k2b_main["kernel_ms"], "call_ms": k2b_main["kernel_call_ms"],
         "plain_ms": k2b_main["plain_ms"], "bound_ms": k2b_main["bound_ms"],
         "bound_by": k2b_main["bound_by"], "library_ms": k2b_main["library_ms"],
         "share_of_bound": k2b_main["share_of_bound"],
         "design": "S samples a block; each sample's gradients unpacked into a symmetric "
                   "(F, F) matrix and its features widened, in shared memory; a thread a "
                   "column and four rows of the result, sums in a fixed order",
         "shape": "grad (1024, 820), feats (1024, 41, 32) float32"},
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
            for t in da_times[1:]},
         # the MoE LMs' decode steps, at their own heads
         **{f"lm_moe {r['arch']}": {
             "launches": r["launches"]["decode_attention"],
             "ms": r["k4"]["kernel_ms"], "call_ms": r["k4"]["kernel_call_ms"],
             "main_ms": r["k4"]["main_ms"], "combine_ms": r["k4"]["combine_ms"],
             "plain_ms": r["k4"]["plain_ms"], "bound_ms": r["k4"]["bound_ms"],
             "bound_by": r["k4"]["bound_by"], "library_ms": r["k4"]["library_ms"],
             "share_of_bound": r["k4"]["share_of_bound"], "run_slots": r["k4"]["run_slots"],
             "max_abs_err": max(r["k4_max_abs_err_in_model"],
                                r["k4"]["max_abs_err_vs_plain"]),
             "shape": f"q ({GEN_BATCH}, {r['heads'][0]}, {r['heads'][2]}), k/v ({GEN_BATCH}, "
                      f"{GEN_CACHE}, {r['heads'][1]}, {r['heads'][2]}) bfloat16, "
                      f"pos = {r['k4']['pos']}"}
            for r in moe_line["runs"]}},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
