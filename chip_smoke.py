#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port: the quickest proof that the port
builds its kernels and serves on a card.

    python3 chip_smoke.py            # needs one CUDA GPU and nvcc; ~15 minutes

What it does, one JSON line per phase:

  env            card name and power limit (nvidia-smi), torch/CUDA versions
  build          compiles src/repro_torch/csrc/*.cu with nvcc, seconds taken
  kernel_checks  each hand-written kernel (K1 embedding bag, K2 dot
                 interaction, K3 CIN layer, K4 flash-decode attention)
                 against its plain PyTorch version on the card: the shape x
                 dtype sweep of the CPU tests plus the shapes the models
                 give it, and timings at the DLRM-RMC2 (and for K2 also
                 RMC1/RMC3), xDeepFM and qwen2-0.5b shapes (kernel,
                 bound, plain version, library call); K3-bwd at xDeepFM's
                 layer shapes, B = 512 to 65,536, against its plain version
                 (to 8,192) and float64, the same bits on a second launch, a
                 one-pass TF32 witness at least 10x further off, and timed
                 at B = 512, 1,024 (the train phase's batch) and 65,536
                 (the library yardstick in chunks)
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
  datacenter     the JAX package's two datacenter examples on the port, on
                 the curves sched just measured (cluster.datacenter): the
                 at-scale table on DLRM-RMC1, RMC3 and WnD (static, tuned on the CPU alone and
                 with the card, B*, threshold, p95 at 70 % under stragglers,
                 hedges and an executor failure, whether the SLA holds:
                 reported), then the fleet day's fleet (skylake x8,
                 broadwell x4 at 1.5x, h100 x4 on RMC1's host-CPU and card
                 curves) over a diurnal day cut to 6 s: static against
                 autoscaled, four routers, reactive against predictive
                 scaling with boot latency, a quarter of skylake killed with
                 and without re-route; every number finite, re-route drops
                 nothing and re-routes some, without it some drop, every
                 query served or dropped, no kernel launched, within 90 s
  live           DLRM-RMC2 at its published size served live on the card by
                 one worker (cluster.live_node, the batch knob sched tuned
                 with the card, no smaller than the static baseline's,
                 buckets to 1,024) and its simulated twin on
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
                 timed (host clock, median of 5; CUDA events, median of
                 20); for MIND and BERT4Rec, the device time of their
                 lookups (history, candidates) beside the bare gather;
                 launch counts zeroed before and read after
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
                 removed after) and resumed, its losses and the stopped
                 run's equal to the straight run's bit for bit; a step's
                 forward, backward and optimiser times; K1-bwd and K2-bwd
                 against their plain versions, the same bits on a second
                 launch and under CUDA-graph replay, and timed beside
                 bound, plain and library versions; then xDeepFM at its
                 published size, B = 1,024 (K1, K1-bwd, three K3 and three
                 K3-bwd a step): the same gradient gate, 10 steps, a run
                 stopped at step 5 and resumed bit for bit; then
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
  cells          the cell builder (launch/steps.py) in an NCCL world of one
                 rank on a (1, 1) (data, model) mesh: DLRM-RMC2's
                 train_batch step at its published size and B = 65,536 on
                 DTensors against the same step on plain tensors (loss,
                 every parameter and optimiser leaf the same bits, exactly
                 one K1, K2, K1-bwd and K2-bwd a step); xDeepFM's
                 train_batch step the same way at B = 65,536 (one K1 and
                 K1-bwd, three K3 and K3-bwd a step); xDeepFM's serve_p99
                 step against bulk_forward (the same bits, one K1 and three
                 K3); granite-moe-1b-a400m's train_4k step through
                 make_sharded_moe, 4 x 1,024 tokens, against one plain
                 step (loss within rtol 2e-4); each timed, median of 3;
                 within 300 s.  Then qwen2-0.5b's train_4k step at its
                 published width and depth (24 layers, bf16, remat on),
                 16 x 4,096 tokens (one data rank's share of the single-pod
                 mesh's 256 sequences), on DTensors against the plain AdamW
                 step of lm.loss_fn (loss, every parameter and AdamW leaf
                 the same bits, no launch), each timed (median of 3), each
                 path's peak, a 2-layer plain step profiled; and remat on against
                 off (and without flash_sdpa's checkpoints) at 2 layers and
                 1 x 4,096 tokens: loss and every gradient the same bits,
                 each variant's peak and step time; within 420 s.  Then K4
                 on a decode_32k cache cut into 16
                 slices of 2,048 slots (lm_cache_pspecs' time split on a
                 16-way model axis), each slice's launch with its
                 log-sum-exp at its local length, merged in slice order,
                 against one launch over the whole cache (pos = T and
                 uniform; every lse against the plain version's);
                 qwen2-0.5b's decode_32k cell at published size (B = 128,
                 32,768 slots, 51.5 GB of cache) on DTensors against the
                 plain decode step on the same storage (the plain step
                 first, the rows it wrote saved and put back), 3 steps, the
                 same bits, exactly 24 K4 launches a step on each path, then
                 timed; granite-moe-1b-a400m's prefill_32k cell (its MoE
                 layers through make_sharded_moe), 2 sequences of 32,768
                 tokens at 2 of its 24 layers, against the plain prefill
                 (logits and caches the same bits, both under torch's
                 deterministic algorithms: the MoE layers' index_add_ sums
                 in no fixed order on the card otherwise); gcn-cora's ogb_products cell (the graph made on
                 the card and padded to multiples of 512) and molecule cell
                 against the same step on plain tensors (loss, parameters,
                 AdamW state: the same bits or the gradient gate's TOL), the
                 padded step's loss against the unpadded one's; within 300 s
                 more
  roofline       the cells phase's five training and serving steps counted
                 on fake tensors in a
                 fake world of one rank (roofline/analysis.py: per-rank
                 FLOPs by unit, bytes, collectives, each hand-written
                 kernel's work(), MemTracker's peak) at the sizes the phase
                 ran: compute, memory and collective terms on the H100's
                 peaks, the bottleneck, the roofline's share of each
                 measured step (DTensor and plain; K1 and K1-bwd charged
                 at every lookup's row, so not a floor), the floor's share
                 (K1 and K1-bwd at the step's distinct rows; past 1.05 the
                 phase fails: a step cannot beat its floor), MFU, the dry
                 run's peak beside max_memory_allocated; each kernel the
                 step launched must be in the count as often and with its
                 work(); then the decode_32k cell's step the same way (K4
                 at every slot); within 300 s; then its fit entry: the dry
                 run of yi-34b x train_4k on the single-pod fake world (256
                 ranks) and of qwen2-0.5b x train_4k on the multi-pod one
                 (512), published size, each peak a rank at or below the
                 card's total_memory less FIT_MARGIN_BYTES, and qwen2-0.5b's
                 train_4k count at one layer on the single-pod mesh at or
                 below FIT_QWEN_L1_FLOPS_MAX; within FIT_SECONDS more
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
  zoo          the zoo phase (a copy of this script in another tree
               times that tree's lookups the same way)
  gnn          the gnn phase
  dist         the dist phase
  cells        the cells phase
  roofline     the cells phase, then the roofline line of its steps and
               its fit entry
  fit          the roofline phase's fit entry alone
  lm_moe       the lm_moe phase
  remote       the remote phase
  datacenter   the sched phase on DLRM-RMC1, RMC3 and WnD (its line), then
               the datacenter phase on those curves
  k2_timings   K2 timed at the DLRM shapes
  k3_bwd_timings  K3-bwd timed at xDeepFM's layer shapes, B = 512, 1,024 and 65,536
  bwd_timings  K1-bwd (Zipf and uniform ids) and K2-bwd timed at RMC2's
               shapes, B = 1,024 and train_batch's 65,536
  k4_timings   K4 timed at its four shapes (decode_32k at pos = T and with
               pos uniform, B = 1 at 32,768 slots, lm_generate's step), main
               kernel and combine timed apart by torch.profiler, the launch
               that also writes the log-sum-exp timed beside the one that
               does not, and other run lengths than the plan's

A copy of this script run from another tree's root times that tree's K2,
K4 or backward kernels the same way (how a change is held against its
parent on one card).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
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
from torch.autograd import DeviceType
from torch.distributed.tensor import DTensor, distribute_tensor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.cluster import (BucketedDeviceModel, FleetFaults, NodeKill,  # noqa: E402
                                 WallClock, WorkerSupervisor, boot_remote_fleet,
                                 calibrate_device, drive_fleet, live_node, make_router,
                                 sim_backends)
from repro_torch.cluster import datacenter as dc  # noqa: E402
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
from repro_torch.layers import embedding as emb_lib  # noqa: E402
from repro_torch.layers import interactions as ix  # noqa: E402
from repro_torch.layers import moe as moe_lib  # noqa: E402
from repro_torch.layers.mlp import linear, mlp  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import gnn, lm, recsys  # noqa: E402
from repro_torch.serve.batching import pad_batch  # noqa: E402
from repro_torch.serve.runtime import (OnlineController, ServingRuntime,  # noqa: E402
                                       to_device)
from repro_torch.train import grad_compress as gc  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402
from repro_torch.train.microbatch import value_and_grad  # noqa: E402
from repro_torch.utils import leaves_with_paths, param_bytes, tree_map  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet, roofline/analysis.py):
# the bound's yardstick
HBM_BYTES_PER_S = analysis.HBM_BW
FP32_FLOP_PER_S = analysis.FP32_FLOPS

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
           "embedding_bag_backward", "dot_interaction_backward", "cin_layer_backward")
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
TRAIN_CKPT = Path(__file__).resolve().parent / "build" / "train_ckpt"
TRAIN_CIN_ARCH = "xdeepfm"          # K3 and K3-bwd in training, at published size, B = 1,024
TRAIN_CIN_STEPS = 10
TRAIN_CIN_RESUME_AT = 5
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
CELLS_TRAIN = ("dlrm-rmc2", "train_batch")       # published size and batch (65,536), not cut
CELLS_TRAIN_CIN = ("xdeepfm", "train_batch")    # K3 and K3-bwd: published size, B = 65,536
CELLS_SERVE = ("xdeepfm", "serve_p99")          # published size, B = 512
CELLS_LM = ("granite-moe-1b-a400m", "train_4k")
CELLS_LM_BATCH, CELLS_LM_SEQ = 4, 1024          # cut from train_4k's 256 x 4,096
CELLS_TIMED = 3                                 # steps timed a path (median)
CELLS_LM_RTOL = 2e-4                            # tests/test_distributed.py's own
CELLS_SECONDS = 300.0
CELLS_DECODE = ("qwen2-0.5b", "decode_32k")     # published size and batch, not cut
CELLS_DECODE_STEPS = 3                          # steps held DTensor against plain
CELLS_PREFILL = ("granite-moe-1b-a400m", "prefill_32k")
CELLS_PREFILL_BATCH = 2                         # cut from prefill_32k's 32 sequences
CELLS_PREFILL_LAYERS = 2                        # cut from 24: flash_sdpa's eager chunk loop
CELLS_GNN = ("ogb_products", "molecule")
CELLS_QWEN = ("qwen2-0.5b", "train_4k")        # published width and depth, remat on
CELLS_QWEN_BATCH = 16                           # one data rank's share of 256 on (16, 16)
CELLS_REMAT_LAYERS = 2                          # remat on against off: the step without fits
CELLS_REMAT_BATCH = 1
CELLS_QWEN_SECONDS = 420.0                      # the qwen2 train_4k path and its remat check
K4_SLICES = 16                                  # a decode_32k cache over a 16-way model axis
K4_LSE_RTOL = 1e-4                              # float32 log-sum-exps against the plain ones
CELLS_SERVING_SECONDS = 300.0                   # the phase's K4 split, LM and GNN cells
REMOTE_MODEL = "mlp:128:256:2"
REMOTE_NODES = 2
REMOTE_MAX_BUCKET = 64
REMOTE_LOAD = 0.5
REMOTE_HORIZON_S = 2.0
REMOTE_SECONDS = 60.0
# the datacenter phase: the JAX package's datacenter_sim.py models and tier
# (dc.MODELS, dc.TIER), and datacenter_fleet.py's fleet on RMC1's curves
# over a day cut from its 60 s (the fast engine takes seconds of host time
# a simulated second at the measured fleet's 50,000-80,000 queries a second)
DATACENTER_DAY_S = 6.0
DATACENTER_SECONDS = 90.0


def bound(work: tuple[dict[str, float], float]) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time a kernel's ``work()``
    (FLOPs by unit, bytes) takes on the card, each unit at its own peak."""
    flops, nbytes = work
    t_ops = sum(f / analysis.PEAKS[u] for u, f in flops.items())
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    work = eb_kernel.work(batch, f, h, d, es, rows=distinct)
    # what the accounting counts (roofline/analysis.py): every lookup's row read
    accounted = eb_kernel.work(batch, f, h, d, es)
    flat_table = tables.view(f * v, d)
    res = {
        "batch": batch, "ids": ids, "distinct_rows": distinct, "lookups": batch * f * h,
        "kernel_ms": device_ms(lambda i: ops.embedding_bag(tables, sets[i % 8])),
        "kernel_call_ms": call_ms(lambda i: ops.embedding_bag(tables, sets[i % 8])),
        "plain_ms": device_ms(lambda i: ref.embedding_bag_stacked(tables, sets[i % 8])),
        "library_ms": device_ms(lambda i: torch.nn.functional.embedding_bag(
            flat_sets[i % 8], flat_table, mode="sum")),
        "bound_ms": bound(work)[0], "bound_by": bound(work)[1],
        # the same bound if every lookup had to come from device memory
        "gathered_bound_ms": accounted[1] / HBM_BYTES_PER_S * 1e3,
        "accounted_flops": accounted[0], "accounted_bytes": accounted[1],
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
    work = ix_kernel.work(batch, f, d, 4)

    def library(i):
        x = sets[i % 8]
        return torch.bmm(x, x.transpose(1, 2)).reshape(batch, f * f)[:, pairs]

    res = {
        "arch": arch, "batch": batch, "shape": [batch, f, d],
        "kernel_ms": device_ms(lambda i: ops.dot_interaction(sets[i % 8])),
        "kernel_call_ms": call_ms(lambda i: ops.dot_interaction(sets[i % 8])),
        "plain_ms": device_ms(lambda i: ref.dot_interaction_packed(sets[i % 8])),
        "library_ms": device_ms(library),
        "bound_ms": bound(work)[0], "bound_by": bound(work)[1],
        "accounted_flops": work[0], "accounted_bytes": work[1],
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


def xdeepfm_cin_layers() -> list[tuple[int, int, int]]:
    """(F, H, Hn) of each of xDeepFM's CIN layers, in order."""
    cfg = configs.get("xdeepfm").config
    shapes, h = [], cfg.n_tables
    for hn in cfg.cin_layers:
        shapes.append((cfg.n_tables, h, hn))
        h = hn
    return shapes


def xdeepfm_cin_shapes() -> list[tuple[int, int, int]]:
    """The distinct (F, H, Hn) of xDeepFM's CIN layers (the last two coincide)."""
    return sorted(set(xdeepfm_cin_layers()))


def cin_bwd_by_layer(times: list[dict], batch: int, launched: int) -> dict:
    """The kernels line's K3-bwd entry for one phase's xDeepFM steps at
    ``batch``: ``launched`` (every layer's) split over the layer shapes,
    each backward step launching K3-bwd once a CIN layer, each shape's
    share beside its time at ``batch`` from ``times``, so that launches ×
    ms adds up."""
    layers = xdeepfm_cin_layers()
    if launched % len(layers):
        fail(f"K3-bwd: {launched} launches at B = {batch} are not a whole number of "
             f"{len(layers)}-layer backward steps")
    out = []
    for f, h, hn in xdeepfm_cin_shapes():
        t = next(t for t in times if t["shape"][:4] == [batch, f, h, hn])
        out.append({"launches": launched // len(layers) * layers.count((f, h, hn)),
                    **{k: t[k] for k in ("shape", "kernel_ms", "bound_ms", "bound_by",
                                         "plain_ms", "library_ms", "library_chunk",
                                         "share_of_bound", "tf32x3_bound_ms",
                                         "tf32x3_share_of_bound", "fp32_cuda_core_bound_ms")}})
    return {"launches": launched, "layers": out}


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
    494.7e12); the float32 CUDA-core bound the first K3 was held to is kept
    beside it.  ``prepass_ms`` times K3's pre-pass (w into TF32 planes)
    alone; in a launch the main kernel starts while it runs, so its share
    is an upper bound."""
    sets = [cin_inputs(gen, dev, b, f, h, hn, d) for _ in range(4)]
    w = sets[0][2]
    k = h * f
    flops = 2 * b * d * k * hn + b * d * k          # the FMAs, plus forming each product once
    work = cin_kernel.work(b, f, h, hn, d, 4)       # three TF32 passes on the tensor cores
    tc_flops, bytes_moved = work[0]["tf32"], work[1]

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
        "bound_ms": bound(work)[0], "bound_by": bound(work)[1],
        "bound_of": "3xTF32 tensor-core operations at 494.7 TFLOP/s, or bytes at 3.35 TB/s",
        "fp32_cuda_core_bound_ms": max(bytes_moved / HBM_BYTES_PER_S,
                                       flops / FP32_FLOP_PER_S) * 1e3,
    }
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    res["prepass_share"] = res["prepass_ms"] / res["kernel_ms"]
    return res


CIN_BWD_BATCHES = (512, 4096, 8192, 65_536)   # K3-bwd's checks: serve_p99's batch, 8x and
# 16x it (the data gradient cut into runs of h, then not), and train_batch's
CIN_BWD_PLAIN_MAX = 8192   # the largest batch held against the float32 plain backward whole
CIN_BWD_CHUNK = 2048       # samples a float64 pass of the plain backward
CIN_BWD_TIMED = (512, TRAIN_BATCH, 65_536)   # its timings: serve_p99's, the train phase's
# and train_batch's batches
CIN_BWD_LIBRARY_BYTES = 12 * 2**30     # the library yardstick's (B·D, H·F) tensors, at most


def cin_backward_inputs(gen, dev, b: int, f: int, h: int, hn: int, d: int,
                        dtype=torch.float32) -> tuple:
    """g (unit normals), x0, xk, w (``cin_inputs``), on the card."""
    x0, xk, w = cin_inputs(gen, dev, b, f, h, hn, d, dtype)
    return torch.randn((b, hn, d), generator=gen, device=dev).to(dtype), x0, xk, w


def cin_backward_float64(g, x0, xk, w, chunk: int = CIN_BWD_CHUNK) -> tuple[tuple, tuple]:
    """The plain backward in float64 (``exact``) and the same of the
    inputs' magnitudes (``mag``: each gradient's Σ|terms|), ``chunk``
    samples at a time, so that the (B, H·F, D) maps of train_batch's
    65,536 samples are never held whole: dx0 and dxk are each sample's
    own, dw the chunks' sum."""
    outs = []
    for cast in (torch.Tensor.double, lambda t: t.double().abs()):
        w64 = cast(w)
        dx0s, dxks, dw = [], [], torch.zeros_like(w64)
        for gs, x0s, xks in zip(g.split(chunk), x0.split(chunk), xk.split(chunk)):
            dx0, dxk, dws = ref.cin_layer_backward(cast(gs), cast(x0s), cast(xks), w64)
            dx0s.append(dx0)
            dxks.append(dxk)
            dw += dws
        outs.append((torch.cat(dx0s), torch.cat(dxks), dw))
    return outs[0], outs[1]


def fp32_backward_bound(b: int, f: int, h: int, n: int, d: int) -> dict[str, float]:
    """The float64 bound K3-bwd was held to while it ran float32 on the CUDA
    cores (the float32 kernel's ``backward_error_bound``, at this plan's
    runs), kept for the history: gamma_L, u = 2^-24, of each result's longest chain of
    roundings: dxk's N products summed into P, then its F terms; dx0's N,
    then its H terms within a run of h, then the runs; dw's rows of a run,
    then the runs."""
    p = cin_kernel.backward_plan(b, f, h, n, d)
    u = 2.0 ** -24

    def gamma(chain: int) -> float:
        return chain * u / (1 - chain * u)
    return {"dx0": gamma(n + h + p.data_splits + 3), "dxk": gamma(n + f + 3),
            "dw": gamma(p.row_run + p.weight_splits + 3)}


def one_pass_tf32_backward(g, x0, xk, w) -> tuple:
    """The witness of K3-bwd: its gradients with both products as one TF32
    pass (P = g·wᵀ and dw = Aᵀ·g through cuBLAS with TF32 allowed, here and
    nowhere else; the contractions in float32), what a lost lo pass would
    give."""
    b, f, d = x0.shape
    h, n = xk.shape[1], w.shape[1]
    rows = g.transpose(1, 2).reshape(b * d, n)
    a = torch.einsum("bhd,bfd->bdhf", xk, x0).reshape(b * d, h * f)
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        p = torch.matmul(rows, w.t())
        dw = torch.matmul(a.t(), rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    p = p.reshape(b, d, h, f)
    return (torch.einsum("bdhf,bhd->bfd", p, xk), torch.einsum("bdhf,bfd->bhd", p, x0), dw)


def check_cin_layer_backward(gen, dev) -> tuple[list, float]:
    """K3-bwd at each of xDeepFM's layer shapes and each CIN_BWD_BATCHES
    batch (its plan: the data gradient cut into runs of h at 512 and 4,096,
    whole from 8,192; the weight gradient's rows in runs at every batch):
    each gradient against the plain backward up to CIN_BWD_PLAIN_MAX
    (float32 by ``grad_compare``; bfloat16, at B = 512, the float32 result
    cast down, within 2e-2 of itself and of the largest value); in float32
    against float64 within ``cin_kernel.backward_error_bound``'s
    c · Σ|terms| (``cin_backward_float64``), at train_batch's 65,536 too,
    with each result's share of the float32 kernel's bound beside it
    (``fp32_backward_bound``); the same bits on a second launch; and at
    B = 512 and K = 7,800 the one-pass TF32 witness
    (``one_pass_tf32_backward``) at least 10× further from the float64
    value than K3-bwd in each gradient, which shows the check can see a
    lost pass."""
    checks, main_err = [], 0.0
    d = configs.get("xdeepfm").config.embed_dim
    k_max = max(hh * ff for ff, hh, _ in xdeepfm_cin_shapes())
    for b in CIN_BWD_BATCHES:
        for f, h, hn in xdeepfm_cin_shapes():
            for dtype in (torch.float32, torch.bfloat16) if b == CIN_BWD_BATCHES[0] else (
                    torch.float32,):
                g, x0, xk, w = cin_backward_inputs(gen, dev, b, f, h, hn, d, dtype)
                got = ops.cin_layer_backward(g, x0, xk, w)
                row = {"shape": [b, f, h, hn, d], "dtype": str(dtype),
                       "plan": cin_kernel.backward_plan(b, f, h, hn, d)._asdict()}
                if b <= CIN_BWD_PLAIN_MAX:
                    want = ref.cin_layer_backward(g, x0, xk, w)
                    for name, a, e in zip(("dx0", "dxk", "dw"), got, want):
                        if dtype == torch.float32:
                            err = grad_compare(f"cin_layer_backward {name} {b, f, h, hn, d}",
                                               a, e)
                            main_err = max(main_err, err)
                        else:
                            tol = CIN_TOL[dtype]
                            err = compare(f"cin_layer_backward {name} {b, f, h, hn, d} {dtype}",
                                          a, e, tol, tol * float(e.float().abs().max()))
                        row[f"{name}_max_abs_err"] = err
                    del want
                if dtype == torch.float32:
                    exact, mag = cin_backward_float64(g, x0, xk, w)
                    bound = cin_kernel.backward_error_bound(b, f, h, hn, d)
                    old = fp32_backward_bound(b, f, h, hn, d)
                    witness = (one_pass_tf32_backward(g, x0, xk, w)
                               if b == CIN_BWD_BATCHES[0] and h * f == k_max else None)
                    for i, (name, a, e, m) in enumerate(zip(("dx0", "dxk", "dw"), got, exact,
                                                            mag)):
                        dev64 = (a.double() - e).abs()
                        if not bool((dev64 <= bound[name] * m).all()):
                            fail(f"cin_layer_backward {name} {b, f, h, hn, d}: outside "
                                 f"{bound[name]:.3e}·Σ|terms| of the float64 value")
                        top = float(dev64.max())
                        row[f"{name}_against_float64_max_abs_err"] = top
                        row[f"{name}_largest_share_of_bound"] = float(
                            (dev64 / (bound[name] * m).clamp_min(1e-300)).max())
                        row[f"{name}_largest_share_of_fp32_bound"] = float(
                            (dev64 / (old[name] * m).clamp_min(1e-300)).max())
                        if witness is not None:
                            one = float((witness[i].double() - e).abs().max())
                            ratio = one / max(top, 1e-30)
                            if ratio < 10:
                                fail(f"cin_layer_backward {name} {b, f, h, hn, d}: the one-pass "
                                     f"TF32 witness is only {ratio:.2f}x further from float64 "
                                     f"than K3-bwd (needs 10x)")
                            row[f"{name}_one_pass_tf32_against_float64_max_abs_err"] = one
                            row[f"{name}_witness_ratio"] = ratio
                        del dev64
                    row["float64_bound"] = {k: f"{v:.4e}*sum|terms|" for k, v in bound.items()}
                    row["fp32_bound"] = {k: f"{v:.4e}*sum|terms|" for k, v in old.items()}
                    del exact, mag, witness
                    again = ops.cin_layer_backward(g, x0, xk, w)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, c) for a, c in zip(again, got)):
                        fail(f"cin_layer_backward {b, f, h, hn, d}: a second launch gave "
                             f"other bits")
                    row["same_bits_on_relaunch"] = True
                    del again
                checks.append(row)
                del got, g, x0, xk, w
                torch.cuda.empty_cache()
    return checks, main_err


def library_cin_backward(g, x0, xk, w) -> tuple:
    """The library yardstick of K3-bwd: autograd of the (B·D, H·F)
    operand materialised and one cuBLAS SGEMM with w (TF32 off), i.e. the
    forward's yardstick, differentiated."""
    b, f, d = x0.shape
    h, n = xk.shape[1], w.shape[1]
    x0_, xk_, w_ = (t.detach().requires_grad_() for t in (x0, xk, w))
    a = torch.einsum("bhd,bfd->bdhf", xk_, x0_).reshape(b * d, h * f)
    out = torch.matmul(a, w_)
    return torch.autograd.grad(out, (x0_, xk_, w_), g.transpose(1, 2).reshape(b * d, n))


def library_cin_backward_chunked(g, x0, xk, w, chunk: int) -> tuple:
    """``library_cin_backward`` ``chunk`` samples at a time, so that its
    four (B·D, H·F) float32 tensors fit the card at train_batch's 65,536:
    dx0 and dxk each chunk's own, dw the chunks' sum in order."""
    dx0, dxk, dw = torch.empty_like(x0), torch.empty_like(xk), torch.zeros_like(w)
    for lo in range(0, x0.shape[0], chunk):
        part = slice(lo, lo + chunk)
        dx0[part], dxk[part], dwc = library_cin_backward(g[part], x0[part], xk[part], w)
        dw += dwc
    return dx0, dxk, dw


def time_cin_layer_backward(gen, dev, b: int, f: int, h: int, hn: int, d: int) -> dict:
    """K3-bwd at one layer's shape.  B = 512 and 1,024 (to
    CIN_BWD_PLAIN_MAX): CUDA-graph replays over four rotating input sets (w
    one matrix), beside the plain backward (graph replays too) and the
    library yardstick (eager calls: autograd inside).  B = 65,536: eager
    calls on the device's clock (a call is tens of ms), no plain version
    (its two (B, H·F, D) float32 tensors, P and the maps, are 40.9 GB at
    K = 7,800), the library yardstick in chunks of samples whose
    four (B·D, H·F) float32 tensors take at most CIN_BWD_LIBRARY_BYTES
    (``library_cin_backward_chunked``).  The bound: ``backward_work``'s
    (3xTF32 on the tensor cores, forming A and the contractions float32 on
    the CUDA cores); beside it the bound of the float32 CUDA-core kernel
    K3-bwd replaced, max(bytes, (4·M·N·K + 5·M·K) / 67 TFLOP/s)."""
    big = b > CIN_BWD_PLAIN_MAX
    n_sets = 1 if big else 4
    sets = [cin_backward_inputs(gen, dev, b, f, h, hn, d) for _ in range(n_sets)]
    w = sets[0][3]
    work = cin_kernel.backward_work(b, f, h, hn, d, 4)
    m, k = b * d, h * f
    fp32_flops = 4 * m * hn * k + 5 * m * k

    def kernel(i):
        g, x0, xk, _ = sets[i % n_sets]
        return ops.cin_layer_backward(g, x0, xk, w)

    def plain(i):
        g, x0, xk, _ = sets[i % n_sets]
        return ref.cin_layer_backward(g, x0, xk, w)

    chunk = max(1, min(b, CIN_BWD_LIBRARY_BYTES // (4 * d * k * 4)))

    def library(i):
        g, x0, xk, _ = sets[i % n_sets]
        if chunk >= b:
            return library_cin_backward(g, x0, xk, w)
        return library_cin_backward_chunked(g, x0, xk, w, chunk)

    res = {"shape": [b, f, h, hn, d], "flops_by_unit": work[0], "bytes": work[1],
           "plan": cin_kernel.backward_plan(b, f, h, hn, d)._asdict(),
           "bound_ms": bound(work)[0], "bound_by": bound(work)[1],
           "bound_of": "3xTF32 tensor-core operations at 494.7 TFLOP/s plus the float32 "
                       "contractions at 67 TFLOP/s, or bytes at 3.35 TB/s",
           "tf32x3_bound_ms": 3 * 4 * m * hn * k / analysis.PEAKS["tf32"] * 1e3,
           "fp32_cuda_core_bound_ms": max(work[1] / HBM_BYTES_PER_S,
                                          fp32_flops / FP32_FLOP_PER_S) * 1e3,
           "library_chunk": chunk}
    if big:
        res["kernel_ms"] = call_ms(kernel, n_iter=3, warmup=1)
        res["plain_ms"] = None
        res["plain_note"] = (f"not timed: the plain backward's two (B, H·F, D) float32 "
                             f"tensors are {2 * b * h * f * d * 4 / 1e9:.1f} GB")
        res["library_ms"] = call_ms(library, n_iter=2, warmup=1)
    else:
        res["kernel_ms"] = device_ms(kernel)
        res["kernel_call_ms"] = call_ms(kernel)
        res["plain_ms"] = device_ms(plain)
        res["library_ms"] = call_ms(library)
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    res["tf32x3_share_of_bound"] = res["tf32x3_bound_ms"] / res["kernel_ms"]
    res["fp32_cuda_core_share_of_bound"] = res["fp32_cuda_core_bound_ms"] / res["kernel_ms"]
    del sets
    torch.cuda.empty_cache()
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
    work = da_kernel.work(b, hq, hkv, d, t, es, valid=n_valid)
    accounted = da_kernel.work(b, hq, hkv, d, t, es)     # every slot: what the accounting counts
    bytes_moved = work[1]
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

    def kernel_lse(i):
        q, k, v = sets[i % n_sets]
        return ops.decode_attention(q, k, v, pos, return_lse=True)

    err = decode_compare(f"decode_attention timing shape B={b} T={t} pos={pos_kind}",
                         kernel(0), plain(0))
    lib_err = float((library(0).float() - plain(0).float()).abs().max())
    big = b * t >= 1 << 20                               # the plain version moves GBs a call
    split = kernel_device_ms(kernel, ("decode_attention_kernel", "decode_attention_combine"),
                             n_iter=max(20, n_sets))
    res = {
        "name": name, "heads": [hq, hkv, d], "batch": b, "slots": t, "pos": pos_kind,
        "valid_slots": n_valid,
        "bytes": bytes_moved, "flops": work[0]["fp32"],
        "run_slots": k4_run_slots(b, t, hq, hkv, d, es),
        "max_abs_err_vs_plain": err, "library_max_abs_err_vs_plain": lib_err,
        "kernel_ms": device_ms(kernel, n_iter=max(20, n_sets)),
        "kernel_call_ms": call_ms(kernel, n_iter=max(20, n_sets)),
        "main_ms": split["decode_attention_kernel"],
        "combine_ms": split["decode_attention_combine"],
        "plain_ms": device_ms(plain, n_iter=3 if big else 20, replays=2 if big else 5),
        "library_ms": device_ms(library, n_iter=5 if big else 20, replays=2 if big else 5),
        "bound_ms": bound(work)[0], "bound_by": bound(work)[1],
        "accounted_bound_ms": bound(accounted)[0],
        "accounted_flops": accounted[0], "accounted_bytes": accounted[1],
    }
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    res["achieved_tb_per_s"] = bytes_moved / res["kernel_ms"] / 1e9
    if "return_lse" in inspect.signature(ops.decode_attention).parameters:
        # the same launch writing each query head's log-sum-exp too (B·Hq floats)
        res["kernel_lse_ms"] = device_ms(kernel_lse, n_iter=max(20, n_sets))
        res["lse_over_no_lse"] = res["kernel_lse_ms"] / res["kernel_ms"]
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


def sched_model(seed: int, dev, arch: str, cfg, out_dir: Path) -> tuple[dict, dict]:
    """One paper model at its published size: the card's latency curve
    through the serving worker's steps (``infra.measure_card_curve``: pad,
    copy, forward, wait; exactly ``forward_launches(cfg)`` a request) and
    the host CPU's curve (``infra.measure_cpu_curve``) twice: on all its
    threads, the reference's method and the one the curve file keeps, and
    on one thread, what one of the simulated node's executors (a core) has.
    Both files go to ``out_dir``.  Then, on each CPU curve at the model's
    medium SLA, ``tune_three`` (40 executors, one accelerator, the
    simulator's request overhead: the reference's constants).  Returns the
    model's row of the sched line and its curves, ``{"cpu": all threads,
    "card": the card}``."""
    t0 = time.monotonic()
    params = recsys.init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    ops.reset_launch_counts()
    card = infra.measure_card_curve(arch, cfg=cfg, params=params, seed=seed)
    launches = ops.launch_counts()
    want = {k: n * card.requests for k, n in forward_launches(cfg).items()}
    if launches != want:
        fail(f"sched {arch}: {card.requests} requests launched {launches}, expected {want}")
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
    row = {
        "arch": arch, "sla_ms": SLA_TARGETS[arch].medium_ms,
        "card_ms": card_ms, "card_steps_ms": card.steps_ms, "card_monotone": monotone(card_ms),
        "cpu_ms": cpu_ms, "cpu_monotone": monotone(cpu_ms),
        "cpu_1t_ms": cpu1_ms, "cpu_1t_monotone": monotone(cpu1_ms),
        **tune_three(arch, cpu, card.curve, SLA_TARGETS[arch].medium_ms, seed),
        "one_thread": tune_three(arch, cpu1, card.curve, SLA_TARGETS[arch].medium_ms, seed),
        "launches": launches, "requests": card.requests,
        "logits_max_abs_err_vs_plain": logit_err,
        "seconds": {"card": card_s, "cpu_curves": t1 - t0 - card_s,
                    "tuning": time.monotonic() - t1}}
    return row, {"cpu": cpu, "card": card.curve}


def sched(seed: int, dev, archs=tuple(PAPER_MODELS)) -> tuple[dict, dict]:
    """DeepRecSched on the card: ``sched_model`` for each of ``archs`` (the
    eight paper models) at its published size, one at a time.  Returns the
    sched line and each model's curves, ``{arch: {"cpu": ..., "card": ...}}``."""
    out_dir = sched_artifacts()
    rows, curves, total = [], {}, dict.fromkeys(KERNELS, 0)
    for arch in archs:
        row, curves[arch] = sched_model(seed, dev, arch, PAPER_MODELS[arch], out_dir)
        total = {k: total[k] + row["launches"][k] for k in KERNELS}
        rows.append(row)
    return {"phase": "sched", "executors": SCHED_EXECUTORS, "cpu_curve_iters": infra.CPU_ITERS,
            "cpu": infra.cpu_model(),
            "cpu_threads": torch.get_num_threads(), "card_reps": infra.CARD_REPS,
            "card_warmup": infra.CARD_WARMUP, "artifacts": str(out_dir),
            "models": rows, "launches": total}, curves


# ------------------------------------------------------------------- datacenter


def numbers(obj, path: str = ""):
    """(path, value) of every number in a line's nested dicts and lists;
    booleans, strings and None are not numbers."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from numbers(v, f"{path}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from numbers(v, f"{path}[{i}]")
    elif not isinstance(obj, (bool, str, type(None))):
        yield path, float(obj)


def check_datacenter(line: dict) -> None:
    """The datacenter line's gates: every number finite; the killed day
    with re-route drops no query and re-routes at least one, without
    re-route it drops at least one; every fleet run serves or drops each
    offered query; no kernel launched; the phase within DATACENTER_SECONDS."""
    bad = [p for p, v in numbers(line) if not math.isfinite(v)]
    if bad:
        fail(f"datacenter: non-finite numbers at {bad}")
    fleet = line["fleet"]
    kill = fleet["kill"]
    if kill["reroute"]["dropped"] != 0 or kill["reroute"]["rerouted"] < 1:
        fail(f"datacenter: the killed day with re-route re-routed {kill['reroute']['rerouted']} "
             f"and dropped {kill['reroute']['dropped']} queries (want >= 1 and 0)")
    if kill["no_reroute"]["dropped"] < 1:
        fail("datacenter: the killed day without re-route dropped no query")
    for what, r in (("static", fleet["static"]), ("autoscaled", fleet["autoscaled"]),
                    ("kill with re-route", kill["reroute"]),
                    ("kill without re-route", kill["no_reroute"])):
        if r["served"] + r["dropped"] != fleet["queries"]:
            fail(f"datacenter: {what} served {r['served']} and dropped {r['dropped']} of "
                 f"{fleet['queries']} offered queries")
    if any(line["launches"].values()):
        fail(f"datacenter: launched {line['launches']}; the phase launches no kernel")
    if line["seconds"]["total"] > DATACENTER_SECONDS:
        fail(f"datacenter: {line['seconds']['total']:.1f} s, past {DATACENTER_SECONDS:.0f} s")


def datacenter(curves: dict, *, day_s: float = DATACENTER_DAY_S, seed: int = 0) -> dict:
    """The JAX package's two datacenter examples on the port, on ``curves``
    (``{arch: {"cpu": ..., "card": ...}}``, as ``sched`` measured them):
    ``dc.sim_rows`` on dc.MODELS with the card's curves as the accelerator
    (static, tuned on the CPU alone and with the card, p95 at 70 % under
    stragglers, hedges and an executor failure), then ``dc.fleet_day`` on
    the fleet of the fleet model's host-CPU and card curves over a
    ``day_s`` day.  Numpy only: no kernel launches.
    Gated by ``check_datacenter``; whether each model meets its SLA under
    faults is reported, not gated, as the reference's OK / VIOLATED column."""
    t0 = time.monotonic()
    before = ops.launch_counts()
    rows = dc.sim_rows(dc.MODELS, dc.TIER, {a: curves[a]["cpu"] for a in dc.MODELS},
                       {a: curves[a]["card"] for a in dc.MODELS}, seed=seed)
    t_sim = time.monotonic() - t0
    arch = dc.FLEET_ARCH
    fleet = dc.fleet_day(dc.build_fleet(False, cpu=curves[arch]["cpu"],
                                        accel=curves[arch]["card"]), day_s=day_s, seed=seed)
    after, total_s = ops.launch_counts(), time.monotonic() - t0
    line = {"phase": "datacenter", "tier": dc.TIER, "fleet_arch": arch,
            "cut": f"the fleet's day {day_s:g} s, windows {fleet['window_s']:g} s, "
                   f"boot {fleet['boot_s']:g} s (the reference's 60 s, 2 s, 6 s)",
            "day_s": day_s, "sim": rows, "fleet": fleet,
            "launches": {k: after[k] - before[k] for k in KERNELS},
            "seconds": {"sim": t_sim, "fleet": total_s - t_sim, "total": total_s}}
    check_datacenter(line)
    return line


def datacenter_only(seed: int, dev) -> dict:
    """``--only datacenter``: ``sched`` on dc.MODELS alone (its line
    printed), then the datacenter phase on the curves it measured."""
    line, curves = sched(seed, dev, dc.MODELS)
    emit({**line, "card": card_line()})
    return datacenter(curves, seed=seed)


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
    with the card (``main`` floors it at the static baseline's),
    ``card_curve`` the log-linear card curve it measured."""
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


# calls of a zoo forward or retrieval timed by CUDA events (median): the host
# clock's median of 5 spreads by up to 40 % between runs
ZOO_EVENT_CALLS = 20


def lookup_cost(table: torch.Tensor, ids: torch.Tensor) -> dict:
    """Device time (``device_ms``: CUDA-graph replay) of ``emb_lib.lookup``
    at ``ids`` beside the bare gather it wraps (``F.embedding``), and the
    difference: what the id pass and the NaN fill of ``jnp.take``'s
    semantics cost a lookup."""
    import torch.nn.functional as F
    n_iter = 5 if ids.numel() > 100_000 else 20
    full = device_ms(lambda i: emb_lib.lookup(table, ids), n_iter=n_iter)
    bare = device_ms(lambda i: F.embedding(ids.long(), table), n_iter=n_iter)
    torch.cuda.empty_cache()
    return {"ids": list(ids.shape), "lookup_ms": full, "gather_ms": bare, "extra_ms": full - bare}


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
        row["forward_event_ms"] = timed_calls(
            counted(lambda: recsys.forward(params, cfg, batch), cfg), ZOO_EVENT_CALLS)[0]
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
            row["lookup_device_ms"] = [lookup_cost(params["item_table"], ids)
                                       for ids in (batch["history"], cand["candidates"])]
            # retrieval runs no kernel: a launch here breaks the count below
            row["score_ms"], scores = host_ms(lambda: recsys.score_candidates(params, cfg, cand))
            row["score_event_ms"] = timed_calls(
                lambda: recsys.score_candidates(params, cfg, cand), ZOO_EVENT_CALLS)[0]
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


class _PlainCin(torch.autograd.Function):
    """The CIN layer's plain forward, and ``bwd`` in float64 as its
    backward, each gradient cast to its input's dtype."""

    @staticmethod
    def forward(ctx, x0, xk, w, bwd):
        ctx.save_for_backward(x0, xk, w)
        ctx.bwd = bwd
        return ref.cin_layer(x0, xk, w)

    @staticmethod
    def backward(ctx, grad):
        x0, xk, w = ctx.saved_tensors
        dx0, dxk, dw = ctx.bwd(grad.double(), x0.double(), xk.double(), w.double())
        return dx0.to(x0.dtype), dxk.to(xk.dtype), dw.to(w.dtype), None


@contextlib.contextmanager
def plain_backward(k1_bwd=ref.embedding_bag_backward, k2_bwd=ref.dot_interaction_backward,
                   k3_bwd=ref.cin_layer_backward):
    """Inside, the model's pooling, dot interaction and CIN layers run their
    plain forwards, and ``k1_bwd`` / ``k2_bwd`` / ``k3_bwd`` (the plain
    backward versions, in float64, unless a test hands in broken ones) as
    their backwards: no kernel launches."""
    kernels = ops.embedding_bag, ops.dot_interaction, ops.cin_layer
    ops.embedding_bag = lambda tables, idx, mode="sum": _PlainBag.apply(tables, idx, mode, k1_bwd)
    ops.dot_interaction = lambda feats: _PlainDot.apply(feats, k2_bwd)
    ops.cin_layer = lambda x0, xk, w: _PlainCin.apply(x0, xk, w, k3_bwd)
    try:
        yield
    finally:
        ops.embedding_bag, ops.dot_interaction, ops.cin_layer = kernels


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


def train_launches(cfg) -> dict[str, int]:
    """A recommendation model's launches a training step: one K1 and one
    K1-bwd; one K2 and one K2-bwd for a dot interaction; a K3 and a K3-bwd
    a CIN layer."""
    dot = int(cfg.interaction == "dot")
    cin = len(cfg.cin_layers) if cfg.interaction == "cin" else 0
    return {"embedding_bag": 1, "embedding_bag_backward": 1, "dot_interaction": dot,
            "dot_interaction_backward": dot, "cin_layer": cin, "cin_layer_backward": cin}


def expect_train_launches(what: str, launches: dict, steps: int,
                          per_step: dict | None = None) -> None:
    """Exactly ``per_step``'s launches a step (by default RMC2's: one K1,
    K1-bwd, K2 and K2-bwd), and nothing else."""
    per_step = per_step or train_launches(PAPER_MODELS[TRAIN_ARCH])
    want = {**dict.fromkeys(KERNELS, 0), **{k: v * steps for k, v in per_step.items()}}
    if launches != want:
        fail(f"train {what}: {steps} steps launched {launches}, expected {want}")


def same_bits_in_a_graph(what: str, eager: torch.Tensor, call) -> None:
    """``call()`` (a whole wrapper call: allocation, zeroing, every kernel)
    captured in a CUDA graph and replayed gives ``eager``'s bits; the
    capture itself fails if the call synchronises with the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, eager):
            fail(f"{what}: a CUDA-graph replay gave other bits")
    del graph, replayed
    torch.cuda.empty_cache()


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
            if name == TRAIN_ARCH and b == TRAIN_BATCH:
                same_bits_in_a_graph(f"embedding_bag_backward {name} B={b}", got,
                                     lambda: ops.embedding_bag_backward(g, idx, vocab))
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
            if name == TRAIN_ARCH and b == TRAIN_BATCH:
                same_bits_in_a_graph(f"dot_interaction_backward {name} B={b}", got,
                                     lambda: ops.dot_interaction_backward(g, x))
            k2_err = max(k2_err, err)
            checks.append({"fn": "dot_interaction_backward", "model": name, "shape": [b, f, 32],
                           "max_abs_err": err})
    return checks, k1_err, k2_err


def distinct_rows(sets: list[torch.Tensor], vocab: int) -> float:
    """Mean count of distinct (table, row) pairs an index set touches."""
    f = sets[0].shape[1]
    offs = (torch.arange(f, device=sets[0].device, dtype=torch.int64) * vocab)[None, :, None]
    return statistics.mean(int(torch.unique(s.long() + offs).numel()) for s in sets)


# the kernels one K1-bwd call launches, by name: this tree's, then the owner-computes
# kernel's.  The last name, k1_bwd_launcher's branch without ``backward_plan``
# and k2_bwd_plan's without ``BWD_BUFFERS`` serve only a copy of this script
# run in the tree of the commit before the sort-based K1-bwd and the
# persistent K2-bwd, to time the kernels they replaced
K1_BWD_KERNELS = ("partition_count", "partition_columns", "partition_scatter", "backward_sum",
                  "backward_combine", "embedding_bag_backward_kernel")


def k1_bwd_launcher(g: torch.Tensor, idx: torch.Tensor, buf: torch.Tensor) -> tuple:
    """(fn, plan): ``fn()`` makes one K1-bwd launch of ``g`` and ``idx`` into
    the standing buffer ``buf`` and nothing else, its plan and scratch made
    once.  From a parent's tree, whose K1-bwd (owner-computes) takes the
    warps a table instead of a plan, the same for that kernel: how a copy of
    this script times the parent's K1-bwd."""
    b, f, h = idx.shape
    v, d = buf.shape[1], buf.shape[2]
    if not hasattr(eb_kernel, "backward_plan"):
        log_w = eb_kernel.backward_warps(f, ix_kernel.sm_count(g.device.index or 0))
        return (lambda: eb_kernel.launch_backward(g, idx, buf, mean=False, log_w=log_w),
                {"design": "owner-computes", "warps_a_table": 1 << log_w})
    plan = eb_kernel.backward_plan(b, f, v, h, d, g.element_size(),
                                   eb_kernel.backward_vectorized(g))
    scratch = {k: torch.empty(shape, dtype=dt, device=g.device)
               for k, (shape, dt) in eb_kernel.backward_scratch(plan, b, f, h, d).items()}
    return (lambda: eb_kernel.launch_backward(g, idx, buf, mean=False, plan=plan,
                                              scratch=scratch),
            {"design": "partition", **plan._asdict(),
             "scratch_bytes": sum(t.numel() * t.element_size() for t in scratch.values())})


def time_embedding_bag_backward(rng, gen, dev, tables: torch.Tensor, batch: int, ids: str,
                                h: int = PAPER_MODELS[TRAIN_ARCH].hotness, n_sets: int = 8,
                                plain: bool = True) -> dict:
    """K1-bwd at the tables' shape: the kernel alone (every kernel of one
    call) into a standing float32 buffer (the wrapper's zeroing timed
    apart), each of those kernels apart by ``torch.profiler``, the
    wrapper's call (zeroing, scratch, kernel), the plain
    version (unless ``plain`` is False: at B = 65,536 it would materialise
    27 GB), and the library's dense backward of ``F.embedding_bag`` over the
    same flat table and bags; ``n_sets`` input sets rotating.  ``ids``
    'zipf' (the training data's skew: a table's row 0 takes 5 % of its
    lookups) or 'uniform'.  The bound reads the gradient rows and the
    indices once and writes every touched row of the gradient once (the
    kernel stores each into the zeroed buffer and never reads it back);
    zeroing the dense buffer has its own bound."""
    f, v, d = tables.shape
    if ids == "zipf":
        sets = [zipf_ids(rng, (batch, f, h), v, dev) for _ in range(n_sets)]
    else:
        sets = [torch.from_numpy(rng.integers(0, v, (batch, f, h)).astype(np.int32)).to(dev)
                for _ in range(n_sets)]
    gs = [torch.randn((batch, f, d), generator=gen, device=dev) for _ in range(n_sets)]
    buf = torch.zeros((f, v, d), device=dev)
    launches = [k1_bwd_launcher(g, idx, buf) for g, idx in zip(gs, sets)]
    distinct = distinct_rows(sets, v)
    work = eb_kernel.backward_work(batch, f, h, d, 4, rows=distinct)
    accounted = eb_kernel.backward_work(batch, f, h, d, 4)    # every lookup's row stored
    res = {
        "batch": batch, "ids": ids, "distinct_rows": distinct, "lookups": batch * f * h,
        "plan": launches[0][1],
        "kernel_ms": device_ms(lambda i: launches[i % n_sets][0]()),
        # each of the call's kernels apart (this tree's partition, sum and
        # combine; a parent's single kernel)
        "kernels_ms": kernel_device_ms(lambda i: launches[i % n_sets][0](), K1_BWD_KERNELS,
                                       n_iter=10 if batch <= TRAIN_BATCH else 3),
        "zero_ms": device_ms(lambda i: buf.zero_()),
        "kernel_call_ms": call_ms(lambda i: ops.embedding_bag_backward(gs[i % n_sets],
                                                                       sets[i % n_sets], v),
                                  n_iter=10),
        "plain_ms": call_ms(lambda i: ref.embedding_bag_backward(gs[i % n_sets], sets[i % n_sets],
                                                                 v),
                            n_iter=5, warmup=1) if plain else None,
        "bound_ms": bound(work)[0], "bound_by": bound(work)[1],
        "accounted_bound_ms": bound(accounted)[0],
        "accounted_flops": accounted[0], "accounted_bytes": accounted[1],
        "zero_bound_ms": f * v * d * 4 / HBM_BYTES_PER_S * 1e3,
    }
    del buf, launches
    torch.cuda.empty_cache()
    flat = tables.view(f * v, d).detach().requires_grad_()
    offs = (torch.arange(f, device=dev, dtype=torch.int64) * v)[None, :, None]
    outs = [torch.nn.functional.embedding_bag((sets[j].long() + offs).reshape(batch * f, h), flat,
                                              mode="sum") for j in range(2)]
    res["library_ms"] = call_ms(lambda i: torch.autograd.grad(
        outs[i % 2], flat, gs[i % 2].view(batch * f, d), retain_graph=True), n_iter=5, warmup=1)
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    del outs, flat
    torch.cuda.empty_cache()
    return res


def k2_bwd_plan(batch: int, f: int, d: int, dev) -> dict:
    """K2-bwd's plan at (batch, F, D) float32; from a parent's tree, whose
    plan takes (B, F, D) alone, that tree's."""
    if not hasattr(ix_kernel, "BWD_BUFFERS"):
        return ix_kernel.backward_plan(batch, f, d)._asdict()
    return ix_kernel.backward_plan(batch, f, d, 4, ix_kernel.sm_count(dev.index or 0))._asdict()


def time_dot_interaction_backward(gen, dev, batch: int = TRAIN_BATCH,
                                  arch: str = TRAIN_ARCH, n_sets: int = 8) -> dict:
    """K2-bwd at a DLRM model's shape (float32), ``n_sets`` input sets
    rotating, beside its plain version and the library's: autograd's
    backward of the ``bmm`` and gather forward.  The bound reads features
    and gradients once and writes the result once; its operations are 2·D
    for each ordered pair (i, j), i != j."""
    f = recsys._num_feature_rows(PAPER_MODELS[arch])
    d = PAPER_MODELS[arch].embed_dim
    n_out = f * (f - 1) // 2
    xs = [torch.randn((batch, f, d), generator=gen, device=dev) / d ** 0.5 for _ in range(n_sets)]
    gs = [torch.randn((batch, n_out), generator=gen, device=dev) for _ in range(n_sets)]
    work = ix_kernel.backward_work(batch, f, d, 4)
    pairs = torch.from_numpy(ref.tril_pairs(f)).to(dev)
    xr = [x.clone().requires_grad_() for x in xs[:2]]
    outs = [torch.bmm(x, x.transpose(1, 2)).reshape(batch, f * f)[:, pairs] for x in xr]
    res = {
        "arch": arch, "batch": batch, "shape": [batch, f, d],
        "plan": k2_bwd_plan(batch, f, d, dev),
        "kernel_ms": device_ms(lambda i: ops.dot_interaction_backward(gs[i % n_sets],
                                                                      xs[i % n_sets])),
        "kernel_call_ms": call_ms(lambda i: ops.dot_interaction_backward(gs[i % n_sets],
                                                                         xs[i % n_sets])),
        "plain_ms": device_ms(lambda i: ref.dot_interaction_backward(gs[i % n_sets],
                                                                     xs[i % n_sets])),
        "library_ms": call_ms(lambda i: torch.autograd.grad(outs[i % 2], xr[i % 2], gs[i % 2],
                                                            retain_graph=True)),
        "bound_ms": bound(work)[0], "bound_by": bound(work)[1],
        "accounted_flops": work[0], "accounted_bytes": work[1],
    }
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    return res


def bwd_timings(seed: int, dev, gen) -> dict:
    """``--only bwd_timings``: K1-bwd on RMC2's tables (40 x 10^6 x 32,
    float32; the values do not matter to the time) with Zipf and uniform
    ids, and K2-bwd at RMC2's (F, D), at the train phase's B = 1,024 and at
    train_batch's published 65,536, with whichever kernels this tree has."""
    rng = np.random.default_rng(seed)
    cfg = PAPER_MODELS[TRAIN_ARCH]
    big = configs.RECSYS_SHAPES["train_batch"].batch
    tables = torch.zeros((cfg.n_tables, cfg.vocab, cfg.embed_dim), device=dev)
    k1 = [time_embedding_bag_backward(rng, gen, dev, tables, b, ids,
                                      n_sets=8 if b == TRAIN_BATCH else 2, plain=b == TRAIN_BATCH)
          for b in (TRAIN_BATCH, big) for ids in ("zipf", "uniform")]
    del tables
    torch.cuda.empty_cache()
    k2 = [time_dot_interaction_backward(gen, dev, b, n_sets=8 if b == TRAIN_BATCH else 2)
          for b in (TRAIN_BATCH, big)]
    return {"phase": "bwd_timings", "tree": str(Path(_build.CSRC).parents[2]),
            "embedding_bag_backward": k1, "dot_interaction_backward": k2}


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


def train_recsys(seed: int, dev, gen, arch: str = TRAIN_ARCH, steps: int = TRAIN_STEPS,
                 resume_at: int = TRAIN_RESUME_AT, kernel_timings: bool = True) -> dict:
    """A recommendation model (by default DLRM-RMC2) at its published size,
    B = TRAIN_BATCH: (a) one step's gradients through the kernels against
    the plain backward versions, then ``steps`` steps of ``train`` with
    exactly the model's kernels a step (``train_launches``); (c) a run
    stopped at ``resume_at`` with a checkpoint and resumed from it, its
    losses against the straight run's; (b) a step's parts timed, and with
    ``kernel_timings`` K1-bwd and K2-bwd checked against their plain
    versions and timed."""
    t_start = time.monotonic()
    cfg = configs.get(arch).config
    per_step = train_launches(cfg)
    rng = np.random.default_rng(seed)
    params = recsys.init(gen, cfg, device=dev)
    batches = [to_device(syn.recsys_batch(rng, cfg, TRAIN_BATCH), dev) for _ in range(steps)]

    def loss_fn(p, b):
        return recsys.loss_fn(p, cfg, b)

    ops.reset_launch_counts()
    loss_k, grads_k = step_grads(loss_fn, params, batches[0])
    expect_train_launches(f"{arch} gradient step", ops.launch_counts(), 1, per_step)
    before = ops.launch_counts()
    with plain_backward():
        loss_p, grads_p = step_grads(loss_fn, params, batches[0])
    if ops.launch_counts() != before:
        fail(f"train {arch}: the plain step launched a kernel")
    grad_err = check_train_grads(f"train {arch}", grads_k, grads_p)
    loss_err = compare(f"train {arch} loss", torch.tensor(loss_k), torch.tensor(loss_p), 1e-5,
                       0.0)
    del grads_k, grads_p
    torch.cuda.empty_cache()

    def run(n, batch_list, losses, **kw):
        return train(loss_fn, recsys_optimizer(), params, iter(batch_list), num_steps=n,
                     log_every=0, clip_norm=TRAIN_CLIP,
                     hooks=[lambda s, p, m: losses.append(float(m["loss"]))], **kw)

    straight = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = run(steps, batches, straight)
    torch.cuda.synchronize()
    straight_s = time.monotonic() - t0
    launches = ops.launch_counts()
    expect_train_launches(f"{arch} {steps} steps", launches, steps, per_step)
    check_losses(f"{arch} straight run", straight, steps)
    del state
    torch.cuda.empty_cache()

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    try:
        first, resumed = [], []
        t0 = time.monotonic()
        run(resume_at, batches, first, ckpt_dir=str(TRAIN_CKPT), ckpt_every=resume_at)
        save_s = time.monotonic() - t0
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        state = run(steps, batches[resume_at:], resumed, ckpt_dir=str(TRAIN_CKPT),
                    ckpt_every=steps)
        resume_s = time.monotonic() - t0
        expect_train_launches(f"{arch} resumed run", ops.launch_counts(), steps - resume_at,
                              per_step)
        launches = {k: launches[k] + n for k, n in ops.launch_counts().items()}
        del state
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    check_losses(f"{arch} resumed run", resumed, steps - resume_at)
    # bit for bit: every kernel of the step sums in an order fixed by its
    # inputs (K1-bwd by the sorted lookups and its chunks, K2-bwd in
    # ascending j, K3-bwd in runs fixed by the shapes; no atomics), the
    # batches and the checkpointed state are the same, so the runs repeat
    # exactly
    check_same_bits(f"train {arch} resumed losses", resumed, straight[resume_at:])
    check_same_bits(f"train {arch} stopped run's losses", first, straight[:resume_at])

    opt = recsys_optimizer()
    parts = train_step_ms(loss_fn, params, opt, opt.init(params),
                          batches[:TRAIN_TIMED_STEPS + 1])
    torch.cuda.empty_cache()
    out = {"arch": arch, "batch": TRAIN_BATCH, "steps": steps,
           "first_loss": straight[0], "last_loss": straight[-1], "losses": straight,
           "grad_max_abs_err": grad_err, "loss_abs_err": loss_err, "tol": TOL[torch.float32],
           "ms_a_step_host": straight_s / steps * 1e3, **parts,
           "resumed_from": resume_at, "resumed_losses": resumed,
           "resume_bit_for_bit": True,
           "checkpoint_save_s": save_s, "resume_run_s": resume_s,
           "launches": launches, "launches_a_step": per_step}
    if kernel_timings:
        checks, k1_err, k2_err = check_backward_kernels(rng, gen, dev, cfg.vocab)
        out.update({
            "backward_checks": checks, "embedding_bag_backward_max_abs_err": k1_err,
            "dot_interaction_backward_max_abs_err": k2_err,
            "timings_embedding_bag_backward": [
                time_embedding_bag_backward(rng, gen, dev, params["tables"], TRAIN_BATCH, ids)
                for ids in ("zipf", "uniform")],
            "timing_dot_interaction_backward": time_dot_interaction_backward(gen, dev)})
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["seconds"] = time.monotonic() - t_start
    del params, batches
    torch.cuda.empty_cache()
    return out


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
    torch.cuda.reset_peak_memory_stats(dev)
    line["xdeepfm"] = train_recsys(seed, dev, gen, TRAIN_CIN_ARCH, TRAIN_CIN_STEPS,
                                   TRAIN_CIN_RESUME_AT, kernel_timings=False)
    line["lm"] = train_lm(seed, dev, gen)
    line["seconds"] = time.monotonic() - t0
    line["launches"] = {k: line["recsys"]["launches"][k] + line["xdeepfm"]["launches"][k]
                        for k in KERNELS}
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


STARTED = time.monotonic()         # the script's start: a profile records its process's age


def lost_kernel_records(events) -> int:
    """Kernel launches in a torch.profiler trace that have no kernel record:
    launch calls on the host (runtime or driver, ``*LaunchKernel*``) whose
    correlation id no device event carries.  On an H100 machine (torch
    2.11, CUPTI) a trace kept every launch call but lost kernel records,
    late in a long run; the cause is not known."""
    launched = {e.id for e in events if e.device_type == DeviceType.CPU
                and "LaunchKernel" in e.name}
    recorded = {e.id for e in events if e.device_type == DeviceType.CUDA}
    return len(launched - recorded)


def step_profile(fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of its
    ``top`` longest kernels (by name, summed over launches), the sum over all
    its kernels, and that sum's share of the call's wall time, the device's
    busy share (the kernels run on one stream, so they do not overlap).
    ``kernel_records_lost`` counts the launches the trace kept no kernel
    record of (``lost_kernel_records``): where it is not 0, ``complete`` is
    false and ``device_ms``, ``busy_share`` and ``launches`` are lower
    bounds.  None where the trace saw no device time."""
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
    lost = lost_kernel_records(prof.events())
    age = {"process_age_s": time.monotonic() - STARTED, "kernel_records_lost": lost,
           "complete": lost == 0}
    if not total:
        return {"wall_ms": wall_ms, "device_ms": None, **age}
    return {"wall_ms": wall_ms, "device_ms": total, "busy_share": total / wall_ms,
            "launches": sum(n for _, n, _ in kernels), **age,
            "top": [{"kernel": k[:90], "ms": ms, "launches": n} for ms, n, k in kernels[:top]]}


def check_same_bits(what: str, a: list, b: list) -> None:
    """Two runs' losses, the same float values (``torch.equal``)."""
    if not torch.equal(torch.tensor(a, dtype=torch.float64), torch.tensor(b, dtype=torch.float64)):
        fail(f"{what}: a second run gave other losses: {a} vs {b}")


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
    check_same_bits("gnn cora", losses, gnn_run(loss_fn, params, batch, GNN_CORA_STEPS)[0])
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
    check_same_bits("gnn molecule", losses, gnn_run(loss_fn, params, batch, GNN_MOLECULE_STEPS)[0])
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


# ------------------------------------------------------------------ cells


def same_leaves(what: str, got: dict, want: dict) -> dict:
    """Two steps' trees, leaf by leaf ({path: tensor}): each must hold the
    same bits (``torch.equal``); a leaf that does not is held to the gradient
    gate's TOL instead (``grad_compare``: an op that sums in another order
    on DTensors) and named.  Fails on a leaf outside TOL or a missing one."""
    if got.keys() != want.keys():
        fail(f"{what}: leaves {sorted(got)} != {sorted(want)}")
    at_tol, err = [], 0.0
    for k, w in want.items():
        g = got[k].to(w.device)
        if not torch.equal(g, w):
            err = max(err, grad_compare(f"{what} {k}", g, w))
            at_tol.append(k)
    return {"leaves": len(want), "bit_equal": len(want) - len(at_tol), "at_tol": at_tol,
            "max_abs_err": err}


def expect_cell_launches(what: str, launches: dict, want: dict) -> None:
    """Exactly ``want`` launches of each kernel named, none of the others."""
    full = {**dict.fromkeys(KERNELS, 0), **want}
    if launches != full:
        fail(f"cells {what}: launched {launches}, expected {full}")


def tally(total: dict, what: str, want: dict) -> None:
    """Check the launches since the last reset (``expect_cell_launches``)
    and add them to the phase's ``total``."""
    launches = ops.launch_counts()
    expect_cell_launches(what, launches, want)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def local_leaves(tree) -> dict:
    """{path: the local tensor} of a tree of DTensors or tensors."""
    return {k: v.to_local() if isinstance(v, DTensor) else v
            for k, v in leaves_with_paths(tree)}


def timed_calls(fn, n: int) -> tuple[float, list]:
    """Median ms of ``n`` calls of ``fn()`` (CUDA events, host issue
    included), and each call's result."""
    ms, outs = [], []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        outs.append(fn())
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(ms), outs


def clone_tree(tree):
    return tree_map(lambda t: t.clone(), tree)


def cells_train_recsys(seed: int, dev, gen, mesh, launches: dict,
                     cell_key: tuple[str, str] = CELLS_TRAIN) -> dict:
    """A recommendation model's train_batch cell at its published size and
    batch (by default DLRM-RMC2's: 40 x 10^6 x 32 float32 tables; B =
    65,536): one step of the cell's train_step on DTensors and the same
    step on plain tensors from the same parameters, optimiser state and
    batch; loss, every parameter and every optimiser leaf bit for bit
    (``same_leaves``, and no leaf let through at its tolerance); exactly
    the model's kernels a step on each path
    (``train_launches``: RMC2 one K1, K2, K1-bwd and K2-bwd; xDeepFM one K1
    and K1-bwd, three K3 and K3-bwd); then CELLS_TIMED more steps of each
    path timed, and one more under torch.profiler (``step_profile``)."""
    t_start = time.monotonic()
    arch, shape = cell_key
    cfg = configs.get(arch).config
    cell = steps_lib.build_cell(arch, shape, mesh)
    b = configs.RECSYS_SHAPES[shape].batch
    torch.cuda.reset_peak_memory_stats(dev)
    params = recsys.init(gen, cfg, device=dev)
    state = cell.init_state(params)
    batch = to_device(syn.recsys_batch(np.random.default_rng(seed), cfg, b), dev)
    sharded = cell.place(clone_tree(params), clone_tree(state), batch)
    one = {**dict.fromkeys(KERNELS, 0), **train_launches(cfg)}
    out = {"arch": arch, "shape": shape, "batch": b, "mesh": list(mesh.shape)}
    runs = {}
    for name, args in (("sharded", sharded), ("unsharded", (params, state, batch))):
        ops.reset_launch_counts()
        ms, (first,) = timed_calls(lambda: cell.fn(*args), 1)
        tally(launches, f"{arch} {name} step", one)
        runs[name] = {"first_step_ms": ms, "loss": local_leaves({"l": first[2]})["['l']"]}
    loss_s, loss_u = runs["sharded"]["loss"], runs["unsharded"]["loss"]
    if not torch.isfinite(loss_u) or not torch.equal(loss_s, loss_u):
        fail(f"cells {arch}: sharded loss {float(loss_s)} != unsharded {float(loss_u)}")
    out["loss"] = float(loss_u)
    out["params"] = same_leaves(f"cells {arch} params", local_leaves(sharded[0]),
                                local_leaves(params))
    out["opt_state"] = same_leaves(f"cells {arch} optimiser state", local_leaves(sharded[1]),
                                   local_leaves(state))
    differ = out["params"]["at_tol"] + out["opt_state"]["at_tol"]
    if differ:
        fail(f"cells {arch}: the DTensor step's leaves {differ} are not the plain step's bits")
    for name, args in (("sharded", sharded), ("unsharded", (params, state, batch))):
        ops.reset_launch_counts()
        runs[name]["step_ms"], _ = timed_calls(lambda: cell.fn(*args), CELLS_TIMED)
        tally(launches, f"{arch} {name} timed steps",
              {k: v * CELLS_TIMED for k, v in one.items()})
        ops.reset_launch_counts()
        runs[name]["profile"] = step_profile(lambda: cell.fn(*args), top=6)
        tally(launches, f"{arch} {name} profiled step", one)
        del runs[name]["loss"]
    out.update(runs)
    out["launches_a_step"] = one
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["distinct_rows"] = distinct_rows([batch["sparse"]], cfg.vocab)
    out["seconds"] = time.monotonic() - t_start
    del params, state, batch, sharded, cell
    torch.cuda.empty_cache()
    return out


def cells_serve_xdeepfm(seed: int, dev, gen, mesh, launches: dict) -> dict:
    """xDeepFM's serve_p99 cell at its published size (39 x 200,000 x 10,
    CIN 200-200-200, B = 512): the cell's serving step on DTensors against
    ``recsys.bulk_forward`` on plain tensors, the same bits, one K1 and
    three K3 launches each."""
    arch, shape = CELLS_SERVE
    cfg = configs.get(arch).config
    cell = steps_lib.build_cell(arch, shape, mesh)
    b = configs.RECSYS_SHAPES[shape].batch
    torch.cuda.reset_peak_memory_stats(dev)
    params = recsys.init(gen, cfg, device=dev)
    batch = to_device(syn.recsys_batch(np.random.default_rng(seed), cfg, b,
                                       with_label=False), dev)
    sharded = cell.place(clone_tree(params), batch)
    want_launches = {"embedding_bag": 1, "cin_layer": len(cfg.cin_layers)}
    out = {"arch": arch, "shape": shape, "batch": b, "mesh": list(mesh.shape)}
    res = {}
    for name, fn in (("sharded", lambda: cell.fn(*sharded)),
                     ("unsharded", lambda: recsys.bulk_forward(params, cfg, batch))):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        tally(launches, f"{arch} {name}", want_launches)
        ops.reset_launch_counts()
        out[f"{name}_ms"], outs = timed_calls(fn, CELLS_TIMED)
        tally(launches, f"{arch} {name} timed calls",
              {k: v * CELLS_TIMED for k, v in want_launches.items()})
        res[name] = local_leaves({"o": outs[0]})["['o']"]
    if res["unsharded"].shape != (b,) or not torch.isfinite(res["unsharded"]).all():
        fail(f"cells {arch}: logits {tuple(res['unsharded'].shape)} not finite of ({b},)")
    if not torch.equal(res["sharded"], res["unsharded"]):
        err = float((res["sharded"] - res["unsharded"]).abs().max())
        fail(f"cells {arch}: sharded logits differ from unsharded by {err:.3e}")
    out["launches_a_call"] = {**dict.fromkeys(KERNELS, 0), **want_launches}
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["distinct_rows"] = distinct_rows([batch["sparse"]], cfg.vocab)
    del params, batch, sharded, cell
    torch.cuda.empty_cache()
    return out


def cells_train_lm(seed: int, dev, gen, mesh, launches: dict) -> dict:
    """granite-moe-1b-a400m's train_4k cell at published width and depth,
    the batch cut to CELLS_LM_BATCH x CELLS_LM_SEQ tokens: one step of the
    cell's train_step on DTensors (its MoE layers through
    ``make_sharded_moe``) against one AdamW step of ``lm.loss_fn`` on plain
    tensors (``apply_moe``) from the same weights and batch; the losses
    within CELLS_LM_RTOL; the largest parameter difference reported; each
    path timed and profiled as RMC2's.  No kernel runs: launches are 0."""
    arch, shape = CELLS_LM
    cfg = configs.get(arch).config
    cell = steps_lib.build_cell(arch, shape, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init(gen, cfg, device=dev)
    state = cell.init_state(params)
    batch = to_device(syn.lm_batch(np.random.default_rng(seed), cfg, CELLS_LM_BATCH,
                                   CELLS_LM_SEQ), dev)
    sharded = cell.place(clone_tree(params), clone_tree(state), batch)
    opt = optim.adamw(3e-4)                       # the cell's optimiser

    def unsharded_step():
        loss, grads = value_and_grad(lambda p, b_: lm.loss_fn(p, cfg, b_), params, batch)
        opt.update(grads, state, params)
        return loss

    ops.reset_launch_counts()
    ms_s, (first,) = timed_calls(lambda: cell.fn(*sharded), 1)
    ms_u, (loss_u,) = timed_calls(unsharded_step, 1)
    tally(launches, f"{arch} steps", {})
    loss_s = float(local_leaves({"l": first[2]})["['l']"])
    if not np.isfinite(loss_s) or abs(loss_s - float(loss_u)) > CELLS_LM_RTOL * abs(float(loss_u)):
        fail(f"cells {arch}: sharded loss {loss_s} vs unsharded {float(loss_u)}, "
             f"past rtol {CELLS_LM_RTOL}")
    got, want = local_leaves(sharded[0]), local_leaves(params)
    diff = {k: float((got[k].float() - w.float()).abs().max()) for k, w in want.items()}
    worst = max(diff, key=diff.get)
    out = {"arch": arch, "shape": shape, "batch": [CELLS_LM_BATCH, CELLS_LM_SEQ],
           "reduced": f"batch {CELLS_LM_BATCH} x {CELLS_LM_SEQ} tokens, cut from "
                      f"{configs.LM_SHAPES[shape].global_batch} x {configs.LM_SHAPES[shape].seq_len}",
           "mesh": list(mesh.shape), "loss_sharded": loss_s, "loss_unsharded": float(loss_u),
           "loss_rel_err": abs(loss_s - float(loss_u)) / abs(float(loss_u)),
           "max_param_abs_diff": diff[worst], "max_param_abs_diff_at": worst,
           "first_step_ms": {"sharded": ms_s, "unsharded": ms_u}}
    ops.reset_launch_counts()
    out["step_ms"] = {"sharded": timed_calls(lambda: cell.fn(*sharded), CELLS_TIMED)[0],
                      "unsharded": timed_calls(unsharded_step, CELLS_TIMED)[0]}
    tally(launches, f"{arch} timed steps", {})
    out["profile"] = {"sharded": step_profile(lambda: cell.fn(*sharded), top=6),
                      "unsharded": step_profile(unsharded_step, top=6)}
    tally(launches, f"{arch} profiled steps", {})
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state, batch, sharded, cell
    torch.cuda.empty_cache()
    return out


def lm_train_gate(what: str, launches: dict, loss: tuple, params: tuple,
                  opt_state: tuple) -> dict:
    """The qwen2 train_4k path's gate, each pair (DTensor step's, plain
    step's): no kernel launched (an LM training step runs none), the loss
    the same bits, every parameter and AdamW leaf the same bits or named at
    the gradient gate's TOL (``same_leaves``)."""
    expect_cell_launches(what, launches, {})
    got, want = loss
    if not torch.isfinite(want) or not torch.equal(got, want):
        fail(f"cells {what}: DTensor loss {float(got)} != plain {float(want)}")
    return {"loss": float(want),
            "params": same_leaves(f"cells {what} params", *params),
            "opt_state": same_leaves(f"cells {what} AdamW state", *opt_state)}


@contextlib.contextmanager
def flash_checkpoints_off():
    """``layers.attention.checkpointed`` runs its function plainly within:
    with a config without ``remat``, ``flash_sdpa``'s loop as it was before
    its checkpoints, timed beside them."""
    from repro_torch.layers import attention as attn_lib
    real = attn_lib.checkpoint
    attn_lib.checkpoint = lambda fn, *args, **_: fn(*args)
    try:
        yield
    finally:
        attn_lib.checkpoint = real


def remat_on_against_off(seed: int, dev, gen) -> dict:
    """qwen2-0.5b at CELLS_REMAT_LAYERS layers and CELLS_REMAT_BATCH x
    4,096 tokens, where a step without remat fits: the loss and every
    gradient of ``lm.loss_fn`` with ``remat`` and without it, and without
    ``flash_sdpa``'s checkpoints too, the same bits (``torch.equal``); each
    variant's peak and its step's time (events, median of CELLS_TIMED
    calls, host issue in), so that the eager loop's host cost is on
    record.  No kernel runs."""
    arch, shape = CELLS_QWEN
    s = configs.LM_SHAPES[shape].seq_len
    on = dataclasses.replace(configs.get(arch).config, n_layers=CELLS_REMAT_LAYERS)
    params = lm.init(gen, on, device=dev)
    batch = to_device(syn.lm_batch(np.random.default_rng(seed), on, CELLS_REMAT_BATCH, s), dev)
    out = {"layers": CELLS_REMAT_LAYERS, "batch": [CELLS_REMAT_BATCH, s]}
    runs = {}
    for name, cfg, ctx in (("remat", on, contextlib.nullcontext),
                           ("no_remat", dataclasses.replace(on, remat=False),
                            contextlib.nullcontext),
                           ("no_remat_no_flash_checkpoints", dataclasses.replace(on, remat=False),
                            flash_checkpoints_off)):
        def step():
            return value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b), params, batch)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        with ctx():
            _, (first,) = timed_calls(step, 1)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            ms, _ = timed_calls(step, CELLS_TIMED)
        expect_cell_launches(f"{arch} {name}", ops.launch_counts(), {})
        runs[name] = (first[0], dict(leaves_with_paths(first[1])))
        out[name] = {"step_ms": ms, "max_memory_allocated_gb": peak}
    loss, grads = runs["remat"]
    for name in ("no_remat", "no_remat_no_flash_checkpoints"):
        if not torch.isfinite(loss) or not torch.equal(loss, runs[name][0]):
            fail(f"cells remat: loss {float(loss)} with remat, {float(runs[name][0])} {name}")
        differ = [k for k, g in grads.items() if not torch.equal(g, runs[name][1][k])]
        if differ:
            fail(f"cells remat: gradients {differ} differ with remat and {name}")
    out.update(loss=float(loss), gradients_same_bits=len(grads))
    del params, batch, runs, loss, grads
    torch.cuda.empty_cache()
    return out


def cells_train_qwen2(seed: int, dev, gen, mesh, launches: dict) -> dict:
    """qwen2-0.5b's train_4k cell at published width and depth (24 layers,
    bf16, ``remat``), CELLS_QWEN_BATCH sequences of 4,096 tokens: one data
    rank's share of the single-pod mesh's 256.  One step of the cell's
    train_step on DTensors against the same AdamW step of ``lm.loss_fn`` on
    plain tensors from the same weights, state and batch (``lm_train_gate``:
    zero launches, the same bits), each path's peak; then CELLS_TIMED - 1
    more steps of each, its time the median of its CELLS_TIMED (events, host
    issue in: a step takes tens of seconds, so the first counts); the
    profile of a plain step of the same batch at CELLS_REMAT_LAYERS layers
    (a 24-layer step's trace holds millions of events); then
    ``remat_on_against_off``."""
    arch, shape = CELLS_QWEN
    cfg = configs.get(arch).config
    s = configs.LM_SHAPES[shape].seq_len
    cell = steps_lib.build_cell(arch, shape, mesh)
    torch.cuda.empty_cache()
    params = lm.init(gen, cfg, device=dev)
    state = cell.init_state(params)
    batch = to_device(syn.lm_batch(np.random.default_rng(seed), cfg, CELLS_QWEN_BATCH, s), dev)
    sharded = cell.place(clone_tree(params), clone_tree(state), batch)
    opt = optim.adamw(3e-4)                       # the cell's optimiser

    def plain_step():
        loss, grads = value_and_grad(lambda p, b_: lm.loss_fn(p, cfg, b_), params, batch)
        opt.update(grads, state, params)
        return loss

    out = {"arch": arch, "shape": shape, "batch": [CELLS_QWEN_BATCH, s],
           "layers": cfg.n_layers, "remat": cfg.remat, "mesh": list(mesh.shape),
           "reduced": f"batch {CELLS_QWEN_BATCH} x {s} tokens, one data rank's share of "
                      f"{configs.LM_SHAPES[shape].global_batch} x {s} on the (16, 16) mesh",
           "held_before_gb": torch.cuda.memory_allocated(dev) / 1e9,   # both paths' trees
           "max_memory_allocated_gb": {}}
    steps = {"dtensor": lambda: cell.fn(*sharded)[2], "plain": plain_step}
    ms, firsts = {}, {}
    ops.reset_launch_counts()
    for name, fn in steps.items():
        torch.cuda.reset_peak_memory_stats(dev)
        first_ms, (firsts[name],) = timed_calls(fn, 1)
        ms[name] = [first_ms]
        out["max_memory_allocated_gb"][name] = torch.cuda.max_memory_allocated(dev) / 1e9
    out.update(lm_train_gate(
        f"{arch} {shape}", ops.launch_counts(),
        (local_leaves({"l": firsts["dtensor"]})["['l']"], firsts["plain"]),
        (local_leaves(sharded[0]), local_leaves(params)),
        (local_leaves(sharded[1]), local_leaves(state))))
    for name, fn in steps.items():
        ms[name] += [timed_calls(fn, 1)[0] for _ in range(CELLS_TIMED - 1)]
    tally(launches, f"{arch} {shape} steps", {})
    out["steps_ms"] = ms
    out["step_ms"] = {name: statistics.median(v) for name, v in ms.items()}
    del params, state, batch, sharded, cell
    torch.cuda.empty_cache()
    two = dataclasses.replace(cfg, n_layers=CELLS_REMAT_LAYERS)
    params = lm.init(gen, two, device=dev)
    batch = to_device(syn.lm_batch(np.random.default_rng(seed), two, CELLS_QWEN_BATCH, s), dev)
    out["profile_plain_two_layers"] = step_profile(
        lambda: value_and_grad(lambda p, b_: lm.loss_fn(p, two, b_), params, batch), top=10)
    tally(launches, f"{arch} {shape} profiled step", {})
    del params, batch
    torch.cuda.empty_cache()
    out["remat_on_against_off"] = remat_on_against_off(seed, dev, gen)
    return out


def check_k4_time_split(seed: int, gen, dev) -> dict:
    """K4 as a decode cell runs it on a cache split over time: a decode_32k
    cache (qwen2-0.5b's heads, bf16) cut into K4_SLICES slices, each slice's
    launch with its log-sum-exp at the local length clamp(pos - r·T_r, 0,
    T_r), merged in slice order (ref.merge_decode_attention), against one
    launch over the whole cache (``decode_compare``: bf16 3e-2); each
    slice's and the whole launch's lse against ref.decode_attention's
    (K4_LSE_RTOL).  pos = T and uniform in [1, T].  Launches made here are
    comparisons and count toward no path."""
    hq, hkv, d = k4_heads()
    shape = configs.LM_SHAPES["decode_32k"]
    b, t = shape.global_batch, shape.seq_len
    per = t // K4_SLICES
    q, k, v = decode_inputs(gen, dev, b, hq, hkv, d, t)
    rng = np.random.default_rng(seed)
    out = {"shape": [b, hq, hkv, d, t], "slices": K4_SLICES, "slots_a_slice": per,
           "dtype": "bfloat16", "tol": DECODE_TOL[torch.bfloat16], "lse_rtol": K4_LSE_RTOL}

    def lse_err(name, got, want):
        if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
            fail(f"{name}: -inf where the plain lse is not, or not where it is")
        fin = torch.isfinite(want)
        err = (got[fin].double() - want[fin].double()).abs()
        if not bool((err <= K4_LSE_RTOL * (1 + want[fin].double().abs())).all()):
            fail(f"{name}: lse max abs err {float(err.max()):.3e} past rtol {K4_LSE_RTOL}")
        return float(err.max()) if err.numel() else 0.0

    for kind in (t, "uniform"):
        pos = decode_positions(rng, b, t, kind, dev)
        whole, whole_lse = ops.decode_attention(q, k, v, pos, return_lse=True)
        if not torch.equal(whole, ops.decode_attention(q, k, v, pos)):
            fail("k4 time split: the launch with lse gave other bits than the one without")
        _, want_lse = ref.decode_attention(q, k, v, pos, return_lse=True)
        errs = {"whole_lse": lse_err(f"k4 lse pos={kind}", whole_lse, want_lse)}
        outs, lses, slice_err = [], [], 0.0
        for r in range(K4_SLICES):
            ks, vs = (x[:, r * per:(r + 1) * per].contiguous() for x in (k, v))
            local = (pos - r * per).clamp(0, per).to(torch.int32)
            o, lse = ops.decode_attention(q, ks, vs, local, return_lse=True)
            _, w = ref.decode_attention(q, ks, vs, local, return_lse=True)
            slice_err = max(slice_err, lse_err(f"k4 slice {r} lse pos={kind}", lse, w))
            outs.append(o)
            lses.append(lse)
            del ks, vs
        merged, merged_lse = ref.merge_decode_attention(torch.stack(outs), torch.stack(lses))
        errs["slice_lse"] = slice_err
        errs["merged_vs_one_launch"] = decode_compare(f"k4 merged slices pos={kind}", merged,
                                                      whole)
        errs["merged_lse_vs_one_launch"] = lse_err(f"k4 merged lse pos={kind}", merged_lse,
                                                   whole_lse)
        out["pos_t" if kind == t else "pos_uniform"] = errs
    del q, k, v
    torch.cuda.empty_cache()
    return out


def rows_at(caches: list[dict], slot: torch.Tensor) -> list[tuple]:
    """Each layer's (k, v) rows at each sequence's ``slot``, copied."""
    bidx = torch.arange(slot.shape[0], device=slot.device)
    return [(c["k"][bidx, slot].clone(), c["v"][bidx, slot].clone()) for c in caches]


def cells_decode(seed: int, dev, gen, mesh, launches: dict) -> dict:
    """qwen2-0.5b's decode_32k cell at its published size: B = 128 against
    caches of 32,768 slots (51.5 GB) filled from the seed, pos near T.  Two
    copies do not fit the card, so both paths run on one storage (a
    one-rank DTensor keeps its tensor whole and shares it, ``Cell.place``):
    each step runs the plain ``lm.decode_step`` first, saves the rows it
    wrote and puts the old ones back, then the cell's step on DTensors;
    logits, the rows written and pos the same bits; exactly 24 K4 launches
    a step on each path.  Then CELLS_TIMED steps of each path timed."""
    arch, shape_name = CELLS_DECODE
    cfg = configs.get(arch).config
    shape = configs.LM_SHAPES[shape_name]
    b, t = shape.global_batch, shape.seq_len
    cell = steps_lib.build_cell(arch, shape_name, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init(gen, cfg, device=dev)
    caches = lm.init_caches(cfg, b, t, device=dev)
    n_steps = CELLS_DECODE_STEPS + 2 * CELLS_TIMED
    start = t - n_steps - 1
    for c in caches:
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
        c["pos"].fill_(start)
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(seed), cfg, b, n_steps)
                            ["tokens"]).to(dev)
    p_d, _, c_d = cell.place(params, None, caches)
    if any(cd["k"].to_local().data_ptr() != c["k"].data_ptr() for cd, c in zip(c_d, caches)):
        fail("cells decode: the DTensor caches are a copy, not the plain caches' storage")
    per_step = {"decode_attention": cfg.n_layers}
    bits = []
    for i in range(CELLS_DECODE_STEPS):
        slot = caches[0]["pos"].long()
        old = rows_at(caches, slot)
        ops.reset_launch_counts()
        want, after = lm.decode_step(params, cfg, toks[:, i], caches)
        tally(launches, f"{arch} decode plain step {i}", per_step)
        new = rows_at(caches, slot)
        bidx = torch.arange(b, device=dev)
        for c, (k_, v_) in zip(caches, old):
            c["k"][bidx, slot] = k_
            c["v"][bidx, slot] = v_
        ops.reset_launch_counts()
        got, c_d = cell.fn(p_d, cell.place(None, toks[:, i])[1], c_d)
        tally(launches, f"{arch} decode DTensor step {i}", per_step)
        caches = after
        if want.shape != (b, cfg.vocab) or not bool(torch.isfinite(want.float()).all()):
            fail(f"cells decode: logits of shape {tuple(want.shape)} or non-finite")
        bits.append({
            "logits": torch.equal(got.to_local(), want),
            "rows": all(torch.equal(a, w) for x, y in zip(rows_at(caches, slot), new)
                        for a, w in zip(x, y)),
            "pos": all(torch.equal(cd["pos"].to_local(), c["pos"])
                       for cd, c in zip(c_d, caches))})
        if not all(bits[-1].values()):
            err = float((got.to_local().float() - want.float()).abs().max())
            fail(f"cells decode step {i}: DTensor against plain {bits[-1]} (logits max abs "
                 f"err {err:.3e})")
    out = {"arch": arch, "shape": shape_name, "batch": b, "cache_slots": t,
           "pos_start": start, "mesh": list(mesh.shape),
           "cache_bytes": sum(c["k"].numel() * c["k"].element_size() * 2 for c in caches),
           "steps_checked": CELLS_DECODE_STEPS, "same_bits": bits,
           "launches_a_step": per_step, "reduced": "none (published size and batch)"}
    k = CELLS_DECODE_STEPS
    ops.reset_launch_counts()
    ms_p, _ = timed_calls(lambda: lm.decode_step(params, cfg, toks[:, k], caches), CELLS_TIMED)
    tally(launches, f"{arch} decode plain timed steps",
          {"decode_attention": cfg.n_layers * CELLS_TIMED})
    token_d = cell.place(None, toks[:, k])[1]
    ops.reset_launch_counts()
    ms_d, _ = timed_calls(lambda: cell.fn(p_d, token_d, c_d), CELLS_TIMED)
    tally(launches, f"{arch} decode DTensor timed steps",
          {"decode_attention": cfg.n_layers * CELLS_TIMED})
    out["step_ms"] = {"dtensor": ms_d, "plain": ms_p}
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, caches, c_d, p_d, cell
    torch.cuda.empty_cache()
    return out


def cells_prefill(seed: int, dev, gen, mesh, launches: dict) -> dict:
    """granite-moe-1b-a400m's prefill_32k cell at published width,
    CELLS_PREFILL_LAYERS layers (cut from 24: the eager chunk loop of
    ``flash_sdpa`` runs 8,192 chunk pairs a layer at 32,768 tokens, 4.6 s a
    layer on the host), CELLS_PREFILL_BATCH sequences of 32,768 tokens (cut
    from 32): the
    cell's step on DTensors (the MoE layers through ``make_sharded_moe``
    by the ``moe_fn`` hook) against ``lm.prefill`` on plain tensors
    (``apply_moe``), the logits and every cache leaf the same bits (or the
    gradient gate's TOL, named).  Both run under torch's deterministic
    algorithms: the MoE layers add each token's experts with ``index_add_``,
    whose CUDA atomics take no fixed order, and a last bit flipped there
    moves a later layer's top-k choice near a tie, which moved the logits
    of the two last tokens by 0.6 to 10 % of their norm between runs (my
    chip runs).  No kernel runs (K4 serves decoding only)."""
    arch, shape_name = CELLS_PREFILL
    cfg = dataclasses.replace(configs.get(arch).config, n_layers=CELLS_PREFILL_LAYERS)
    s = configs.LM_SHAPES[shape_name].seq_len
    cell = steps_lib.build_cell(arch, shape_name, mesh, layers_override=CELLS_PREFILL_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init(gen, cfg, device=dev)
    toks = torch.from_numpy(syn.lm_batch(np.random.default_rng(seed), cfg, CELLS_PREFILL_BATCH,
                                         s)["tokens"]).to(dev)
    args = cell.place(params, toks)
    ops.reset_launch_counts()
    with deterministic():
        ms_d, (got,) = timed_calls(lambda: cell.fn(*args), 1)
        with torch.no_grad():
            ms_p, (want,) = timed_calls(lambda: lm.prefill(params, cfg, toks, s), 1)
    tally(launches, f"{arch} prefill", {})
    if want[0].shape != (CELLS_PREFILL_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(want[0].float()).all()):
        fail(f"cells prefill: logits of shape {tuple(want[0].shape)} or non-finite")
    out = {"arch": arch, "shape": shape_name, "batch": [CELLS_PREFILL_BATCH, s],
           "reduced": f"batch {CELLS_PREFILL_BATCH} x {s} tokens, cut from "
                      f"{configs.LM_SHAPES[shape_name].global_batch} x {s}; "
                      f"{CELLS_PREFILL_LAYERS} layers, cut from "
                      f"{configs.get(arch).config.n_layers}",
           "mesh": list(mesh.shape), "step_ms": {"dtensor": ms_d, "plain": ms_p},
           "deterministic_algorithms": True,
           "logits": same_leaves(f"cells {arch} prefill logits", {"l": got[0].to_local()},
                                 {"l": want[0]}),
           "caches": same_leaves(f"cells {arch} prefill caches", local_leaves(got[1]),
                                 local_leaves(want[1])),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del params, args, got, want, cell
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms within (``index_add_`` sorts in
    place of adding with atomics; a cuBLAS call only warns), the setting of
    before restored after."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def device_graph(gen, dev, n_nodes: int, n_edges: int, d_feat: int, n_classes: int) -> dict:
    """A random graph made on the card from ``gen`` (``syn.random_graph``'s
    numpy on the host takes tens of seconds at ogbn-products' 61.9 M edges):
    ``random_graph``'s leaves and dtypes."""
    return {"x": torch.randn((n_nodes, d_feat), generator=gen, device=dev),
            "edge_index": torch.randint(0, n_nodes, (2, n_edges), generator=gen, device=dev,
                                        dtype=torch.int32),
            "labels": torch.randint(0, n_classes, (n_nodes,), generator=gen, device=dev,
                                    dtype=torch.int32),
            "train_mask": torch.rand((n_nodes,), generator=gen, device=dev) < 0.6}


def cells_gnn(seed: int, dev, gen, mesh, launches: dict) -> dict:
    """gcn-cora's ogb_products cell (published size: the graph made on the
    card, padded to multiples of 512 nodes and edges by ``steps.pad_graph``)
    and molecule cell: one step of the cell on DTensors against the same
    step on plain tensors (loss, parameters, AdamW state: the same bits, or
    the gradient gate's TOL where a sum runs in another order); the
    ogb_products plain step on the padded graph against the unpadded
    graph's: the loss within TOL, and AdamW's state (its first moment is
    the gradient) within the gradient gate, so padding is inert.  No kernel
    runs."""
    out = {}
    rng = np.random.default_rng(seed)
    for shape_name in CELLS_GNN:
        shape = configs.GNN_SHAPES[shape_name]
        cell = steps_lib.build_cell("gcn-cora", shape_name, mesh)
        cfg = gcn_cora.config_for_shape(shape)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = gnn.init(gen, cfg, device=dev)
        if shape.kind == "full":
            graph = device_graph(gen, dev, shape.n_nodes, shape.n_edges, cfg.d_feat,
                                 cfg.n_classes)
            batch = steps_lib.pad_graph(graph, steps_lib._pad_up(shape.n_nodes),
                                        steps_lib._pad_up(shape.n_edges))
        else:
            graph = None
            batch = to_device(syn.molecule_batch(rng, shape.batch, shape.nodes_per_graph,
                                                 shape.edges_per_graph, cfg.d_feat,
                                                 cfg.n_classes), dev)
        state = cell.init_state(params)
        sharded = cell.place(clone_tree(params), clone_tree(state), batch)
        plain = (clone_tree(params), clone_tree(state), batch)
        ops.reset_launch_counts()
        ms_d, (res_d,) = timed_calls(lambda: cell.fn(*sharded), 1)
        ms_p, (res_p,) = timed_calls(lambda: cell.fn(*plain), 1)
        tally(launches, f"gcn-cora {shape_name}", {})
        loss_d, loss_p = local_leaves({"l": res_d[2]})["['l']"], res_p[2]
        if not torch.isfinite(loss_p) or not torch.equal(loss_d, loss_p):
            err = abs(float(loss_d) - float(loss_p))
            if not err <= TOL[torch.float32] * abs(float(loss_p)):
                fail(f"cells gcn {shape_name}: sharded loss {float(loss_d)} vs plain "
                     f"{float(loss_p)}")
        line = {"batch_shapes": {k: list(v.shape) for k, v in batch.items()},
                "loss": float(loss_p), "loss_same_bits": bool(torch.equal(loss_d, loss_p)),
                "params": same_leaves(f"cells gcn {shape_name} params",
                                      local_leaves(sharded[0]), local_leaves(plain[0])),
                "opt_state": same_leaves(f"cells gcn {shape_name} AdamW state",
                                         local_leaves(sharded[1]), local_leaves(plain[1])),
                "first_step_ms": {"dtensor": ms_d, "plain": ms_p}}
        if graph is not None:
            unpadded = (clone_tree(params), clone_tree(state), graph)
            _, _, loss_u = cell.fn(*unpadded)
            if abs(float(loss_u) - float(loss_p)) > TOL[torch.float32] * abs(float(loss_u)):
                fail(f"cells gcn {shape_name}: padded loss {float(loss_p)} vs unpadded "
                     f"{float(loss_u)}")
            line["padded_vs_unpadded"] = {
                "loss_unpadded": float(loss_u),
                "opt_state": same_leaves(f"cells gcn {shape_name} padded AdamW state",
                                         local_leaves(plain[1]), local_leaves(unpadded[1]))}
            line["padded_to"] = [steps_lib._pad_up(shape.n_nodes),
                                 steps_lib._pad_up(shape.n_edges)]
        line["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out[shape_name] = line
        del params, state, batch, graph, sharded, plain, cell
        torch.cuda.empty_cache()
    return out


def cells_phase(seed: int, dev, gen) -> dict:
    """The cell builder (launch/steps.py) on the card: an NCCL world of one
    rank, a (1, 1) (data, model) mesh; RMC2's train_batch step, xDeepFM's
    serve_p99 step and granite-moe's train_4k step on DTensors, each held
    against the same step on plain tensors (see each part), within
    CELLS_SECONDS; then qwen2-0.5b's train_4k step and remat on against
    off (``cells_train_qwen2``) within CELLS_QWEN_SECONDS; then K4 on a
    time-split cache (``check_k4_time_split``),
    the decode_32k, prefill_32k and GNN cells, within CELLS_SERVING_SECONDS
    more.  Frees all it holds."""
    t0 = time.monotonic()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1)
        line = {"phase": "cells", "backend": dist.get_backend(), "mesh": list(mesh.shape),
                "launches": dict.fromkeys(KERNELS, 0)}
        for key, fn in (("rmc2_train_batch", cells_train_recsys),
                        ("xdeepfm_train_batch",
                         lambda *a: cells_train_recsys(*a, cell_key=CELLS_TRAIN_CIN)),
                        ("xdeepfm_serve_p99", cells_serve_xdeepfm),
                        ("granite_moe_train_4k", cells_train_lm)):
            line[key] = fn(seed, dev, gen, mesh, line["launches"])
        line["train_serve_seconds"] = time.monotonic() - t0
        if line["train_serve_seconds"] > CELLS_SECONDS:
            fail(f"cells: took {line['train_serve_seconds']:.1f} s, past {CELLS_SECONDS} s")
        t1 = time.monotonic()
        line["qwen2_train_4k"] = cells_train_qwen2(seed, dev, gen, mesh, line["launches"])
        line["qwen2_train_4k_seconds"] = time.monotonic() - t1
        if line["qwen2_train_4k_seconds"] > CELLS_QWEN_SECONDS:
            fail(f"cells: qwen2-0.5b train_4k took {line['qwen2_train_4k_seconds']:.1f} s, "
                 f"past {CELLS_QWEN_SECONDS} s")
        t1 = time.monotonic()
        line["k4_time_split"] = check_k4_time_split(seed, gen, dev)
        for key, fn in (("qwen2_decode_32k", cells_decode),
                        ("granite_moe_prefill_32k", cells_prefill),
                        ("gcn_cora", cells_gnn)):
            line[key] = fn(seed, dev, gen, mesh, line["launches"])
        line["serving_gnn_seconds"] = time.monotonic() - t1
        if line["serving_gnn_seconds"] > CELLS_SERVING_SECONDS:
            fail(f"cells: the K4 split, LM and GNN cells took "
                 f"{line['serving_gnn_seconds']:.1f} s, past {CELLS_SERVING_SECONDS} s")
    finally:
        dist.destroy_process_group()
    line["seconds"] = time.monotonic() - t0
    return line


# ---------------------------------------------------------------- roofline

# a step cannot beat its floor (the roofline with K1 and K1-bwd at the
# distinct rows the step's ids touch): past this, a count or a constant is wrong
ROOFLINE_SHARE_GATE = 1.05
ROOFLINE_SECONDS = 300.0


def cell_kernel_work(cfg, batch: int, rows: float | None = None, *,
                     train: bool) -> dict[str, tuple[int, tuple]]:
    """{kernel: (calls a step, its summed ``work()``)} of a recommendation
    cell's step (``cfg`` float32) at ``batch``, a training step's backward
    kernels with ``train``: what the count must hold for each kernel the
    step launches.  With ``rows`` (the distinct rows of the step's ids), K1
    and K1-bwd move those rows in place of every lookup's: the work the
    data needs."""

    def total(works):
        flops: dict = {}
        for w in works:
            for u, x in w[0].items():
                flops[u] = flops.get(u, 0) + x
        return flops, sum(w[1] for w in works)

    f, h, d = cfg.n_tables, cfg.hotness, cfg.embed_dim
    out = {"embedding_bag": (1, eb_kernel.work(batch, f, h, d, 4, rows=rows))}
    if train:
        out["embedding_bag_backward"] = (1, eb_kernel.backward_work(batch, f, h, d, 4,
                                                                    rows=rows))
    if cfg.interaction == "dot":
        n = recsys._num_feature_rows(cfg)
        out["dot_interaction"] = (1, ix_kernel.work(batch, n, d, 4))
        if train:
            out["dot_interaction_backward"] = (1, ix_kernel.backward_work(batch, n, d, 4))
    if cfg.interaction == "cin":
        layers = list(zip((f,) + tuple(cfg.cin_layers[:-1]), cfg.cin_layers))
        out["cin_layer"] = (len(layers), total([cin_kernel.work(batch, f, hk, hn, d, 4)
                                                for hk, hn in layers]))
        if train:
            out["cin_layer_backward"] = (len(layers), total(
                [cin_kernel.backward_work(batch, f, hk, hn, d, 4) for hk, hn in layers]))
    return out


def roofline_gate(what: str, roofline_ms: float, steps_ms: dict[str, float],
                  counted: dict[str, dict], launched: dict[str, int],
                  expected: dict[str, tuple[int, tuple]]) -> dict[str, float]:
    """The driven step against its counted floor (``roofline_ms``): the
    floor's share of each measured step (``steps_ms``: name -> ms), failing
    past ROOFLINE_SHARE_GATE (a step faster than its floor means a wrong
    count or constant); every kernel the step launched (``launched``: name ->
    launches a step) must be in the count (``counted``: the counter's
    kernels) as often, with the work ``expected`` gives, and the count may
    hold no kernel the step did not launch."""
    shares = {name: roofline_ms / ms for name, ms in steps_ms.items()}
    for name, share in shares.items():
        if not share <= ROOFLINE_SHARE_GATE:
            fail(f"roofline {what}: the {name} step ({steps_ms[name]:.4f} ms) is faster than "
                 f"its roofline floor ({roofline_ms:.4f} ms): share {share:.3f} > "
                 f"{ROOFLINE_SHARE_GATE}, so a count or a constant is wrong")
    for k in set(launched) | set(counted):
        n = launched.get(k, 0)
        got = counted.get(k, {}).get("calls", 0)
        if n != got:
            fail(f"roofline {what}: {k} launched {n} times a step, counted {got} times")
        if n:
            calls, (flops, nbytes) = expected[k]
            if calls != n or dict(counted[k]["flops_by_unit"]) != flops or \
                    counted[k]["bytes"] != nbytes:
                fail(f"roofline {what}: {k} counted {counted[k]}, its work() gives "
                     f"{calls} calls, {flops} FLOPs, {nbytes} bytes")
    return shares


def cell_roofline(cell, specs: tuple | None, steps_ms: dict[str, float], launched: dict,
                  expected: dict, measured_peak_gb: float, needed: dict | None = None) -> dict:
    """One driven cell counted on fake tensors (``dryrun.count_cell``: the
    same cell, size and (1, 1) mesh) and held to its measured steps.  The
    count charges K1 and K1-bwd at every lookup's row (data-independent
    work), which K1 beats when ids repeat, so that roofline is no floor:
    its share is reported, not gated.  The floor takes K1's and K1-bwd's
    bytes from ``needed`` (``cell_kernel_work`` at the step's distinct
    rows) in their place; its share is gated."""
    t0 = time.monotonic()
    counted = dryrun.count_cell(cell, specs)
    rf = counted["roofline"]
    roofline_ms = rf.roofline_time * 1e3
    launched = {k: v for k, v in launched.items() if v}
    spare = sum(expected[k][1][1] - needed[k][1][1] for k in launched) if needed else 0
    floor = dataclasses.replace(rf, bytes_accessed=rf.bytes_accessed - spare)
    floor_ms = floor.roofline_time * 1e3
    shares = roofline_gate(cell.name, floor_ms, steps_ms, counted["kernels"], launched,
                           expected)
    per_chip = rf.model_flops_per_chip
    return {"roofline": rf.to_dict(), "roofline_ms": roofline_ms,
            "t_compute_ms": rf.t_compute * 1e3, "t_memory_ms": rf.t_memory * 1e3,
            "t_collective_ms": rf.t_collective * 1e3, "bottleneck": rf.bottleneck,
            "steps_ms": steps_ms,
            "share_of_roofline": {k: roofline_ms / ms for k, ms in steps_ms.items()},
            "floor_ms": floor_ms, "floor_t_memory_ms": floor.t_memory * 1e3,
            "floor_bottleneck": floor.bottleneck, "share_of_floor": shares,
            "mfu": {k: per_chip / rf.peak_flops / (ms / 1e3) for k, ms in steps_ms.items()},
            "peak_flops": rf.peak_flops,
            "dry_run_peak_gb": counted["memory"]["peak_bytes_per_device"] / 1e9,
            "dry_run_memory": counted["memory"],
            "max_memory_allocated_gb": measured_peak_gb,
            "kernels_counted": counted["kernels"], "launches_a_step": launched,
            # the operations that move the most bytes: [op, bytes, calls]
            "top_bytes": counted["top_bytes"], "count_s": time.monotonic() - t0}


def roofline_phase(cells_line: dict) -> dict:
    """The cells phase's five training and serving steps and its
    decode_32k step counted (``roofline.analysis``) in a fake world of one
    rank on a (1, 1) mesh of the card's device, at the sizes the phase ran,
    and held to the steps it measured (``roofline_gate``); fails past
    ROOFLINE_SECONDS.  Then ``fit_entry``."""
    t0 = time.monotonic()
    rmc2, xdfm_train, xdfm, moe = (cells_line[k] for k in (
        "rmc2_train_batch", "xdeepfm_train_batch", "xdeepfm_serve_p99", "granite_moe_train_4k"))
    line = {"phase": "roofline", "mesh": [1, 1], "gate": ROOFLINE_SHARE_GATE,
            "peaks": {"hbm_bytes_per_s": analysis.HBM_BW, **analysis.PEAKS,
                      "nvlink_bytes_per_s": analysis.NVLINK_BW}}
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_host_mesh(1, 1)
        for key, (arch, shape), run, train in (
                ("rmc2_train_batch", CELLS_TRAIN, rmc2, True),
                ("xdeepfm_train_batch", CELLS_TRAIN_CIN, xdfm_train, True),
                ("xdeepfm_serve_p99", CELLS_SERVE, xdfm, False)):
            cfg = configs.get(arch).config
            if train:
                steps_ms = {"dtensor": run["sharded"]["step_ms"],
                            "plain": run["unsharded"]["step_ms"]}
            else:
                steps_ms = {"dtensor": run["sharded_ms"], "plain": run["unsharded_ms"]}
            line[key] = cell_roofline(
                steps_lib.build_cell(arch, shape, mesh), None, steps_ms,
                run["launches_a_step" if train else "launches_a_call"],
                cell_kernel_work(cfg, run["batch"], train=train),
                run["max_memory_allocated_gb"],
                cell_kernel_work(cfg, run["batch"], run["distinct_rows"], train=train))
        arch, shape = CELLS_LM
        cfg = configs.get(arch).config
        cell = steps_lib.build_cell(arch, shape, mesh)
        # the batch the phase ran, and its model FLOPs
        cell = dataclasses.replace(cell, model_flops=costs.lm_model_flops(
            cfg, CELLS_LM_BATCH * CELLS_LM_SEQ, train=True))
        line["granite_moe_train_4k"] = cell_roofline(
            cell, (cell.args[0], cell.args[1], syn.lm_specs(cfg, CELLS_LM_BATCH, CELLS_LM_SEQ)),
            {"dtensor": moe["step_ms"]["sharded"], "plain": moe["step_ms"]["unsharded"]},
            {}, {}, moe["max_memory_allocated_gb"])
        qwen = cells_line["qwen2_train_4k"]
        arch, shape = CELLS_QWEN
        cfg = configs.get(arch).config
        cell = steps_lib.build_cell(arch, shape, mesh)
        cell = dataclasses.replace(cell, model_flops=costs.lm_model_flops(
            cfg, qwen["batch"][0] * qwen["batch"][1], train=True))
        line["qwen2_train_4k"] = cell_roofline(
            cell, (cell.args[0], cell.args[1], syn.lm_specs(cfg, *qwen["batch"])),
            qwen["step_ms"], {}, {}, qwen["max_memory_allocated_gb"]["plain"])
        dec = cells_line["qwen2_decode_32k"]
        arch, shape = CELLS_DECODE
        cfg = configs.get(arch).config
        # K4 at every slot of each layer's cache: a decode_32k cache is full
        k4 = da_kernel.work(dec["batch"], cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            dec["cache_slots"], 2)
        expected = {"decode_attention": (cfg.n_layers, ({u: f * cfg.n_layers
                                                         for u, f in k4[0].items()},
                                                        k4[1] * cfg.n_layers))}
        line["qwen2_decode_32k"] = cell_roofline(
            steps_lib.build_cell(arch, shape, mesh), None, dec["step_ms"],
            dec["launches_a_step"], expected, dec["max_memory_allocated_gb"])
    line["seconds"] = time.monotonic() - t0
    if line["seconds"] > ROOFLINE_SECONDS:
        fail(f"roofline: took {line['seconds']:.1f} s, past {ROOFLINE_SECONDS} s")
    line["fit"] = fit_entry()
    return line


# The dry run's peak a rank is gated below the card's memory less this
# margin: what the count does not see, the CUDA context with cuBLAS's and
# NCCL's workspaces (about 1 GB) and the caching allocator's rounding and
# fragmentation (a whole run's measured peaks read 0.9 GB above a phase's
# own), with room to spare.
FIT_MARGIN_BYTES = 4 * 2**30
FIT_SECONDS = 240.0
# the LM train_4k cells that came nearest a card's memory, and their mesh
FIT_CELLS = (("yi-34b", "train_4k", "single"), ("qwen2-0.5b", "train_4k", "multi"))
# qwen2-0.5b's train_4k at one layer on the (16, 16) mesh, counted as it was
# before activation checkpointing (no remat, no flash_sdpa checkpoints): the
# card machine's torch took the tied unembedding's gradient over the whole
# vocabulary on every rank, 25.17e12 FLOPs a rank; over each rank's own rows
# and vocabulary shard it is under this
FIT_QWEN_L1_FLOPS_MAX = 10e12


@contextlib.contextmanager
def registry_config(arch: str, smoke: bool, **changes):
    """The registry's config of ``arch`` (its smoke config with ``smoke``)
    with ``changes`` within: the cell builder reads the registry."""
    spec = configs.registry.get(arch)
    which = "smoke_config" if smoke else "config"
    configs.registry._REGISTRY[arch] = dataclasses.replace(
        spec, **{which: dataclasses.replace(getattr(spec, which), **changes)})
    try:
        yield
    finally:
        configs.registry._REGISTRY[arch] = spec


def fit_entry(*, smoke: bool = False, device: str = "cuda", total: int | None = None) -> dict:
    """The dry run (``launch/dryrun.py``, fake tensors on ``device``, published
    size unless ``smoke``) of each of FIT_CELLS on its production mesh's
    fake world (256 ranks single-pod, 512 multi-pod), each peak a rank gated
    at or below ``total`` (the card's memory) less FIT_MARGIN_BYTES; and
    qwen2-0.5b's train_4k counts on the single-pod mesh: as published, what
    it counts outside its layers (one layer's count twice less two layers')
    below what the whole vocabulary's gradient over a data rank's rows
    alone costs; at one layer without activation checkpointing (as the
    count was taken before it), at or below FIT_QWEN_L1_FLOPS_MAX.  Fails
    past FIT_SECONDS."""
    t0 = time.monotonic()
    if total is None:
        total = torch.cuda.get_device_properties(0).total_memory
    usable = total - FIT_MARGIN_BYTES
    out = {"total_memory_bytes": total, "margin_bytes": FIT_MARGIN_BYTES,
           "usable_bytes": usable, "cells": {}}
    for arch, shape, which in FIT_CELLS:
        mesh_name, multi = dryrun.MESHES[which]
        with dryrun.fake_world(math.prod(mesh_lib.MULTI_POD if multi else mesh_lib.SINGLE_POD)):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi, device=device)
            rec = dryrun.run_cell(arch, shape, mesh, mesh_name, smoke=smoke, verbose=False)
        peak = rec["memory"]["peak_bytes_per_device"]
        out["cells"][f"{arch}×{shape}×{mesh_name}"] = {
            "peak_bytes_per_device": peak, "peak_gb": peak / 1e9,
            "collective_bytes": rec["roofline"]["collective_bytes"],
            "flops": rec["roofline"]["flops"], "count_s": rec["count_s"]}
        if not peak <= usable:
            fail(f"fit: {arch}×{shape} on {mesh_name} holds {peak / 1e9:.2f} GB a rank, past "
                 f"the card's {total / 1e9:.2f} GB less {FIT_MARGIN_BYTES / 1e9:.2f}")
    arch, shape = "qwen2-0.5b", "train_4k"
    cfg = getattr(configs.get(arch), "smoke_config" if smoke else "config")
    with dryrun.fake_world(math.prod(mesh_lib.SINGLE_POD)):
        mesh = mesh_lib.make_production_mesh(device=device)

        def flops(layers: int) -> float:
            cell = steps_lib.build_cell(arch, shape, mesh, smoke=smoke, layers_override=layers)
            return dryrun.count_cell(cell, memory=False)["roofline"].flops

        out["qwen2_l1_flops"], out["qwen2_l2_flops"] = flops(1), flops(2)
        with registry_config(arch, smoke, remat=False), flash_checkpoints_off():
            out["qwen2_l1_flops_no_checkpoints"] = flops(1)
    # the count outside the layers (the lookup, the final norm, the
    # unembedding and cross-entropy, AdamW) against what the whole
    # vocabulary's gradient over a data rank's rows alone would cost
    out["qwen2_outside_layers_flops"] = 2 * out["qwen2_l1_flops"] - out["qwen2_l2_flops"]
    lm_shape = configs.LM_SHAPES[shape]
    rows = lm_shape.global_batch // mesh_lib.SINGLE_POD[0] * lm_shape.seq_len
    out["qwen2_whole_vocab_grad_flops"] = 2.0 * cfg.vocab * rows * cfg.d_model
    if not out["qwen2_outside_layers_flops"] < out["qwen2_whole_vocab_grad_flops"]:
        fail(f"fit: qwen2-0.5b train_4k counts {out['qwen2_outside_layers_flops']:.4g} FLOPs a "
             f"rank outside its layers, not below the whole vocabulary's gradient alone "
             f"({out['qwen2_whole_vocab_grad_flops']:.4g})")
    if not out["qwen2_l1_flops_no_checkpoints"] <= FIT_QWEN_L1_FLOPS_MAX:
        fail(f"fit: qwen2-0.5b train_4k at one layer without checkpoints counts "
             f"{out['qwen2_l1_flops_no_checkpoints']:.4g} FLOPs a rank, past "
             f"{FIT_QWEN_L1_FLOPS_MAX:.4g}")
    out["seconds"] = time.monotonic() - t0
    if out["seconds"] > FIT_SECONDS:
        fail(f"fit: took {out['seconds']:.1f} s, past {FIT_SECONDS} s")
    return out


def roofline_only(args, dev, gen) -> dict:
    """``--only roofline``: the cells phase (its line printed), then the
    roofline line of its steps."""
    cells_line = cells_phase(args.seed, dev, gen)
    emit({**cells_line, "card": card_line()})
    return roofline_phase(cells_line)


# the phases ``--only`` runs alone: (args, device, generator) -> its line
ONLY = {
    "train": lambda args, dev, gen: train_phase(args.seed, dev, gen),
    "zoo": lambda args, dev, gen: zoo(args.seed, dev, gen)[0],
    "lm_moe": lambda args, dev, gen: lm_moe(args.seed, dev, gen),
    "remote": lambda args, dev, gen: remote(args.seed),
    "datacenter": lambda args, dev, gen: datacenter_only(args.seed, dev),
    "gnn": lambda args, dev, gen: gnn_phase(args.seed, dev, gen),
    "dist": lambda args, dev, gen: dist_phase(args.seed, dev),
    "cells": lambda args, dev, gen: cells_phase(args.seed, dev, gen),
    "roofline": roofline_only,
    "fit": lambda args, dev, gen: {"phase": "fit", **fit_entry()},
    "k2_timings": lambda args, dev, gen: {
        "phase": "k2_timings", "timings": time_dot_interactions(gen, dev, other_store=False)},
    "bwd_timings": lambda args, dev, gen: bwd_timings(args.seed, dev, gen),
    "k3_bwd_timings": lambda args, dev, gen: {
        "phase": "k3_bwd_timings",
        "timings": [time_cin_layer_backward(gen, dev, b, f, h, hn,
                                            configs.get("xdeepfm").config.embed_dim)
                    for b in CIN_BWD_TIMED for f, h, hn in xdeepfm_cin_shapes()]},
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
                         "a copy of this script times another tree's K2, K3-bwd, K4 or "
                         "backward kernels the same way")
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
    t_bwd = time.monotonic()
    cin_bwd_checks, cin_bwd_err = check_cin_layer_backward(gen, dev)
    cin_bwd_times = [time_cin_layer_backward(gen, dev, b, f, h, hn, xdfm.embed_dim)
                     for b in CIN_BWD_TIMED for f, h, hn in xdeepfm_cin_shapes()]
    t_bwd = time.monotonic() - t_bwd
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
          "cin_layer_backward": {"checks": cin_bwd_checks, "timings_xdeepfm": cin_bwd_times,
                                 "seconds": t_bwd},
          "decode_attention": {"checks": da_checks, "timings_qwen2": da_times}})

    after({"phase": "parity", "rtol": 1e-4, "atol": 1e-4,
           "configs": check_parity(args.seed, dev)})

    served = serve(args.seed, dev, params, cfg, qps=args.qps, seconds=args.seconds,
                   batch_size=64, sla_ms=SLA_TARGETS[SERVE_ARCH].medium_ms, curve=True)
    after(served)

    scheduled, curves = sched(args.seed, dev)
    after(scheduled)
    # the two datacenter examples on the curves sched just measured
    after(datacenter(curves, seed=args.seed))

    # RMC2 live against its twin, at the knob the sched phase just tuned
    # with the card (no smaller than the static baseline's: the live node
    # holds the card alone, and a tuned knob of 1, which a bumpy host-CPU
    # curve can give the climb, turns each production query into ~130
    # one-item requests and the phase's ladder runs past the script's time
    # limit) and beside the card curve it measured; then everything the
    # phase held is freed for the LM phases
    row = next(r for r in scheduled["models"] if r["arch"] == SERVE_ARCH)
    card_curve = TableDeviceModel(list(BUCKETS), [row["card_ms"][b] / 1e3 for b in BUCKETS])
    lived = live(args.seed, dev, params, cfg,
                 max(row["with_card"]["batch"], row["static"]["batch"]), card_curve)
    lived["tuned_batch_size"] = row["with_card"]["batch"]
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
    # the cell builder's steps on DTensors: RMC2 at train_batch's 65,536
    # (about 40 GB at its peak), freed before lm_decode_32k
    celled = cells_phase(args.seed, dev, gen)
    after(celled)
    # the same three steps counted on fake tensors and held to their roofline
    after(roofline_phase(celled))

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
             served_x["launches"], trained["launches"], celled["launches"],
             generated["launches"], decoded["launches"], moe_line["launches"])
    total = {k: sum(p[k] for p in paths) for k in KERNELS}
    eb_main = next(t for t in eb_times if t["ids"] == "zipf" and t["batch"] == MAIN_BATCHES[-1])
    ix_main = next(t for t in ix_times
                   if t["arch"] == SERVE_ARCH and t["batch"] == MAIN_BATCHES[-1])
    k_max = max(h * f for f, h, _ in xdeepfm_cin_shapes())
    cin_main = next(t for t in cin_times
                    if t["shape"][0] == ZOO_BATCHES[-1] and t["shape"][1] * t["shape"][2] == k_max)
    b, f, h, hn, d = cin_main["shape"]
    cin_bwd_main = next(t for t in cin_bwd_times if t["shape"][0] == CIN_BWD_TIMED[0]
                        and t["shape"][1] * t["shape"][2] == k_max)
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
         "design": "each table's (row, bag) pairs sorted by row once (a stable LSD radix "
                   "sort written in the .cu: count, scan, rank-and-scatter a pass), then "
                   "chunks of the sorted lookups summed by lane groups in runs of equal "
                   "rows, rows that cross a chunk left as partials and combined in chunk "
                   "order by a second kernel; no atomics, each touched row stored once, the "
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
         "design": "a grid of about one wave, each block walking samples at a fixed "
                   "stride; a sample's packed gradient and slab copied in by 16-byte "
                   "cp.async, double-buffered (the next sample in flight); G unpacked "
                   "through a pair-index table built once a block; a thread a column and "
                   "four rows, G read in 16-byte runs of j, sums in ascending j",
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
        {"name": "cin_layer_backward", "route": "cuda",
         "source": "src/repro_torch/csrc/cin_backward.cu",
         "replaces": "src/repro/kernels/cin.py:20",
         "of": "K3's gradient (the TPU kernel has no backward; XLA's autodiff of the "
               "reference's plain CIN layer gives it)",
         "launches": total["cin_layer_backward"], "max_abs_err": cin_bwd_err,
         "ms": cin_bwd_main["kernel_ms"], "call_ms": cin_bwd_main["kernel_call_ms"],
         "plain_ms": cin_bwd_main["plain_ms"],
         "bound_ms": cin_bwd_main["bound_ms"], "bound_by": cin_bwd_main["bound_by"],
         "library_ms": cin_bwd_main["library_ms"],
         "share_of_bound": cin_bwd_main["share_of_bound"],
         "bound_of": cin_bwd_main["bound_of"],
         "fp32_cuda_core_bound_ms": cin_bwd_main["fp32_cuda_core_bound_ms"],
         "tf32x3_bound_ms": cin_bwd_main["tf32x3_bound_ms"],
         "tf32x3_share_of_bound": cin_bwd_main["tf32x3_share_of_bound"],
         "design": "3xTF32 wgmma on the tensor cores for both products, A formed in "
                   "registers (g from a shared tile; xk·x0 from a stage's rows), B's TF32 "
                   "hi/lo planes (w along n; g along r, N = 200 in one m64n200k8) written "
                   "by pre-passes and brought in by cp.async.bulk; each 16-value stage "
                   "from a zero accumulator into a float32 total; P contracted with x0 and "
                   "xk in shared memory, float32, in ascending m; runs fixed by the "
                   "shapes, their float32 planes added in order; no atomics",
         # the train phase's xDeepFM steps (B = 1,024) and the cells phase's
         # xdeepfm x train_batch steps (B = 65,536), each layer shape's launches
         # beside its time
         "train_phase": cin_bwd_by_layer(cin_bwd_times, CIN_BWD_TIMED[1],
                                         trained["launches"]["cin_layer_backward"]),
         "train_batch": cin_bwd_by_layer(cin_bwd_times, CIN_BWD_TIMED[2],
                                         celled["launches"]["cin_layer_backward"]),
         "shape": f"g ({b}, {hn}, {d}), x0 ({b}, {f}, {d}), xk ({b}, {h}, {d}), "
                  f"w ({h * f}, {hn}) float32"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:23",
         "launches": total["decode_attention"], "max_abs_err": da_err,
         "ms": da_main["kernel_ms"], "call_ms": da_main["kernel_call_ms"],
         "plain_ms": da_main["plain_ms"],
         "bound_ms": da_main["bound_ms"], "bound_by": da_main["bound_by"],
         "library_ms": da_main["library_ms"], "share_of_bound": da_main["share_of_bound"],
         "main_ms": da_main["main_ms"], "combine_ms": da_main["combine_ms"],
         "run_slots": da_main["run_slots"], "lse_ms": da_main["kernel_lse_ms"],
         "time_split": celled["k4_time_split"],
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
             "run_slots": t["run_slots"], "lse_ms": t["kernel_lse_ms"],
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
