#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port: the quickest proof that the port
builds its kernels and serves on a card.

    python3 chip_smoke.py            # needs one CUDA GPU and nvcc; ~1-2 minutes

What it does, one JSON line per phase:

  env            card name and power limit (nvidia-smi), torch/CUDA versions
  build          compiles src/repro_torch/csrc/*.cu with nvcc, seconds taken
  kernel_checks  each hand-written kernel against its plain PyTorch version
                 on the card: the shape x dtype sweep of the CPU tests plus
                 the shapes the paper models give it, and timings at the
                 DLRM-RMC2 shapes (kernel, bound, plain version, library call)
  parity         forward of every paper model's smoke config on the card
                 (kernels) against the same weights and batch on the CPU
                 (plain versions)
  serve          DLRM-RMC2 at its published size behind ServingRuntime and
                 OnlineController, fed a Poisson stream of production-sized
                 queries; launch counts are zeroed just before and read just
                 after; one request's logits are held against the plain
                 versions on the card
  kernels        per kernel: launches on the serve path, max error, and at
                 RMC2 batch 1024 its time on the card (CUDA-graph replay, no
                 host time between launches), the host's time for one eager
                 call, the bound, and the plain and library versions' times

then the card line and, last, {"ok": true, "device": {...}}.  Any failed
phase raises: the script exits non-zero and prints no result.  It also
exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.paper_models import PAPER_MODELS, SLA_TARGETS  # noqa: E402
from repro_torch.core.query_gen import PRODUCTION, query_stream  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.layers.mlp import mlp  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.serve.batching import pad_batch  # noqa: E402
from repro_torch.serve.runtime import (OnlineController, ServingRuntime,  # noqa: E402
                                       to_device)

# published peaks of one H100 SXM (NVIDIA data sheet): the bound's yardstick
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}       # rtol = atol, as the CPU sweep
BUCKETS = (1, 4, 16, 64, 256, 1024)
MAIN_BATCHES = (1, 64, 1024)
SERVE_ARCH = "dlrm-rmc2"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


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
    return tree.to(device)


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


def time_embedding_bag(rng, dev, tables: torch.Tensor, batch: int, ids: str) -> dict:
    """Times at the DLRM-RMC2 shape.  ``ids`` is 'zipf' (the serving data's
    skew: hot rows repeat and sit in L2) or 'uniform' (every lookup a
    different row, the gather at its coldest).  Eight index sets rotate so
    consecutive launches do not repeat a request."""
    f, v, d = tables.shape
    h = PAPER_MODELS[SERVE_ARCH].hotness
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


def time_dot_interaction(gen, dev, batch: int) -> dict:
    f = recsys._num_feature_rows(PAPER_MODELS[SERVE_ARCH])
    d = PAPER_MODELS[SERVE_ARCH].embed_dim
    sets = [torch.randn((batch, f, d), generator=gen, device=dev) / d ** 0.5 for _ in range(8)]
    pairs = torch.from_numpy(ref.tril_pairs(f)).to(dev)
    n_out = f * (f - 1) // 2
    bytes_moved = batch * (f * d + n_out) * 4
    flops = 2 * batch * n_out * d

    def library(i):
        x = sets[i % 8]
        return torch.bmm(x, x.transpose(1, 2)).reshape(batch, f * f)[:, pairs]

    return {
        "batch": batch,
        "kernel_ms": device_ms(lambda i: ops.dot_interaction(sets[i % 8])),
        "kernel_call_ms": call_ms(lambda i: ops.dot_interaction(sets[i % 8])),
        "plain_ms": device_ms(lambda i: ref.dot_interaction_packed(sets[i % 8])),
        "library_ms": device_ms(library),
        "bound_ms": max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3,
        "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
        else "operations",
    }


# ----------------------------------------------------------------------- parity


def check_parity(seed: int, dev) -> list:
    """Smoke configs: kernels on the card against plain versions on the CPU.
    float32, rtol = atol = 1e-4: the two sum in different orders (Kahan in
    index order against torch.sum; cuBLAS against the CPU's matmul)."""
    rows = []
    for name in PAPER_MODELS:
        cfg = configs.get(name).smoke_config
        cpu_params = recsys.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
        batch = syn.recsys_batch(np.random.default_rng(seed), cfg, 13, with_label=False)
        want = recsys.forward(cpu_params, cfg, to_device(batch, torch.device("cpu")))
        ops.reset_launch_counts()
        got = recsys.forward(tree_to(cpu_params, dev), cfg, to_device(batch, dev))
        err = compare(f"parity {cfg.name}", got.cpu(), want, 1e-4, 1e-4)
        if ops.launch_counts()["embedding_bag"] != 1:
            fail(f"parity {cfg.name}: forward on the card did not launch embedding_bag once")
        rows.append({"config": cfg.name, "shape": list(got.shape), "max_abs_err": err})
    return rows


# ------------------------------------------------------------------------ serve


def plain_forward_dot(params, cfg, batch: dict) -> torch.Tensor:
    """DLRM forward through the plain versions only (no kernel launch)."""
    dense = mlp(params["dense_mlp"], batch["dense"], act="relu", final_act="relu")
    emb = ref.embedding_bag_stacked(params["tables"], batch["sparse"], mode=cfg.pooling)
    feats = torch.cat([dense[:, None, :], emb], dim=1)
    z = torch.cat([ref.dot_interaction_packed(feats), dense], dim=-1)
    return mlp(params["predict"][0], z, act="relu")[..., 0]


def serve(seed: int, dev, params, cfg, qps: float, seconds: float) -> dict:
    rng = np.random.default_rng(seed)
    # one pool of Zipf-id items made up front; a query is a window of it, so
    # the feeder thread paces arrivals instead of generating data
    pool_n = 8192
    pool = syn.recsys_batch(rng, cfg, pool_n, with_label=False)

    def query_batch(size: int) -> dict:
        lo = int(rng.integers(0, pool_n - size + 1))
        return {k: v[lo:lo + size] for k, v in pool.items()}

    def apply_fn(batch: dict) -> torch.Tensor:
        return recsys.forward(params, cfg, batch)

    # one request's logits against the plain versions, and a warm-up of cuBLAS
    probe = to_device(pad_batch(query_batch(200), 256), dev)
    logit_err = compare("serve logits vs plain", apply_fn(probe),
                        plain_forward_dot(params, cfg, probe), 1e-4, 1e-4)

    rt = ServingRuntime(apply_fn, n_workers=2, batch_size=64, device=dev)
    ctl = OnlineController(rt, sla_ms=SLA_TARGETS[SERVE_ARCH].medium_ms, window=50)
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
            ctl.step()
        rt.drain(timeout=120)
        wall = time.monotonic() - t0
        done = rt.completed()
    finally:
        rt.shutdown()
    launches = ops.launch_counts()

    errors = [r.error for r in done if r.error is not None]
    if errors:
        fail(f"serve: {len(errors)} queries errored, first: {errors[0]}")
    if len(done) != n_submitted or n_submitted == 0:
        fail(f"serve: {len(done)} of {n_submitted} queries completed")
    for kernel, n in launches.items():
        if n == 0:
            fail(f"serve: kernel {kernel} was never launched on the serving path")
    lats = [r.latency_ms for r in done]
    if not all(np.isfinite(lats)) or min(lats) <= 0:
        fail("serve: non-positive or non-finite latencies")

    # median request latency per bucket through the worker's own steps, each
    # on the host's clock: pad on the host, move to the card, forward and
    # wait for the device (a one-item query pads nothing: 3 items into 4 do)
    curve, steps = {}, {}
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
            out = apply_fn(on_card)
            torch.cuda.synchronize()
            t3 = time.monotonic()
            ts.append(((t3 - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
        if out.shape != (bucket,) or not bool(torch.isfinite(out).all()):
            fail(f"serve: bucket {bucket} gave shape {tuple(out.shape)} or non-finite logits")
        total, pad, copy, fwd = (statistics.median(col) for col in zip(*ts[2:]))
        curve[str(bucket)] = total
        steps[str(bucket)] = {"pad_ms": pad, "copy_ms": copy, "forward_ms": fwd}

    return {"phase": "serve", "arch": cfg.name, "qps_offered": qps, "seconds": wall,
            "queries": len(done), "items": int(sum(r.size for r in done)), "errors": 0,
            "p50_ms": float(np.percentile(lats, 50)), "p95_ms": float(np.percentile(lats, 95)),
            "sla_ms": ctl.sla_ms, "final_batch_size": rt.batch_size,
            "controller_history": ctl.history, "launches": launches,
            "logits_max_abs_err_vs_plain": logit_err, "bucket_median_ms": curve,
            "bucket_steps_ms": steps}


# ------------------------------------------------------------------------- main


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qps", type=float, default=100.0, help="offered load of the serve phase")
    ap.add_argument("--seconds", type=float, default=4.0, help="length of the serve phase")
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
    cfg = PAPER_MODELS[SERVE_ARCH]
    params = recsys.init(gen, cfg, device=dev)           # 40 x 10^6 x 32 float32 on the card
    tables = params["tables"]

    eb_checks, eb_err = check_embedding_bag(rng, gen, dev, tables)
    ix_checks, ix_err = check_dot_interaction(gen, dev)
    eb_times = [time_embedding_bag(rng, dev, tables, b, ids)
                for ids in ("zipf", "uniform") for b in MAIN_BATCHES]
    ix_times = [time_dot_interaction(gen, dev, b) for b in MAIN_BATCHES]
    emit({"phase": "kernel_checks", "card": card,
          "embedding_bag": {"checks": eb_checks, "timings_rmc2": eb_times},
          "dot_interaction": {"checks": ix_checks, "timings_rmc2": ix_times}})

    emit({"phase": "parity", "rtol": 1e-4, "atol": 1e-4,
          "configs": check_parity(args.seed, dev)})

    served = serve(args.seed, dev, params, cfg, args.qps, args.seconds)
    served["card"] = card
    emit(served)

    eb_main = next(t for t in eb_times if t["ids"] == "zipf" and t["batch"] == MAIN_BATCHES[-1])
    ix_main = next(t for t in ix_times if t["batch"] == MAIN_BATCHES[-1])
    emit({"kernels": [
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag.py:23",
         "launches": served["launches"]["embedding_bag"], "max_abs_err": eb_err,
         "ms": eb_main["kernel_ms"], "call_ms": eb_main["kernel_call_ms"], "plain_ms": eb_main["plain_ms"],
         "bound_ms": eb_main["bound_ms"], "bound_by": eb_main["bound_by"],
         "library_ms": eb_main["library_ms"],
         "shape": "tables (40, 1000000, 32) float32, idx (1024, 40, 80) Zipf ids"},
        {"name": "dot_interaction", "route": "cuda",
         "source": "src/repro_torch/csrc/interaction.cu",
         "replaces": "src/repro/kernels/interaction.py:24",
         "launches": served["launches"]["dot_interaction"], "max_abs_err": ix_err,
         "ms": ix_main["kernel_ms"], "call_ms": ix_main["kernel_call_ms"], "plain_ms": ix_main["plain_ms"],
         "bound_ms": ix_main["bound_ms"], "bound_by": ix_main["bound_by"],
         "library_ms": ix_main["library_ms"],
         "shape": "feats (1024, 41, 32) float32"},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
