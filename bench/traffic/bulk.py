"""Offline scoring: the port's ``bulk_forward`` over batches that already
lie on the device, back to back, the scores of each pass copied to the
host, as an offline job collects them.

``n_batches`` batches of ``batch`` items (ids, and dense features for a
model that has them) are made on the device from the seed and taken in
turn.  ``items_per_s`` is every item of every pass over the whole window:
passes start until ``--seconds`` have gone by, and the window ends when the
last one's scores are on the host.  After the window every pass's scores
are compared with the reference's scores of its batch.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.harness import compare, inputs, trace
from bench.harness import params as weights
from bench.harness.cell import Ctx, Outcome, now, peak_bytes, sync
from bench.harness.context import Run
from bench.harness.systems import tf32
from bench.reference import recsys as ref
from bench.work import counts


def distinct_rows(sparse: torch.Tensor, vocab: int) -> int:
    """How many distinct (table, row) pairs the ids name: what K1 has to
    read at least once a pass."""
    seen = torch.zeros(sparse.shape[1] * vocab, dtype=torch.bool, device=sparse.device)
    for f in range(sparse.shape[1]):
        seen[sparse[:, f].reshape(-1).long() + f * vocab] = True
    return int(seen.sum())


def run(ctx: Ctx) -> Outcome:
    p, model, dev = ctx.params, ctx.model, ctx.device
    params = weights.init(model, ctx.seed, dev)
    score = ctx.system.bulk(params, model)
    rows = p["batch"]
    batches = [inputs.recsys_batch(model, inputs.generator(inputs.substream(ctx.seed, 4, k), dev),
                                   rows) for k in range(p["n_batches"])]
    distinct = [distinct_rows(b["sparse"], model["vocab"]) for b in batches]
    for b in batches:                                 # every shape of the window
        score(b).cpu()
    tracer = trace.Tracer(ctx.trace, dev)
    tracer.warm()
    sync(dev)
    t0 = now()
    setup_s = t0 - ctx.t_process
    outs, which, dispatch = [], [], []
    traced = 0
    tracer.start()
    tracing = tracer.on
    while True:
        k = len(outs) % len(batches)
        ta = now()
        out = score(batches[k])
        dispatch.append(now() - ta)
        outs.append(out.cpu())
        which.append(k)
        t = now() - t0
        if tracing and t >= trace.TRACE_SECONDS:
            tracer.stop()
            tracing, traced = False, len(outs)
        if t >= ctx.seconds:
            break
    if tracing:
        tracer.stop()
        traced = len(outs)
    elapsed = now() - t0
    memory_peak = peak_bytes(dev)

    with tf32(False):
        want = [ref.forward(params, model, b).cpu() for b in batches]
    gap = max(compare.score_gap(o, want[k]) for o, k in zip(outs, which))
    checks = [ctx.check("score_gap", gap)]

    work = {}
    if traced:
        ks = which[:traced]
        work["k1_bound_s"] = sum(counts.k1_bound_s(model, rows, distinct[k]) for k in ks)
        work["model_flops"] = traced * rows * counts.forward_flops(model)
        if model["interaction"] == "cin":
            work["k3_bound_s"] = traced * counts.k3_bound_s(model, rows)
    # a traced pass's dispatch pays the profiler's cost on the host: the
    # dispatch reading takes the passes after the traced part
    spans = dispatch[traced:] if len(dispatch) > traced else dispatch
    return Outcome(
        values={"items_per_s": len(outs) * rows / elapsed, "setup_s": setup_s},
        attempted=len(outs), failed=0, checks=checks,
        run=Run(trace=tracer.read(), work=work, samples={"dispatch_s": np.asarray(spans)}),
        memory_peak_bytes=memory_peak,
        counters={"passes": len(outs), "rows_a_pass": rows, "distinct_rows": distinct,
                  "window_s": elapsed})
