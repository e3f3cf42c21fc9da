"""GPipe-style pipeline parallelism over a ``torch.distributed`` group.

Stages hold L/S contiguous layers; microbatches stream through the stage
ring.  The schedule is the classic GPipe fill-steady-drain loop: with M
microbatches and S stages, M + S − 1 steps, a bubble of (S − 1)/(M + S − 1).

The stage function is the caller's, ``(params_stage, x) → x``, so any
layer body pipelines.  Rank s of the group is stage s.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import ring_shift
from repro_torch.utils import tree_map


def gpipe_forward(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                  *, group=None) -> torch.Tensor:
    """Run microbatches through the stage ring, on every rank of ``group``.

    stage_params: this rank's stage.  x_micro (M, mb, ...): all microbatches
    (every rank holds them); stage 0 feeds them in order, stage S − 1 emits
    outputs in arrival order.  Returns (M, mb, ...) outputs, valid on the
    last stage and zeros elsewhere (callers reduce or send them home)."""
    s, sid = dist.get_world_size(group), dist.get_rank(group)
    m = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])                # stage input register
    outs = torch.zeros_like(x_micro)
    for t in range(m + s - 1):
        if sid == 0:
            cur = x_micro[t] if t < m else torch.zeros_like(buf)
        else:
            cur = buf
        y = stage_fn(stage_params, cur)
        out_idx = t - (s - 1)                         # last stage records microbatch t-(s-1)
        if sid == s - 1 and out_idx >= 0:
            outs[out_idx] = y
        if s > 1:                                     # forward activations to the next stage
            buf, works = ring_shift(y.contiguous(), group)
            for w in works:
                w.wait()
        else:
            buf = y
    return outs


def make_pipelined_fn(stage_fn: Callable, *, num_microbatches: int, group=None):
    """Wrap a stage function into a full-model forward over ``group``'s
    ranks.  stacked_stage_params carry a leading (S, ...) stage axis; rank s
    runs slice s.  Every rank gets the last stage's outputs."""
    def fwd(stacked_stage_params, x: torch.Tensor) -> torch.Tensor:
        sid = dist.get_rank(group)
        my_stage = tree_map(lambda a: a[sid], stacked_stage_params)
        mbs = x.reshape((num_microbatches, -1) + tuple(x.shape[1:]))
        outs = gpipe_forward(stage_fn, my_stage, mbs, group=group)
        # only the last stage holds real outputs: the sum over the ranks
        # hands them to all
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs.reshape((-1,) + tuple(outs.shape[2:]))

    return fwd
