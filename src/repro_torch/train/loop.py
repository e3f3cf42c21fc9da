"""Fault-tolerant training loop.

Checkpoint/restart: the loop always resumes from the newest valid checkpoint
(``checkpoint.restore``), writes atomically every ``ckpt_every`` steps, and a
kill at any point loses at most ``ckpt_every`` steps of work.

NaN guard: a non-finite loss skips the update (the parameters and optimiser
state stay as they were) and counts it; three consecutive skips abort, the
production "poisoned batch" policy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.microbatch import accumulated_grads
from repro_torch.train.optim import Optimizer, clip_by_global_norm
from repro_torch.utils import tree_map

PyTree = Any


@dataclasses.dataclass
class TrainState:
    step: int
    params: PyTree
    opt_state: PyTree


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *,
                    num_microbatches: int = 1, clip_norm: float | None = None):
    """A ``(params, opt_state, batch) → (params, opt_state, metrics)`` step.
    The optimiser updates in place; on a non-finite loss it does not run,
    so the old parameters and state come back unchanged.  ``metrics`` holds
    the loss (a 0-d tensor) and ``finite`` (a bool, read on the host)."""

    def step(params, opt_state, batch):
        loss, grads = accumulated_grads(loss_fn, params, batch, num_microbatches)
        finite = bool(torch.isfinite(loss))
        if finite:
            if clip_norm is not None:
                grads = clip_by_global_norm(grads, clip_norm)
            params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "finite": finite}

    return step


def train(loss_fn: Callable, optimizer: Optimizer, init_params: PyTree,
          batches: Iterator[PyTree], *, num_steps: int, ckpt_dir: str | None = None,
          ckpt_every: int = 100, log_every: int = 10,
          num_microbatches: int = 1, clip_norm: float | None = None,
          hooks: list[Callable] | None = None) -> TrainState:
    """Run (or resume) training.  Returns the final TrainState; the caller's
    ``init_params`` are copied first and never changed."""
    params = tree_map(lambda p: p.detach().clone(), init_params)
    opt_state = optimizer.init(params)
    start = 0
    if ckpt_dir is not None and ckpt_lib.latest_step(ckpt_dir) is not None:
        (params, opt_state), start = ckpt_lib.restore(ckpt_dir, (params, opt_state))
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(loss_fn, optimizer, num_microbatches=num_microbatches,
                              clip_norm=clip_norm)
    nan_streak = 0
    losses = []
    t0 = time.perf_counter()
    for step in range(start, num_steps):
        batch = next(batches)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        nan_streak = 0 if metrics["finite"] else nan_streak + 1
        if nan_streak >= 3:
            raise FloatingPointError(f"3 consecutive non-finite losses at step {step}")
        if log_every and (step + 1) % log_every == 0:
            dt = (time.perf_counter() - t0) / max(len(losses), 1)
            print(f"[train] step {step + 1}/{num_steps} "
                  f"loss {np.mean(losses[-log_every:]):.4f} ({dt * 1e3:.1f} ms/step)")
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, step + 1, (params, opt_state))
        for h in hooks or []:
            h(step, params, metrics)
    # the last step may just have been saved: the reference saves it again,
    # and that rename onto the full directory fails
    if ckpt_dir is not None and ckpt_lib.latest_step(ckpt_dir) != num_steps:
        ckpt_lib.save(ckpt_dir, num_steps, (params, opt_state))
    return TrainState(num_steps, params, opt_state)
