"""Training steps of the port (``train/loop.make_train_step`` over
``recsys.loss_fn``, Adagrad on the tables and AdamW on the towers, the
global norm clipped: ``launch/train.py``'s step), back to back on labelled
batches that lie on the device.

``n_batches`` batches of ``batch`` samples are made on the device from the
seed and taken in turn.  Set-up builds the step and its optimiser state
once and drives it through its first three steps, on batches 0, 1 and 2,
through the same call the window makes; the window goes on with the same
object.  From those three steps the benchmark keeps each step's loss, each
leaf's first gradient as the optimiser got it (read from its state after
one step) and each leaf's change after three steps.  After the window the
reference trains the same weights (made again from the seed) on the same
batches for three steps, and the three are compared leaf by leaf.

The window's own steps are held too.  A window step whose loss is not
finite has failed (the port's step then leaves the weights as they were),
and any such step makes the run not correct.  Once the window has closed
the same object takes one more step, from the state the window left, on the
next batch; the reference takes that step from a copy of the same state,
and the two are compared by the step's loss and each leaf's change.

``train_samples_per_s`` is every sample of every window step over the
whole window: steps start until ``--seconds`` have gone by, and each step
ends with its loss read on the host.
"""
from __future__ import annotations

import copy

import torch

from bench.harness import compare, inputs, trace
from bench.harness import params as weights
from bench.harness.cell import Ctx, Outcome, now, peak_bytes, sync
from bench.harness.context import Run
from bench.harness.systems import first_grad_norms, tf32
from bench.reference.train import Trainer as Reference
from bench.work import counts

CHECKED_STEPS = 3


def first_steps(trainer, params, state, batches) -> tuple:
    """(params, state, losses, first-gradient norms) after the checked
    steps."""
    losses, g1 = [], None
    for k in range(CHECKED_STEPS):
        params, state, m = trainer.step(params, state, batches[k % len(batches)])
        losses.append(float(m["loss"]))
        if k == 0:
            g1 = first_grad_norms(state)
    return params, state, losses, g1


def changes(params: dict, start: dict) -> dict[str, float]:
    """Each leaf's change from ``start``, as a norm."""
    start = dict(weights.leaves(start))
    return {k: float(torch.linalg.vector_norm((v - start[k]).double()))
            for k, v in weights.leaves(params)}


def late_step(trainer, params, state, batch) -> tuple[float, dict[str, float]]:
    """(loss, each leaf's change) of one step from ``params`` and ``state``,
    which it may update in place."""
    start = copy.deepcopy(params)
    params, state, m = trainer.step(params, state, batch)
    return float(m["loss"]), changes(params, start)


def run(ctx: Ctx) -> Outcome:
    p, model, dev = ctx.params, ctx.model, ctx.device
    rows = p["batch"]
    params = weights.init(model, ctx.seed, dev)
    trainer = ctx.system.trainer(params, model, p)
    state = trainer.init(params)
    batches = [inputs.recsys_batch(model, inputs.generator(inputs.substream(ctx.seed, 5, k), dev),
                                   rows, label=True) for k in range(p["n_batches"])]
    params, state, losses, g1 = first_steps(trainer, params, state, batches)
    moved = changes(params, weights.init(model, ctx.seed, dev))
    tracer = trace.Tracer(ctx.trace, dev)
    tracer.warm()
    sync(dev)
    t0 = now()
    setup_s = t0 - ctx.t_process
    steps = traced = nonfinite = 0
    tracer.start()
    tracing = tracer.on
    while True:
        params, state, m = trainer.step(params, state,
                                        batches[(CHECKED_STEPS + steps) % len(batches)])
        steps += 1
        nonfinite += not m["finite"]
        t = now() - t0
        if tracing and t >= trace.TRACE_SECONDS:
            tracer.stop()
            tracing, traced = False, steps
        if t >= ctx.seconds:
            break
    if tracing:
        tracer.stop()
        traced = steps
    sync(dev)
    elapsed = now() - t0
    memory_peak = peak_bytes(dev)
    if nonfinite:
        ctx.log(f"{nonfinite} of {steps} window steps had a loss that is not finite")

    late_batch = batches[(CHECKED_STEPS + steps) % len(batches)]
    window_end = copy.deepcopy((params, state))
    late_loss, late_moved = late_step(trainer, params, state, late_batch)
    del params, state, trainer

    with tf32(False):
        reference = Reference(model, adagrad_lr=p["adagrad_lr"], adam_lr=p["adam_lr"],
                              clip_norm=p["clip_norm"])
        r_params = weights.init(model, ctx.seed, dev)
        r_params, _, r_losses, r_g1 = first_steps(reference, r_params, reference.init(r_params),
                                                  batches)
        r_moved = changes(r_params, weights.init(model, ctx.seed, dev))
        del r_params
        r_late_loss, r_late_moved = late_step(reference, *window_end, late_batch)
    keep = compare.moving_leaves(r_g1)
    grad_gap, grad_leaf = compare.worst_leaf_gap(g1, r_g1)
    change_gap, change_leaf = compare.worst_leaf_gap(moved, r_moved, keep=keep)
    late_gap, late_leaf = compare.worst_leaf_gap(late_moved, r_late_moved, keep=keep)
    checks = [ctx.check("loss_gap", compare.loss_gap(losses, r_losses)),
              ctx.check("grad_norm_gap", grad_gap), ctx.check("change_gap", change_gap),
              ctx.check("nonfinite_steps", nonfinite),
              ctx.check("late_loss_gap", compare.loss_gap([late_loss], [r_late_loss])),
              ctx.check("late_change_gap", late_gap)]

    work = {}
    if traced:
        work = {"k3_bound_s": traced * counts.k3_bound_s(model, rows),
                "k3bwd_bound_s": traced * counts.k3_bwd_bound_s(model, rows),
                "model_flops": traced * rows * counts.train_flops(model)}
    return Outcome(
        values={"train_samples_per_s": steps * rows / elapsed, "setup_s": setup_s},
        attempted=steps, failed=nonfinite, checks=checks,
        run=Run(trace=tracer.read(), work=work),
        memory_peak_bytes=memory_peak,
        counters={"steps": steps, "window_s": elapsed, "losses": losses,
                  "reference_losses": r_losses, "late_loss": late_loss,
                  "late_reference_loss": r_late_loss, "worst_grad_leaf": grad_leaf,
                  "worst_change_leaf": change_leaf, "worst_late_leaf": late_leaf})
