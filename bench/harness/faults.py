"""Faults planted under a system, to show that the comparison that decides
``correct`` catches them (``bench/tests``, ``bench/control.py --fault``).

* ``half_batch``: half of the batch left out: a pass scores its first half
  and repeats those scores for the rest; a training step's loss is the mean
  over the first half.
* ``answer_altered``: one score of every pass moved by 1 % of the scores'
  root mean square where it is produced.
* ``state_unchanged``: a training step computes its loss and hands back
  the weights and the optimiser state it was given, unchanged.
* ``nan_loss``: a training step's loss is not finite, so the step, as the
  port's does then, leaves the weights and the optimiser state as they were.

``after`` spares the first calls: with ``after=3`` a training step is
broken from its fourth call on, past the checked steps, in the window.
"""
from __future__ import annotations

import copy

import torch

from bench.harness.params import leaves

FAULTS = ("half_batch", "answer_altered", "state_unchanged", "nan_loss")


def _half(fn):
    def broken(batch):
        n = next(iter(batch.values())).shape[0]
        head = fn({k: v[:max(1, n // 2)] for k, v in batch.items()})
        return head.repeat(-(-n // head.shape[0]))[:n]
    return broken


def _altered(fn):
    def broken(batch):
        out = fn(batch).clone()
        out[0] += 0.01 * out.double().square().mean().sqrt().to(out.dtype)
        return out
    return broken


def _unchanged(step, p, state, batch):
    keep_p, keep_s = copy.deepcopy(p), copy.deepcopy(state)
    _, _, m = step(p, state, batch)
    with torch.no_grad():
        for (_, a), (_, b) in zip(leaves([p, state]), leaves([keep_p, keep_s])):
            a.copy_(b)
    return p, state, m


class Faulty:
    """``base`` (a system) with ``fault`` planted under it, from call
    ``after + 1`` on."""

    def __init__(self, base, fault: str, after: int = 0):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        self.base, self.fault, self.after = base, fault, after
        self.name = f"{base.name}+{fault}" + (f"@{after}" if after else "")

    def bulk(self, params, model):
        fn = self.base.bulk(params, model)
        broken = {"half_batch": _half, "answer_altered": _altered}.get(self.fault,
                                                                     lambda f: f)(fn)
        calls = [0]

        def score(batch):
            calls[0] += 1
            return (broken if calls[0] > self.after else fn)(batch)
        return score

    def trainer(self, params, model, hp):
        inner = self.base.trainer(params, model, hp)
        fault, after = self.fault, self.after

        class Broken:
            init = staticmethod(inner.init)
            calls = 0

            @classmethod
            def step(cls, p, state, batch):
                cls.calls += 1
                if cls.calls <= after:
                    return inner.step(p, state, batch)
                if fault == "half_batch":
                    n = batch["label"].shape[0] // 2
                    return inner.step(p, state, {k: v[:n] for k, v in batch.items()})
                if fault == "state_unchanged":
                    return _unchanged(inner.step, p, state, batch)
                if fault == "nan_loss":
                    p, state, m = _unchanged(inner.step, p, state, batch)
                    return p, state, {"loss": m["loss"] * float("nan"), "finite": False}
                return inner.step(p, state, batch)

        return Broken()
