"""The benchmark's inputs, made from ``--seed``: ids, dense features and
labels on the device with a ``torch.Generator`` there.

The ids' distribution is a copy of the program's traffic, kept here because
a later change may alter the program but not the yardstick:
``repro_torch/data/synthetic.py::_zipf_ids`` (``floor(V**u) - 1``: a heavy
head of ids and a long tail).
"""
from __future__ import annotations

import numpy as np
import torch

_ROWS_A_CALL = 1 << 24        # ids drawn a call: bounds the float64 scratch to 128 MB


def substream(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of a run (weights, inputs, ...), drawn
    from the run's seed and the stream's path."""
    return int(np.random.SeedSequence([int(seed), *path]).generate_state(1, np.uint64)[0]
               & np.uint64(2 ** 63 - 1))


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def zipf_ids(gen: torch.Generator, shape: tuple[int, ...], vocab: int) -> torch.Tensor:
    """int32 ids in [0, vocab) of the given shape, on the generator's device:
    ``floor(vocab ** u) - 1`` for u uniform in [0, 1), drawn in calls of at
    most ``_ROWS_A_CALL`` values."""
    out = torch.empty(shape, dtype=torch.int32, device=gen.device)
    flat = out.view(-1)
    log_v = float(np.log(vocab))
    for lo in range(0, flat.numel(), _ROWS_A_CALL):
        n = min(_ROWS_A_CALL, flat.numel() - lo)
        u = torch.rand(n, generator=gen, device=gen.device, dtype=torch.float64)
        ids = torch.floor(torch.exp(u * log_v)) - 1
        flat[lo:lo + n] = ids.clamp_(0, vocab - 1).to(torch.int32)
    return out


def dense(gen: torch.Generator, rows: int, width: int) -> torch.Tensor:
    return torch.randn((rows, width), generator=gen, device=gen.device)


def labels(gen: torch.Generator, rows: int) -> torch.Tensor:
    """Click labels, 0 or 1 with even odds, float32."""
    return (torch.rand(rows, generator=gen, device=gen.device) < 0.5).float()


def recsys_batch(model: dict, gen: torch.Generator, rows: int, *, label: bool = False) -> dict:
    """One batch of ``rows`` items on the generator's device: ids (rows, F, H)
    int32, dense features (rows, n_dense) for a model that has them, and
    click labels if asked, drawn in that order."""
    out = {"sparse": zipf_ids(gen, (rows, model["n_tables"], model["hotness"]), model["vocab"])}
    if model["interaction"] == "dot":
        out["dense"] = dense(gen, rows, model["n_dense"])
    if label:
        out["label"] = labels(gen, rows)
    return out

