"""Batch bucketing: requests pad up to a power-of-two bucket, so the model
only ever sees a handful of batch shapes (the buckets a latency curve is
measured on)."""
from __future__ import annotations

import numpy as np
import torch


def bucket_for(size: int, max_bucket: int = 1024) -> int:
    b = 1
    while b < size and b < max_bucket:
        b *= 2
    return b


def bucket_ladder(max_bucket: int) -> list[int]:
    """Every bucket a runtime capped at ``max_bucket`` pads to (powers of
    two, ascending) — the single definition of the rung set calibrations
    measure."""
    out, b = [], 1
    while b <= max_bucket:
        out.append(b)
        b *= 2
    return out


def pad_batch(batch: dict, to: int) -> dict:
    """Pad every leaf's leading dim to ``to`` by repeating row 0 — cheap,
    and padded rows always carry valid embedding ids; results past the true
    size are sliced off.  numpy leaves are padded with numpy on the host
    and stay numpy; tensor leaves stay tensors on their device.

    Raises ``ValueError`` on a leaf larger than ``to``: ``bucket_for``
    clamps at ``max_bucket``, so an oversize request means the caller
    forgot to split (see ``ServingRuntime.submit``) — padding "negatively"
    would silently drop rows."""
    def pad(x):
        n = x.shape[0]
        if n > to:
            raise ValueError(
                f"batch of {n} rows exceeds bucket {to}; split oversize "
                f"requests into ≤-bucket chunks before padding")
        if n == to:
            return x
        if isinstance(x, np.ndarray):
            reps = np.broadcast_to(x[:1], (to - n,) + x.shape[1:])
            return np.concatenate([x, reps], axis=0)
        return torch.cat([x, x[:1].expand(to - n, *x.shape[1:])], dim=0)
    return {k: pad(v) for k, v in batch.items()}


def slice_result(out, n: int):
    """First ``n`` rows of every leaf of a dict/list/tuple tree (or of a
    bare array)."""
    if isinstance(out, dict):
        return {k: slice_result(v, n) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(slice_result(v, n) for v in out)
    return out[:n]
