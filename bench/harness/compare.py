"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the reference works out from the same weights and
inputs."""
from __future__ import annotations

import numpy as np
import torch


def score_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between a score and the reference's, over the
    reference's root mean square (scores of random weights have no scale
    of their own).  NaN if any score is missing (NaN)."""
    got, want = got.double(), want.double()
    rms = float(want.square().mean().sqrt())
    return float((got - want).abs().max()) / max(rms, 1e-30)


def loss_gap(got: list[float], want: list[float]) -> float:
    """The widest relative gap of a step's loss."""
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def worst_leaf_gap(got: dict[str, float], want: dict[str, float],
                   keep=None) -> tuple[float, str]:
    """(gap, leaf) of the worst leaf: the gap between the program's norm and
    the reference's, over the larger of the reference's norm of that leaf
    and of the median leaf.  ``keep`` names the leaves compared (all if
    None)."""
    paths = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in want]))
    worst, leaf = -1.0, ""
    for k in paths:
        gap = abs(got.get(k, float("nan")) - want[k]) / max(want[k], med, 1e-30)
        if np.isnan(gap):
            return float("nan"), k
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(first_grad: dict[str, float], share: float = 1e-3) -> set[str]:
    """The leaves whose first gradient in the reference is at least ``share``
    of the median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(first_grad.values())))
    return {k for k, v in first_grad.items() if v >= share * med}
