"""Shared utilities: parameter trees, accounting, random streams, timing.

A parameter tree is nested dictionaries, lists and tuples of tensors (the
port's layout of the JAX package's pytrees).  A leaf's path is the string
``jax.tree_util.keystr`` gives for the same tree (``"['tables']"``,
``"['predict'][0]['w']"``), and dictionaries are walked in sorted key order,
as JAX flattens them, so checkpoints and optimiser routes written against
the reference read the same here.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

PyTree = Any


def leaves_with_paths(tree: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) for every leaf; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in leaves_with_paths(t, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree, prefix: str = "",
             with_path: bool = False) -> PyTree:
    """A tree of ``fn(leaf, *leaves of rest)`` (``fn(path, leaf, ...)`` with
    ``with_path``) in ``tree``'s structure; ``rest`` share it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), prefix=f"{prefix}[{k!r}]",
                            with_path=with_path) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest), prefix=f"{prefix}[{i}]",
                                   with_path=with_path) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree, *rest) if with_path else fn(tree, *rest)


def param_count(params: PyTree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def tree_cast(params: PyTree, dtype: torch.dtype) -> PyTree:
    """Cast every floating leaf to ``dtype`` (integer leaves untouched)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def rng_seq(seed: int, *, device: torch.device | str = "cpu") -> Iterator[torch.Generator]:
    """Infinite stream of fresh generators on ``device``, each seeded from
    one numpy stream of ``seed`` (the counterpart of splitting a JAX key)."""
    seeds = np.random.default_rng(seed)
    while True:
        yield torch.Generator(device=device).manual_seed(int(seeds.integers(0, 2**63 - 1)))


def check_finite(tree: PyTree) -> torch.Tensor:
    """Scalar bool tensor: every floating leaf is finite."""
    leaves = [torch.isfinite(x).all() for x in tree_leaves(tree) if x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([x.to(leaves[0].device) for x in leaves]).all()


def timeit(fn: Callable[[], Any], iters: int = 10, warmup: int = 2) -> float:
    """Median wall-clock seconds per call; waits for the card after each
    call when one is present."""
    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"
