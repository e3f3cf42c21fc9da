"""Fault-tolerant checkpointing, in the reference's on-disk format.

* atomic: written to a temporary directory, the manifest fsynced, then
  renamed, so a crash mid-save never corrupts the latest checkpoint;
* step-tagged (``step_%010d``) with retention (keep the last K);
* ``arrays.npz`` with one ``leaf_%05d`` array a leaf and ``manifest.json``
  with each leaf's ``keystr`` path, shape, dtype and sha256, verified on
  load.

Leaves are matched by path, so a parameter tree that the JAX package's
``repro.train.checkpoint.save`` wrote restores here, and the other way
round.  bfloat16 leaves are stored as their 16-bit patterns (numpy has no
bfloat16) under the dtype name ``bfloat16``, the bytes the reference
writes for them.

**Elastic restore.** A ``DTensor`` leaf is saved as its full logical array
(``full_tensor()``, a collective every rank joins), so a checkpoint written
on one mesh restores onto another of any size: ``restore(..., mesh=,
placements=)`` lays each leaf onto the current mesh.  With a process group
initialised, every rank gathers and rank 0 alone writes; the others wait
for it at a barrier.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.utils import leaves_with_paths, tree_map

PyTree = Any
_MANIFEST = "manifest.json"


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).reshape(-1).view(np.uint8)).hexdigest()


def save(ckpt_dir: str, step: int, tree: PyTree, *, keep: int = 3) -> str:
    """Atomically save ``tree`` as ``<ckpt_dir>/step_<step>``; prune old ones."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    leaves = [(key, *_to_numpy(leaf)) for key, leaf in leaves_with_paths(tree)]
    if dist.is_initialized():
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, step, leaves, keep)
        dist.barrier()
    else:
        _write(ckpt_dir, final, step, leaves, keep)
    return final


def _write(ckpt_dir: str, final: str, step: int, leaves, keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    arrays = {}
    for i, (key, arr, dtype) in enumerate(leaves):
        name = f"leaf_{i:05d}"
        arrays[name] = arr
        manifest["leaves"].append({"key": key, "name": name, "shape": list(arr.shape),
                                   "dtype": dtype, "sha256": _sha256(arr)})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)                                            # atomic commit

    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[len("step_"):]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, target: PyTree, *, step: int | None = None,
            mesh=None, placements: dict | None = None,
            verify: bool = True) -> tuple[PyTree, int]:
    """Restore into the structure of ``target``: every leaf becomes a new
    tensor of the target leaf's dtype, on its device.  Raises ``KeyError``
    for a leaf the checkpoint lacks, ``IOError`` for a checksum that does not
    match, ``ValueError`` for a shape that does not.

    With ``mesh`` and ``placements`` (``{path: placements}``, e.g. from
    ``distributed.sharding.to_placements``) every leaf instead becomes a
    DTensor laid onto the current mesh (the elastic-reshard path: a
    checkpoint written on N ranks restores onto M); every rank calls it."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    with np.load(os.path.join(path, "arrays.npz")) as data:
        def one(key, leaf):
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[entry["name"]]
            if verify and _sha256(arr) != entry["sha256"]:
                raise IOError(f"checksum mismatch for {key}: corrupt checkpoint")
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs {leaf.shape}")
            if entry["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if mesh is not None:
                return distribute_tensor(t.to(device=mesh.device_type, dtype=leaf.dtype),
                                         mesh, placements[key])
            return t.to(device=leaf.device, dtype=leaf.dtype)

        return tree_map(one, target, with_path=True), step
