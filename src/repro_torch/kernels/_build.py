"""Builds ``csrc/*.cu`` with ``nvcc`` into one shared library and loads it
with ``ctypes``.

The sources have a plain C interface and include none of PyTorch's
headers, so a build takes seconds.  It happens at the first kernel launch
of a process, never at import.  The library goes to ``build/`` at the
repository root under a name keyed by a hash of the sources, the headers
they include (``csrc/*.cuh``) and the flags, so a second process on the
same tree loads what the first one built.  Every source is compiled by its
own ``nvcc`` process, all started together, and the objects are linked
once.

A failed build raises ``RuntimeError`` with the compiler's output; nothing
here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# No -use_fast_math: it would license the compiler to cancel the Kahan
# compensation term in embedding_bag.cu.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None      # None until this process built or loaded


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
                           "/usr/local/cuda and $PATH); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _key(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(CSRC.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def _build(srcs: list[Path], target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = BUILD_DIR / f"{tag}.so"
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                  for s, o in zip(srcs, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, target)          # atomic: a reader never sees half a file
    finally:
        for p in (*objs, tmp):
            p.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if this tree's sources have
    not been built yet."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.monotonic()
            srcs = _sources()
            target = BUILD_DIR / f"librepro_torch_kernels_{_key(srcs)}.so"
            if not target.exists():
                _build(srcs, target)
            _lib = ctypes.CDLL(str(target))
            build_seconds = time.monotonic() - t0
        return _lib

