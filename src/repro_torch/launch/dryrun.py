"""Dry run: build EVERY (architecture × input shape) cell on the production
meshes of a fake world and count what one step costs each rank.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu               # all cells, both meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch qwen2-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --mesh single  # 16×16 only

The reference lowers and compiles each cell for 256 or 512 host devices.
The port initialises a fake world (``torch.testing._internal.distributed.
fake_pg``) of 256 or 512 ranks itself, builds each cell of ``all_cells()``
on ``make_production_mesh``, makes its arguments as fake tensors (nothing
allocated) placed by ``cell.place``, and runs ``cell.fn`` once under
``roofline.analysis``'s counter and ``MemTracker``: per rank, the step's
FLOPs by unit, bytes, collectives and hand-written kernels, and its peak of
live bytes.  The step's loops are eager, so every iteration is counted: the
reference's ``--unroll`` has nothing to do here.  The count runs under
``flags.unrolled_scans()``, as the reference's does, so that
``flash_sdpa`` takes the accounting chunks (see ``flags``).  ``--device cuda`` (the
default) makes fake CUDA tensors and needs a CUDA build of torch; a
CPU-only torch takes ``--device cpu``.  The counts are the same on either: the
kernels' wrappers record their work on fake tensors of any device.

Serving cells' arguments are made under ``torch.inference_mode()``, as a
server's are: the serving entry points run under it, and a fake tensor made
outside it cannot be sliced inside it.

Artifacts: artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json (the
reference's artifacts/dryrun/ is left alone).  A cell the reference skips
is recorded as skipped; any other failure fails the run (exit 1).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import flags
from repro_torch.configs import get, shapes_for_family
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh
from repro_torch.launch.steps import SkippedCell, _walk, all_cells, build_cell
from repro_torch.roofline import analysis as roofline

ART_DIR = os.environ.get("REPRO_ARTIFACTS", "artifacts")
MESHES = {"single": ("single_pod_16x16", False), "multi": ("multi_pod_2x16x16", True)}
SERVING = ("serve", "retrieval")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0): a mesh of that many ranks builds, and collectives do nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_args(cell, fake_mode: FakeTensorMode, specs: tuple | None = None) -> tuple:
    """The cell's arguments (``specs``, else ``cell.args``) as fake tensors
    on the mesh's device, placed by ``cell.place``; a serving cell's under
    ``torch.inference_mode()``."""
    specs = cell.args if specs is None else specs
    device = cell.mesh.device_type
    mode = torch.inference_mode() if cell.kind in SERVING else contextlib.nullcontext()
    with fake_mode, mode:
        trees = tuple(_walk(lambda _, s: torch.empty(s.shape, dtype=s.dtype, device=device), t)
                      for t in specs)
        return cell.place(*trees)


def _storages(tree) -> dict[int, int]:
    """{storage id: bytes} of every local tensor in ``tree``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in roofline.local_tensors(tree)}


def count_cell(cell, specs: tuple | None = None, *, memory: bool = True) -> dict:
    """One step of ``cell`` on fake arguments under the counter: the
    per-rank ``Roofline``, the kernels' calls and work, and (``memory``)
    the reference's memory keys, in-place updates of the arguments counted
    as their alias.  Counted under ``flags.unrolled_scans()``."""
    fm = FakeTensorMode()
    args = fake_args(cell, fm, specs)
    mode = torch.inference_mode() if cell.kind in SERVING else contextlib.nullcontext()
    with mode, flags.unrolled_scans():
        out, c = roofline.count(cell.fn, args, memory=memory)
    res = {"roofline": c.roofline(math.prod(cell.mesh.shape), cell.model_flops),
           "kernels": {k: {"calls": v["calls"], "flops_by_unit": dict(v["flops_by_unit"]),
                           "bytes": v["bytes"]} for k, v in c.kernels.items()},
           "top_bytes": [[op, n, c.ops[op]] for op, n in c.op_bytes.most_common(8)]}
    if memory:
        arg, outs = _storages(args), _storages(out)
        a, o = sum(arg.values()), sum(outs.values())
        alias = sum(n for k, n in outs.items() if k in arg)
        peak = roofline.peak_bytes(c.mem_tracker)
        res["memory"] = {"argument_bytes": a, "output_bytes": o,
                         "temp_bytes": max(0, peak - a - o + alias), "alias_bytes": alias,
                         "peak_bytes_per_device": peak}
    return res


def count_lm_layers(arch: str, shape: str, mesh, *, smoke: bool = False, fsdp: bool = False,
                    n_layers: int | None = None, memory: bool = True,
                    first: int = 1) -> dict:
    """An LM cell of ``n_layers`` (the config's depth unless given) from
    counts at L = ``first`` and ``first`` + 1, each with the full cell's
    microbatches: ``count_cell``'s roofline, kernels and (``memory``) memory
    keys, each term(first) + (L−first)·(term(first+1) − term(first)).  An
    eager count walks every layer, which at 60 layers and 8 microbatches
    takes too long; the reference's sweep does the same from L = 1 and 2.
    The terms are exact from ``first`` = 1 for a layer-homogeneous stack.
    The peak of live bytes is not always linear from L = 1, so the dry run
    counts from ``first`` = 2 (tests/test_torch_roofline.py holds both
    against direct counts).
    A stack no deeper than ``first`` + 1 is counted directly.  Also
    ``cell``, the full cell, and ``note``."""
    spec = get(arch)
    n = n_layers or (spec.smoke_config if smoke else spec.config).n_layers
    full = build_cell(arch, shape, mesh, smoke=smoke, fsdp=fsdp, layers_override=n)
    if n <= first + 1:
        return {**count_cell(full, memory=memory), "cell": full,
                "note": f"direct (L={n})"}
    lo, hi = (count_cell(build_cell(arch, shape, mesh, smoke=smoke, fsdp=fsdp,
                                    layers_override=depth, n_micro=full.n_micro),
                         memory=memory) for depth in (first, first + 1))

    def lin(a, b):
        return a + (n - first) * (b - a)

    def kernel(k, key):
        return lo["kernels"].get(k, {}).get(key, 0)

    out = {"cell": full, "note": f"L-extrapolated from L={first},{first + 1} (full L={n})",
           "roofline": roofline.extrapolate(lo["roofline"], hi["roofline"], n,
                                            full.model_flops, first=first),
           "kernels": {k: {"calls": lin(kernel(k, "calls"), v["calls"]),
                           "flops_by_unit": {u: lin(dict(kernel(k, "flops_by_unit") or {})
                                                    .get(u, 0), f)
                                             for u, f in v["flops_by_unit"].items()},
                           "bytes": lin(kernel(k, "bytes"), v["bytes"])}
                       for k, v in hi["kernels"].items()}}
    if memory:
        out["memory"] = {k: lin(lo["memory"][k], v) for k, v in hi["memory"].items()}
    return out


def run_cell(arch: str, shape: str, mesh, mesh_name: str, *, fsdp: bool = False,
             smoke: bool = False, layers_override: int | None = None,
             verbose: bool = True) -> dict:
    """One cell's record.  An LM cell at its config's depth is counted at
    two and three layers and extrapolated (``count_lm_layers``); an LM cell
    at ``layers_override`` layers, and every other cell, directly."""
    t0 = time.perf_counter()
    if get(arch).family == "lm" and layers_override is None:
        counted = count_lm_layers(arch, shape, mesh, smoke=smoke, fsdp=fsdp, first=2)
        cell = counted["cell"]
        t_build = 0.0
    else:
        cell = build_cell(arch, shape, mesh, smoke=smoke, fsdp=fsdp,
                          layers_override=layers_override)
        t_build = time.perf_counter() - t0
        counted = count_cell(cell)
    t_count = time.perf_counter() - t0 - t_build
    rf = counted["roofline"]
    rec = {
        "arch": arch, "shape": shape, "kind": cell.kind, "mesh": mesh_name,
        "chips": math.prod(mesh.shape), "device": mesh.device_type,
        "unrolled_accounting": True,          # eager loops: every iteration counted
        "build_s": round(t_build, 2), "count_s": round(t_count, 2),
        "memory": counted["memory"],
        "roofline": rf.to_dict(),
        "kernels": counted["kernels"],
        "note": cell.note,
    }
    if "note" in counted:
        rec["accounting"] = counted["note"]
    if verbose:
        m = rec["memory"]["peak_bytes_per_device"] / 2**30
        r = rec["roofline"]
        print(f"[dryrun:{mesh_name}] {arch}×{shape}: count {t_count:.1f}s "
              f"peak/dev {m:.2f} GiB | compute {r['t_compute_s']:.2e}s "
              f"memory {r['t_memory_s']:.2e}s coll {r['t_collective_s']:.2e}s "
              f"→ {r['bottleneck']}-bound, useful={r['useful_flops_ratio']:.2f}", flush=True)
    return rec


def save_record(rec: dict, mesh_name: str) -> str:
    d = os.path.join(ART_DIR, "dryrun_torch", mesh_name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def run_cells(cells, mesh, mesh_name: str, *, fsdp: bool = False, smoke: bool = False,
              layers_override: int | None = None) -> dict:
    """Every cell of ``cells`` on ``mesh``: {"records": ..., "ok", "skipped",
    "failed": [names]}."""
    out = {"records": {}, "ok": 0, "skipped": 0, "failed": []}
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, mesh, mesh_name, fsdp=fsdp, smoke=smoke,
                           layers_override=layers_override)
            out["ok"] += 1
        except SkippedCell as e:
            print(f"[dryrun:{mesh_name}] SKIP {e}", flush=True)
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "skipped": str(e)}
            out["skipped"] += 1
        except Exception:
            print(f"[dryrun:{mesh_name}] FAIL {arch}×{shape}", flush=True)
            traceback.print_exc()
            out["failed"].append(f"{arch}×{shape}")
            continue
        out["records"][(arch, shape)] = rec
    return out


def select_cells(arch: str | None, shape: str | None) -> list[tuple[str, str]]:
    """``all_cells()``, or ``arch``'s shapes (an arch the registry holds but
    ``all_cells`` does not assign, as ``dlrm-rmc2``, included), kept to
    ``shape`` when given; raises when none is left."""
    cells = all_cells()
    if arch:
        cells = [(arch, s) for s in shapes_for_family(get(arch).family)]
    if shape:
        cells = [(a, s) for a, s in cells if s == shape]
    if not cells:
        raise SystemExit(f"no cell of arch {arch!r} and shape {shape!r}")
    return cells


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device (cuda needs a CUDA build of torch)")
    args = ap.parse_args()

    cells = select_cells(args.arch, args.shape)

    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    totals = {"ok": 0, "skipped": 0, "failed": 0}
    t0 = time.perf_counter()
    for name in names:
        mesh_name, multi = MESHES[name]
        t_mesh = time.perf_counter()
        with fake_world(math.prod(MULTI_POD if multi else SINGLE_POD)):
            mesh = make_production_mesh(multi_pod=multi, device=args.device)
            res = run_cells(cells, mesh, mesh_name, fsdp=args.fsdp)
        for rec in res["records"].values():
            save_record(rec, mesh_name)
        print(f"[dryrun:{mesh_name}] ok={res['ok']} skipped={res['skipped']} "
              f"failed={len(res['failed'])} "
              f"({time.perf_counter() - t_mesh:.1f} s)", flush=True)
        for k in ("ok", "skipped"):
            totals[k] += res[k]
        totals["failed"] += len(res["failed"])
    print(f"\n[dryrun] ok={totals['ok']} skipped={totals['skipped']} "
          f"failed={totals['failed']} "
          f"({time.perf_counter() - t0:.1f} s)")
    if totals["failed"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
