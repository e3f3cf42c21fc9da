"""Roofline accounting of every cell on the single-pod (16 × 16) mesh.

The reference's sweep unrolls its scans (XLA counts a loop's body once)
and compiles LM layer stacks at L ∈ {1, 2}.  The port counts eagerly on a
fake world (``launch/dryrun.py``, ``roofline.analysis``), so every loop
iteration is seen already; the LM stacks are still counted at L ∈ {1, 2}
and extrapolated linearly, since a full-depth LM's eager count is slow:

    term(L) = term(1) + (L−1)·(term(2)−term(1))

exact for layer-homogeneous transformers (the embedding, the loss and the
unembedding live in the L-independent base; eager counting makes it exact,
and tests/test_torch_roofline.py holds it against a direct count at L = 3).
``model_flops`` comes from the full config's cell.  Recommendation cells
have no layer loop and are counted directly.

    PYTHONPATH=src python -m repro_torch.launch.roofline_sweep --device cpu
    PYTHONPATH=src python -m repro_torch.launch.roofline_sweep --device cpu --arch qwen2-0.5b

Artifacts: artifacts/roofline_torch/<arch>__<shape>.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from repro_torch.configs import get
from repro_torch.launch.dryrun import (ART_DIR, count_cell, count_lm_layers, fake_world,
                                       select_cells)
from repro_torch.launch.mesh import SINGLE_POD, make_production_mesh
from repro_torch.launch.steps import SkippedCell, build_cell


def account_cell(arch: str, shape: str, mesh, *, smoke: bool = False,
                 n_layers: int | None = None) -> dict:
    """The cell's per-rank roofline: LM cells from L = 1, 2 extrapolated to
    ``n_layers`` (the config's depth unless given), with the full cell's
    microbatches (``dryrun.count_lm_layers``); the others directly."""
    t0 = time.perf_counter()
    if get(arch).family == "lm":
        counted = count_lm_layers(arch, shape, mesh, smoke=smoke, n_layers=n_layers,
                                  memory=False)
    else:
        counted = count_cell(build_cell(arch, shape, mesh, smoke=smoke), memory=False)
        counted["note"] = "direct (eager: every loop iteration counted)"
    return {"arch": arch, "shape": shape, "mesh": "single_pod_16x16",
            "chips": math.prod(mesh.shape), "accounting": "eager", "note": counted["note"],
            "count_s": round(time.perf_counter() - t0, 1),
            "roofline": counted["roofline"].to_dict()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device (cuda needs a CUDA build of torch)")
    args = ap.parse_args()

    cells = select_cells(args.arch, args.shape)

    out_dir = os.path.join(ART_DIR, "roofline_torch")
    os.makedirs(out_dir, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    with fake_world(math.prod(SINGLE_POD)):
        mesh = make_production_mesh(multi_pod=False, device=args.device)
        for arch, shape in cells:
            path = os.path.join(out_dir, f"{arch}__{shape}.json")
            try:
                rec = account_cell(arch, shape, mesh)
                r = rec["roofline"]
                print(f"[roofline] {arch}×{shape}: compute {r['t_compute_s']:.2e}s "
                      f"memory {r['t_memory_s']:.2e}s coll {r['t_collective_s']:.2e}s "
                      f"→ {r['bottleneck']}; useful={r['useful_flops_ratio']:.2f} "
                      f"frac={r['roofline_fraction']:.3f} ({rec['count_s']}s)", flush=True)
                n_ok += 1
            except SkippedCell as e:
                print(f"[roofline] SKIP {e}", flush=True)
                rec = {"arch": arch, "shape": shape, "skipped": str(e)}
                n_skip += 1
            except Exception:
                print(f"[roofline] FAIL {arch}×{shape}", flush=True)
                traceback.print_exc()
                n_fail += 1
                continue
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"[roofline] ok={n_ok} skipped={n_skip} failed={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
