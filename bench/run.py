"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profiled part of the window.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``; the
numbers compared come last, under ``checks``), and the last lines of
standard error give each number compared beside its limit.

Exits with 1, printing no result, without a CUDA device (or with fewer
than the cell asks for), and with 3 if JAX, Flax or the JAX package were
loaded by the time the window closed.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every cache a run writes stays inside the checkout, at a fixed path
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import runner, spec

    chips = spec.cell(spec.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 1
    result, _ = runner.run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), device="cuda", t_process=T_PROCESS)
    loaded = runner.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for text in runner.checks_text(result):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(runner.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
