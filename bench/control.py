"""Readings of the numbers that decide ``correct``, on many seeds in one
process: the program's (the lower readings), the control's (the plain
reference in TF32 in the program's place: the upper readings) and the
program's with a fault planted under it.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds 1,2,3 \
        [--system port|control] [--fault <name> [--fault-after <calls>]] \
        [--out chiprun_out/readings.jsonl]

Runs any workload of ``bench/workloads``, listed in ``BENCHMARK.json`` or
not.  Prints, and appends to ``--out``, one JSON line a seed with its checks
and ``correct``.  The benchmark's own runs (``bench/run.py``) never run this.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--system", choices=("port", "control"), default="port")
    ap.add_argument("--fault", default=None, help="a name of bench/harness/faults.py")
    ap.add_argument("--fault-after", type=int, default=0, help="calls spared first")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import faults, runner, systems

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    base = systems.Control() if args.system == "control" else systems.Port()
    system = faults.Faulty(base, args.fault, args.fault_after) if args.fault else base
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _, out = runner.execute(args.workload, seed=seed, seconds=args.seconds, trace=False,
                                device=args.device, system=system, t_process=t)
        row = {"workload": args.workload, "system": system.name, "seed": seed,
               "correct": out.correct,
               "checks": {c.name: {"value": c.value, "limit": c.limit} for c in out.checks},
               "metrics": out.values, "counters": out.counters,
               "run_s": time.monotonic() - t}
        text = runner.dumps(row)
        print(text, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
