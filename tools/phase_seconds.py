"""Run a checkout's ``chip_smoke.py`` and report how long each phase took.

    python3 tools/phase_seconds.py [--dir DIR] [--out FILE] [-- chip_smoke args]

Starts ``python3 -u chip_smoke.py`` in DIR (default: the checkout this
script lies in) and writes its standard output to FILE as it comes (its
standard error is passed through).  Each JSON line is stamped when it
arrives; a phase's seconds are the time from the line before it to its own
line (the first line's from the start), summed over the phase's lines.
A phase is a line's ``phase``, or ``kernels`` for the kernels line.  Ends
with chip_smoke's last three lines and one JSON line
``{"phase_seconds": {...}, "total_s": t, "rc": rc}``, and exits with
chip_smoke's code.  Works on any tree whose ``chip_smoke.py`` prints one
JSON object a line, so two commits can be timed in one call to the card.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def phase_of(line: str) -> str | None:
    """The phase a line of chip_smoke's output closes, or None for text."""
    try:
        obj = json.loads(line)
    except ValueError:
        return None
    if not isinstance(obj, dict):
        return None
    if "phase" in obj:
        return str(obj["phase"])
    return "kernels" if "kernels" in obj else next(iter(obj), None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=os.devnull)
    ap.add_argument("args", nargs="*")
    a = ap.parse_args()
    seconds: dict[str, float] = {}
    tail: list[str] = []
    t0 = last = time.monotonic()
    with open(a.out, "w") as out:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py", *a.args], cwd=a.dir,
                                stdout=subprocess.PIPE, text=True)
        for line in proc.stdout:
            now = time.monotonic()
            out.write(line)
            out.flush()
            tail = (tail + [line.rstrip("\n")])[-3:]
            phase = phase_of(line)
            if phase is not None:
                seconds[phase] = seconds.get(phase, 0.0) + now - last
                last = now
        rc = proc.wait()
    print("\n".join(tail))
    print(json.dumps({"phase_seconds": seconds, "total_s": time.monotonic() - t0, "rc": rc}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
