"""``tools/phase_seconds.py``: each phase's seconds from the arrival of
chip_smoke's lines, and chip_smoke's exit code passed on."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "phase_seconds.py")

FAKE = """import json, sys, time
print(json.dumps({"env": 1}), flush=True)
time.sleep(0.3)
print("a text line", flush=True)
print(json.dumps({"phase": "sched"}), flush=True)
time.sleep(0.2)
print(json.dumps({"phase": "sched", "more": 1}), flush=True)
print(json.dumps({"kernels": []}), flush=True)
print("NVIDIA H100 80GB HBM3, 700.00 W", flush=True)
print(json.dumps({"ok": True}), flush=True)
sys.exit(int(sys.argv[1]))
"""


def _run(tmp_path, code: str):
    (tmp_path / "chip_smoke.py").write_text(FAKE)
    out = tmp_path / "out.txt"
    res = subprocess.run([sys.executable, TOOL, "--dir", str(tmp_path), "--out", str(out),
                          "--", code], capture_output=True, text=True, timeout=60)
    return res, out.read_text().splitlines()


def test_phase_seconds_stamps_each_phase(tmp_path):
    res, lines = _run(tmp_path, "0")
    assert res.returncode == 0, res.stderr
    *tail, summary = res.stdout.splitlines()
    got = json.loads(summary)
    assert list(got["phase_seconds"]) == ["env", "sched", "kernels", "ok"]
    assert 0.25 <= got["phase_seconds"]["sched"] < 5
    assert got["total_s"] >= sum(got["phase_seconds"].values()) - 1e-9
    assert got["rc"] == 0
    assert tail == lines[-3:] and len(lines) == 7


def test_phase_seconds_passes_on_the_exit_code(tmp_path):
    res, _ = _run(tmp_path, "3")
    assert res.returncode == 3
    assert json.loads(res.stdout.splitlines()[-1])["rc"] == 3
