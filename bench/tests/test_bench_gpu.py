"""On the card: the control (the plain reference in TF32 in the program's
place) comes out as not correct in every cell, and the program as correct,
at the published widths with fewer rows and a shorter window, so that a
test run holds them.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -q -m gpu bench/tests/test_bench_gpu.py
"""
import pytest
import torch

from bench.harness import runner, spec
from bench.harness.systems import Control, Port

SMALL = {
    "dlrm-rmc2.bulk": {"model": {"vocab": 100_000}, "params": {"batch": 32_768}},
    "xdeepfm.bulk": {"model": {"vocab": 20_000}, "params": {"batch": 32_768}},
    "xdeepfm.train": {"model": {"vocab": 20_000}, "params": {"batch": 8_192}},
}
WORKLOADS = sorted(p.stem for p in (spec.ROOT / "bench" / "workloads").glob("*.json"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_control_is_not_correct_and_program_is(name, card):
    assert sorted(SMALL) == WORKLOADS
    kw = dict(seed=2 ** 31 + 5, seconds=2.0, trace=False, device=card, overrides=SMALL[name])
    _, program = runner.execute(name, system=Port(), **kw)
    assert program.correct, program.checks
    try:
        _, control = runner.execute(name, system=Control(), **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert not control.correct, control.checks
