"""The port stands alone: it imports without CUDA, nvcc or triton, pulls in
neither jax nor the JAX package, refuses to pick the CPU by itself, and its
GPU smoke script fails where there is no GPU."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _run(code: str, cwd: str = REPO) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_every_module_imports_without_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = ['repro_torch'] + [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import chip_smoke\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'examples')!r})\n"
        "import serve_recsys_torch, quickstart_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    n_modules = sum(1 for _ in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
    assert int(res.stdout.strip().splitlines()[-1]) == n_modules + 1 >= 31


def test_no_source_file_imports_jax_or_the_jax_package():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "examples", "serve_recsys_torch.py"),
             os.path.join(REPO, "examples", "quickstart_torch.py")]
    for root, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 31
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: default_device() returns it")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.default_device()
    from repro_torch.device import resolve
    assert resolve("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    table = torch.arange(12.0).reshape(6, 2)
    idx = torch.tensor([[0, 5], [2, 2]], dtype=torch.int32)
    out = ops.embedding_bag(table, idx)
    assert torch.equal(out, torch.tensor([[10.0, 12.0], [8.0, 10.0]]))
    feats = torch.tensor([[[1.0, 0.0], [2.0, 1.0], [0.0, 3.0]]])
    assert torch.equal(ops.dot_interaction(feats), torch.tensor([[2.0, 0.0, 3.0]]))
    assert ops.gram(feats).shape == (1, 9)
    x0 = torch.tensor([[[1.0, 2.0]]])                   # B=1, F=1, D=2
    assert torch.equal(ops.cin_layer(x0, x0, torch.tensor([[3.0]])), torch.tensor([[[3.0, 12.0]]]))
    kv = torch.tensor([[[[1.0, 2.0]], [[3.0, 4.0]]]])   # B=1, T=2, Hkv=1, D=2
    out = ops.decode_attention(torch.zeros((1, 2, 2)), kv, kv, torch.tensor([1], dtype=torch.int32))
    assert torch.equal(out, torch.tensor([[[1.0, 2.0], [1.0, 2.0]]]))
    assert ops.launch_counts() == {"embedding_bag": 0, "dot_interaction": 0, "cin_layer": 0,
                                   "decode_attention": 0}


def test_kernel_sources_are_in_the_package():
    from repro_torch.kernels import _build
    names = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert names == ["cin.cu", "decode_attention.cu", "embedding_bag.cu", "interaction.cu"]
    for p in _build.CSRC.glob("*.cu"):
        text = p.read_text()
        assert "__global__" in text and 'extern "C"' in text
    assert "-use_fast_math" not in _build.NVCC_FLAGS
    assert _build.BUILD_DIR == type(_build.BUILD_DIR)(REPO) / "build"


def test_build_without_nvcc_raises_instead_of_falling_back(monkeypatch):
    from repro_torch.kernels import _build
    import shutil
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
