"""Nothing the benchmark runs imports JAX, Flax or the JAX package, and the
references import nothing of the program.  Top-level module names are
compared whole: the port, ``repro_torch``, begins with the JAX package's
name, ``repro``."""
import ast

import pytest

from bench.harness import runner, spec

BENCH_DIR = spec.ROOT / "bench"
FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & set(runner.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "repro_torch" not in names
    tree = ast.parse(path.read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert all(m == "__future__" or m.startswith("bench.reference") for m in mods)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("repro_torchlike"))
    assert "repro_torchlike" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert "repro.core" in runner.forbidden_modules()
