"""The JAX package's cells, for the port's tests of ``launch/steps.py`` and
``launch/dryrun.py``: ``built_cells()``, the (arch, shape) cells the port
builds, and ``reference_cells``, a module-scoped fixture of the reference's
cells of ``built_cells()`` at smoke size on a (2, 4) host mesh.  A test
module takes the fixture by importing it."""
import json

import pytest

from conftest import run_in_devices

REFERENCE_CELLS = """
import json
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.launch import steps
from repro.launch.mesh import make_host_mesh

mesh = make_host_mesh(2, 4)

def listed(s):
    return [list(a) if isinstance(a, tuple) else a for a in tuple(s)]

def flat(tree, leaf, is_leaf=None):
    pairs = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {jax.tree_util.keystr(k): leaf(v) for k, v in pairs}

out = {}
for arch, shape in CELLS:
    c = steps.build_cell(arch, shape, mesh, smoke=True)
    out[arch + "|" + shape] = {
        "kind": c.kind, "note": c.note, "model_flops": float(c.model_flops),
        "args": [flat(a, lambda s: [list(s.shape), np.dtype(s.dtype).name]) for a in c.args],
        "specs": [flat(sh, lambda ns: listed(ns.spec),
                       is_leaf=lambda x: isinstance(x, NamedSharding)) for sh in c.in_shardings]}
with open(OUT, "w") as f:
    json.dump(out, f)
print("OK")
"""


def built_cells() -> list[tuple[str, str]]:
    """The (arch, shape) cells the port's ``launch/steps.py`` builds: every
    assigned cell but the five the reference skips (``long_500k``), 35."""
    from repro_torch.configs import FULL_ATTENTION_SKIPS
    from repro_torch.launch import steps
    return [c for c in steps.all_cells() if c[1] not in FULL_ATTENTION_SKIPS]


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    """The JAX package's cells of ``built_cells()`` at smoke size on a (2, 4)
    host mesh, built once a module in a subprocess of 8 host devices: each
    cell's kind, note, ``model_flops``, argument shapes and specs."""
    out = tmp_path_factory.mktemp("cells") / "reference.json"
    stdout = run_in_devices(f"CELLS = {built_cells()!r}\nOUT = {str(out)!r}\n" + REFERENCE_CELLS,
                            n_devices=8)
    assert "OK" in stdout
    return json.loads(out.read_text())
