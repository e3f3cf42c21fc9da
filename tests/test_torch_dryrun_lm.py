"""The port's dry run (``launch/dryrun.py``) over the LM ``train_4k``
cells, on the CPU: each is run by ``dryrun.run_cell`` at smoke size and one
layer on a (2, 4) ``(data, model)`` mesh of a fake world of 8 ranks, and
its record checked as ``tests/test_torch_dryrun.py`` checks a
recommendation cell's, ``model_flops`` against the reference's cell at the
smoke config's depth (``model_flops`` does not count layers of the
override).  Apart from that file so that the two share the CPU's time."""
import dataclasses

import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from torch_reference_cells import built_cells, reference_cells  # noqa: F401  (a fixture)
from repro_torch import configs
from repro_torch.configs import registry
from repro_torch.core import costs
from repro_torch.launch import dryrun
from test_torch_dryrun import check_record

LM_CELLS = [c for c in built_cells() if c[1] == "train_4k"]


@pytest.fixture(scope="module")
def mesh8():
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    with dryrun.fake_world(8):
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_dryrun_counts_an_lm_train_cell(arch, shape, mesh8, reference_cells):
    rec = dryrun.run_cell(arch, shape, mesh8, "test_2x4", smoke=True, layers_override=1,
                          verbose=False)
    want = dict(reference_cells[f"{arch}|{shape}"])
    cfg = configs.get(arch).smoke_config
    lm_shape = configs.LM_SHAPES[shape]
    tokens = lm_shape.global_batch * lm_shape.seq_len
    # the reference's cell is at the smoke config's depth; the count at one layer
    assert want["model_flops"] == costs.lm_model_flops(cfg, tokens, train=True)
    want["model_flops"] = costs.lm_model_flops(dataclasses.replace(cfg, n_layers=1), tokens,
                                               train=True)
    check_record(rec, arch, shape, want)
    assert rec["kernels"] == {}                      # no hand-written kernel in an LM step
    assert sum(rec["roofline"]["collective_bytes"].values()) > 0


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_remat_lowers_an_lm_train_cells_peak(arch, shape, mesh8, monkeypatch):
    """The smoke ``train_4k`` cell at two layers with ``remat`` and without:
    the peak per rank is lower with it, and the recomputed forward is
    counted in the backward (more FLOPs and bytes, the layers' collectives
    issued again), while ``model_flops`` stays."""
    spec = registry.get(arch)
    recs = {}
    for on in (False, True):
        monkeypatch.setitem(registry._REGISTRY, arch, dataclasses.replace(
            spec, smoke_config=dataclasses.replace(spec.smoke_config, remat=on)))
        recs[on] = dryrun.run_cell(arch, shape, mesh8, "test_2x4", smoke=True,
                                   layers_override=2, verbose=False)
    on, off = recs[True], recs[False]
    assert on["memory"]["peak_bytes_per_device"] < off["memory"]["peak_bytes_per_device"]
    assert on["roofline"]["flops"] > off["roofline"]["flops"]
    assert on["roofline"]["bytes_accessed"] > off["roofline"]["bytes_accessed"]
    assert sum(on["roofline"]["collective_bytes"].values()) > \
        sum(off["roofline"]["collective_bytes"].values())
    assert on["roofline"]["model_flops"] == off["roofline"]["model_flops"]
