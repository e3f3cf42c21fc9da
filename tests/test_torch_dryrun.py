"""The port's dry run (``launch/dryrun.py``) over the recommendation cells
and over the LM prefill and decode and GNN cells, on the CPU.

Every recommendation cell ``launch/steps.py`` builds is run by
``dryrun.run_cell`` at smoke size on a (2, 4) ``(data, model)`` mesh of a
fake world of 8 ranks (fake tensors: nothing is allocated): each record
has the reference's keys, a peak no lower than its arguments, counted
FLOPs and bytes, its kernels' work, and ``model_flops`` equal to the
reference's cell's (``torch_reference_cells.reference_cells``).  The LM
``train_4k`` cells are in ``tests/test_torch_dryrun_lm.py``.  Over the
other cells of ``all_cells()`` the run counts the 14 LM prefill and decode
and GNN cells, K4 once a layer in each decode cell, and skips the 5 the
reference skips, none failed; and the command line writes its record for
``dlrm-rmc2 × train_batch`` at full size on the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from conftest import SRC
from torch_reference_cells import built_cells, reference_cells  # noqa: F401  (a fixture)
from repro_torch import configs
from repro_torch.kernels import decode_attention as da_kernel
from repro_torch.launch import dryrun, steps

RECSYS_CELLS = [c for c in built_cells() if configs.get(c[0]).family == "recsys"]
MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_bytes_per_device")


@pytest.fixture(scope="module")
def mesh8():
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    with dryrun.fake_world(8):
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


def check_record(rec: dict, arch: str, shape: str, want: dict) -> None:
    """A dry run's record of a built cell against the reference's cell."""
    assert (rec["arch"], rec["shape"], rec["kind"], rec["chips"]) == (arch, shape,
                                                                     want["kind"], 8)
    assert rec["note"] == want["note"]
    r = rec["roofline"]
    assert r["model_flops"] == want["model_flops"] and r["chips"] == 8
    assert r["flops"] > 0 and r["bytes_accessed"] > 0 and r["bottleneck"] in (
        "compute", "memory", "collective")
    assert r["flops"] == sum(r["flops_by_unit"].values())
    m = rec["memory"]
    assert set(m) == set(MEMORY_KEYS)
    assert m["peak_bytes_per_device"] >= m["argument_bytes"] > 0
    assert m["peak_bytes_per_device"] == (m["argument_bytes"] + m["output_bytes"]
                                          + m["temp_bytes"] - m["alias_bytes"])
    if rec["kind"] == "train":       # the parameters and optimiser state update in place
        assert m["alias_bytes"] > 0
    for k in rec["kernels"].values():
        assert k["calls"] >= 1 and k["bytes"] > 0 and sum(k["flops_by_unit"].values()) > 0


@pytest.mark.parametrize("arch,shape", RECSYS_CELLS)
def test_dryrun_counts_a_recommendation_cell(arch, shape, mesh8, reference_cells):
    rec = dryrun.run_cell(arch, shape, mesh8, "test_2x4", smoke=True, verbose=False)
    check_record(rec, arch, shape, reference_cells[f"{arch}|{shape}"])
    cfg = configs.get(arch).smoke_config
    if cfg.n_tables and cfg.pooling in ("sum", "mean"):
        calls = rec["kernels"]["embedding_bag"]["calls"]
        assert calls >= 1
        if shape == "train_batch":
            assert rec["kernels"]["embedding_bag_backward"]["calls"] == calls
    json.dumps(rec)                                  # a record is plain JSON


def test_dryrun_skips_and_leaves_out_what_it_does_not_count(mesh8):
    """The cells that are neither recommendation nor LM ``train_4k`` cells:
    the 14 LM prefill/decode and GNN cells counted, the 5 ``long_500k``
    skipped, none failed."""
    others = [c for c in steps.all_cells()
              if configs.get(c[0]).family != "recsys" and c[1] != "train_4k"]
    assert len(built_cells()) == 35 and len(others) == 19
    res = dryrun.run_cells(others, mesh8, "test_2x4", smoke=True)
    assert (res["ok"], res["skipped"], res["failed"]) == (14, 5, [])
    assert {c for c, r in res["records"].items() if "skipped" in r} == {
        (a, "long_500k") for a in configs.ASSIGNED_ARCHS if configs.get(a).family == "lm"}
    for (arch, shape), rec in res["records"].items():
        if "skipped" in rec:
            continue
        assert rec["kind"] == {"prefill_32k": "prefill", "decode_32k": "decode"}.get(
            shape, "train")
        assert rec["roofline"]["flops"] > 0 and rec["roofline"]["bytes_accessed"] > 0
        # K4 once a layer in a decode step, each launch's work at every slot
        kernels = {k: v["calls"] for k, v in rec["kernels"].items()}
        cfg = configs.get(arch).smoke_config
        assert kernels == ({"decode_attention": cfg.n_layers} if shape == "decode_32k"
                           else {}), (arch, shape)
        if shape == "decode_32k":
            lm_shape, m = configs.LM_SHAPES[shape], 4
            if cfg.n_kv_heads % m == 0:                 # split by heads
                hq, hkv, t = cfg.n_heads // m, cfg.n_kv_heads // m, lm_shape.seq_len
            else:                                       # split over time
                hq, hkv, t = cfg.n_heads, cfg.n_kv_heads, lm_shape.seq_len // m
            work = da_kernel.work(lm_shape.global_batch // 2, hq, hkv, cfg.hd, t, 4)
            assert rec["kernels"]["decode_attention"]["bytes"] == cfg.n_layers * work[1]


def test_the_command_line_writes_its_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               REPRO_ARTIFACTS=str(tmp_path))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "single",
                          "--device", "cpu", "--arch", "dlrm-rmc2", "--shape", "train_batch"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ok=1 skipped=0 failed=0" in res.stdout
    rec = json.loads((tmp_path / "dryrun_torch" / "single_pod_16x16" /
                      "dlrm-rmc2__train_batch.json").read_text())
    assert rec["chips"] == 256 and rec["roofline"]["chips"] == 256
    assert set(rec["kernels"]) == {"embedding_bag", "dot_interaction", "embedding_bag_backward",
                                   "dot_interaction_backward"}
