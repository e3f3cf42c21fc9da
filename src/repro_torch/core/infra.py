"""DeepRecInfra orchestration (paper Fig. 8): models × SLA targets × query
patterns → the experiment harness the scheduler plugs into.

Two measured latency curves a model, each cached to its own artifact file:

* the CPU executors' — ``measure_cpu_curve`` times ``recsys.forward`` on
  the host's CPU at mid-size tables, as the JAX package's ``infra`` times
  its models (``torch_cpu_latency_curves.json``);
* the accelerator's — ``measure_card_curve`` times one request of the
  *published* config on the card through the serving worker's own steps:
  pad on the host, copy to the card, ``forward``, wait for the device
  (``h100_latency_curves.json``).

``accelerator(arch, "h100")`` is the measured card as a
``TableDeviceModel``; nothing here measures the accelerator on the CPU.
The JAX package's ``cpu_latency_curves.json`` is never read or written.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.configs.paper_models import SLA_TARGETS
from repro_torch.core import latency_model as lat
from repro_torch.data import synthetic as syn
from repro_torch.device import default_device
from repro_torch.models import recsys
from repro_torch.serve.batching import pad_batch
from repro_torch.serve.runtime import to_device

_REPO = Path(__file__).resolve().parents[3]
CPU_CURVES = "torch_cpu_latency_curves.json"
CARD_CURVES = "h100_latency_curves.json"

# measured models use mid-size configs (full vocab tables would only slow the
# gather without changing the latency/batch *shape* on this host)
_MEASURE_VOCAB = 20_000
_BATCH_LADDER = (1, 4, 16, 64, 256, 1024)
# the card's curve: median of CARD_REPS requests a bucket after CARD_WARMUP
# rounds (the first requests of a bucket pay allocator and cuBLAS warm-up)
CARD_REPS, CARD_WARMUP = 20, 2
# repetitions a bucket of a CPU curve, after one warm-up (the reference's
# infra takes 3; more keep the small buckets' medians from bumping)
CPU_ITERS = 12


def artifact_dir() -> Path:
    """``$REPRO_ARTIFACTS`` (read as the JAX package reads it), else the
    repository's ``artifacts/``."""
    return Path(os.environ.get("REPRO_ARTIFACTS", _REPO / "artifacts"))


def _measure_cfg(arch: str):
    cfg = get(arch).config
    return dataclasses.replace(
        cfg, vocab=min(cfg.vocab, _MEASURE_VOCAB),
        item_vocab=min(cfg.item_vocab, _MEASURE_VOCAB) if cfg.item_vocab else 0)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cpu_model() -> str:
    """The host CPU's model name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return platform.processor() or platform.machine()


# ------------------------------------------------------------ CPU executors


def measure_cpu_curve(arch: str, batches=_BATCH_LADDER, iters: int = CPU_ITERS, *,
                      cfg=None, threads: int | None = None) -> lat.TableDeviceModel:
    """Mean time of ``recsys.forward`` on the host's CPU a batch, after one
    warm-up, at ``_measure_cfg(arch)`` (or ``cfg``), on every intra-op
    thread torch has (the reference's method) or on ``threads`` of them."""
    cfg = cfg or _measure_cfg(arch)
    cpu = torch.device("cpu")
    had = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        params = recsys.init(torch.Generator().manual_seed(0), cfg, device=cpu)
        secs = []
        for b in batches:
            batch = to_device(syn.recsys_batch(np.random.default_rng(0), cfg, b,
                                               with_label=False), cpu)
            recsys.forward(params, cfg, batch)                 # warm
            t0 = time.perf_counter()
            for _ in range(iters):
                recsys.forward(params, cfg, batch)
            secs.append((time.perf_counter() - t0) / iters)
    finally:
        torch.set_num_threads(had)
    return lat.TableDeviceModel(np.asarray(batches, float), np.asarray(secs, float))


def cpu_meta(arch: str) -> dict:
    """What ``torch_cpu_latency_curves.json`` keeps beside a CPU curve."""
    cfg = _measure_cfg(arch)
    return {"config": cfg.name, "vocab": cfg.vocab, "item_vocab": cfg.item_vocab,
            "iters": CPU_ITERS, "cpu": cpu_model(), "threads": torch.get_num_threads(),
            "torch": torch.__version__}


def cpu_curves(archs) -> dict[str, lat.TableDeviceModel]:
    """Measured CPU curves, cached to the artifact file."""
    path = artifact_dir() / CPU_CURVES
    curves = lat.load_curves(str(path)) if path.exists() else {}
    for a in archs:
        if a not in curves:
            print(f"[infra] measuring CPU latency curve for {a} ...")
            curves[a] = measure_cpu_curve(a)
            store_curves(path, {a: curves[a]}, {a: cpu_meta(a)})
    return {a: curves[a] for a in archs}


# --------------------------------------------------------------- the card


@dataclasses.dataclass
class CardCurve:
    curve: lat.TableDeviceModel
    steps_ms: dict[int, dict[str, float]]   # bucket → median pad/copy/forward ms
    requests: int                           # forwards run, warm-ups included


def measure_card_curve(arch: str, *, cfg=None, params=None, seed: int = 0) -> CardCurve:
    """One request's cost on the card a bucket, through the serving worker's
    steps: ``pad_batch`` on the host, ``to_device``, ``recsys.forward``, and
    a wait for the device; each step on the host's clock, the median of
    ``CARD_REPS`` requests a bucket after ``CARD_WARMUP`` rounds, at every
    bucket of ``(1, 4, 16, 64, 256, 1024)``.  The buckets take turns, one
    request each a round, so a drift of the card's or the host's clocks
    falls on every bucket alike.  ``cfg`` defaults to the published config;
    ``params`` are made from ``seed`` on the card when not given.

    A request holds 3/4 of its bucket's items (one item for bucket 1), so
    every request but the smallest is padded as the runtime pads it.  Every
    request's logits must have the bucket's rows and be finite, or this
    raises; without a card it raises (``default_device``)."""
    dev = default_device()
    cfg = cfg or get(arch).config
    if params is None:
        params = recsys.init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    batches = _BATCH_LADDER
    rng = np.random.default_rng(seed)
    # one pool of items made up front; a request is a window of it
    pool_n = 2 * max(batches)
    pool = syn.recsys_batch(rng, cfg, pool_n, with_label=False)
    want_tail = () if cfg.n_tasks == 1 else (cfg.n_tasks,)
    ts: dict[int, list] = {b: [] for b in batches}
    n = 0
    for i in range(CARD_WARMUP + CARD_REPS):
        for b in batches:
            size = max(1, b * 3 // 4)
            lo = int(rng.integers(0, pool_n - size + 1))
            req = {k: v[lo:lo + size] for k, v in pool.items()}
            t0 = time.perf_counter()
            padded = pad_batch(req, b)
            t1 = time.perf_counter()
            on_card = to_device(padded, dev)
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            out = recsys.forward(params, cfg, on_card)
            torch.cuda.synchronize(dev)
            t3 = time.perf_counter()
            n += 1
            if tuple(out.shape) != (b, *want_tail) or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"{cfg.name}: bucket {b} gave logits of shape "
                                   f"{tuple(out.shape)} or non-finite values")
            if i >= CARD_WARMUP:
                ts[b].append((t3 - t0, t1 - t0, t2 - t1, t3 - t2))
    secs, steps = [], {}
    for b in batches:
        total, pad, copy, fwd = (statistics.median(col) for col in zip(*ts[b]))
        secs.append(total)
        steps[b] = {"pad_ms": pad * 1e3, "copy_ms": copy * 1e3, "forward_ms": fwd * 1e3}
    return CardCurve(lat.TableDeviceModel(np.asarray(batches, float), np.asarray(secs, float)),
                     steps, n)


def card_meta(arch: str, measured: CardCurve, *, cfg=None) -> dict:
    """What ``h100_latency_curves.json`` keeps beside a card curve."""
    cfg = cfg or get(arch).config
    return {"config": cfg.name, "vocab": cfg.vocab, "reps": CARD_REPS,
            "warmup": CARD_WARMUP,
            "steps_ms": {str(b): s for b, s in measured.steps_ms.items()},
            "card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda}


def store_curves(path: Path, curves: dict[str, lat.TableDeviceModel],
                 meta: dict[str, dict]) -> None:
    """Merge ``curves`` (with ``meta``) into the curve file at ``path``,
    keeping the models it already holds."""
    old, old_meta = {}, {}
    if path.exists():
        old, old_meta = lat.load_curves(str(path)), lat.load_meta(str(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    lat.save_curves(str(path), {**old, **curves}, {**old_meta, **meta})


def accelerator(arch: str, kind: str = "h100"):
    """The accelerator's latency model: ``"h100"``, the curve measured on
    the card (from the artifact file, or measured now and stored there when
    the file lacks the model; with neither a card nor the file this
    raises); ``"gpu"`` / ``"tpu"``, the reference's analytic presets."""
    if kind != "h100":
        return lat.accelerator_model(get(arch).config, kind)
    path = artifact_dir() / CARD_CURVES
    curves = lat.load_curves(str(path)) if path.exists() else {}
    if arch in curves:
        return curves[arch]
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no measured card curve for {arch!r} in {path} and no CUDA device to "
            "measure one on; the accelerator is never measured on the CPU")
    print(f"[infra] measuring the card's latency curve for {arch} ...")
    measured = measure_card_curve(arch)
    store_curves(path, {arch: measured.curve}, {arch: card_meta(arch, measured)})
    return measured.curve


def sla_ms(arch: str, tier: str = "medium") -> float:
    return SLA_TARGETS[arch].get(tier)
