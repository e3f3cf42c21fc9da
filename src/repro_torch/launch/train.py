"""Generic training launcher: ``--arch <id>`` from the registry.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rmc1 --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch xdeepfm --full --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora --device cpu

Runs on the card unless ``--device cpu`` is given (the CPU takes the
kernels' plain versions).  Smoke configs by default, so the launcher is
usable anywhere; ``--full`` uses the published config.  Recommendation
models train with the production split (adagrad on the tables, AdamW on
the dense towers), dense LMs with AdamW, and the GCN with AdamW, full-batch
on one community-structured random graph of 400 nodes and 3,200 edges, as
the reference does; all clip the gradient's global norm at 10.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve
from repro_torch.models import gnn, lm, recsys
from repro_torch.serve.runtime import to_device
from repro_torch.train import optim
from repro_torch.train.loop import TrainState, train
from repro_torch.utils import param_count


def setup(arch: str, *, full: bool, batch: int, seq: int, device: torch.device, seed: int = 0):
    """(params, loss_fn, batch iterator, optimizer) for ``arch``."""
    spec = get(arch)
    cfg = spec.config if full else spec.smoke_config
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    if spec.family == "recsys":
        params = recsys.init(gen, cfg, device=device)
        batches = iter(lambda: to_device(syn.recsys_batch(rng, cfg, batch), device), None)
        opt = optim.combined(lambda path: "table" in str(path),
                             optim.adagrad(0.02), optim.adamw(1e-3))
        return params, (lambda p, b: recsys.loss_fn(p, cfg, b)), batches, opt
    if spec.family == "lm":
        params = lm.init(gen, cfg, device=device)
        batches = iter(lambda: to_device(syn.lm_batch(rng, cfg, batch, seq), device), None)
        return params, (lambda p, b: lm.loss_fn(p, cfg, b)), batches, optim.adamw(3e-4)
    params = gnn.init(gen, cfg, device=device)
    g = to_device(syn.random_graph(rng, 400, 3200, cfg.d_feat, cfg.n_classes), device)
    return params, (lambda p, b: gnn.loss_fn(p, cfg, b)), iter(lambda: g, None), optim.adamw(1e-2)


def main(argv: list[str] | None = None) -> TrainState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64, help="LM sequence length")
    ap.add_argument("--full", action="store_true", help="published config (needs the card)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    params, loss_fn, batches, opt = setup(args.arch, full=args.full, batch=args.batch,
                                          seq=args.seq, device=device)
    print(f"[train] {args.arch} ({get(args.arch).family}) on {device} "
          f"params={param_count(params) / 1e6:.2f}M")
    state = train(loss_fn, opt, params, batches, num_steps=args.steps, ckpt_dir=args.ckpt,
                  log_every=max(args.steps // 10, 1), num_microbatches=args.microbatches,
                  clip_norm=10.0)
    print(f"[train] done at step {state.step}")
    return state


if __name__ == "__main__":
    main()
