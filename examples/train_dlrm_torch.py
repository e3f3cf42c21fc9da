"""End-to-end example of the PyTorch port: train a ~100M-parameter DLRM-class
ranker for a few hundred steps with the full production stack: the
sparse-aware combined optimizer (adagrad on the tables, AdamW on the dense
towers), fault-tolerant checkpointing (kill it mid-run and launch it again:
it resumes), the NaN guard and gradient clipping.  On the card the pooling
and the dot interaction and their gradients run in the hand-written
kernels (K1, K1-bwd, K2, K2-bwd).

    PYTHONPATH=src python examples/train_dlrm_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_dlrm_torch.py --device cpu   # plain versions
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve
from repro_torch.models import recsys
from repro_torch.serve.runtime import to_device
from repro_torch.train import optim
from repro_torch.train.loop import train
from repro_torch.utils import param_count


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ckpt", default="build/ckpt_dlrm_torch")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to ask for the CPU")
    args = ap.parse_args()
    dev = resolve(args.device)

    # ~100M params: 10 tables × 300k rows × 32 dims ≈ 96M + dense towers
    cfg = dataclasses.replace(get("dlrm-rmc1").config, vocab=300_000, hotness=16)
    params = recsys.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    print(f"model: {cfg.name}  params: {param_count(params) / 1e6:.1f}M  device: {dev}")

    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield to_device(syn.recsys_batch(rng, cfg, args.batch), dev)

    # production recsys optimizer split: adagrad rows / adamw dense
    opt = optim.combined(lambda path: "table" in str(path),
                         optim.adagrad(0.02), optim.adamw(1e-3))

    state = train(lambda p, b: recsys.loss_fn(p, cfg, b), opt, params,
                  batches(), num_steps=args.steps, ckpt_dir=args.ckpt,
                  ckpt_every=50, log_every=20, clip_norm=10.0)

    eval_batch = to_device(syn.recsys_batch(np.random.default_rng(9), cfg, 4096), dev)
    with torch.no_grad():
        loss = float(recsys.loss_fn(state.params, cfg, eval_batch))
        logits = recsys.forward(state.params, cfg, eval_batch)
    auc = _auc(logits.cpu().numpy(), eval_batch["label"].cpu().numpy())
    print(f"final eval: loss {loss:.4f}  AUC {auc:.3f}")


def _auc(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


if __name__ == "__main__":
    main()
