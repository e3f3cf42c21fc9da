"""Quickstart for the PyTorch port: build a DeepRecInfra model, score a
query, measure its latency curve, tune the scheduler.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain versions
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.latency_model import measure_curve
from repro_torch.core.scheduler import static_baseline, tune
from repro_torch.core.simulator import SchedulerConfig, max_qps_under_sla
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve
from repro_torch.models import recsys
from repro_torch.serve.runtime import to_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to ask for the CPU")
    dev = resolve(ap.parse_args().device)

    # 1. a DeepRecInfra model (DLRM-RMC1, reduced) --------------------------
    cfg = configs.get("dlrm-rmc1").smoke_config
    params = recsys.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)
    batch = to_device(syn.recsys_batch(rng, cfg, 64, with_label=False), dev)
    ctr = torch.sigmoid(recsys.forward(params, cfg, batch)).cpu()
    print(f"scored {ctr.shape[0]} candidates on {dev}; CTR[:4] = {ctr[:4].numpy()}")

    # 2. measure its latency curve, waiting for the device each call --------
    sizes = [1, 16, 64, 256, 1024]
    batches = {b: to_device(syn.recsys_batch(rng, cfg, b, with_label=False), dev)
               for b in sizes}

    def apply(b: int) -> None:
        recsys.forward(params, cfg, batches[b])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    curve = measure_curve(apply, batches=sizes, iters=3)
    print("latency curve:", {b: f"{s*1e3:.2f}ms" for b, s in zip(sizes, curve.seconds)})

    # 3. DeepRecSched: tune per-request batch size under a 100 ms p95 SLA ---
    b0 = static_baseline(1000, n_executors=40)
    q_static = max_qps_under_sla(curve, SchedulerConfig(batch_size=b0), 100.0,
                                 n_queries=600, iters=6)
    result = tune(curve, sla_ms=100.0, n_queries=600)
    print(f"static baseline (B={b0}): {q_static:.0f} QPS")
    print(f"DeepRecSched   (B={result.batch_size}): {result.qps:.0f} QPS "
          f"→ {result.qps / max(q_static, 1e-9):.2f}×")


if __name__ == "__main__":
    main()
