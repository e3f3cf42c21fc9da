"""Live serving on the GPU: the PyTorch/CUDA port behind the DeepRecSched
online controller.

Streams Poisson queries with production-tail sizes through the threaded
runtime; the controller hill-climbs the batch-size knob from measured p95.
The model is one of the eight paper models at its published size (the
tables are created on the card), or its reduced config with ``--smoke``.

    PYTHONPATH=src python examples/serve_recsys_torch.py [--arch dlrm-rmc2]
    PYTHONPATH=src python examples/serve_recsys_torch.py --smoke --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.paper_models import SLA_TARGETS
from repro_torch.core.query_gen import PRODUCTION, query_stream
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import recsys
from repro_torch.serve.batching import bucket_ladder
from repro_torch.serve.runtime import OnlineController, ServingRuntime, to_device


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="dlrm-rmc2", choices=sorted(SLA_TARGETS))
    ap.add_argument("--smoke", action="store_true", help="reduced config of the same family")
    ap.add_argument("--device", default=None, help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--qps", type=float, default=60.0)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args()

    device = resolve(args.device)
    spec = configs.get(args.arch)
    cfg = spec.smoke_config if args.smoke else spec.config
    params = recsys.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)

    # the first launch builds the kernels, and cuBLAS meets each batch shape
    # for the first time: pay for that once per bucket before the clock
    # starts, not in the first queries' latency
    for bucket in bucket_ladder(1024):
        warm = syn.recsys_batch(rng, cfg, bucket, with_label=False)
        recsys.forward(params, cfg, to_device(warm, device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launch_counts()

    rt = ServingRuntime(lambda b: recsys.forward(params, cfg, b), n_workers=2,
                        batch_size=32, device=device)
    ctl = OnlineController(rt, sla_ms=SLA_TARGETS[args.arch].medium_ms, window=25)
    stream = query_stream(0, qps=args.qps, size_dist=PRODUCTION)

    t0 = time.monotonic()
    try:
        for q in stream:
            if q.arrival > args.seconds:
                break
            delay = q.arrival - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            batch = syn.recsys_batch(rng, cfg, q.size, with_label=False)
            rt.submit(q.qid, batch, q.size)
            ctl.step()
        rt.drain(timeout=120)
        done = rt.completed()
        errors = [r.error for r in done if r.error]
        lats = sorted(r.latency_ms for r in done)
        print(f"{cfg.name} on {device}: served {len(done)} queries, {len(errors)} errors "
              f"| p50 {lats[len(lats)//2]:.1f} ms | p95 {rt.percentile_ms(95):.1f} ms")
        print(f"controller trajectory (batch, p95): {ctl.history}")
        print(f"final batch size: {rt.batch_size} | kernel launches: {ops.launch_counts()}")
        if errors:
            raise SystemExit(f"first error: {errors[0]}")
    finally:
        rt.shutdown()


if __name__ == "__main__":
    main()
