"""At-scale scenario on the PyTorch port: schedule DeepRecInfra models on a
simulated datacenter tier (40-core nodes, optionally the card as each
node's accelerator), with stragglers, hedging and an executor failure
mid-run, then print the capacity table the paper's Fig. 11 summarizes.

    PYTHONPATH=src python examples/datacenter_sim_torch.py [--models dlrm-rmc1,ncf]
    PYTHONPATH=src python examples/datacenter_sim_torch.py --card   # + the H100's curve

The CPU executors cost the host CPU's measured torch curves
(``repro_torch.core.infra.cpu_curves``, cached in
``torch_cpu_latency_curves.json``).  ``--card`` adds the accelerator: the
curve measured on the card (``infra.accelerator(arch, "h100")``, from
``h100_latency_curves.json``, or measured now on the card); without the
file and without a card it raises.  The CPU-only columns are the JAX
package's ``examples/datacenter_sim.py`` table, call for call
(``repro_torch.cluster.datacenter.sim_rows``).
"""
import argparse

from repro_torch.cluster import datacenter as dc
from repro_torch.core import infra


def format_row(row: dict) -> list[str]:
    ok = "OK" if row["ok"] else "VIOLATED"
    lines = [f"{row['arch']:12s} {row['sla_ms']:5.0f}ms {row['static']:8.0f} "
             f"{row['tuned']:8.0f} {row['x']:4.1f}x {row['batch']:5d} "
             f"{row['p95_ms']:8.1f}ms {ok} (hedges={row['hedges']}, "
             f"requeued={row['requeued']})"]
    if "card" in row:
        c = row["card"]
        ok = "OK" if c["ok"] else "VIOLATED"
        lines.append(f"{'  + h100':12s} {'':7s} {'':8s} {c['tuned']:8.0f} "
                     f"{c['tuned'] / max(row['static'], 1e-9):4.1f}x {c['batch']:5d} "
                     f"{c['p95_ms']:8.1f}ms {ok} (thr={c['threshold']}, "
                     f"hedges={c['hedges']}, requeued={c['requeued']})")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(dc.MODELS))
    ap.add_argument("--tier", default=dc.TIER)
    ap.add_argument("--card", action="store_true",
                    help="also tune with the card's measured curve as the accelerator")
    args = ap.parse_args()
    models = args.models.split(",")

    curves = infra.cpu_curves(models)
    card = {a: infra.accelerator(a, "h100") for a in models} if args.card else None
    print(f"{'model':12s} {'SLA':>6s} {'static':>9s} {'tuned':>9s} "
          f"{'x':>5s} {'B*':>5s} {'p95@70% (faults)':>18s}")
    for row in dc.sim_rows(models, args.tier, curves, card):
        print("\n".join(format_row(row)))


if __name__ == "__main__":
    main()
