"""Fleet-scale scenario on the PyTorch port: a heterogeneous datacenter tier
(Skylake + Broadwell + accelerator pools, per-pool DeepRecSched knobs)
serving a compressed diurnal day, with query routing, reactive and
predictive autoscaling, and a mid-day rack kill with query re-route: the
paper's §VII deployment story on the numpy fast engine, plus the fleet
lifecycle layer.

    PYTHONPATH=src python examples/datacenter_fleet_torch.py --synthetic   # canned curves
    PYTHONPATH=src python examples/datacenter_fleet_torch.py               # measured curves

``--synthetic`` uses the JAX package's canned CPU curve and its analytic
GTX 1080 Ti (``AnalyticalDeviceModel(**GPU_1080TI)``), the same inputs as
``examples/datacenter_fleet.py --synthetic``.  Without it the CPU pools
take the host CPU's measured torch curve of DLRM-RMC1
(``infra.cpu_curves``) and the accelerated pool, named after the card,
takes the curve measured on the H100 (``infra.accelerator(arch, "h100")``:
``h100_latency_curves.json``, or measured now on the card; without the
file and without a card it raises).  The scenario is
``repro_torch.cluster.datacenter.build_fleet`` and ``fleet_day``.
"""
import argparse

from repro_torch.cluster import datacenter as dc


def report(res: dict) -> list[str]:
    """The JAX example's printout of ``fleet_day``'s numbers, line for line."""
    sla = res["sla_ms"]
    lines = [f"tuning per-pool DeepRecSched knobs for {res['fleet']} ..."]
    lines += [f"  {p['name']:10s} ×{p['count']}  B*={p['batch']:<4d} "
              f"thr={str(p['threshold']):>5s} node_qps={p['node_qps']:8.0f}"
              for p in res["pools"]]
    lines += ["", f"diurnal day: {res['queries']} queries, "
                  f"{res['base_qps']:.0f}±{res['amplitude'] * 100:.0f}% qps, "
                  f"period {res['day_s']:.0f}s (compressed)"]
    lines += ["", f"{'t(s)':>5s} {'offered':>8s} {'nodes':>6s} {'p95(ms)':>8s}"]
    lines += [f"{t0:5.0f} {offered:8.0f} {n_nodes:6d} {p95:8.1f} "
              + "#" * int(p95 / sla * 20)
              for t0, offered, n_nodes, p95 in res["timeline"]]
    st, au = res["static"], res["autoscaled"]
    lines += ["", f"static fleet : p95={st['p95_ms']:7.1f}ms  "
                  f"node_hours={st['node_hours']:.3f}  nodes={st['nodes']}",
              f"autoscaled   : p95={au['p95_ms']:7.1f}ms  "
              f"node_hours={au['node_hours']:.3f}  "
              f"({au['saved_pct']:.0f}% saved, {au['events']} scale events, "
              f"final {au['final_nodes']} nodes)",
              f"SLA {sla:.0f}ms: {'OK' if au['meets_sla'] else 'VIOLATED'}"]
    lines += ["", "routing policy comparison (same trace, static fleet):"]
    lines += [f"  {name:18s} p95={r['p95_ms']:9.1f}ms  "
              f"{'meets SLA' if r['meets_sla'] else 'violates'}"
              for name, r in res["routers"].items()]
    lines += ["", f"with node boot latency ({res['boot_s']:.0f}s) on the same day:"]
    lines += [f"  {name:10s} SLA-violation minutes={r['sla_violation_minutes']:6.3f}  "
              f"node_hours={r['node_hours']:.3f}  triggers={r['triggers']}"
              for name, r in res["boot"].items()]
    k = res["kill"]
    lines += ["", f"killing {k['killed']} skylake nodes at t={k['at_s']:.0f}s:",
              f"  with re-route   : {k['reroute']['rerouted']} orphans re-routed, "
              f"{k['reroute']['dropped']} dropped, p95={k['reroute']['p95_ms']:.1f}ms",
              f"  without re-route: {k['no_reroute']['dropped']} dropped "
              f"(every orphan lost)"]
    return lines


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true",
                    help="the JAX example's canned CPU curve and analytic 1080 Ti "
                         "instead of the measured host-CPU and H100 curves")
    args = ap.parse_args()
    print("\n".join(report(dc.fleet_day(dc.build_fleet(args.synthetic)))))


if __name__ == "__main__":
    main()
