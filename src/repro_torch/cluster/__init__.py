"""Cluster tier: heterogeneous serving fleets — simulated or live — behind
one ``NodeBackend`` interface (paper §VII — DeepRecSched deployed "on
hundreds of machines", validated against real execution).

* ``backend`` — the ``NodeBackend`` contract (submit / advance-to-time /
  completed-records / capacity weight) plus ``SimNodeBackend``, the numpy
  fast engine behind it.
* ``live`` — ``LiveNodeBackend``: real ``ServingRuntime`` instances
  (PyTorch models on the card or the host CPU, wall-clock pacing,
  per-node online controllers) behind the same contract, with
  device-curve calibration through the runtime to close the sim-vs-real
  loop.
* ``remote`` — ``RemoteNodeBackend``: worker *processes* over localhost
  sockets (``serve.remote`` wire protocol) behind the same contract, plus
  the ``WorkerSupervisor`` that spawns, health-checks, and reaps them —
  real multi-core serving, real ``SIGKILL`` faults, measured boot times;
  each worker serves on the card unless the supervisor is told the CPU.
* ``fleet`` — ``NodeSpec``/``Pool``/``Fleet``: mixed CPU generations and
  accelerator nodes, each pool with its own DeepRecSched knobs.
* ``router`` — pluggable, backend-agnostic query-routing policies
  (round-robin, least-outstanding-work, size-aware, Hercules-style
  heterogeneity-aware with per-tenant affinity).
* ``traffic`` — diurnal / bursty / multi-tenant arrival scenarios.
* ``lifecycle`` — the node lifecycle layer: ``NodeState``
  (BOOTING → SERVING → DRAINING → DEAD, with a transient SUSPECT) owned
  by a ``FleetController`` that materializes, boots, drains, retires, and
  kills backends on the shared timeline; ``FleetFaults`` kill plans with
  re-route, and ``SelfHealPolicy`` auto-restart under a crash-loop
  budget plus terminate-after-idle for draining nodes.
* ``chaos`` — deterministic fault injection: ``ChaosPlan`` extends
  ``FleetFaults`` with hung RPCs, garbled/dropped frames, and slow-start
  spawns, all scheduled at trace times (``crash_storm`` builds the kill
  bursts the chaos benchmark gates on).
* ``autoscaler`` — reactive p95-vs-SLA pool scaling plus the predictive
  boot-latency-ahead ``PredictiveAutoscaler`` over traffic forecasts,
  with node-hour accounting, against the ``CapacityLedger`` protocol;
  ``TelemetrySignal`` swaps the driver-plumbed p95 scalar for the
  registry's window sketches, and ``DiagnosisPolicy`` wraps any scaler
  with SLO-breach-diagnosis-matched actions (scale out on queueing
  saturation, hold on fault recovery, pre-warm on cold capacity) via
  ``drive_fleet(slo=..., autoscaler=DiagnosisPolicy(...))``.
* ``cache`` — ``FleetCache``: the fleet-front result cache (sharded
  LRU/LFU with TTL staleness) that answers popularity-keyed repeats
  before the router; ``drive_fleet(cache=..., query_keys=...)``.
* ``cluster_sim`` — ``drive_fleet``, the engine-agnostic shared-timeline
  driver (plus the event engine per node when faults/contention are
  enabled); ``OffloadTuning`` turns on the per-node online
  offload-threshold controller.

The port's copy of the JAX package's ``repro.cluster``.  Every module but
``live`` and ``remote`` is a copy, equal to the reference on the same
inputs; ``live`` binds the backend to the port's ``ServingRuntime``, and
``remote`` spawns the port's workers (``repro_torch.serve.remote``).
"""
from repro_torch.cluster.autoscaler import (Autoscaler,  # noqa: F401
                                            CapacityLedger, DiagnosisPolicy,
                                            PredictiveAutoscaler, ScalingEvent,
                                            TelemetrySignal)
from repro_torch.cluster.backend import (BackendDied,  # noqa: F401
                                         CompletedQuery, NodeBackend, NodeHandle,
                                         PendingQuery, SimNodeBackend, sim_backends)
from repro_torch.cluster.cache import CacheConfig, FleetCache  # noqa: F401
from repro_torch.cluster.chaos import (ChaosPlan, FrameGarble,  # noqa: F401
                                       RpcHang, SlowStart, crash_storm)
from repro_torch.cluster.lifecycle import (FleetController,  # noqa: F401
                                           FleetFaults, LifecycleEvent, NodeKill,
                                           NodeState, SelfHealPolicy)
from repro_torch.cluster.cluster_sim import (ClusterResult,  # noqa: F401
                                             OffloadTuning, cluster_max_qps,
                                             drive_fleet, simulate_fleet)
from repro_torch.cluster.fleet import (Fleet, NodeSpec, Pool,  # noqa: F401
                                       ScaledDeviceModel)
from repro_torch.cluster.live import (BucketedDeviceModel,  # noqa: F401
                                      LiveNodeBackend, WallClock, calibrate_device,
                                      live_node)
from repro_torch.cluster.remote import (BootingRemoteBackend,  # noqa: F401
                                        RemoteBackendFactory, RemoteNodeBackend,
                                        RestartPolicy, WorkerCrashed,
                                        WorkerSupervisor, boot_remote_fleet,
                                        remote_node)
from repro_torch.cluster.router import (HeterogeneityAwareRouter,  # noqa: F401
                                        LeastOutstandingRouter, RoundRobinRouter,
                                        Router, SizeAwareRouter, make_router)
from repro_torch.cluster.traffic import (BurstyTraffic, DiurnalTraffic,  # noqa: F401
                                         MultiTenantTraffic, StationaryTraffic,
                                         Traffic)
