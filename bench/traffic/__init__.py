"""Traffic drivers, one module a driver, found by the name a workload file
gives (``"driver"``).  Each has ``run(ctx) -> Outcome``."""
