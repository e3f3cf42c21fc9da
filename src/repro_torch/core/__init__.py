"""DeepRecSys core: DeepRecInfra (query gen, device models, simulator) and
DeepRecSched (hill-climbing scheduler).  numpy only, apart from ``costs``
and ``infra``."""
import importlib

from repro_torch.core import latency_model, query_gen, scheduler, simulator  # noqa: F401

# `costs` and `infra` pull in torch and the model code; import them lazily
# (PEP 562) so the numpy-only tuning stack — including the spawned workers
# of `tune(workers=N)` — stays free of the model code and fast to start
_LAZY = ("costs", "infra")


def __getattr__(name: str):
    if name in _LAZY:
        return importlib.import_module(f"repro_torch.core.{name}")
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
