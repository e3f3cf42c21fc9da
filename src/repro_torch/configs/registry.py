"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import dataclasses
from typing import Any

_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                     # recsys (lm, gnn arrive with their models)
    config: Any                     # full (published) config
    smoke_config: Any               # reduced config for CPU smoke tests
    source: str                     # citation of the published config
    notes: str = ""


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise KeyError(f"duplicate arch id {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        import repro_torch.configs  # noqa: F401 — trigger registration
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}") from None


def list_archs(family: str | None = None) -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(a for a, s in _REGISTRY.items()
                  if family is None or s.family == family)
