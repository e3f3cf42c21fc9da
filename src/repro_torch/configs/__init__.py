"""Config registry of the port: the eight DeepRecInfra paper models.

``--arch <id>`` in the port's entry points resolves through ``get``.
"""
from repro_torch.configs import paper_models  # noqa: F401 — registration side effects
from repro_torch.configs.registry import ArchSpec, get, list_archs  # noqa: F401
