"""Config registry of the port: the eight DeepRecInfra paper models and the
rest of the recsys zoo (xDeepFM, AutoInt, MIND, BERT4Rec), with the
recommendation input shapes (``RECSYS_SHAPES``).

``--arch <id>`` in the port's entry points resolves through ``get``.
"""
from repro_torch.configs import (  # noqa: F401 — registration side effects
    autoint,
    bert4rec,
    mind,
    paper_models,
    xdeepfm,
)
from repro_torch.configs.registry import ArchSpec, get, list_archs  # noqa: F401
from repro_torch.configs.shapes import RECSYS_SHAPES, RecShape  # noqa: F401
