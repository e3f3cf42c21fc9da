"""Config registry of the port: the eight DeepRecInfra paper models, the
rest of the recsys zoo (xDeepFM, AutoInt, MIND, BERT4Rec), the three
dense LMs (qwen2-0.5b, phi3-mini-3.8b, yi-34b), the two mixture-of-experts
LMs (granite-moe-1b-a400m, qwen3-moe-30b-a3b) and the GCN (gcn-cora), with
the input shapes of each family (``RECSYS_SHAPES``, ``LM_SHAPES``,
``GNN_SHAPES``).

``--arch <id>`` in the port's entry points resolves through ``get``.
"""
from repro_torch.configs import (  # noqa: F401 — registration side effects
    autoint,
    bert4rec,
    gcn_cora,
    granite_moe_1b_a400m,
    mind,
    paper_models,
    phi3_mini_3_8b,
    qwen2_0_5b,
    qwen3_moe_30b_a3b,
    xdeepfm,
    yi_34b,
)
from repro_torch.configs.registry import ArchSpec, get, list_archs  # noqa: F401
from repro_torch.configs.shapes import (  # noqa: F401
    FULL_ATTENTION_SKIPS,
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    GNNShape,
    LMShape,
    RecShape,
    shapes_for_family,
)
