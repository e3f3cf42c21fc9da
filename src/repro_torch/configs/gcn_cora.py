"""gcn-cora [arXiv:1609.02907; paper].

n_layers=2 d_hidden=16 aggregator=mean norm=sym.  The same weights run the
four GNN shapes (Cora full-batch, Reddit-scale sampled minibatch,
ogbn-products full-batch, batched molecules): d_feat/n_classes come from the
shape, so the config is rebound per shape (``config_for_shape``).
"""
import dataclasses

from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.gnn import GCNConfig

CONFIG = GCNConfig(
    name="gcn-cora", n_layers=2, d_feat=1433, d_hidden=16, n_classes=7,
    aggregator="mean", norm="sym",
)

SMOKE = GCNConfig(
    name="gcn-smoke", n_layers=2, d_feat=8, d_hidden=4, n_classes=3,
    aggregator="mean", norm="sym",
)

SPEC = register(ArchSpec(
    arch_id="gcn-cora", family="gnn", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:1609.02907",
    notes="message passing as a gather and a fixed-order segment sum (no SpMM)",
))


def config_for_shape(shape) -> GCNConfig:
    """Rebind feature/class dims to the shape's dataset."""
    return dataclasses.replace(CONFIG, d_feat=shape.d_feat or CONFIG.d_feat,
                               n_classes=shape.n_classes or CONFIG.n_classes)
