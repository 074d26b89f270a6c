"""graphsage-reddit [arXiv:1706.02216], as the reference's
(``repro.configs.gnn_archs``): 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10 (the minibatch_lg shape overrides to 15-10).

d_in / n_classes are shape-dependent (Cora / Reddit / ogbn-products /
molecules): a caller specialises the config per shape.  The paper's
technique does not apply here."""
from __future__ import annotations

from dataclasses import replace

from repro_torch.models.gnn import GraphSAGEConfig

FAMILY = "gnn"


def graphsage_reddit_full() -> GraphSAGEConfig:
    return GraphSAGEConfig(
        name="graphsage-reddit", d_in=602, n_classes=41, n_layers=2,
        d_hidden=128, aggregator="mean", fanouts=(25, 10),
    )


def _reduced(full: GraphSAGEConfig) -> GraphSAGEConfig:
    return replace(full, d_in=16, n_classes=5, d_hidden=32, fanouts=(3, 2))


ARCHS = {"graphsage-reddit": graphsage_reddit_full}


def get(arch_id: str, *, reduced: bool = False) -> GraphSAGEConfig:
    cfg = ARCHS[arch_id]()
    return _reduced(cfg) if reduced else cfg
