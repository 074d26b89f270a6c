"""The four recsys architectures the port runs, exact configs as the
reference's (``repro.configs.recsys_archs``).

  bst      [arXiv:1905.06874]  embed 32, seq 20, 1 transformer block, 8 heads,
                               MLP 1024-512-256 (Taobao-scale vocabularies)
  dien     [arXiv:1809.03672]  embed 18, seq 100, AUGRU dim 108, MLP 200-80
                               (Amazon Books vocabularies)
  autoint  [arXiv:1810.11921]  39 fields, embed 16, 3 attn layers x 2 heads,
                               total attention dim 32 (=> 16 per head)
  dcn-v2   [arXiv:2008.13535]  13 dense + 26 sparse, embed 16, 3 cross layers,
                               MLP 1024-1024-512 (Criteo vocabularies, capped)

Vocabulary sizes are the public datasets' cardinalities (large Criteo fields
capped at 1M by the usual hashing trick).
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.models.recsys import RecSysConfig

FAMILY = "recsys"

# Criteo categorical cardinalities (capped at 1M, standard hashing trick)
_CRITEO_26 = (
    1460, 583, 1_000_000, 800_000, 305, 24, 12517, 633, 3, 93145,
    5683, 1_000_000, 3194, 27, 14992, 1_000_000, 10, 5652, 2173, 4,
    1_000_000, 18, 15, 286181, 105, 142572,
)


def bst_full() -> RecSysConfig:
    return RecSysConfig(
        name="bst", interaction="transformer-seq", embed_dim=32,
        # seq fields: item (4M), category (10k); plain: user 1M + 5 context
        field_vocabs=(4_000_000, 10_000, 1_000_000, 50_000, 10_000, 1_000, 500, 100),
        seq_len=20, seq_fields=2, n_blocks=1, n_heads=8, d_attn=8,
        mlp=(1024, 512, 256),
    )


def dien_full() -> RecSysConfig:
    return RecSysConfig(
        name="dien", interaction="augru", embed_dim=18,
        # seq fields: item (367k), category (1.6k); plain: user 543k, context
        field_vocabs=(367_983, 1_601, 543_060, 10_000),
        seq_len=100, seq_fields=2, gru_dim=108, mlp=(200, 80),
    )


def autoint_full() -> RecSysConfig:
    vocabs = tuple([100] * 13 + list(_CRITEO_26))  # 13 bucketized dense + 26 cat
    return RecSysConfig(
        name="autoint", interaction="self-attn", embed_dim=16,
        field_vocabs=vocabs, n_blocks=3, n_heads=2, d_attn=16, mlp=(64,),
    )


def dcn_v2_full() -> RecSysConfig:
    return RecSysConfig(
        name="dcn-v2", interaction="cross", embed_dim=16,
        field_vocabs=_CRITEO_26, n_dense=13, n_cross_layers=3,
        mlp=(1024, 1024, 512),
    )


def _reduced(full: RecSysConfig) -> RecSysConfig:
    """Same family, smoke scale: six fields of at most 100 rows, width 8."""
    small_vocabs = tuple(min(v, 100) for v in full.field_vocabs[:6]) or (100,)
    return replace(
        full,
        field_vocabs=small_vocabs,
        embed_dim=8,
        seq_len=min(full.seq_len, 8) if full.seq_len else 0,
        seq_fields=min(full.seq_fields, 2) if full.seq_len else full.seq_fields,
        mlp=tuple(min(m, 32) for m in full.mlp),
        gru_dim=min(full.gru_dim, 16) if full.gru_dim else 0,
        n_dense=full.n_dense,
        d_attn=8,
        n_heads=2,
    )


ARCHS = {
    "bst": bst_full,
    "dien": dien_full,
    "autoint": autoint_full,
    "dcn-v2": dcn_v2_full,
}


def get(arch_id: str, *, reduced: bool = False) -> RecSysConfig:
    cfg = ARCHS[arch_id]()
    return _reduced(cfg) if reduced else cfg
