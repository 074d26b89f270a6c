"""The paper's own experimental configuration (§5).

1M SigLIP embeddings, 1152-d float16; target cluster size C = 455 vectors
(~1 MB at 2304 B/vector); L = 3 for V3C-scale (4.1M), L = 2 for ~1M
collections; search expansion b = 64; k = 100. Benchmarks (Tables 2-4)
instantiate scaled-down versions of this config; the batched serve cell
lowers the device search at the full scale.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.build import ECPBuildConfig

FAMILY = "ann"


@dataclass(frozen=True)
class ECPFSPaperConfig:
    name: str = "ecpfs-paper"
    n_items: int = 1_000_000
    dim: int = 1152
    storage_dtype: str = "float16"
    cluster_cap: int = 455          # ~1MB clusters (paper §5.2)
    levels: int = 2                 # L=2 for 1M-scale (LSC24 / V3C1)
    levels_large: int = 3           # L=3 for V3C (4.1M)
    metric: str = "cosine"
    b: int = 64                     # search expansion (matches IVF nprobe=64)
    k: int = 100
    serve_batch: int = 128


def ecpfs_paper_full() -> ECPFSPaperConfig:
    return ECPFSPaperConfig()


def ecpfs_paper_reduced() -> ECPFSPaperConfig:
    return ECPFSPaperConfig(
        name="ecpfs-paper-reduced", n_items=20_000, dim=64, cluster_cap=100,
        levels=2, b=8, k=20, serve_batch=8,
    )


def build_cfg(cfg: ECPFSPaperConfig) -> ECPBuildConfig:
    return ECPBuildConfig(
        levels=cfg.levels, metric=cfg.metric, cluster_cap=cfg.cluster_cap,
        storage_dtype=cfg.storage_dtype,
    )
