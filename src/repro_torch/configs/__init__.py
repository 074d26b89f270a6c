"""Configurations of the port: the paper's §5 setup (``ecpfs_paper``) and
the config registry, as the reference's (``repro.configs``):

  get_arch(arch_id, reduced=False) -> (family, model_cfg)
  arch_shapes(arch_id) -> the shape table for that arch's family
  ALL_ARCHS / ALL_CELLS -> the 10 archs / 40 (arch x shape) cells
"""
from __future__ import annotations

from . import gnn_archs, lm_archs, recsys_archs
from .ecpfs_paper import ECPFSPaperConfig, ecpfs_paper_full, ecpfs_paper_reduced
from .shapes import FAMILY_SHAPES, GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES

_FAMILY_OF = {}
for _m in (lm_archs, gnn_archs, recsys_archs):
    for _a in _m.ARCHS:
        _FAMILY_OF[_a] = (_m.FAMILY, _m)

ALL_ARCHS = tuple(_FAMILY_OF)


def get_arch(arch_id: str, *, reduced: bool = False):
    if arch_id not in _FAMILY_OF:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_FAMILY_OF)}")
    family, mod = _FAMILY_OF[arch_id]
    return family, mod.get(arch_id, reduced=reduced)


def arch_shapes(arch_id: str) -> dict:
    family, _ = _FAMILY_OF[arch_id]
    return FAMILY_SHAPES[family]


ALL_CELLS = tuple(
    (a, s) for a in ALL_ARCHS for s in arch_shapes(a)
)

__all__ = [
    "get_arch",
    "arch_shapes",
    "ALL_ARCHS",
    "ALL_CELLS",
    "LM_SHAPES",
    "GNN_SHAPES",
    "RECSYS_SHAPES",
    "FAMILY_SHAPES",
    "ECPFSPaperConfig",
    "ecpfs_paper_full",
    "ecpfs_paper_reduced",
]
