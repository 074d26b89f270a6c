"""On-disk layout of the eCP-FS index (paper Fig. 1).

root/
  info                      group; .zattrs holds index metadata
  rep/embeddings            [l, D]  all cluster leaders (representatives)
  rep/item_ids              [l]     dataset ids the leaders came from
  index_root/embeddings     [n_1, D] level-1 node centroids
  index_root/ids            [n_1]    level-1 node indices (0..n_1-1)
  lvl_1/node_<j>/embeddings [n_children, D]  centroids of children at lvl_2
  lvl_1/node_<j>/ids        [n_children]     child node indices at lvl_2
  ...
  lvl_L/node_<j>/embeddings [cluster_n, D]   item embeddings of cluster j
  lvl_L/node_<j>/ids        [cluster_n]      item ids of cluster j

Internal node ids point at nodes of the next level; leaf (lvl_L) ids are
dataset item ids. ``index_root`` plays the role of the single lvl_0 node.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

INFO = "info"
REP = "rep"
ROOT = "index_root"
EMB = "embeddings"
IDS = "ids"
REP_EMB = "rep/embeddings"
REP_IDS = "rep/item_ids"

# Mutation metadata (index lifecycle, core/lifecycle.py).  Both live in the
# ``info`` group's attributes next to the IndexInfo fields so every backend
# (including the single-file blob, whose only attribute store is the header's
# ``info`` dict) carries them:
#   GENERATION   int, bumped by every mutation (insert/delete/compact);
#                readers use it to detect that an index changed under them.
#   DELETED_IDS  sorted list of tombstoned item ids; the search engines
#                filter them during leaf scoring and compact() purges them.
GENERATION = "generation"
DELETED_IDS = "deleted_ids"


def read_tombstones(attrs: dict) -> set:
    """The tombstone set recorded in the ``info`` attributes."""
    return {int(x) for x in attrs.get(DELETED_IDS, [])}


def write_tombstones(attrs: dict, tombstones: set) -> dict:
    """Return ``attrs`` updated with a canonical (sorted) tombstone list."""
    attrs = dict(attrs)
    attrs[DELETED_IDS] = sorted(int(x) for x in tombstones)
    return attrs


def lvl_group(level: int) -> str:
    return f"lvl_{level}"


def node_group(level: int, node: int) -> str:
    return f"lvl_{level}/node_{node:08d}"


def node_emb(level: int, node: int) -> str:
    return f"{node_group(level, node)}/{EMB}"


def node_ids(level: int, node: int) -> str:
    return f"{node_group(level, node)}/{IDS}"


@dataclass(frozen=True)
class IndexInfo:
    """Contents of the ``info`` group's attributes."""

    levels: int              # L: leaves live at lvl_L
    metric: str              # l2 | ip | cosine
    dim: int                 # V (feature dimensionality)
    dtype: str               # storage dtype of embeddings, e.g. "float16"
    n_items: int             # N
    cluster_cap: int         # C/V: target vectors per leaf cluster
    n_leaders: int           # l = ceil(N / cluster_cap)
    fanout: int              # w = ceil(l ** (1/L))
    nodes_per_level: tuple[int, ...] = field(default_factory=tuple)  # n_1..n_L
    seed: int = 0
    version: str = "ecp-fs/1"
    generation: int = 0      # bumped by every mutation (lifecycle.py)
    insert_batch: int = 8192  # build-time assignment batch; compact() replays
                              # it so its rebuild is bit-reproducible
    next_id: int = 0         # smallest never-used item id: default insert ids
                             # allocate from here (monotonic across compact(),
                             # so purged ids are never reissued)
    spill_s: int = 0         # build-time spill: max ADDITIONAL leaf replicas
                             # per vector (0 = single assignment, the default)
    spill_eps: float = 0.0   # spill eligibility band vs the nearest leader:
                             # l2/cosine  d_j <= (1+eps)*d_1 (multiplicative),
                             # ip         d_j <= d_1 + eps   (additive)

    def to_attrs(self) -> dict:
        return {
            "levels": self.levels,
            "metric": self.metric,
            "dim": self.dim,
            "dtype": self.dtype,
            "n_items": self.n_items,
            "cluster_cap": self.cluster_cap,
            "n_leaders": self.n_leaders,
            "fanout": self.fanout,
            "nodes_per_level": list(self.nodes_per_level),
            "seed": self.seed,
            "version": self.version,
            GENERATION: self.generation,
            "insert_batch": self.insert_batch,
            "next_id": self.next_id,
            "spill_s": self.spill_s,
            "spill_eps": self.spill_eps,
        }

    @staticmethod
    def from_attrs(a: dict) -> "IndexInfo":
        return IndexInfo(
            levels=int(a["levels"]),
            metric=str(a["metric"]),
            dim=int(a["dim"]),
            dtype=str(a["dtype"]),
            n_items=int(a["n_items"]),
            cluster_cap=int(a["cluster_cap"]),
            n_leaders=int(a["n_leaders"]),
            fanout=int(a["fanout"]),
            nodes_per_level=tuple(int(x) for x in a.get("nodes_per_level", [])),
            seed=int(a.get("seed", 0)),
            version=str(a.get("version", "ecp-fs/1")),
            generation=int(a.get(GENERATION, 0)),
            insert_batch=int(a.get("insert_batch", 8192)),
            # legacy indexes (no next_id) used default positional ids
            next_id=int(a.get("next_id", a.get("n_items", 0))),
            spill_s=int(a.get("spill_s", 0)),
            spill_eps=float(a.get("spill_eps", 0.0)),
        )


def derive_shape(
    n_items: int, cluster_cap: int, levels: int, *, n_leaders: int | None = None
) -> tuple[int, int, tuple[int, ...]]:
    """Paper §3: l = N·V/C leaders, w = l^(1/L) fanout.

    Returns (n_leaders, fanout, nodes_per_level) where nodes_per_level[i]
    is the node count at lvl_{i+1} (so [-1] == n_leaders).  ``n_leaders``
    overrides the derived leader count (the streaming build's reservoir
    mode, where the collection size is unknown until the stream ends).
    """
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if n_leaders is None:
        n_leaders = max(1, math.ceil(n_items / max(1, cluster_cap)))
    n_leaders = max(1, int(n_leaders))
    fanout = max(1, math.ceil(n_leaders ** (1.0 / levels)))
    nodes = []
    for i in range(1, levels + 1):
        nodes.append(min(n_leaders, fanout**i))
    nodes[-1] = n_leaders
    return n_leaders, fanout, tuple(nodes)
