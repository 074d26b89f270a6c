"""eCP-FS core of the port: file formats, build, and file-mode retrieval.

  open_index(path, mode="file")   — the file-structure searcher (ECPIndex)
  build_index / ECPBuildConfig    — one-shot top-down construction
  ECPIndex / ECPQuery             — retrieval with LRU cache and incremental
                                    search; quantized=True scores leaves on
                                    the device with one grouped kernel launch
                                    per traversal round
  Store / open_store / convert    — fstore and blob (v1/v2/v3) backends
"""
from .api import (
    NodeCache,
    Query,
    QueryClosedError,
    ResultSet,
    Searcher,
    SearchStats,
    StaleQueryError,
    open_index,
)
from .build import ECPBuildConfig, build_index
from .frontier import CandidateBuffer, Frontier
from .fstore import FStore
from .layout import IndexInfo, derive_shape
from .search import ECPIndex, ECPQuery, QueryState, make_kernel_scorer
from .store import BlobStore, FStoreBackend, IOStats, NodeNormCache, Store, convert, open_store

__all__ = [
    "Searcher",
    "ResultSet",
    "Query",
    "QueryClosedError",
    "StaleQueryError",
    "SearchStats",
    "IOStats",
    "NodeCache",
    "open_index",
    "Store",
    "open_store",
    "convert",
    "FStoreBackend",
    "BlobStore",
    "ECPBuildConfig",
    "build_index",
    "FStore",
    "IndexInfo",
    "derive_shape",
    "ECPIndex",
    "ECPQuery",
    "QueryState",
    "Frontier",
    "CandidateBuffer",
    "NodeNormCache",
    "make_kernel_scorer",
]
