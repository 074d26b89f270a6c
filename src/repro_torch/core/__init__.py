"""eCP-FS core of the port: file formats, build and mutation, file-mode and
packed-mode retrieval.

  open_index(path, mode)          — file | packed | auto searcher factory
                                    ("auto", the default, is packed on a GPU)
  build_index / ECPBuildConfig    — one-shot top-down construction
  build_index_streaming           — out-of-core build from a chunk iterator,
                                    bit-identical to the one-shot build
  ECPIndex / ECPQuery             — retrieval with LRU cache and incremental
                                    search; quantized=True scores leaves on
                                    the device with one grouped kernel launch
                                    per traversal round; a MutableIndex:
                                    insert, delete, compact
  ECPSnapshot / BlobSnapshot      — generation-pinned read-only views for
                                    concurrent serving (ECPIndex.snapshot /
                                    BlobStore.pin)
  BatchedSearcher / BatchedQuery  — level-synchronous batched search of the
                                    whole hierarchy resident on the device
  load_packed / PackedIndex       — dense view of the hierarchy
  Store / open_store / convert    — fstore and blob (v1/v2/v3) backends
"""
from .api import (
    MutableIndex,
    NodeCache,
    Query,
    QueryClosedError,
    ResultSet,
    Searcher,
    SearchStats,
    StaleQueryError,
    open_index,
)
from .batched import BatchedQuery, BatchedQueryState, BatchedSearcher
from .build import ECPBuildConfig, build_index
from .frontier import CandidateBuffer, Frontier
from .fstore import FStore
from .layout import IndexInfo, derive_shape
from .lifecycle import build_index_streaming, reservoir_sample
from .packed import PackedIndex, load_packed
from .search import ECPIndex, ECPQuery, ECPSnapshot, QueryState, make_kernel_scorer
from .store import (
    BlobSnapshot,
    BlobStore,
    FStoreBackend,
    IOStats,
    NodeNormCache,
    Store,
    convert,
    open_store,
)

__all__ = [
    "Searcher",
    "MutableIndex",
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
    "build_index_streaming",
    "reservoir_sample",
    "BatchedQuery",
    "BatchedQueryState",
    "BatchedSearcher",
    "FStore",
    "IndexInfo",
    "derive_shape",
    "PackedIndex",
    "load_packed",
    "ECPIndex",
    "ECPQuery",
    "ECPSnapshot",
    "BlobSnapshot",
    "QueryState",
    "Frontier",
    "CandidateBuffer",
    "NodeNormCache",
    "make_kernel_scorer",
]
