"""Pluggable node-storage backends — the I/O seam under every searcher.

The port's copy of the reference's store layer: the ``Store`` protocol,
``FStoreBackend`` (the zarr-v2 hierarchy), ``BlobStore`` (v1/v2/v3 single
files, with the v3 quantized companion blocks), their write path
(``write_attrs``, ``write_node``, ``append_rows``, ``delete_rows``,
``free_slot``), generation pinning (``BlobStore.pin`` -> ``BlobSnapshot``),
``convert(..., quant=)``, ``NodeNormCache`` and ``open_store``.  Every
byte read or written is the reference's, so either package opens what the
other wrote.

  ``Store``
    * ``get_node(level, node)``          one node's (embeddings f32, ids)
    * ``get_nodes([(level, node), ..])`` batched node reads (backends may
                                         coalesce adjacent blocks)
    * ``read_attrs`` / ``write_attrs``   JSON metadata (``info`` group)
    * ``write_node(level, node, emb, ids)``
    * ``append_rows(level, node, emb, ids)``   grow a node in place
    * ``delete_rows(level, node, drop_ids)``   physically remove rows by id
    * ``free_slot(level, node)``         release a node's storage; the node
                                         id stays valid but empty
    * ``io``                             an ``IOStats`` counter
    * level 0, node 0 is the index root (``index_root`` in the file layout)

BlobStore on-disk format::

  [0:8)    magic b"ECPBLOB1"
  [8:16)   uint64 LE header length H
  [16:16+H) JSON header: page_size, block_bytes, data_offset, dim,
            emb_dtype, ids_dtype, info (index metadata), levels
            (levels[lv] = per-node row counts; levels[0] = [root rows])
  data_offset (page-aligned): one block per node.  A block is n_rows
            embeddings (emb_dtype) then n_rows ids (ids_dtype),
            zero-padded to block_bytes.

Two header formats share the magic; the JSON ``format`` field versions them:

  ``ecp-blob/1``  node -> physical slot is implicit: slots are ordered by
            (level, node) and the file is exactly full.  Read-only in
            structure: rows in an existing slot may be rewritten, but no
            node can be added or released.
  ``ecp-blob/2``  the mutable form (``convert()`` default): the header
            additionally carries ``slots`` (a per-node physical-slot map,
            -1 = released), ``free_slots`` (released physical slots,
            reused by the next allocation), and ``n_slots`` (slots ever
            allocated — the file's data region is n_slots blocks).  New
            nodes appended by leaf splits take a free slot or grow the
            file; ``block_bytes`` is sized so a full ``cluster_cap`` leaf
            always fits.  A v1 file is upgraded to v2 in place the first
            time a structural mutation needs the slot map (if its reserved
            header page can hold the map — otherwise rebuild).
  ``ecp-blob/3``  v2 plus a quantized companion block per slot
            (``convert(..., quant="int8"|"float16")``): the header adds
            ``quant = {"qformat", "q_block_bytes"}`` and every slot's
            stride becomes ``block_bytes + q_block_bytes`` — the
            full-precision block, then ``[scale f32][offset f32][codes
            n_rows*dim]``.  ``get_quantized``/``get_nodes_quantized``
            read only the (much smaller) companion; ``get_node_rows``
            reads a subset of full-precision rows for the rerank;
            ``write_node`` re-encodes the companion on every update so
            insert/delete/split/compact keep the two views coherent.
            Stores without a companion (v1/v2 blobs, fstore) serve
            ``get_quantized`` by encoding on the fly from the
            full-precision rows — same codes, no byte savings.

Snapshot isolation (the serving scheduler's read side): ``BlobStore.pin()``
returns a ``BlobSnapshot`` — a read-only view pinned to the header version
at pin time, on its own dup'd fd.  While pins are outstanding, in-place
node updates copy-on-write into fresh slots and the superseded slots are
retired (recycled once every older pin releases), so snapshot reads are
bit-identical to the pinned version forever and never take the store lock.

Not ported yet (ROADMAP Queue 1 #2): ``AsyncPrefetchStore`` (the
``"<name>+prefetch"`` backends).
"""
from __future__ import annotations

import json
import os
import threading
import weakref
from collections import OrderedDict
from pathlib import Path
from typing import Protocol, runtime_checkable

import numpy as np

from . import layout
from .fstore import FStore, dtype_to_zarr, zarr_to_dtype
from .quant import QFORMATS, QuantNode, encode_node, qdtype

__all__ = [
    "IOStats",
    "Store",
    "FStoreBackend",
    "BlobStore",
    "BlobSnapshot",
    "NodeNormCache",
    "open_store",
    "convert",
    "BLOB_MAGIC",
    "BLOB_FILENAME",
]

BLOB_MAGIC = b"ECPBLOB1"
BLOB_FILENAME = "index.blob"


# ------------------------------------------------------------------- IOStats
class IOStats:
    """Thread-safe I/O counters: bytes read, files opened, reads issued.

    Prefetch accuracy rides along: ``prefetch_issued`` counts background
    reads scheduled, ``prefetch_hits`` counts prefetched payloads a demand
    read actually consumed (joined in flight, or served from the node
    cache before eviction), and ``prefetch_wasted_bytes`` counts bytes
    read ahead that were never used (evicted before demand, invalidated by
    a write, or still unconsumed when the pass flushed) — the axis that
    explains whether ``+prefetch`` pays for its extra reads.
    """

    __slots__ = (
        "bytes_read",
        "files_opened",
        "reads_issued",
        "prefetch_issued",
        "prefetch_hits",
        "prefetch_wasted_bytes",
        "internal_reads",
        "_lock",
    )

    def __init__(
        self,
        bytes_read: int = 0,
        files_opened: int = 0,
        reads_issued: int = 0,
        prefetch_issued: int = 0,
        prefetch_hits: int = 0,
        prefetch_wasted_bytes: int = 0,
        internal_reads: int = 0,
    ):
        self.bytes_read = bytes_read
        self.files_opened = files_opened
        self.reads_issued = reads_issued
        self.prefetch_issued = prefetch_issued
        self.prefetch_hits = prefetch_hits
        self.prefetch_wasted_bytes = prefetch_wasted_bytes
        self.internal_reads = internal_reads
        self._lock = threading.Lock()

    def count(self, nbytes: int, *, files: int = 0, reads: int = 1) -> None:
        with self._lock:
            self.bytes_read += int(nbytes)
            self.files_opened += files
            self.reads_issued += reads

    def count_internal(self, reads: int = 1) -> None:
        """Internal-level (non-leaf) node loads that missed the cache —
        incremented by the traversal, not the raw read path, because only
        the engine knows a key's level.  Hot-level pinning drives this to
        ~0 on warm queries; the counter is the proof."""
        with self._lock:
            self.internal_reads += reads

    def count_prefetch(self, *, issued: int = 0, hits: int = 0, wasted_bytes: int = 0) -> None:
        with self._lock:
            self.prefetch_issued += issued
            self.prefetch_hits += hits
            self.prefetch_wasted_bytes += int(wasted_bytes)

    def snapshot(self) -> "IOStats":
        with self._lock:
            return IOStats(
                self.bytes_read,
                self.files_opened,
                self.reads_issued,
                self.prefetch_issued,
                self.prefetch_hits,
                self.prefetch_wasted_bytes,
                self.internal_reads,
            )

    def delta(self, since: "IOStats") -> "IOStats":
        with self._lock:
            return IOStats(
                self.bytes_read - since.bytes_read,
                self.files_opened - since.files_opened,
                self.reads_issued - since.reads_issued,
                self.prefetch_issued - since.prefetch_issued,
                self.prefetch_hits - since.prefetch_hits,
                self.prefetch_wasted_bytes - since.prefetch_wasted_bytes,
                self.internal_reads - since.internal_reads,
            )

    def add(self, other: "IOStats") -> None:
        with self._lock:
            self.bytes_read += other.bytes_read
            self.files_opened += other.files_opened
            self.reads_issued += other.reads_issued
            self.prefetch_issued += other.prefetch_issued
            self.prefetch_hits += other.prefetch_hits
            self.prefetch_wasted_bytes += other.prefetch_wasted_bytes
            self.internal_reads += other.internal_reads

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "bytes_read": self.bytes_read,
                "files_opened": self.files_opened,
                "reads_issued": self.reads_issued,
                "prefetch_issued": self.prefetch_issued,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_wasted_bytes": self.prefetch_wasted_bytes,
                "internal_reads": self.internal_reads,
            }

    def __repr__(self) -> str:
        return (
            f"IOStats(bytes_read={self.bytes_read}, "
            f"files_opened={self.files_opened}, reads_issued={self.reads_issued}, "
            f"prefetch_issued={self.prefetch_issued}, "
            f"prefetch_hits={self.prefetch_hits}, "
            f"prefetch_wasted_bytes={self.prefetch_wasted_bytes})"
        )


# ------------------------------------------------------------------ protocol
@runtime_checkable
class Store(Protocol):
    """Node storage for an eCP index; level 0 node 0 is the root.

    Optional extensions (not required for isinstance checks, probed with
    ``getattr``): ``get_quantized(level, node, qformat)`` /
    ``get_nodes_quantized(keys, qformat)`` returning ``QuantNode``s,
    ``get_node_ids(level, node)`` (ids only), and
    ``get_node_rows(level, node, rows)`` (a sorted subset of fp rows) —
    the quantized-scan/rerank seam.  Backends without them still serve
    the quantized engine via the engine's encode-on-the-fly fallback."""

    backend: str
    io: IOStats

    def get_node(self, level: int, node: int) -> tuple[np.ndarray, np.ndarray]:
        ...

    def get_nodes(self, keys: list) -> list:
        ...

    def read_attrs(self, path: str) -> dict:
        ...

    def write_attrs(self, path: str, attrs: dict) -> None:
        ...

    def write_node(self, level: int, node: int, emb: np.ndarray, ids: np.ndarray) -> None:
        ...

    def append_rows(self, level: int, node: int, emb: np.ndarray, ids: np.ndarray) -> None:
        ...

    def delete_rows(self, level: int, node: int, drop_ids: np.ndarray) -> int:
        ...

    def free_slot(self, level: int, node: int) -> None:
        ...

    def close(self) -> None:
        ...


def _node_group(level: int, node: int) -> str:
    if level == 0:
        if node != 0:
            raise ValueError(f"level 0 has only the root node, got node {node}")
        return layout.ROOT
    return layout.node_group(level, node)


# ------------------------------------------------------------- fstore backend
class FStoreBackend:
    """The paper's mode: nodes as zarr-v2 groups in a directory hierarchy.

    Every hierarchy operation the index's persistence layer needs
    (``read_array``, ``create_group``, ``listdir`` …) delegates to the
    underlying ``FStore``, so this backend is a strict superset: it speaks
    the ``Store`` protocol *and* remains the writable human-readable file
    structure.
    """

    backend = "fstore"

    def __init__(self, path: str | os.PathLike | FStore, *, create: bool = False):
        self.fstore = path if isinstance(path, FStore) else FStore(path, create=create)
        self.io = IOStats()
        self.fstore.io = self.io  # FStore counts json/chunk reads into it
        self.path = self.fstore.root
        self._dim: int | None = None
        self._dtype: np.dtype | None = None

    def __getattr__(self, name):
        # hierarchy ops (read_array, create_group, listdir, exists, ...)
        if name == "fstore":  # pre-__init__ lookups must not recurse
            raise AttributeError(name)
        return getattr(self.fstore, name)

    def _node_dim(self) -> int:
        if self._dim is None:
            self._dim = int(self.read_attrs(layout.INFO).get("dim", 0))
        return self._dim

    def _node_dtype(self) -> np.dtype:
        if self._dtype is None:
            self._dtype = np.dtype(self.read_attrs(layout.INFO).get("dtype", "float16"))
        return self._dtype

    # -------------------------------------------------------------- protocol
    def get_node(self, level: int, node: int) -> tuple[np.ndarray, np.ndarray]:
        g = _node_group(level, node)
        emb_path = f"{g}/{layout.EMB}"
        if not self.fstore.exists(emb_path):
            return (
                np.zeros((0, self._node_dim()), np.float32),
                np.zeros((0,), np.int64),
            )
        emb = self.fstore.read_array(emb_path).astype(np.float32)  # f16 -> f32
        ids = self.fstore.read_array(f"{g}/{layout.IDS}")
        if emb.shape[0] > ids.shape[0]:
            # a torn append (emb grown, ids metadata not yet rewritten)
            # must stay invisible: the node's row count IS len(ids)
            emb = emb[: ids.shape[0]]
        return emb, ids

    def get_nodes(self, keys: list) -> list:
        # the file structure has no batched read primitive — that is the
        # paper's trade-off this seam makes measurable
        return [self.get_node(lv, nd) for lv, nd in keys]

    def node_rows(self, keys: list) -> list[int]:
        """Row counts without reading node data (one metadata read each)."""
        out = []
        for lv, nd in keys:
            ids_path = f"{_node_group(lv, nd)}/{layout.IDS}"
            if not self.fstore.exists(ids_path):
                out.append(0)
            else:
                out.append(int(self.fstore.array_meta(ids_path)["shape"][0]))
        return out

    # ---------------------------------------------- quantized-read fallback
    # the file structure has no quantized companion — codes are derived on
    # the fly from the full-precision rows (bit-identical to what a v3
    # blob persists, since both encode from the storage-dtype-rounded
    # rows), so the quantized engine path works unchanged, just without
    # the byte savings
    quant_format = None

    def get_quantized(self, level: int, node: int, qformat: str = "int8") -> QuantNode:
        emb, _ = self.get_node(level, node)
        return encode_node(emb, qformat)

    def get_nodes_quantized(self, keys: list, qformat: str = "int8") -> list:
        return [encode_node(emb, qformat) for emb, _ in self.get_nodes(keys)]

    def get_node_ids(self, level: int, node: int) -> np.ndarray:
        return self.get_node(level, node)[1]

    def get_node_rows(self, level: int, node: int, rows) -> tuple[np.ndarray, np.ndarray]:
        emb, ids = self.get_node(level, node)
        rows = np.asarray(rows, np.int64)
        return emb[rows], ids[rows]

    def read_attrs(self, path: str) -> dict:
        return self.fstore.read_attrs(path)

    def write_attrs(self, path: str, attrs: dict) -> None:
        self.fstore.write_attrs(path, attrs)

    def write_node(
        self,
        level: int,
        node: int,
        emb: np.ndarray,
        ids: np.ndarray,
        *,
        chunk_rows: int | None = None,
    ) -> None:
        g = _node_group(level, node)
        self.fstore.create_group(g)
        self.fstore.write_array(f"{g}/{layout.EMB}", np.asarray(emb), chunk_rows=chunk_rows)
        self.fstore.write_array(f"{g}/{layout.IDS}", np.asarray(ids))

    def append_rows(
        self,
        level: int,
        node: int,
        emb: np.ndarray,
        ids: np.ndarray,
        *,
        chunk_rows: int | None = None,
    ) -> None:
        """Grow a node in place; only the trailing chunk of each array is
        rewritten.  Creates the node when missing (the streaming build's
        first touch of a leaf)."""
        emb, ids = np.asarray(emb), np.asarray(ids)
        if emb.shape[0] != ids.shape[0]:
            raise ValueError(f"append_rows shape mismatch: emb {emb.shape} ids {ids.shape}")
        g = _node_group(level, node)
        if not self.fstore.is_group(g):
            self.fstore.create_group(g)
        # ids metadata is rewritten last: a torn append leaves extra emb
        # rows invisible to get_node (which sizes the node by its ids)
        self.fstore.append_rows(f"{g}/{layout.EMB}", emb, chunk_rows=chunk_rows)
        self.fstore.append_rows(f"{g}/{layout.IDS}", ids)

    def delete_rows(self, level: int, node: int, drop_ids: np.ndarray) -> int:
        """Physically remove the rows whose ids are in ``drop_ids``."""
        emb, ids = self.get_node(level, node)
        if len(ids) == 0:
            return 0
        keep = ~np.isin(ids, np.asarray(drop_ids, ids.dtype))
        removed = int((~keep).sum())
        if removed:
            self.write_node(level, node, emb[keep].astype(self._node_dtype()), ids[keep])
        return removed

    def free_slot(self, level: int, node: int) -> None:
        """Release a node's storage (the group vanishes from the
        hierarchy); the node id stays addressable and reads as empty."""
        self.fstore.delete(_node_group(level, node))

    def close(self) -> None:
        pass


# --------------------------------------------------------------- blob backend
def _align(n: int, page: int) -> int:
    return -(-n // page) * page


class BlobStore:
    """Page-aligned single-file backend: one ``pread`` per node.

    A v2 blob (``convert()`` default) is mutable: nodes can be rewritten,
    grown (``append_rows``), added (``write_node`` at the level's next
    index — leaf splits), or released (``free_slot``, slot returned to the
    header's free list).  A v1 blob allows only in-slot rewrites; the
    first structural mutation upgrades it to v2 in place when the reserved
    header page can hold the slot map.
    """

    backend = "blob"

    def __init__(self, path: str | os.PathLike):
        p = Path(path)
        if p.is_dir():
            p = p / BLOB_FILENAME
        if not p.is_file():
            raise FileNotFoundError(f"blob store does not exist: {p}")
        self.path = p
        self.io = IOStats()
        try:
            self._fd = os.open(p, os.O_RDWR)
            self._writable = True
        except OSError:  # EACCES, EROFS (read-only mounts), ...
            self._fd = os.open(p, os.O_RDONLY)
            self._writable = False
        head = os.pread(self._fd, 16, 0)
        if head[:8] != BLOB_MAGIC:
            os.close(self._fd)
            self._fd = -1
            raise ValueError(f"not an ecp-blob file (bad magic): {p}")
        (hlen,) = np.frombuffer(head[8:16], "<u8")
        raw = os.pread(self._fd, int(hlen), 16)
        self.io.count(16 + int(hlen), files=1, reads=2)
        self._header = json.loads(raw.decode("utf-8"))
        h = self._header
        fmt = str(h.get("format", "ecp-blob/1"))
        self.format = 3 if fmt.endswith("/3") else 2 if fmt.endswith("/2") else 1
        self.page_size = int(h["page_size"])
        self.block_bytes = int(h["block_bytes"])
        self.data_offset = int(h["data_offset"])
        self.dim = int(h["dim"])
        self.emb_dtype = zarr_to_dtype(h["emb_dtype"])
        self.ids_dtype = zarr_to_dtype(h["ids_dtype"])
        # v3: quantized companion block after each slot's fp block
        q = h.get("quant") or None
        self.quant_format: str | None = str(q["qformat"]) if q else None
        self.q_block_bytes = int(q["q_block_bytes"]) if q else 0
        self._q_dtype = qdtype(self.quant_format) if q else None
        self._stride = self.block_bytes + self.q_block_bytes
        # levels[lv] = list of per-node row counts; levels[0] = [root rows]
        self._n_rows: list[list[int]] = [list(map(int, lv)) for lv in h["levels"]]
        if self.format >= 2:
            self._slots: list[list[int]] = [list(map(int, lv)) for lv in h["slots"]]
            self._free: list[int] = sorted(int(s) for s in h.get("free_slots", []))
            self._n_slots = int(h["n_slots"])
        else:
            # v1: physical slots are implicitly (level, node)-ordered
            at = 0
            self._slots = []
            for lv in self._n_rows:
                self._slots.append(list(range(at, at + len(lv))))
                at += len(lv)
            self._free = []
            self._n_slots = at
        self._row_bytes = self.dim * self.emb_dtype.itemsize + self.ids_dtype.itemsize
        # re-entrant: append_rows/delete_rows hold it across their whole
        # read-modify-write, and call write_node (which takes it) inside
        self._lock = threading.RLock()
        # ---- MVCC: generation pinning for snapshot-isolated readers ----
        # every header install bumps _mvcc_seq; pin() records the current
        # seq and returns a BlobSnapshot whose reads see exactly that
        # header.  While pins exist, in-place updates copy-on-write into a
        # fresh slot and the old slot is RETIRED (kept out of the free
        # list) until every pin taken before the retirement is released.
        self._mvcc_seq = 0
        self._pins: dict[int, int] = {}  # pin id -> seq pinned at
        self._next_pin = 0
        self._retired: list[tuple[int, int]] = []  # (seq retired at, slot)

    # ---------------------------------------------------------------- layout
    @property
    def capacity_rows(self) -> int:
        """Rows one fixed-size block can hold (the hard per-node bound the
        lifecycle's split threshold must respect)."""
        return self.block_bytes // self._row_bytes

    def _check_key(self, level: int, node: int) -> None:
        if not (0 <= level < len(self._n_rows)):
            raise KeyError(f"no such level in blob: {level}")
        if not (0 <= node < len(self._n_rows[level])):
            raise KeyError(f"no such node in blob: lvl {level} node {node}")
        if level == 0 and node != 0:
            raise KeyError("level 0 has only the root node")

    def _slot(self, level: int, node: int) -> int:
        self._check_key(level, node)
        return self._slots[level][node]

    def _offset(self, slot: int) -> int:
        return self.data_offset + slot * self._stride

    def _parse_block(self, buf: bytes, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
        eb = n_rows * self.dim * self.emb_dtype.itemsize
        emb = (
            np.frombuffer(buf, self.emb_dtype, count=n_rows * self.dim)
            .reshape(n_rows, self.dim)
            .astype(np.float32)
        )
        ids = np.frombuffer(buf, self.ids_dtype, count=n_rows, offset=eb).copy()
        return emb, ids

    def _empty(self) -> tuple[np.ndarray, np.ndarray]:
        return np.zeros((0, self.dim), np.float32), np.zeros((0,), self.ids_dtype)

    # ------------------------------------------------------------- raw reads
    # fd/slot-map/row-counts come in as parameters so a pinned
    # ``BlobSnapshot`` (own dup'd fd, frozen maps) shares the exact same
    # read + coalescing code as the live store
    def _read_one(self, fd: int, slot: int, n_rows: int, io: IOStats):
        need = n_rows * self._row_bytes
        buf = os.pread(fd, need, self._offset(slot))
        io.count(need, reads=1)
        return self._parse_block(buf, n_rows)

    def _read_batch(self, fd: int, entries: list, out: list, io: IOStats) -> None:
        """``entries``: (slot, n_rows, out_index) triples; runs of adjacent
        slots coalesce into one pread.  On a v3 blob adjacent fp blocks
        are separated by the quantized companions, so coalescing would
        read (and count) bytes the caller never asked for — each entry
        reads on its own there."""
        entries.sort()
        if self.q_block_bytes:
            for slot, n_rows, i in entries:
                out[i] = self._read_one(fd, slot, n_rows, io)
            return
        j = 0
        while j < len(entries):
            # grow a run of consecutive slots
            r = j
            while r + 1 < len(entries) and entries[r + 1][0] == entries[r][0] + 1:
                r += 1
            first_slot = entries[j][0]
            last_slot, last_rows, _ = entries[r]
            need = (last_slot - first_slot) * self.block_bytes + last_rows * self._row_bytes
            buf = os.pread(fd, need, self._offset(first_slot))
            io.count(need, reads=1)
            for s in range(j, r + 1):
                slot, n_rows, i = entries[s]
                rel = (slot - first_slot) * self.block_bytes
                out[i] = self._parse_block(buf[rel : rel + n_rows * self._row_bytes], n_rows)
            j = r + 1

    def _read_quant_one(self, fd: int, slot: int, n_rows: int, io: IOStats) -> QuantNode:
        """Read one slot's quantized companion: [scale f32][offset f32]
        [codes n_rows*dim] right after the fp block."""
        need = 8 + n_rows * self.dim * self._q_dtype.itemsize
        buf = os.pread(fd, need, self._offset(slot) + self.block_bytes)
        io.count(need, reads=1)
        scale, offset = np.frombuffer(buf, "<f4", count=2)
        codes = (
            np.frombuffer(buf, self._q_dtype, count=n_rows * self.dim, offset=8)
            .reshape(n_rows, self.dim)
            .copy()
        )
        return QuantNode(codes, float(scale), float(offset), self.quant_format)

    def _read_ids_one(self, fd: int, slot: int, n_rows: int, io: IOStats) -> np.ndarray:
        """Read only a block's ids segment (tombstone/exclude filtering of
        a quantized scan — the emb rows stay untouched on disk)."""
        eb = n_rows * self.dim * self.emb_dtype.itemsize
        need = n_rows * self.ids_dtype.itemsize
        buf = os.pread(fd, need, self._offset(slot) + eb)
        io.count(need, reads=1)
        return np.frombuffer(buf, self.ids_dtype, count=n_rows).copy()

    # runs of requested rows whose index difference is <= this merge into
    # one pread.  A difference of 1 is *adjacent* (merging is free), so 1
    # is the bytes-optimal floor for both spans: rerank reads sit on the
    # cold path where bytes_read is the contended budget, so neither span
    # trades bytes for syscalls
    _ROW_READ_GAP = 1
    _IDS_READ_GAP = 1

    def _read_rows_one(
        self, fd: int, slot: int, n_rows: int, rows: np.ndarray, io: IOStats
    ) -> tuple[np.ndarray, np.ndarray]:
        """Read a sorted subset of one block's rows: coalesced range
        preads over the emb rows and over the ids rows independently (the
        full-precision rerank's partial fetch)."""
        esz = self.dim * self.emb_dtype.itemsize
        base = self._offset(slot)
        emb = np.empty((len(rows), self.dim), self.emb_dtype)
        j = 0
        while j < len(rows):
            r = j
            while r + 1 < len(rows) and rows[r + 1] - rows[r] <= self._ROW_READ_GAP:
                r += 1
            a, b = int(rows[j]), int(rows[r])
            need = (b - a + 1) * esz
            buf = os.pread(fd, need, base + a * esz)
            io.count(need, reads=1)
            span = np.frombuffer(buf, self.emb_dtype, count=(b - a + 1) * self.dim)
            span = span.reshape(b - a + 1, self.dim)
            emb[j : r + 1] = span[rows[j : r + 1] - a]
            j = r + 1
        isz = self.ids_dtype.itemsize
        ibase = base + n_rows * esz
        ids = np.empty(len(rows), self.ids_dtype)
        j = 0
        while j < len(rows):
            r = j
            while r + 1 < len(rows) and rows[r + 1] - rows[r] <= self._IDS_READ_GAP:
                r += 1
            a, b = int(rows[j]), int(rows[r])
            need = (b - a + 1) * isz
            buf = os.pread(fd, need, ibase + a * isz)
            io.count(need, reads=1)
            span = np.frombuffer(buf, self.ids_dtype, count=b - a + 1)
            ids[j : r + 1] = span[rows[j : r + 1] - a]
            j = r + 1
        return emb.astype(np.float32), ids

    # -------------------------------------------------------------- protocol
    def get_node(self, level: int, node: int) -> tuple[np.ndarray, np.ndarray]:
        self._check_key(level, node)
        n_rows = self._n_rows[level][node]
        if n_rows == 0:
            return self._empty()
        return self._read_one(self._fd, self._slots[level][node], n_rows, self.io)

    def get_nodes(self, keys: list) -> list:
        """Batched read; runs of adjacent slots coalesce into one pread."""
        out: list = [None] * len(keys)
        entries = []
        for i, (lv, nd) in enumerate(keys):
            self._check_key(lv, nd)
            if self._n_rows[lv][nd] == 0:
                out[i] = self._empty()
            else:
                entries.append((self._slots[lv][nd], self._n_rows[lv][nd], i))
        self._read_batch(self._fd, entries, out, self.io)
        return out

    def node_rows(self, keys: list) -> list[int]:
        """Row counts straight from the in-memory header (no I/O)."""
        return [self._n_rows[lv][nd] for lv, nd in keys]

    # ------------------------------------------------------ quantized reads
    def _empty_quant(self, qformat: str) -> QuantNode:
        return QuantNode(np.zeros((0, self.dim), qdtype(qformat)), 0.0, 0.0, qformat)

    def get_quantized(self, level: int, node: int, qformat: str = "int8") -> QuantNode:
        """One node's quantized rows.  A v3 blob reads the persisted
        companion block (``qformat`` is ignored — the blob has one); a
        v1/v2 blob encodes on the fly from the fp rows (same codes, no
        byte savings)."""
        self._check_key(level, node)
        n_rows = self._n_rows[level][node]
        if self.quant_format is None:
            if n_rows == 0:
                return self._empty_quant(qformat)
            emb, _ = self.get_node(level, node)
            return encode_node(emb, qformat)
        if n_rows == 0:
            return self._empty_quant(self.quant_format)
        return self._read_quant_one(self._fd, self._slots[level][node], n_rows, self.io)

    def get_nodes_quantized(self, keys: list, qformat: str = "int8") -> list:
        return [self.get_quantized(lv, nd, qformat) for lv, nd in keys]

    def get_node_ids(self, level: int, node: int) -> np.ndarray:
        """Only a node's ids (the quantized scan needs them just for
        tombstone/exclude filtering)."""
        self._check_key(level, node)
        n_rows = self._n_rows[level][node]
        if n_rows == 0:
            return np.zeros((0,), self.ids_dtype)
        return self._read_ids_one(self._fd, self._slots[level][node], n_rows, self.io)

    def get_node_rows(self, level: int, node: int, rows) -> tuple[np.ndarray, np.ndarray]:
        """Read a subset of one node's full-precision rows (sorted row
        indices) — the rerank's partial fetch."""
        self._check_key(level, node)
        rows = np.asarray(rows, np.int64)
        n_rows = self._n_rows[level][node]
        if len(rows) == 0:
            return self._empty()
        if rows[0] < 0 or rows[-1] >= n_rows:
            raise IndexError(f"rows out of range for lvl {level} node {node}")
        return self._read_rows_one(self._fd, self._slots[level][node], n_rows, rows, self.io)

    def read_attrs(self, path: str) -> dict:
        if path == layout.INFO:
            return dict(self._header["info"])
        return {}

    def write_attrs(self, path: str, attrs: dict) -> None:
        if not self._writable:
            raise PermissionError(f"blob store opened read-only: {self.path}")
        if path != layout.INFO:
            raise ValueError(
                f"blob store only holds '{layout.INFO}' attributes, not {path!r}"
            )
        with self._lock:
            old = self._header
            self._header = dict(old)
            self._header["info"] = dict(attrs)
            try:
                self._rewrite_header_locked()
            except ValueError:
                # an oversized header (e.g. a huge tombstone list) raises
                # BEFORE any byte is written; in-memory state must agree
                # with the disk, so the old attrs come back
                self._header = old
                raise

    def _prep_rows(self, emb, ids) -> tuple[np.ndarray, np.ndarray, bytes]:
        emb = np.ascontiguousarray(np.asarray(emb), dtype=self.emb_dtype)
        ids = np.ascontiguousarray(np.asarray(ids), dtype=self.ids_dtype)
        if emb.ndim != 2 or emb.shape[1] != self.dim or emb.shape[0] != ids.shape[0]:
            raise ValueError(
                f"write_node shape mismatch: emb {emb.shape} ids {ids.shape} dim {self.dim}"
            )
        need = emb.shape[0] * self._row_bytes
        if need > self.block_bytes:
            raise ValueError(
                f"node data ({need} B) exceeds the fixed block size "
                f"({self.block_bytes} B = {self.capacity_rows} rows); split the "
                "node first or rebuild the blob with convert()"
            )
        block = emb.tobytes() + ids.tobytes()
        block += b"\0" * (self.block_bytes - len(block))
        if self.quant_format is not None:
            # re-encode the companion from the storage-dtype-rounded rows
            # so codes match what a reader would encode from get_node
            qn = encode_node(np.asarray(emb, np.float32), self.quant_format)
            qraw = (
                np.float32(qn.scale).tobytes()
                + np.float32(qn.offset).tobytes()
                + qn.codes.tobytes()
            )
            if len(qraw) > self.q_block_bytes:
                raise ValueError(
                    f"quantized node data ({len(qraw)} B) exceeds the quant "
                    f"block size ({self.q_block_bytes} B); rebuild with convert()"
                )
            block += qraw + b"\0" * (self.q_block_bytes - len(qraw))
        return emb, ids, block

    def write_node(self, level: int, node: int, emb: np.ndarray, ids: np.ndarray) -> None:
        """In-place node update; ``node == len(level)`` appends a new node
        (v2: slot from the free list, else the file grows by one block).

        NOT crash-atomic: the block and header are two in-place writes, so
        a crash between them can leave a stale row count over new bytes.
        The blob is a derived serving artifact — the writable source of
        truth is the fstore hierarchy (every write there goes through
        tmp + os.replace); rebuild a torn blob with ``convert()``.
        """
        if not self._writable:
            raise PermissionError(f"blob store opened read-only: {self.path}")
        emb, ids, block = self._prep_rows(emb, ids)
        n_rows = emb.shape[0]
        with self._lock:
            if not (0 <= level < len(self._n_rows)):
                raise KeyError(f"no such level in blob: {level}")
            n_level = len(self._n_rows[level])
            if level == 0 and node != 0:
                raise KeyError("level 0 has only the root node")
            if node == n_level:
                # structural append: nodes are numbered densely per level
                slot, commit = self._alloc_slot_locked(level, node, n_rows)
            elif 0 <= node < n_level:
                slot = self._slots[level][node]
                if slot < 0:  # rewriting a released node re-allocates storage
                    slot, commit = self._alloc_slot_locked(level, node, n_rows)
                elif self._pins:
                    # copy-on-write: a pinned snapshot may still read the
                    # old block, so the update lands in a fresh slot and
                    # the old one is retired until those pins release
                    slot, commit = self._alloc_slot_locked(
                        level, node, n_rows, retire=slot
                    )
                else:
                    def commit() -> None:
                        self._n_rows[level][node] = n_rows
                        self._rewrite_header_locked()
            else:
                raise KeyError(
                    f"blob nodes are dense per level: next node of lvl {level} "
                    f"is {n_level}, got {node}"
                )
            os.pwrite(self._fd, block, self._offset(slot))
            commit()

    def _v2_candidate_locked(self, rows, slots, free, n_slots) -> tuple[bytes, dict]:
        """Serialize a CANDIDATE v2 header (nothing mutates; an oversized
        header raises here with file and in-memory maps untouched).  Both
        structural mutators build their candidates through this one place
        so the header schema cannot diverge between them."""
        header = dict(self._header)
        # the mutable form: /3 when this blob carries quantized companions
        # (the "quant" section rides along in the header copy), else /2
        header["format"] = "ecp-blob/3" if self.quant_format else "ecp-blob/2"
        header["levels"] = rows
        header["slots"] = slots
        header["free_slots"] = free
        header["n_slots"] = n_slots
        raw = self._check_fits(json.dumps(header, sort_keys=True).encode("utf-8"))
        return raw, header

    def _install_v2_locked(self, raw: bytes, header: dict) -> None:
        """Adopt a candidate header (in memory + on disk)."""
        self.format = max(2, self.format)
        self._header = header
        self._n_rows = header["levels"]
        self._slots = header["slots"]
        self._free = header["free_slots"]
        self._n_slots = header["n_slots"]
        self._pwrite_header_locked(raw)

    def ensure_capacity(self, level: int, new_nodes: int) -> None:
        """Raise — without writing or mutating anything — if appending
        ``new_nodes`` nodes at ``level`` could not fit the reserved header
        region (covers the v1→v2 upgrade too).  Multi-node mutations
        (leaf splits) pre-flight through this so a mid-sequence header
        overflow can never strand already-written nodes."""
        if new_nodes <= 0:
            return
        with self._lock:
            if not (0 <= level < len(self._n_rows)):
                raise KeyError(f"no such level in blob: {level}")
            cand_slots = [list(lv) for lv in self._slots]
            cand_rows = [list(lv) for lv in self._n_rows]
            free = list(self._free)
            n_slots = self._n_slots
            for _ in range(new_nodes):
                slot = free.pop(0) if free else n_slots
                n_slots = max(n_slots, slot + 1)
                cand_slots[level].append(slot)
                cand_rows[level].append(0)
            self._v2_candidate_locked(cand_rows, cand_slots, free, n_slots)

    def _alloc_slot_locked(self, level: int, node: int, n_rows: int, *, retire: int | None = None):
        """Pick a physical slot for a new/re-allocated node; the returned
        commit closure installs the pre-serialized candidate header after
        the block write succeeds.  ``retire`` is the node's previous slot
        when this allocation is a copy-on-write around pinned snapshots:
        it is dropped from the slot map but NOT freed — it joins the
        retired list until every pin older than the install releases.
        (Any slot already on the free list is safe to hand out: it was
        unreferenced in every header a current pin could have pinned.)"""
        new_node = node == len(self._n_rows[level])
        slot = self._free[0] if self._free else self._n_slots
        cand_slots = [list(lv) for lv in self._slots]
        cand_rows = [list(lv) for lv in self._n_rows]
        if new_node:
            cand_slots[level].append(slot)
            cand_rows[level].append(n_rows)
        else:
            cand_slots[level][node] = slot
            cand_rows[level][node] = n_rows
        raw, header = self._v2_candidate_locked(
            cand_rows,
            cand_slots,
            [s for s in self._free if s != slot],
            max(self._n_slots, slot + 1),
        )

        def commit() -> None:
            self._install_v2_locked(raw, header)
            if retire is not None and retire >= 0:
                self._retired.append((self._mvcc_seq, retire))

        return slot, commit

    def append_rows(self, level: int, node: int, emb: np.ndarray, ids: np.ndarray) -> None:
        """Grow a node in place.  The block layout is emb-rows-then-ids, so
        growing rewrites the whole block (one pread + one pwrite); the
        lock is held across the read-modify-write so concurrent appends
        cannot lose each other's rows."""
        with self._lock:
            old_emb, old_ids = self.get_node(level, node)
            emb = np.concatenate(
                [old_emb.astype(self.emb_dtype), np.asarray(emb, self.emb_dtype)]
            )
            ids = np.concatenate([old_ids, np.asarray(ids, self.ids_dtype)])
            self.write_node(level, node, emb, ids)

    def delete_rows(self, level: int, node: int, drop_ids: np.ndarray) -> int:
        with self._lock:
            emb, ids = self.get_node(level, node)
            if len(ids) == 0:
                return 0
            keep = ~np.isin(ids, np.asarray(drop_ids, ids.dtype))
            removed = int((~keep).sum())
            if removed:
                self.write_node(level, node, emb[keep], ids[keep])
            return removed

    def free_slot(self, level: int, node: int) -> None:
        """Release a node's block back to the free list; the node id stays
        valid and reads as empty until something is written to it again.
        With pinned snapshots outstanding the slot is retired instead of
        freed (a pin taken before the release may still read it)."""
        if not self._writable:
            raise PermissionError(f"blob store opened read-only: {self.path}")
        with self._lock:
            self._check_key(level, node)
            slot = self._slots[level][node]
            if slot < 0 and self._n_rows[level][node] == 0:
                return
            retire = bool(self._pins) and slot >= 0
            cand_slots = [list(lv) for lv in self._slots]
            cand_rows = [list(lv) for lv in self._n_rows]
            cand_slots[level][node] = -1
            cand_rows[level][node] = 0
            free = set(self._free)
            if slot >= 0 and not retire:
                free.add(slot)
            raw, header = self._v2_candidate_locked(
                cand_rows, cand_slots, sorted(free), self._n_slots
            )
            self._install_v2_locked(raw, header)
            if retire:
                self._retired.append((self._mvcc_seq, slot))

    def _check_fits(self, raw: bytes) -> bytes:
        if 16 + len(raw) > self.data_offset:
            raise ValueError(
                "blob header grew past the data region (more tombstones or "
                "nodes than the reserved header pages can hold); compact() "
                "the index or rebuild the blob with convert()"
            )
        return raw

    def _pwrite_header_locked(self, raw: bytes) -> None:
        """THE header write: every path (row updates, slot allocation,
        free_slot, attrs) funnels through here so padding/length framing
        can never diverge — and every install is a new MVCC version."""
        self._mvcc_seq += 1
        pad = b" " * (self.data_offset - 16 - len(raw))
        os.pwrite(self._fd, BLOB_MAGIC + len(raw).to_bytes(8, "little") + raw + pad, 0)

    # ------------------------------------------------- snapshot pinning (MVCC)
    def pin(self) -> "BlobSnapshot":
        """Pin the current header and return a read-only ``BlobSnapshot``
        whose every read sees exactly this version of the index, no matter
        what the writer does afterwards (in-place updates copy-on-write
        around pinned slots; a compaction's ``os.replace`` cannot touch
        the snapshot's dup'd fd).  Release with ``BlobSnapshot.close()``.

        Retired-but-pinned slots live only in memory: a crash while pins
        are outstanding leaks them from the persisted free list (harmless
        — ``compact()`` rebuilds the file and reclaims everything)."""
        with self._lock:
            pin_id = self._next_pin
            self._next_pin += 1
            self._pins[pin_id] = self._mvcc_seq
            return BlobSnapshot(self, pin_id)

    def _release_pin(self, pin_id: int) -> None:
        with self._lock:
            self._pins.pop(pin_id, None)
            self._recycle_locked()

    def _recycle_locked(self) -> None:
        """Return retired slots to the (in-memory) free list once no pin
        predates their retirement; the persisted free list catches up on
        the next header write."""
        if not self._retired:
            return
        floor = min(self._pins.values()) if self._pins else None
        still, freed = [], []
        for seq, slot in self._retired:
            # a pin at seq P sees the header as of P; the slot became
            # unreferenced at seq > P only for pins with P < seq
            if floor is None or seq <= floor:
                freed.append(slot)
            else:
                still.append((seq, slot))
        if freed:
            self._retired = still
            self._free = sorted(set(self._free) | set(freed))

    def _serialize_header_locked(self) -> bytes:
        self._header["levels"] = self._n_rows
        if self.format >= 2:
            self._header["format"] = "ecp-blob/3" if self.quant_format else "ecp-blob/2"
            self._header["slots"] = self._slots
            self._header["free_slots"] = self._free
            self._header["n_slots"] = self._n_slots
        return self._check_fits(json.dumps(self._header, sort_keys=True).encode("utf-8"))

    def _rewrite_header_locked(self) -> None:
        self._pwrite_header_locked(self._serialize_header_locked())

    def close(self) -> None:
        if getattr(self, "_fd", -1) >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except OSError:
            pass


# ------------------------------------------------------------- blob snapshot
class BlobSnapshot:
    """A pinned, read-only view of one ``BlobStore`` version (the
    ``SnapshotView`` of the serving subsystem).

    Created by ``BlobStore.pin()`` under the store lock: it copies the
    row-count/slot maps and info of the pinned header and dups the file
    descriptor, so

      * reads are lock-free and bit-identical to what the live store
        would have returned at pin time — writers copy-on-write around
        pinned slots, so the bytes under this view never change;
      * it survives a blob compaction's ``os.replace`` (the dup'd fd
        keeps the replaced file alive until the snapshot closes);
      * N snapshot readers share one physical file with a single writer.

    It speaks the read side of the ``Store`` protocol (``get_node``,
    ``get_nodes``, ``node_rows``, ``read_attrs``, ``io``); every write
    raises ``PermissionError``.  ``close()`` releases the pin (idempotent)
    so the parent can recycle retired slots.
    """

    backend = "blob+snapshot"

    def __init__(self, parent: BlobStore, pin_id: int):
        # runs under the parent's (re-entrant) lock, inside pin()
        self._parent = parent
        self._pin_id = pin_id
        self._fd = os.dup(parent._fd)
        self.path = parent.path
        self.io = IOStats()
        self.pinned_seq = parent._mvcc_seq
        self._n_rows = [list(lv) for lv in parent._n_rows]
        self._slots = [list(lv) for lv in parent._slots]
        self._info = dict(parent._header.get("info", {}))
        self.generation = int(self._info.get(layout.GENERATION, 0))

    # ------------------------------------------------------------ read side
    def _check_key(self, level: int, node: int) -> None:
        if not (0 <= level < len(self._n_rows)):
            raise KeyError(f"no such level in blob snapshot: {level}")
        if not (0 <= node < len(self._n_rows[level])):
            raise KeyError(f"no such node in blob snapshot: lvl {level} node {node}")

    def get_node(self, level: int, node: int) -> tuple[np.ndarray, np.ndarray]:
        self._check_key(level, node)
        n_rows = self._n_rows[level][node]
        if n_rows == 0:
            return self._parent._empty()
        return self._parent._read_one(self._fd, self._slots[level][node], n_rows, self.io)

    def get_nodes(self, keys: list) -> list:
        out: list = [None] * len(keys)
        entries = []
        for i, (lv, nd) in enumerate(keys):
            self._check_key(lv, nd)
            if self._n_rows[lv][nd] == 0:
                out[i] = self._parent._empty()
            else:
                entries.append((self._slots[lv][nd], self._n_rows[lv][nd], i))
        self._parent._read_batch(self._fd, entries, out, self.io)
        return out

    def node_rows(self, keys: list) -> list[int]:
        return [self._n_rows[lv][nd] for lv, nd in keys]

    @property
    def quant_format(self):
        return self._parent.quant_format

    def get_quantized(self, level: int, node: int, qformat: str = "int8") -> QuantNode:
        self._check_key(level, node)
        p = self._parent
        n_rows = self._n_rows[level][node]
        if p.quant_format is None:
            if n_rows == 0:
                return p._empty_quant(qformat)
            emb, _ = self.get_node(level, node)
            return encode_node(emb, qformat)
        if n_rows == 0:
            return p._empty_quant(p.quant_format)
        return p._read_quant_one(self._fd, self._slots[level][node], n_rows, self.io)

    def get_nodes_quantized(self, keys: list, qformat: str = "int8") -> list:
        return [self.get_quantized(lv, nd, qformat) for lv, nd in keys]

    def get_node_ids(self, level: int, node: int) -> np.ndarray:
        self._check_key(level, node)
        p = self._parent
        n_rows = self._n_rows[level][node]
        if n_rows == 0:
            return np.zeros((0,), p.ids_dtype)
        return p._read_ids_one(self._fd, self._slots[level][node], n_rows, self.io)

    def get_node_rows(self, level: int, node: int, rows) -> tuple[np.ndarray, np.ndarray]:
        self._check_key(level, node)
        p = self._parent
        rows = np.asarray(rows, np.int64)
        n_rows = self._n_rows[level][node]
        if len(rows) == 0:
            return p._empty()
        if rows[0] < 0 or rows[-1] >= n_rows:
            raise IndexError(f"rows out of range for lvl {level} node {node}")
        return p._read_rows_one(self._fd, self._slots[level][node], n_rows, rows, self.io)

    def read_attrs(self, path: str) -> dict:
        if path == layout.INFO:
            return dict(self._info)
        return {}

    # ----------------------------------------------------------- write side
    def _read_only(self, *_a, **_k):
        raise PermissionError(
            "blob snapshot is a pinned read-only view; mutate the live store"
        )

    write_attrs = write_node = append_rows = delete_rows = free_slot = _read_only

    # ------------------------------------------------------------ lifecycle
    @property
    def closed(self) -> bool:
        return self._fd < 0

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
            self._parent._release_pin(self._pin_id)

    def __enter__(self) -> "BlobSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except OSError:
            pass


def convert(
    src: "Store | str | os.PathLike",
    dst: str | os.PathLike,
    *,
    page_size: int = 4096,
    format: int = 2,
    quant: str | None = None,
) -> Path:
    """Serialize any ``Store``'s index into a page-aligned blob file.

    Returns the path of the written blob.  Embeddings are stored in the
    index's own storage dtype (``info['dtype']``, e.g. float16) so reads
    are bit-identical with the source backend's ``get_node``.

    ``format=2`` (default) writes the mutable header (slot map + free
    list) and sizes blocks so a full ``cluster_cap`` leaf fits — the form
    ``ECPIndex.insert``/``delete``/``compact`` require.  ``format=1``
    writes the legacy fixed-layout header.

    ``quant="int8"|"float16"`` additionally writes a quantized companion
    block per slot (blob format v3, mutable): the compressed-scan input
    of the device-resident scoring pipeline.  Converting an existing v2
    blob with ``quant=`` set is the v2->v3 upgrade path.
    """
    if format not in (1, 2):
        raise ValueError(f"unknown blob format: {format!r} (1|2)")
    if quant is not None:
        if quant not in QFORMATS:
            raise ValueError(f"unknown quant format: {quant!r} {QFORMATS}")
        if format == 1:
            raise ValueError("quantized companions need the mutable format (format=2)")
    store = src if isinstance(src, Store) else open_store(src)
    info = store.read_attrs(layout.INFO)
    if not info:
        raise ValueError("source store has no index info; not an eCP index?")
    dim = int(info["dim"])
    emb_dt = np.dtype(info.get("dtype", "float16"))
    ids_dt = np.dtype(np.int64)
    levels = int(info["levels"])
    nodes_per_level = [int(x) for x in info["nodes_per_level"]]

    keys = [(0, 0)] + [
        (lv, nd) for lv in range(1, levels + 1) for nd in range(nodes_per_level[lv - 1])
    ]
    n_rows: list[list[int]] = [[] for _ in range(levels + 1)]
    row_bytes = dim * emb_dt.itemsize + ids_dt.itemsize
    max_block = page_size
    if format >= 2:
        # a mutable blob must fit any legal leaf: inserts grow a leaf up to
        # cluster_cap rows before the lifecycle splits it
        max_block = max(max_block, int(info.get("cluster_cap", 0)) * row_bytes)

    dst = Path(dst)
    if dst.is_dir():
        dst = dst / BLOB_FILENAME
    dst.parent.mkdir(parents=True, exist_ok=True)

    # pass 1: row counts to size the fixed blocks — metadata only where the
    # backend supports it (node_rows), never the embedding bytes themselves
    batch = 512
    rows_fn = getattr(store, "node_rows", None)
    if rows_fn is not None:
        counts = rows_fn(keys)
    else:
        counts = []
        for lo in range(0, len(keys), batch):
            counts.extend(len(ids) for _, ids in store.get_nodes(keys[lo : lo + batch]))
    for (lv, nd), n in zip(keys, counts):
        n_rows[lv].append(int(n))
        max_block = max(max_block, int(n) * row_bytes)
    block_bytes = _align(max_block, page_size)
    q_block_bytes = 0
    if quant is not None:
        # the companion must hold any node the fp block can: size it for
        # capacity_rows so in-place updates never outgrow it
        q_row = dim * qdtype(quant).itemsize
        q_block_bytes = _align(8 + (block_bytes // row_bytes) * q_row, page_size)

    header = {
        "format": "ecp-blob/3" if quant else f"ecp-blob/{format}",
        "page_size": page_size,
        "block_bytes": block_bytes,
        "dim": dim,
        "emb_dtype": dtype_to_zarr(emb_dt),
        "ids_dtype": dtype_to_zarr(ids_dt),
        "info": dict(info),
        "levels": n_rows,
    }
    if quant is not None:
        header["quant"] = {"qformat": quant, "q_block_bytes": q_block_bytes}
    if format >= 2:
        at = 0
        slots = []
        for lv in n_rows:
            slots.append(list(range(at, at + len(lv))))
            at += len(lv)
        header["slots"] = slots
        header["free_slots"] = []
        header["n_slots"] = at
    # reserve spare pages so in-place header rewrites never collide with
    # the data region: one page for row-count churn (v1) plus, for the
    # mutable format, room for the slot map / free list to grow as splits
    # append nodes AND for the tombstone list (info.deleted_ids) — budgeted
    # at every item deleted at once, ~12 JSON bytes per id.  Deleting past
    # that budget raises cleanly (compact() shrinks the list to zero).
    raw = json.dumps(header, sort_keys=True).encode("utf-8")
    slack = page_size
    if format >= 2:
        slack += _align(len(keys) * 16 + page_size, page_size)
        slack += _align(int(info.get("n_items", 0)) * 12 + page_size, page_size)
    data_offset = _align(16 + len(raw), page_size) + slack
    header["data_offset"] = data_offset
    raw = json.dumps(header, sort_keys=True).encode("utf-8")

    tmp = dst.with_suffix(dst.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(BLOB_MAGIC)
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        f.write(b" " * (data_offset - 16 - len(raw)))
        for lo in range(0, len(keys), batch):
            for emb, ids in store.get_nodes(keys[lo : lo + batch]):
                emb = np.ascontiguousarray(emb, dtype=emb_dt)
                b = emb.tobytes() + np.ascontiguousarray(ids, dtype=ids_dt).tobytes()
                f.write(b)
                f.write(b"\0" * (block_bytes - len(b)))
                if quant is not None:
                    # encode from the storage-dtype-rounded rows: a reader
                    # quantizing get_node's output lands on the same codes
                    qn = encode_node(np.asarray(emb, np.float32), quant)
                    qb = (
                        np.float32(qn.scale).tobytes()
                        + np.float32(qn.offset).tobytes()
                        + qn.codes.tobytes()
                    )
                    f.write(qb)
                    f.write(b"\0" * (q_block_bytes - len(qb)))
    os.replace(tmp, dst)
    return dst


# --------------------------------------------------------- norm-aware payloads
class NodeNormCache:
    """Bounded LRU of per-node squared-norm vectors, keyed ``(level, node)``.

    l2 scoring decomposes as ``|q|^2 + |c|^2 - 2 q.c``; the ``|c|^2`` term
    depends only on the node's stored embeddings, yet the traversal used
    to recompute ``(c * c).sum(-1)`` on every visit of every query.  The
    search engine attaches this cache next to its ``NodeCache`` so a
    node's norms are computed once per residency and shared across
    queries (``np_distances(..., c_sqnorms=...)`` — bit-identical by
    construction since the cached value IS that exact expression).

    Entries are one float32 per node row (~1/(dim) of the node payload);
    ``max_entries`` bounds residency with LRU eviction.  Each entry holds
    a weakref to the exact embedding array it was computed from and is
    only served for that same array — so the norms are never fresher or
    staler than the node payload the caller is scoring (an in-place
    ``Store.write_node`` rewrite produces a new array and transparently
    recomputes, without pinning evicted payloads alive).
    """

    def __init__(self, max_entries: int = 16384):
        self.max_entries = max(1, int(max_entries))
        # key -> (weakref-to-emb, sqnorms)
        self._d: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, level: int, node: int, emb: np.ndarray) -> np.ndarray:
        key = (level, node)
        with self._lock:
            v = self._d.get(key)
            if v is not None and v[0]() is emb:
                self._d.move_to_end(key)
                return v[1]
        sq = (emb * emb).sum(-1)
        with self._lock:
            self._d[key] = (weakref.ref(emb), sq)
            self._d.move_to_end(key)
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)
        return sq

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


# ------------------------------------------------------------------- factory
def open_store(
    path: "str | os.PathLike | Store",
    backend: str = "auto",
    *,
    create: bool = False,
) -> Store:
    """Open an index's node storage.

    backend="fstore"  -> the zarr-v2 directory hierarchy (paper's mode).
    backend="blob"    -> the page-aligned single-file form (``convert()``).
    backend="auto"    -> blob when ``path`` is a blob file or a directory
                         holding ``index.blob``; otherwise fstore.
    A ``"<name>+prefetch"`` backend (async prefetch) is not ported yet.
    """
    if backend.endswith("+prefetch"):
        raise NotImplementedError(
            "async prefetch stores are not ported yet (ROADMAP Queue 1 #2: "
            "prefetch); open the index without '+prefetch'"
        )
    if isinstance(path, Store):
        return path
    if isinstance(path, FStore):
        return FStoreBackend(path)
    p = Path(path)
    if backend == "auto":
        backend = "blob" if p.is_file() or (p / BLOB_FILENAME).is_file() else "fstore"
    if backend == "fstore":
        return FStoreBackend(p, create=create)
    if backend == "blob":
        if create:
            raise ValueError("blob stores are created with convert(), not create=True")
        return BlobStore(p)
    raise ValueError(f"unknown store backend: {backend!r} (fstore|blob|auto)")
