"""fstore — a minimal, zero-dependency, zarr-v2-compatible file structure.

The paper's point is that the index *is* a file structure: every node is a
directory, every array a set of raw chunk files plus JSON metadata, so the
index is readable from any language (and by humans with ``ls`` + ``xxd``).
Zarr itself is not installed in this environment, so we implement the v2
on-disk layout directly:

  group/            .zgroup   -> {"zarr_format": 2}
                    .zattrs   -> arbitrary JSON attributes
  array/            .zarray   -> shape/chunks/dtype/order metadata, compressor
                                 null (raw little-endian C-order bytes)
                    0.0, 1.0  -> chunk files (row-major chunk grid indices)

Arrays written here are readable by the real ``zarr`` library and vice versa
(for compressor=None arrays), which preserves the paper's language-agnostic
claim. Only the features the index needs are implemented: C-order raw chunks,
chunking along the leading axis, partial (chunk-aligned) reads.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Iterator

import numpy as np

__all__ = ["FStore", "dtype_to_zarr", "zarr_to_dtype"]

_ENDIAN = "<"  # little-endian on disk, always


def dtype_to_zarr(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    kind = dt.kind
    if kind not in "fiub":
        raise TypeError(f"unsupported dtype for fstore: {dt}")
    if kind == "b":
        return "|b1"
    return f"{_ENDIAN}{kind}{dt.itemsize}"


def zarr_to_dtype(s: str) -> np.dtype:
    return np.dtype(s)


class FStore:
    """A root directory acting as a zarr-v2 style hierarchical store."""

    def __init__(self, root: str | os.PathLike, *, create: bool = False):
        self.root = Path(root)
        if create:
            self.root.mkdir(parents=True, exist_ok=True)
            self._write_json(self.root / ".zgroup", {"zarr_format": 2})
        if not self.root.is_dir():
            raise FileNotFoundError(f"fstore root does not exist: {self.root}")
        self._root = self.root.resolve()  # resolved ONCE; _p is on the hot path
        self._lock = threading.Lock()
        self.io = None  # optional IOStats sink (set by FStoreBackend)

    # ---------------------------------------------------------------- paths
    def _p(self, path: str) -> Path:
        # Fast path: relative, '..'-free paths join the pre-resolved root
        # without any syscalls (this is under every node read).  Only
        # lexical escapes (absolute paths, '..' segments) pay for a resolve
        # check; a symlink planted INSIDE the store pointing outside is
        # deliberately not re-checked per access — the store owns its tree.
        path = str(path)
        if (
            path.startswith(("/", "\\"))
            or ":" in path.split("/", 1)[0]  # windows drive-absolute
            or ".." in path.replace("\\", "/").split("/")
        ):
            p = (self._root / path).resolve()
            if self._root not in p.parents and p != self._root:
                raise ValueError(f"path escapes store root: {path}")
            return p
        return self._root / path

    def _count_io(self, nbytes: int, *, files: int = 1, reads: int = 1) -> None:
        if self.io is not None:
            self.io.count(nbytes, files=files, reads=reads)

    def exists(self, path: str) -> bool:
        return self._p(path).exists()

    def is_array(self, path: str) -> bool:
        return (self._p(path) / ".zarray").exists()

    def is_group(self, path: str) -> bool:
        return (self._p(path) / ".zgroup").exists()

    def listdir(self, path: str = "") -> list[str]:
        p = self._p(path)
        if not p.is_dir():
            return []
        return sorted(c.name for c in p.iterdir() if not c.name.startswith("."))

    def walk_arrays(self, path: str = "") -> Iterator[str]:
        base = self._p(path)
        for dirpath, dirnames, filenames in os.walk(base):
            if ".zarray" in filenames:
                yield str(Path(dirpath).relative_to(self.root))
                dirnames.clear()

    def delete(self, path: str) -> None:
        p = self._p(path)
        if p.exists():
            shutil.rmtree(p)

    # ---------------------------------------------------------------- json
    @staticmethod
    def _write_json(p: Path, obj: Any) -> None:
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(obj, indent=2, sort_keys=True))
        os.replace(tmp, p)

    def _read_json(self, p: Path) -> Any:
        raw = p.read_bytes()
        self._count_io(len(raw))
        return json.loads(raw)

    # ---------------------------------------------------------------- groups
    def create_group(self, path: str, attrs: dict | None = None) -> None:
        p = self._p(path)
        p.mkdir(parents=True, exist_ok=True)
        self._write_json(p / ".zgroup", {"zarr_format": 2})
        if attrs:
            self.write_attrs(path, attrs)

    def write_attrs(self, path: str, attrs: dict) -> None:
        p = self._p(path)
        p.mkdir(parents=True, exist_ok=True)
        self._write_json(p / ".zattrs", attrs)

    def read_attrs(self, path: str) -> dict:
        p = self._p(path) / ".zattrs"
        if not p.exists():
            return {}
        return self._read_json(p)

    # ---------------------------------------------------------------- arrays
    def write_array(
        self,
        path: str,
        arr: np.ndarray,
        *,
        chunk_rows: int | None = None,
        attrs: dict | None = None,
    ) -> None:
        """Write ``arr`` as a raw-chunked zarr-v2 array (chunked on axis 0)."""
        arr = np.ascontiguousarray(arr)
        p = self._p(path)
        p.mkdir(parents=True, exist_ok=True)
        shape = list(arr.shape) if arr.ndim else [1]
        data = arr.reshape(shape)
        rows = shape[0]
        cr = rows if chunk_rows is None else max(1, min(int(chunk_rows), max(rows, 1)))
        if rows == 0:
            cr = 1
        chunks = [cr] + shape[1:]
        meta = {
            "zarr_format": 2,
            "shape": shape,
            "chunks": chunks,
            "dtype": dtype_to_zarr(data.dtype),
            "compressor": None,
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        self._write_json(p / ".zarray", meta)
        if attrs:
            self._write_json(p / ".zattrs", attrs)
        n_chunks = max(1, -(-rows // cr))
        trailing_zeros = ".".join(["0"] * (len(shape) - 1))
        for ci in range(n_chunks):
            lo, hi = ci * cr, min((ci + 1) * cr, rows)
            block = data[lo:hi]
            if block.shape[0] < cr:  # zarr pads the final chunk to full size
                pad = np.zeros((cr - block.shape[0],) + block.shape[1:], data.dtype)
                block = np.concatenate([block, pad], axis=0)
            name = str(ci) if not trailing_zeros else f"{ci}.{trailing_zeros}"
            tmp = p / (name + ".tmp")
            tmp.write_bytes(np.ascontiguousarray(block).tobytes())
            os.replace(tmp, p / name)
        # overwriting a larger array leaves chunk files past the new grid;
        # reads honor the metadata, but stale chunks would shadow future
        # appends (and lie to anyone inspecting the files) — drop them
        for child in p.iterdir():
            if child.name.startswith("."):
                continue
            head = child.name.split(".", 1)[0]
            if head.isdigit() and int(head) >= n_chunks:
                child.unlink()

    def append_rows(self, path: str, arr: np.ndarray, *, chunk_rows: int | None = None) -> None:
        """Append rows to an axis-0-chunked array, touching only the
        trailing partial chunk plus the new chunks (the out-of-core build
        appends leaf blocks incrementally; rewriting the whole array per
        append would be quadratic).  Creates the array when missing
        (``chunk_rows`` then sets the chunk size).  The metadata's shape is
        rewritten *after* the chunk files, so a torn append leaves the old
        (consistent) view."""
        arr = np.ascontiguousarray(arr)
        if arr.shape[0] == 0:
            if not self.is_array(path):
                self.write_array(path, arr, chunk_rows=chunk_rows)
            return
        if not self.is_array(path):
            self.write_array(path, arr, chunk_rows=chunk_rows)
            return
        p = self._p(path)
        meta = self.array_meta(path)
        shape, chunks = meta["shape"], meta["chunks"]
        dt = zarr_to_dtype(meta["dtype"])
        if list(arr.shape[1:]) != shape[1:] or np.dtype(arr.dtype) != dt:
            raise ValueError(
                f"append_rows mismatch at {path}: array is {shape[1:]}/{dt}, "
                f"got {list(arr.shape[1:])}/{arr.dtype}"
            )
        rows, cr = shape[0], chunks[0]
        if rows == 0:
            # zero-row arrays carry a degenerate 1-row chunk grid; replace
            # wholesale so the appended array gets a sensible chunk size
            self.write_array(path, arr, chunk_rows=chunk_rows)
            return
        trailing_zeros = ".".join(["0"] * (len(shape) - 1))

        def chunk_name(ci: int) -> str:
            return str(ci) if not trailing_zeros else f"{ci}.{trailing_zeros}"

        new_rows = rows + arr.shape[0]
        at = 0  # rows of ``arr`` consumed
        # 1) fill the trailing partial chunk in place (tmp + replace)
        if rows % cr:
            ci = rows // cr
            fill = min(cr - rows % cr, arr.shape[0])
            cp = p / chunk_name(ci)
            block = np.frombuffer(cp.read_bytes(), dtype=dt).reshape([cr] + shape[1:]).copy()
            block[rows % cr : rows % cr + fill] = arr[:fill]
            tmp = p / (chunk_name(ci) + ".tmp")
            tmp.write_bytes(block.tobytes())
            os.replace(tmp, cp)
            at = fill
        # 2) whole new chunks
        ci = (rows + at) // cr
        while at < arr.shape[0]:
            block = arr[at : at + cr]
            if block.shape[0] < cr:
                pad = np.zeros((cr - block.shape[0],) + block.shape[1:], dt)
                block = np.concatenate([block, pad], axis=0)
            tmp = p / (chunk_name(ci) + ".tmp")
            tmp.write_bytes(np.ascontiguousarray(block).tobytes())
            os.replace(tmp, p / chunk_name(ci))
            at += cr
            ci += 1
        meta["shape"] = [new_rows] + shape[1:]
        self._write_json(p / ".zarray", meta)

    def array_meta(self, path: str) -> dict:
        return self._read_json(self._p(path) / ".zarray")

    def read_array(self, path: str) -> np.ndarray:
        meta = self.array_meta(path)
        shape = meta["shape"]
        chunks = meta["chunks"]
        dt = zarr_to_dtype(meta["dtype"])
        rows, cr = shape[0], chunks[0]
        n_chunks = max(1, -(-rows // cr))
        p = self._p(path)
        trailing_zeros = ".".join(["0"] * (len(shape) - 1))
        parts = []
        for ci in range(n_chunks):
            name = str(ci) if not trailing_zeros else f"{ci}.{trailing_zeros}"
            raw = (p / name).read_bytes()
            self._count_io(len(raw))
            block = np.frombuffer(raw, dtype=dt).reshape([cr] + shape[1:])
            parts.append(block)
        out = np.concatenate(parts, axis=0)[:rows] if parts else np.zeros(shape, dt)
        return np.ascontiguousarray(out.reshape(shape))

    def read_rows(self, path: str, lo: int, hi: int) -> np.ndarray:
        """Partial read of rows [lo, hi): reads only the BYTES covering the
        requested rows of each chunk file (chunks are raw C-order with
        leading-axis chunking, so a row range is contiguous in its chunk)."""
        meta = self.array_meta(path)
        shape, chunks = meta["shape"], meta["chunks"]
        dt = zarr_to_dtype(meta["dtype"])
        cr = chunks[0]
        hi = min(hi, shape[0])
        lo = max(0, lo)
        if hi <= lo:
            return np.zeros([0] + shape[1:], dt)
        c_lo, c_hi = lo // cr, -(-hi // cr)
        p = self._p(path)
        trailing_zeros = ".".join(["0"] * (len(shape) - 1))
        row_shape = shape[1:]
        row_nbytes = dt.itemsize * int(np.prod(row_shape, dtype=np.int64))
        parts = []
        for ci in range(c_lo, c_hi):
            name = str(ci) if not trailing_zeros else f"{ci}.{trailing_zeros}"
            r_lo = max(lo - ci * cr, 0)          # first needed row inside chunk
            r_hi = min(hi - ci * cr, cr)         # one past the last needed row
            with open(p / name, "rb") as f:
                if r_lo:
                    f.seek(r_lo * row_nbytes)
                raw = f.read((r_hi - r_lo) * row_nbytes)
            self._count_io(len(raw))
            parts.append(np.frombuffer(raw, dtype=dt).reshape([r_hi - r_lo] + row_shape))
        if len(parts) == 1:
            return np.ascontiguousarray(parts[0])
        return np.ascontiguousarray(np.concatenate(parts, axis=0))

    def array_nbytes(self, path: str) -> int:
        meta = self.array_meta(path)
        dt = zarr_to_dtype(meta["dtype"])
        n = 1
        for s in meta["shape"]:
            n *= s
        return n * dt.itemsize
