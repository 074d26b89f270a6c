"""The port's zarr-v2 file layer against the JAX package's (the twins of
``tests/test_fstore.py``): what either writes, the other reads back, the
two write the same bytes, and partial reads, empty arrays, groups and
path escapes behave alike."""
import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.fstore import FStore as RefFStore
from repro.core.store import IOStats as RefIOStats
from repro_torch.core.fstore import FStore
from repro_torch.core.store import IOStats

PAIRS = {"port->ref": (FStore, RefFStore), "ref->port": (RefFStore, FStore)}


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(params=list(PAIRS))
def pair(request, tmp_path):
    """(writer store, reader store on the same directory)."""
    w, r = PAIRS[request.param]
    return w(tmp_path / "s", create=True), r(tmp_path / "s")


def _write_all(store):
    rng = np.random.default_rng(0)
    store.write_array("x/y", np.arange(100, dtype=np.float32).reshape(20, 5), chunk_rows=7)
    store.write_array("arr", np.arange(12, dtype="<i4").reshape(3, 4), chunk_rows=2)
    store.write_array("a", rng.normal(size=(100, 8)).astype(np.float32), chunk_rows=16)
    store.write_array("e", np.zeros((0, 4), np.float16))
    store.write_array("s", np.asarray([7], np.int64))
    store.write_array("z3", np.zeros((0, 2, 5), np.float16), chunk_rows=4)
    store.create_group("g", attrs={"metric": "l2", "levels": 3})


def test_the_port_writes_the_reference_bytes(tmp_path):
    _write_all(FStore(tmp_path / "port", create=True))
    _write_all(RefFStore(tmp_path / "ref", create=True))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")


def test_roundtrip_basic(pair):
    w, r = pair
    a = np.arange(100, dtype=np.float32).reshape(20, 5)
    w.write_array("x/y", a, chunk_rows=7)
    np.testing.assert_array_equal(r.read_array("x/y"), a)


def test_layout_is_transparent(pair, tmp_path):
    w, r = pair
    a = np.arange(12, dtype="<i4").reshape(3, 4)
    w.write_array("arr", a, chunk_rows=2)
    meta = json.loads((tmp_path / "s/arr/.zarray").read_text())
    assert meta["zarr_format"] == 2 and meta["compressor"] is None
    assert meta["shape"] == [3, 4] and meta["chunks"] == [2, 4]
    assert r.array_meta("arr") == meta
    raw = (tmp_path / "s/arr/0.0").read_bytes()
    assert np.frombuffer(raw, "<i4").reshape(2, 4).tolist() == a[:2].tolist()


def test_partial_read(pair):
    w, r = pair
    a = np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32)
    w.write_array("a", a, chunk_rows=16)
    np.testing.assert_array_equal(r.read_rows("a", 10, 35), a[10:35])
    np.testing.assert_array_equal(r.read_rows("a", 96, 200), a[96:])


def test_empty_and_scalar(pair):
    w, r = pair
    w.write_array("e", np.zeros((0, 4), np.float16))
    assert r.read_array("e").shape == (0, 4)
    w.write_array("s", np.asarray([7], np.int64))
    assert r.read_array("s")[0] == 7


def test_zero_row_roundtrip_all_shapes(pair):
    w, r = pair
    for name, arr in (
        ("z1", np.zeros((0,), np.int32)),
        ("z2", np.zeros((0, 3), np.float32)),
        ("z3", np.zeros((0, 2, 5), np.float16)),
    ):
        w.write_array(name, arr, chunk_rows=4)
        back = r.read_array(name)
        assert back.shape == arr.shape and back.dtype == arr.dtype
        meta = r.array_meta(name)
        assert meta["shape"][0] == 0 and meta["chunks"][0] == 1
        assert r.read_rows(name, 0, 10).shape[0] == 0


def test_read_rows_reads_the_reference_bytes(tmp_path):
    """A 2-row read from a large chunked array reads only what it needs:
    the same bytes, reads and files as the reference's read."""
    a = np.random.default_rng(1).normal(size=(10_000, 16)).astype(np.float32)
    FStore(tmp_path / "s", create=True).write_array("big", a, chunk_rows=5_000)
    for lo, hi in ((4_998, 5_000), (4_999, 5_001)):
        io = []
        for cls, stats in ((FStore, IOStats), (RefFStore, RefIOStats)):
            s = cls(tmp_path / "s")
            s.io = stats()
            np.testing.assert_array_equal(s.read_rows("big", lo, hi), a[lo:hi])
            io.append(s.io.as_dict())
        assert io[0] == io[1]
        assert io[0]["bytes_read"] < 2 * 16 * 4 + 4_096


def test_attrs_groups(pair):
    w, r = pair
    w.create_group("g", attrs={"metric": "l2", "levels": 3})
    assert r.read_attrs("g")["levels"] == 3
    assert r.is_group("g") and not r.is_array("g")


@pytest.mark.parametrize("path", ["../../etc/passwd", "a/../../b"])
def test_escape_rejected(tmp_path, path):
    for cls in (FStore, RefFStore):
        with pytest.raises(ValueError):
            cls(tmp_path / "s", create=True).read_array(path)


@settings(max_examples=25, deadline=None)
@given(
    rows=st.integers(1, 50),
    cols=st.integers(1, 8),
    chunk=st.integers(1, 60),
    dt=st.sampled_from(["float32", "float16", "int32", "int64"]),
)
def test_roundtrip_property(tmp_path_factory, rows, cols, chunk, dt):
    root = tmp_path_factory.mktemp("fs")
    rng = np.random.default_rng(rows * 100 + cols)
    a = (rng.normal(size=(rows, cols)) * 100).astype(dt)
    FStore(root / "port", create=True).write_array("a", a, chunk_rows=chunk)
    RefFStore(root / "ref", create=True).write_array("a", a, chunk_rows=chunk)
    assert _tree(root / "port") == _tree(root / "ref")
    lo = min(rows - 1, chunk)
    for cls, where in ((FStore, "ref"), (RefFStore, "port")):
        s = cls(root / where)
        np.testing.assert_array_equal(s.read_array("a"), a)
        np.testing.assert_array_equal(s.read_rows("a", lo, rows), a[lo:])
