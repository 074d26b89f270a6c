"""The benchmark's own pieces on the CPU: finding cells and metrics by
name, the collection and traffic generators, percentiles, byte counts,
the trace's reduction."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import collection, harness, roofline, traffic
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_and_metric_is_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((ROOT / "portbench/held_out").glob("*.json")):
        held = json.loads(f.read_text())
        for key in ("workloads", "per_layer"):
            bench[key] += held.get(key, [])
        with pytest.raises(KeyError):
            harness.Cell.find(f.stem)
    for w in bench["workloads"]:
        cell = harness.Cell.find(w["name"], held_out=True)
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer, w["name"]
    for m in bench["per_layer"]:
        assert callable(harness.read_metric(m["name"]))
    assert {"packed.batch128", "file.tkis", "file.incremental"} <= {w["name"] for w in bench["workloads"]}
    cell = harness.Cell.find("file.incremental", held_out=True)
    assert cell.traffic["more_per_query"] == 10
    assert {m["name"] for m in cell.per_layer} == {
        "cache_hit_share.file", "bytes_read_per_search.file", "distance_topk_roofline",
        "device_idle_share.file", "build_s.file"}
    assert {m["name"] for m in cell.end_to_end} == {"pages_per_s", "setup_s"}


def test_a_cell_is_added_by_adding_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = dict(json.loads((ROOT / "portbench/configs/ecpfs-packed-1m.json").read_text()), name="dummy-1m")
    (tmp_path / "portbench/configs/dummy-1m.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "dummy-1m", "source": "a test", "file": "portbench/configs/dummy-1m.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "packed.dummy", "config": "dummy-1m", "traffic": "dummy",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_count", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "packed search",
                               "moves": "search_p95_ms", "workloads": ["packed.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = dict(json.loads((ROOT / "portbench/traffic/batch128.json").read_text()), clients=2)
    (tmp_path / "portbench/traffic/dummy.json").write_text(json.dumps(mix))
    shutil.copy(ROOT / "portbench/limits/packed.batch128.json", tmp_path / "portbench/limits/packed.dummy.json")
    (tmp_path / "portbench/metrics/dummy_count.py").write_text("def read(run):\n    return 42.0\n")
    cell = harness.Cell.find("packed.dummy", root=tmp_path)
    assert cell.traffic["clients"] == 2 and cell.config["name"] == "dummy-1m"
    assert [m["name"] for m in cell.per_layer] == ["dummy_count"]
    assert harness.read_metric("dummy_count", tmp_path)(None) == 42.0


def _tiny_cfg():
    cfg = harness.Cell.find("file.tkis", held_out=True).config
    return dict(cfg, n_items=2000, dim=32)


def test_the_collection_and_traffic_are_a_function_of_the_seed_and_keep_their_geometry():
    cfg = _tiny_cfg()
    mix = dict(harness.Cell.find("file.tkis", held_out=True).traffic, pool_sessions=3)
    made = {}
    for s in (2**31 + 5, 2**31 + 5, 17):
        rot = collection.rotation(s, cfg["dim"], "cpu")
        data = collection.make(cfg, rot, "cpu")
        made.setdefault(s, []).append((data.float(), traffic.pool(mix, data, rot, 1)))
    (a, pa), (a2, pa2), (b, pb) = made[2**31 + 5] + made[17]
    assert torch.equal(a, a2)
    assert all(np.array_equal(x.queries, y.queries) for s, t in zip(pa, pa2) for x, y in zip(s, t))
    assert not torch.equal(a, b)
    # another seed turns the same collection and traffic: every inner
    # product agrees to float16, the targets are the same items
    assert float((a[:300] @ a[:300].T - b[:300] @ b[:300].T).abs().max()) < 5e-3
    assert float((torch.linalg.vector_norm(a, dim=1) - 1).abs().max()) < 2e-3
    qa, qb = (np.concatenate([r.queries for r in p[0]]) for p in (pa, pb))
    assert np.array_equal(pa[0][0].targets, pb[0][0].targets)
    assert np.abs(qa @ a.numpy().T - qb @ b.numpy().T).max() < 5e-3
    assert len(pa) == 3 and len(pa[0]) == mix["queries_per_session"]
    # the hints sharpen: the last query is nearer its target than the first
    t = a[pa[0][0].targets[0]].numpy()
    assert float(qa[-1] @ t) > float(qa[0] @ t)


def test_percentiles_are_taken_over_every_request():
    lat = {"search": list(np.arange(1, 101, dtype=float)), "more": [5.0] * 99 + [500.0]}
    units = [harness.Unit(np.zeros((4, 8)), pages=[None, None]) for _ in range(10)]
    out = harness._end_to_end(harness.Cell.find("packed.batch128"), lat, units, 2.0, 3 << 30, 12.5)
    assert out["search_p95_ms"]["value"] == pytest.approx(np.percentile(np.arange(1, 101), 95))
    assert out["pages_per_s"]["value"] == pytest.approx(10 * 4 * 2 / 2.0)
    assert out["device_peak_gib"]["value"] == pytest.approx(3.0)
    assert out["setup_s"]["value"] == 12.5
    assert harness.percentile([5.0] * 99 + [500.0], 95) == pytest.approx(np.percentile([5.0] * 99 + [500.0], 95))
    # a name's part before the dot is what it measures
    out = harness._end_to_end(harness.Cell.find("file.tkis", held_out=True), lat, units, 4.0, 1 << 29, 3.0)
    assert set(out) == {"pages_per_s.file", "device_peak_gib.file", "setup_s"}
    assert out["pages_per_s.file"]["value"] == pytest.approx(20.0)
    assert out["device_peak_gib.file"]["value"] == pytest.approx(0.5)


def test_roofline_byte_counts():
    # two leaves of 455 and 300 rows at float16, 1152-d: rows once, the
    # float32 query once a launch, a float32 distance and int32 index a row
    assert roofline.distance_topk_full_bytes([455, 300], 1152, 2) == 755 * (2304 + 8) + 2 * 4608
    assert roofline.packed_batch_bytes(1000, 100, 128, 1152, 2, 25600) == (
        1100 * 2304 + 128 * 4608 + 25600 * 12)
    # the longer of the two bounds over the device time
    assert roofline.share(3.35e9, 0, 1e-3) == pytest.approx(100.0)
    assert roofline.share(3.35e9, 2 * 67e9, 1e-3) == pytest.approx(200.0)
    assert roofline.share(1, 1, 0) is None


def test_the_trace_reduction():
    tr = Trace((0.0, 10.0),
               device=[("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 6.0, 7.0)],
               host=[("portbench.search", 0.0, 9.0), ("aten::copy_", 4.0, 5.0)])
    assert tr.busy() == [(1.0, 3.0), (6.0, 7.0)]
    assert tr.busy_s == pytest.approx(3.0)
    assert tr.device_s("k1") == (pytest.approx(2.0), 2)
    assert tr.gaps() == [(0.0, 1.0), (3.0, 6.0), (7.0, 10.0)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(2.0)]
    assert bd["idle_gaps"][0] == ["portbench.search > aten::copy_", pytest.approx(3.0)]
