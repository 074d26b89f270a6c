"""A federation of shards through the benchmark, on the CPU at a tiny size
(4 shards of 1,500 rows at dim 64): the set-up numbers of a sound build
and of broken ones, the reference's effort split against the program's,
the program's federated pages against the reference, a broken federated
path, the controls, and a configuration added as files alone."""
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, collection, control, harness, reference

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 77


@pytest.fixture
def fed(tiny):
    """The federated cell at 4 x 1,500 rows; ``more`` pages as asked."""
    def make(**traffic):
        cell = tiny("federation.tkis", **traffic)
        return dataclasses.replace(cell, config=dict(cell.config, n_items=6000))

    return make


def _built(cell, path):
    """The collection of ``SEED`` and the federation set-up builds from it at ``path``."""
    cfg = cell.config
    data = collection.make(cfg, collection.rotation(SEED, int(cfg["dim"]), "cpu"), "cpu")
    harness._build(cfg, data.numpy(), path, "cpu")
    return data


def _run(cell, tmp_path, seed=SEED):
    result, _ = harness.run(cell.name, seed, 0.5, False, device="cpu", workdir=tmp_path, cell=cell)
    return result


# ------------------------------------------------------------ set-up
def test_a_sound_federation_reads_zero(fed, tmp_path):
    cell = fed()
    data = _built(cell, tmp_path / "fed")
    manifest = json.loads((tmp_path / "fed" / "federation.json").read_text())
    assert [e["n_items"] for e in manifest["shards"]] == [1500] * 4
    numbers, judged = check.index_numbers(data, cell.config, tmp_path / "fed", SEED)
    assert numbers == {"leader_mismatch": 0, "structure_errors": 0, "assign_gap": 0.0, "routing_errors": 0}
    # each shard holds its own slice, under its own leader draw, in global ids
    for s, (ix, (lo, hi)) in enumerate(zip(judged, reference.shard_bounds(6000, cell.config["shards"]))):
        assert (lo, hi) == (1500 * s, 1500 * (s + 1))
        assert np.array_equal(np.sort(np.concatenate(ix.members)), np.arange(lo, hi))
        assert np.array_equal(ix.leaders - lo, reference.leader_draw(int(cell.config["build_seed"]), 1500, len(ix.members)))


def _write_ids(path: Path, ids: np.ndarray) -> None:
    """Overwrite a one-chunk int64 zarr array of the same length."""
    meta = json.loads((path / ".zarray").read_text())
    assert meta["shape"][0] <= meta["chunks"][0]
    (path / "0").write_bytes(np.asarray(ids, np.dtype(meta["dtype"])).tobytes())


def _wrong_leader(root):
    p = root / "shard_0001" / "rep" / "item_ids"
    ids = check.read_array(root / "shard_0001", "rep/item_ids")
    ids[3] = next(i for i in range(1500, 3000) if i not in set(ids))
    _write_ids(p, ids)
    return "leader_mismatch"


def _moved_row(root):
    # an item of shard 2 listed in a leaf of shard 1 instead
    a = check.read_array(root / "shard_0001", "lvl_2/node_00000000/ids")
    b = check.read_array(root / "shard_0002", "lvl_2/node_00000000/ids")
    a[0], b[0] = b[0], a[0]
    _write_ids(root / "shard_0001" / "lvl_2/node_00000000/ids", a)
    _write_ids(root / "shard_0002" / "lvl_2/node_00000000/ids", b)
    return "structure_errors"


def _edit_manifest(key):
    def edit(root):
        m = json.loads((root / "federation.json").read_text())
        if key == "router":
            m["shards"][2]["router"][1][5] += 1e-3
        else:
            m["shards"][3]["n_items"] += 1
        (root / "federation.json").write_text(json.dumps(m))
        return "routing_errors"
    return edit


BREAKS = {"wrong_leader": _wrong_leader, "moved_row": _moved_row,
          "edited_centroid": _edit_manifest("router"), "edited_count": _edit_manifest("n_items")}


@pytest.mark.parametrize("how", BREAKS)
def test_a_broken_federation_is_caught(how, fed, tmp_path):
    cell = fed()
    data = _built(cell, tmp_path / "fed")
    number = BREAKS[how](tmp_path / "fed")
    numbers, _ = check.index_numbers(data, cell.config, tmp_path / "fed", SEED)
    assert numbers[number] > 0, numbers
    assert not check.decide(numbers, cell.limits)[0]


# ------------------------------------------------------------ the router
@pytest.mark.parametrize("b,b_min,top_m,probe_m", [(64, 1, None, 1), (8, 1, None, 1), (5, 2, None, 1),
                                                   (64, 4, 2, 1), (3, 1, None, 2), (16, 0, 3, 1)])
def test_the_reference_splits_effort_as_the_program(b, b_min, top_m, probe_m):
    from repro_torch.core.federation import allocate_effort

    rng = np.random.default_rng(5)
    sizes = [24, 24, 24, 24]
    owner = np.repeat(np.arange(4), sizes)
    for _ in range(200):
        # distances skewed towards one shard, as a semantic split makes them
        d = rng.random(len(owner)) + 0.5 * (owner != rng.integers(4)) * rng.random()
        probe, alloc = allocate_effort(d, owner, b, n_shards=4, b_min=b_min, top_m=top_m, probe_m=probe_m)
        got = reference.allocate(d, owner, b, 4, b_min=b_min, top_m=top_m, probe_m=probe_m)
        assert got == {int(s): int(a) for s, a in zip(probe, alloc)}
        assert list(got) == [int(s) for s in probe] and sum(got.values()) == max(1, b)


def test_a_split_within_tie_of_the_reference_stands():
    shards = [reference.Index(np.arange(2), [2], [], [np.array([0]), np.array([1])]) for _ in range(2)]
    fedr = reference.Federation(torch.zeros(4, 2), shards, "best_first", torch.float64, 2, 1, tie=1e-6)
    d = np.array([0.1, 0.3, 0.5, 0.3 + 4e-7])  # shard 0's second centroid and shard 1's tie for the 2nd vote
    own = fedr.route(d)
    assert own == {0: 2}
    assert fedr.route(d, {0: 1, 1: 1}) == {0: 1, 1: 1}
    assert fedr.route(d, {1: 2}) == own  # not a tie's reading: the reference's stands
    d[3] += 1e-5
    assert fedr.route(d, {0: 1, 1: 1}) == own


# ------------------------------------------------------------ the pages
@pytest.mark.parametrize("mores", [1, 8])
def test_the_federation_matches_the_reference(mores, fed, tmp_path):
    result = _run(fed(more_per_query=mores), tmp_path)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["routing_errors"] == {"value": 0, "limit": 0}
    assert result["checks"]["page_miss"]["value"] == 0.0
    assert result["checks"]["dist_err"]["value"] < 1e-5


def test_a_traced_federated_run_reports_its_layers(fed, tmp_path):
    result, _ = harness.run("federation.tkis", SEED, 0.5, True, device="cpu", workdir=tmp_path, cell=fed())
    assert result["correct"]
    assert {"shards_probed_per_search.federation", "cache_hit_share.federation",
            "bytes_read_per_search.federation", "build_s.federation"} <= set(result["metrics"])
    assert 1 <= result["metrics"]["shards_probed_per_search.federation"]["value"] <= 4


def _misroute(monkeypatch):
    from repro_torch.core import federation

    def farthest(d, owner, b, **kw):
        near = np.full(int(owner.max()) + 1, np.inf)
        np.minimum.at(near, owner, d)
        return np.array([int(np.argmax(near))]), np.array([max(1, int(b))])

    monkeypatch.setattr(federation, "allocate_effort", farthest)


def _no_refill(monkeypatch):
    from repro_torch.core import federation

    monkeypatch.setattr(federation._ShardStream, "refill", lambda self, k: None)


def _answer_altered(monkeypatch):
    from repro_torch.core import federation

    orig = federation.pack_rows

    def pack(d, i, k):
        d, i = orig(d, i, k)
        i[:, 0] = (i[:, 0] + 1) % 6000
        return d, i

    monkeypatch.setattr(federation, "pack_rows", pack)


def _state_unchanged(monkeypatch):
    from repro_torch.core.frontier import CandidateBuffer

    orig = CandidateBuffer.take

    def take(self, k):
        start = self.start
        out = orig(self, k)
        self.start = start
        return out

    monkeypatch.setattr(CandidateBuffer, "take", take)


FAULTS = {"misroute": _misroute, "no_refill": _no_refill, "answer_altered": _answer_altered,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_federated_path_is_not_correct(fault, fed, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(fed(more_per_query=2), tmp_path)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("precision", [reference.TF32, torch.bfloat16])
def test_the_federated_controls_are_not_correct(precision, fed):
    out = control.run_control(fed(), 7, precision, "cpu")
    assert not out["correct"], out["checks"]


def test_the_federated_reference_against_itself(fed):
    sound = control.run_control(fed(), 7, torch.float64, "cpu", stats=True)
    assert sound["correct"] and sound["checks"]["page_miss"]["value"] == 0.0
    assert [r["items"] for r in sound["leaf_rows"]] == [1500] * 4
    assert sum(sound["rows_probing"].values()) == 48
    assert 0 < sound["recall_at_k"] <= 1


# ------------------------------------------------------------ one index
def test_a_single_index_takes_its_old_path(tiny, tmp_path, monkeypatch):
    from repro_torch import core

    def refuse(*a, **kw):
        raise AssertionError("a configuration without shards built a federation")

    monkeypatch.setattr(core, "build_federation", refuse)
    cell = tiny("file.tkis")
    assert "shards" not in cell.config
    result = _run(cell, tmp_path)
    assert result["correct"] and "routing_errors" not in result["checks"]
    data = collection.make(cell.config, collection.rotation(SEED, int(cell.config["dim"]), "cpu"), "cpu")
    harness._build(cell.config, data.numpy(), tmp_path / "one", "cpu")
    assert not (tmp_path / "one" / "federation.json").exists()
    assert isinstance(reference.make_searcher(data, None, cell.config, torch.float64), reference.Searcher)


def test_a_federated_configuration_is_added_by_adding_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    here = tmp_path / "portbench"
    conf = json.loads((here / "configs/ecpfs-fed4-file-1m.json").read_text())
    conf.update(name="fed3-tiny", n_items=4500, dim=64, cluster_cap=50, b=8, k=20,
                shards={"n": 3, "split": "contiguous"})
    (here / "configs/fed3-tiny.json").write_text(json.dumps(conf))
    held = {"configs": [{"name": "fed3-tiny", "source": "a test", "file": "portbench/configs/fed3-tiny.json",
                         "reduced": [], "why": "a test"}],
            "workloads": [{"name": "federation.fed3", "config": "fed3-tiny", "traffic": "fed3", "chips": 1,
                           "why": "a test"}],
            "end_to_end": [{"name": "pages_per_s.federation", "unit": "pages/s", "better": "higher",
                            "source": "host_clock", "workloads": ["federation.fed3"]}],
            "per_layer": [{"name": "shards_probed_per_search.federation", "unit": "count", "better": "lower",
                           "source": "program_counter", "layer": "federation router",
                           "moves": "pages_per_s.federation", "workloads": ["federation.fed3"]}]}
    (here / "held_out/federation.fed3.json").write_text(json.dumps(held))
    mix = dict(json.loads((here / "traffic/tkis.json").read_text()), check_requests=48, pool_sessions=64)
    (here / "traffic/fed3.json").write_text(json.dumps(mix))
    shutil.copy(here / "limits/federation.tkis.json", here / "limits/federation.fed3.json")
    cell = harness.Cell.find("federation.fed3", root=tmp_path, held_out=True)
    result, _ = harness.run(cell.name, SEED, 0.5, True, device="cpu", workdir=tmp_path / "wd", cell=cell)
    assert result["correct"], result["checks"]
    assert result["checks"]["routing_errors"]["value"] == 0
    assert 1 <= result["metrics"]["shards_probed_per_search.federation"]["value"] <= 3
