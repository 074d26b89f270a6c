"""The check that decides ``correct``, on the CPU at a tiny size: the port
against the plain reference, a run with the timed path broken underneath
(each fault a cell can have), the lower-precision controls, and the
import rule."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, collection, control, harness, reference

ROOT = Path(__file__).resolve().parents[2]
PORTBENCH = ROOT / "portbench"
CELLS = ("file.tkis", "file.incremental", "packed.batch128")


def _run(cell, tmp_path, seed=2**31 + 99, trace=False):
    result, _ = harness.run(cell.name, seed, 0.5, trace, device="cpu", workdir=tmp_path, cell=cell)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_the_port_matches_the_reference(name, tiny, tmp_path):
    result = _run(tiny(name), tmp_path)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert result["checks"]["page_miss"]["value"] == 0.0
    assert result["checks"]["dist_err"]["value"] < 1e-5


def test_incremental_browsing_serves_eleven_pages_a_search(tiny, tmp_path, monkeypatch):
    pages, orig = [], check.page_numbers

    def page_numbers(reference, queries, served, routes=None):
        pages.extend(len(row) for row in served)
        return orig(reference, queries, served, routes)

    monkeypatch.setattr(check, "page_numbers", page_numbers)
    built = []
    monkeypatch.setattr(harness, "_open", lambda cfg, path, device, _o=harness._open: (
        built.append(path), _o(cfg, path, device))[1])
    result = _run(tiny("file.incremental"), tmp_path)
    assert result["correct"], result["checks"]
    assert pages and set(pages) == {11}
    assert result["attempted"] % 11 == 0
    # the index was opened from the run's own directory, and removed with it
    assert built == [tmp_path / "index"]
    assert not (tmp_path / "index").exists()


def test_a_traced_run_reports_its_layers(tiny, tmp_path):
    result = _run(tiny("file.tkis"), tmp_path, trace=True)
    assert result["correct"]
    assert {"cache_hit_share.file", "bytes_read_per_search.file", "device_idle_share.file"} <= set(result["metrics"])
    assert result["device"]["window_s"] > 0 and "breakdown" in result


# --------------------------------------------------------- planted faults
def _drop_nearest_leaf(monkeypatch, mode):
    from repro_torch.core.batched import BatchedSearcher
    from repro_torch.core.search import ECPIndex

    if mode == "file":
        orig, seen = ECPIndex._stage_leaf, {}

        def stage(self, qs, d, ids):
            if id(qs) not in seen:
                seen[id(qs)] = qs  # held, so that no later state reuses the id
                return orig(self, qs, d[:0], ids[:0])
            return orig(self, qs, d, ids)

        monkeypatch.setattr(ECPIndex, "_stage_leaf", stage)
    else:
        orig = BatchedSearcher.rank_leaves
        monkeypatch.setattr(BatchedSearcher, "rank_leaves",
                            lambda self, q, bi: tuple(t[:, 1:] for t in orig(self, q, bi)))


def _state_unchanged(monkeypatch, mode):
    from repro_torch.core.batched import BatchedSearcher
    from repro_torch.core.frontier import CandidateBuffer

    if mode == "file":
        orig = CandidateBuffer.take

        def take(self, k):
            start = self.start
            out = orig(self, k)
            self.start = start
            return out

        monkeypatch.setattr(CandidateBuffer, "take", take)
    else:
        orig = BatchedSearcher._emit
        monkeypatch.setattr(BatchedSearcher, "_emit",
                            staticmethod(lambda state, k: (*orig(state, k)[:2], state)))


def _half_batch(monkeypatch, mode):
    from repro_torch.core.batched import BatchedSearcher

    orig = BatchedSearcher._result

    def result(self, d, i, state, single, query):
        half = d.shape[0] // 2
        return orig(self, d[:half].repeat(2, 1)[: d.shape[0]], i[:half].repeat(2, 1)[: d.shape[0]],
                    state, single, query)

    monkeypatch.setattr(BatchedSearcher, "_result", result)


def _answer_altered(monkeypatch, mode):
    from repro_torch.core import search
    from repro_torch.core.batched import BatchedSearcher

    if mode == "file":
        orig = search.pack_rows

        def pack(d, i, k):
            d, i = orig(d, i, k)
            i[:, 0] = (i[:, 0] + 1) % 3000
            return d, i

        monkeypatch.setattr(search, "pack_rows", pack)
    else:
        orig = BatchedSearcher._result

        def result(self, d, i, state, single, query):
            i = i.clone()
            i[:, 0] = (i[:, 0] + 1) % 3000
            return orig(self, d, i, state, single, query)

        monkeypatch.setattr(BatchedSearcher, "_result", result)


FAULTS = {"drop_nearest_leaf": _drop_nearest_leaf, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch, "answer_altered": _answer_altered}


# a file cell's request is one query row: it has no half of a batch to leave out
@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS
                                        if not (f == "half_batch" and c.startswith("file."))])
def test_a_broken_timed_path_is_not_correct(name, fault, tiny, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch, harness.Cell.find(name, held_out=True).config["open"]["mode"])
    result = _run(tiny(name), tmp_path)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_tf32_is_not_correct(name, tiny):
    out = control.run_control(tiny(name), 7, reference.TF32, "cpu")
    assert not out["correct"], out["checks"]
    assert out["checks"]["dist_err"]["value"] > out["checks"]["dist_err"]["limit"]


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 3 * 2**-11), 0.1])
    assert reference.tf32(x).tolist() == [1.0, 1 + 2**-9, -(1 + 2**-9), 0.0999755859375]
    y = torch.randn(4096)
    assert float(((reference.tf32(y) - y) / y).abs().max()) <= 2**-11


def test_the_reference_searches_its_own_build_but_keeps_a_tie(tiny):
    cell = tiny("packed.batch128")
    cfg = cell.config
    data = collection.make(cfg, collection.rotation(3, int(cfg["dim"]), "cpu"), "cpu")
    own = reference.build(data, cfg, torch.float64)
    numbers, judged = check.build_numbers(data, cfg, own, root=None, seed=3)
    assert numbers["assign_gap"] == 0.0
    assert all(np.array_equal(a, b) for a, b in zip(judged.members, own.members))
    # one item moved to a leaf that is not its nearest: the gap shows, and
    # the reference searches the item where its own build puts it
    big = max(range(len(own.members)), key=lambda j: len(own.members[j]))
    item = int(own.members[big][0])
    moved = [m[m != item] for m in own.members]
    moved[(big + 1) % len(moved)] = np.append(moved[(big + 1) % len(moved)], item)
    stored = reference.Index(own.leaders, own.nodes, own.children, moved)
    numbers, judged = check.build_numbers(data, cfg, stored, root=None, seed=3)
    assert numbers["assign_gap"] > check.TIE and numbers["structure_errors"] == 0
    assert all(np.array_equal(np.sort(a), np.sort(b)) for a, b in zip(judged.members, own.members))


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_bfloat16_is_not_correct(name, tiny):
    assert not control.run_control(tiny(name), 7, torch.bfloat16, "cpu")["correct"]
    sound = control.run_control(tiny(name), 7, torch.float64, "cpu", stats=True)
    assert sound["correct"] and sound["checks"]["page_miss"]["value"] == 0.0
    assert sound["opened_rows_min"] >= sound["served_rows"]
    assert 0 < sound["recall_at_k"] <= 1


# ----------------------------------------------------------- the imports
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(PORTBENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for f in ("reference.py", "check.py", "collection.py", "traffic.py", "roofline.py"):
        assert "repro_torch" not in _imports(PORTBENCH / f), f


def test_a_run_on_the_cpu_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from pathlib import Path
from portbench import harness
from portbench.run import loaded_forbidden
cell = harness.Cell.find("packed.batch128")
cell = harness.Cell(cell.name, cell.entry, dict(cell.config, n_items=1500, dim=32, cluster_cap=50, b=8, k=10),
                    dict(cell.traffic, rows_per_request=8, check_requests=2, pool_sessions=8), cell.limits, cell.end_to_end, cell.per_layer)
result, _ = harness.run(cell.name, 5, 0.3, False, device="cpu", workdir=Path({str(tmp_path)!r}), cell=cell)
assert result["correct"], result
print(loaded_forbidden())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, str(PORTBENCH / "run.py"), "--workload", "packed.batch128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    if "CUDA device" not in out.stderr:
        pytest.skip("a CUDA card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
