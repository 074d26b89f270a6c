"""The per-layer readers of what the program records of itself
(``portbench/program.py`` and the metrics that use it): each on a
hand-built run, trace and registry; the idle gaps put down to the
innermost program span; silence without a trace, without records or
without the program's tracing module; and a tiny traced run on the CPU."""
import math
import sys

import pytest

from portbench import harness, program
from portbench.trace import Trace

STAGES = {"rank_device_ms_per_batch.packed": "ecpfs.packed.rank",
          "leaf_score_device_ms_per_batch.packed": "ecpfs.packed.score",
          "merge_device_ms_per_batch.packed": "ecpfs.packed.merge"}
READERS = (*STAGES, "scanned_row_yield.packed", "host_syncs_per_batch.packed",
           "search_idle_ms_per_batch.packed", "build_s.packed", "build_s.file", "open_s.packed")


def _span(count, device_s=0.0, device_n=0):
    return {"count": count, "host_s": 1.0, "self_s": 0.5, "device_s": device_s, "device_n": device_n,
            "parents": {}}


REGISTRY = {
    "spans": {"ecpfs.packed.rank": _span(4, 0.008, 4), "ecpfs.packed.score": _span(8, 0.2, 8),
              "ecpfs.packed.merge": _span(8, 0.04, 8), "ecpfs.serve.search": _span(4)},
    "counters": {"ecpfs.packed.host_syncs": 40, "ecpfs.packed.rows_needed": 300,
                 "ecpfs.packed.rows_scored": 20000},
    "phases": {"ecpfs.build.hierarchy": {"count": 1, "s": 1.5}, "ecpfs.build.assign": {"count": 1, "s": 6.0},
               "ecpfs.build.write": {"count": 1, "s": 4.5}, "ecpfs.open.load": {"count": 1, "s": 17.0},
               "ecpfs.open.upload": {"count": 1, "s": 2.0}},
}


def _trace():
    """Device busy at [1, 2], [4, 5], [7, 8] of a 10 s window; gaps [0, 1],
    [2, 4], [5, 7], [8, 10].  The program's spans: a search over nearly
    all of it, a scoring span around the second gap, a loop around the
    third with its test inside; a torch op over everything."""
    return Trace((0.0, 10.0),
                 device=[("k", 1.0, 2.0), ("k", 4.0, 5.0), ("k", 7.0, 8.0)],
                 host=[("portbench.window", 0.0, 10.0), ("aten::mm", 0.0, 10.0),
                       ("ecpfs.serve.search", 0.0, 9.5), ("ecpfs.packed.score", 1.5, 4.5),
                       ("ecpfs.packed.advance", 4.8, 7.5), ("ecpfs.packed.advance.wait", 5.5, 6.5)])


def _run(trace=None, searches=4):
    cell = harness.Cell.find("packed.batch128")
    return harness.Run(cell, {}, [], {"search": [1.0] * searches, "more": [], "done": []}, 10.0, trace)


def test_each_reader_on_a_hand_built_run(monkeypatch):
    monkeypatch.setattr(program, "registry", lambda: REGISTRY)
    run = _run(_trace())
    got = {name: harness.read_metric(name)(run) for name in READERS}
    assert got == {
        "rank_device_ms_per_batch.packed": pytest.approx(2.0),
        "leaf_score_device_ms_per_batch.packed": pytest.approx(50.0),
        "merge_device_ms_per_batch.packed": pytest.approx(10.0),
        "scanned_row_yield.packed": pytest.approx(1.5),
        "host_syncs_per_batch.packed": pytest.approx(10.0),
        "search_idle_ms_per_batch.packed": pytest.approx(1e3 * 4.0 / 4),
        "build_s.packed": pytest.approx(12.0),
        "build_s.file": pytest.approx(12.0),
        "open_s.packed": pytest.approx(19.0),
    }


def test_an_idle_gap_goes_to_the_innermost_program_span_around_its_midpoint():
    tr = _trace()
    assert program.idle_by_span(tr, "ecpfs.packed.") == {
        None: pytest.approx(3.0), "ecpfs.packed.score": pytest.approx(2.0),
        "ecpfs.packed.advance.wait": pytest.approx(2.0)}
    assert program.idle_by_span(tr, "ecpfs.") == {
        "ecpfs.serve.search": pytest.approx(3.0), "ecpfs.packed.score": pytest.approx(2.0),
        "ecpfs.packed.advance.wait": pytest.approx(2.0)}
    # a span that starts later but ends before the midpoint is not around it
    tr.host.append(("ecpfs.packed.emit", 5.1, 5.4))
    assert program.idle_by_span(tr, "ecpfs.packed.")["ecpfs.packed.advance.wait"] == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_is_silent_without_a_trace_or_records(name, monkeypatch):
    read = harness.read_metric(name)
    monkeypatch.setattr(program, "registry", lambda: REGISTRY)
    assert read(_run(None)) is None
    monkeypatch.setattr(program, "registry", lambda: None)
    assert read(_run(Trace((0.0, 10.0), device=[("k", 1.0, 2.0)], host=[]))) is None


def test_without_the_programs_tracing_module_there_is_no_registry(monkeypatch):
    import repro_torch

    # a checkout from before the module: neither the attribute nor the module
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert program.registry() is None
    assert harness.read_metric("host_syncs_per_batch.packed")(_run(_trace())) is None


def test_a_tiny_traced_packed_run_reports_the_program_layers(tiny, tmp_path):
    from repro_torch import tracing

    tracing.reset()
    cell = tiny("packed.batch128")
    result, _ = harness.run(cell.name, 2**31 + 77, 0.5, True, device="cpu", workdir=tmp_path, cell=cell)
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("host_syncs_per_batch.packed", "scanned_row_yield.packed", "build_s.packed", "open_s.packed"):
        assert math.isfinite(metrics[name]), name
    assert 0 < metrics["scanned_row_yield.packed"] < 100
    assert metrics["host_syncs_per_batch.packed"] >= 10  # a search and a more: at least 6 + 4
    # no CUDA events and no device operations on the CPU: the device readers are silent
    assert not set(STAGES) & set(metrics)
    assert "search_idle_ms_per_batch.packed" not in metrics
    spans = tracing.snapshot()["spans"]
    requests = result["attempted"] // (1 + int(cell.traffic["more_per_query"]))
    assert spans["ecpfs.serve.search"]["count"] == spans["ecpfs.packed.rank"]["count"] == requests
    tracing.reset()
