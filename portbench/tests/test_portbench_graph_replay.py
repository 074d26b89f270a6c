"""The reader ``graph_replay_share.packed`` on a hand-built run, trace and
registry: replayed scan chunks over the scoring spans, and silence
without a trace, without records, without the replay counter (a program
that has no graphs) and without a scoring span."""
import pytest

from portbench import harness, program
from portbench.trace import Trace


def _span(count):
    return {"count": count, "host_s": 1.0, "self_s": 0.5, "device_s": 0.0, "device_n": 0, "parents": {}}


REGISTRY = {
    "spans": {"ecpfs.packed.rank": _span(4), "ecpfs.packed.score": _span(8),
              "ecpfs.packed.merge": _span(8), "ecpfs.serve.search": _span(4)},
    "counters": {"ecpfs.packed.host_syncs": 40, "ecpfs.packed.graph_replays": 6},
    "phases": {},
}


def _run(trace):
    cell = harness.Cell.find("packed.batch128")
    return harness.Run(cell, {}, [], {"search": [1.0] * 4, "more": [], "done": []}, 10.0, trace)


def _trace():
    return Trace((0.0, 10.0), device=[("k", 1.0, 2.0), ("k", 4.0, 5.0)],
                 host=[("portbench.window", 0.0, 10.0), ("ecpfs.packed.score", 1.5, 4.5)])


def test_graph_replay_share_reads_replays_over_chunks(monkeypatch):
    monkeypatch.setattr(program, "registry", lambda: REGISTRY)
    assert harness.read_metric("graph_replay_share.packed")(_run(_trace())) == pytest.approx(100.0 * 6 / 8)


def _without_replays():
    return {**REGISTRY, "counters": {k: v for k, v in REGISTRY["counters"].items()
                                     if k != "ecpfs.packed.graph_replays"}}


def _without_score():
    return {**REGISTRY, "spans": {k: v for k, v in REGISTRY["spans"].items() if k != "ecpfs.packed.score"}}


@pytest.mark.parametrize("registry, traced", [
    (REGISTRY, False),             # no trace
    (None, True),                  # no records
    (_without_replays(), True),    # a program without graphs
    (_without_score(), True),      # no scoring span
], ids=["no_trace", "no_records", "no_replay_counter", "no_score_span"])
def test_graph_replay_share_is_silent_without_what_it_reads(registry, traced, monkeypatch):
    monkeypatch.setattr(program, "registry", lambda: registry)
    assert harness.read_metric("graph_replay_share.packed")(_run(_trace() if traced else None)) is None
