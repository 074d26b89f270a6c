import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def tiny():
    """A cell of the benchmark cut to a size the CPU runs in seconds: the
    same code, configuration keys and traffic shape, smaller numbers; a
    cell held out of BENCHMARK.json is found too.  The page size keeps the
    full cells' margin: the ``b`` leaves a search opens hold at least four
    times the rows of all its pages (at full size 64 leaves of ~455 rows
    against at most 11 pages of 100), so every page is a slice of the
    first search's leaves, as the reference serves it."""
    from portbench import harness

    def make(name: str, **traffic):
        cell = harness.Cell.find(name, held_out=True)
        pages = 1 + int(cell.traffic["more_per_query"])
        cfg = dict(cell.config, n_items=3000, dim=64, cluster_cap=50, b=8, k=min(20, 8 * 50 // (4 * pages)))
        mix = dict(cell.traffic, rows_per_request=min(int(cell.traffic["rows_per_request"]), 16),
                   check_requests=48 if cell.traffic["rows_per_request"] == 1 else 4,
                   pool_sessions=64, **traffic)
        return harness.Cell(cell.name, cell.entry, cfg, mix, cell.limits, cell.end_to_end, cell.per_layer)

    return make
