"""The leaf scorer's ``distance_topk`` launches against their roofline:
the rows each launch scored, at the index's storage dtype, with the query
and the outputs (the bytes), and a multiply-add a row and dimension (the
operations), over the profiler's time of the kernel's full-selection
path (``full_select_kernel``).  Where the profiler kept fewer records than
the wrapper counted launches, the time is scaled up by the ratio."""
import numpy as np

from portbench import roofline

KERNEL = "full_select_kernel"


def read(run):
    rows = run.counters.get("scorer_rows") or []
    launches = run.counters.get("distance_topk_launches", 0)
    if run.trace is None or not rows or launches != len(rows):
        return None
    seconds, records = run.trace.device_s(KERNEL)
    if not records:
        return None
    cfg = run.cell.config
    dim = int(cfg["dim"])
    moved = roofline.distance_topk_full_bytes(rows, dim, np.dtype(cfg["storage_dtype"]).itemsize)
    return roofline.share(moved, 2.0 * dim * float(np.sum(rows)), seconds * launches / records)
