"""Idle device time inside packed search, per request: the window's gaps
with no device operation whose midpoint lies inside a host span of the
program named ``ecpfs.packed.*``, summed."""
from portbench import program


def read(run):
    if run.trace is None or not run.trace.device or not run.searches:
        return None  # no device operation traced: nothing was idle on a device
    if not any(n.startswith("ecpfs.packed.") for n, _, _ in run.trace.host):
        return None
    idle = program.idle_by_span(run.trace, "ecpfs.packed.")
    return 1e3 * sum(s for name, s in idle.items() if name is not None) / run.searches
