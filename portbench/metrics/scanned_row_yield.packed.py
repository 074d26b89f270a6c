"""Share of the (row, query) distances packed search computed that a query
needed, in percent, over the window: each query's own valid leaves' real
rows (``ecpfs.packed.rows_needed``) over the distances scored
(``ecpfs.packed.rows_scored``).  On the card's kernel path the latter is
each visited leaf's 128-row tiles (zero-filled past its real rows) times
its valid (query, leaf) pairs rounded up to whole 4-pair warps
(``leaf_distances.scored_rows``), so the yield reads the tiles' and the
warps' waste; on the plain path (the CPU) every query against every
distinct visited leaf padded to the largest."""
from portbench import program


def read(run):
    needed = program.counter(run, "ecpfs.packed.rows_needed")
    scored = program.counter(run, "ecpfs.packed.rows_scored")
    if needed is None or not scored:
        return None
    return 100.0 * needed / scored
