"""Share of the rows packed search scored that a query needed, in percent:
each query's own valid leaves' real rows (``ecpfs.packed.rows_needed``)
over the rows scored, every query against every distinct visited leaf
padded to the largest (``ecpfs.packed.rows_scored``), over the window."""
from portbench import program


def read(run):
    needed = program.counter(run, "ecpfs.packed.rows_needed")
    scored = program.counter(run, "ecpfs.packed.rows_scored")
    if needed is None or not scored:
        return None
    return 100.0 * needed / scored
