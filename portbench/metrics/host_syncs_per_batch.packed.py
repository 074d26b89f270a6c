"""Times packed search made the host wait for the device
(``ecpfs.packed.host_syncs``: the query upload, each scan chunk's
``torch.unique``, each loop test, the copies back) per request, its
search and its continuations."""
from portbench import program


def read(run):
    n = program.counter(run, "ecpfs.packed.host_syncs")
    if n is None or not run.searches:
        return None
    return n / run.searches
