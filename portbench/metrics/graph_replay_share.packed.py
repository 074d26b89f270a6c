"""Share of packed search's scan chunks that ran as replays of the
searcher's CUDA graphs, in percent, over the traced window: counter
``ecpfs.packed.graph_replays`` (one a replayed chunk) over the spans
``ecpfs.packed.score`` (one a chunk, replayed or eager).  A program
without the counter records no replay: the reader is silent there."""
from portbench import program


def read(run):
    replays = program.counter(run, "ecpfs.packed.graph_replays")
    if replays is None:
        return None
    chunks = ((program.registry() or {}).get("spans", {}).get("ecpfs.packed.score") or {}).get("count")
    if not chunks:
        return None
    return 100.0 * replays / chunks
