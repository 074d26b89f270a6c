"""Device time of packed search's merge (the span ``ecpfs.packed.merge``:
the mask, the stable sort of the buffer with the scanned rows, the
gathers), timed by the program's CUDA events, per request."""
from portbench import program


def read(run):
    return program.device_ms_per_batch(run, "ecpfs.packed.merge")
