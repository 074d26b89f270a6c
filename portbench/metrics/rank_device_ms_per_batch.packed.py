"""Device time of packed search's rank stage (the span
``ecpfs.packed.rank``: root scoring, the internal top-b, the stable sort
of every candidate leaf), timed by the program's CUDA events, per request."""
from portbench import program


def read(run):
    return program.device_ms_per_batch(run, "ecpfs.packed.rank")
