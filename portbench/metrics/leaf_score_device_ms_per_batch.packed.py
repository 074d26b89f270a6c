"""Device time of packed search's leaf scoring (the span
``ecpfs.packed.score``: ``torch.unique``, the padded gather, the float32
product, each query's pick), timed by the program's CUDA events, per
request."""
from portbench import program


def read(run):
    return program.device_ms_per_batch(run, "ecpfs.packed.score")
