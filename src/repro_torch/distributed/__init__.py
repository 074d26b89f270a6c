"""Fault tolerance on one process (the reference's ``repro.distributed``).
The collectives and the elastic reshard wait for the distribution layer
(ROADMAP Queue 1 #13) and raise naming it."""
from .collectives import psum_compressed, tree_psum
from .elastic import make_shardings, reshard_tree
from .fault_tolerance import FailureInjector, TrainSupervisor

__all__ = [
    "psum_compressed",
    "tree_psum",
    "make_shardings",
    "reshard_tree",
    "FailureInjector",
    "TrainSupervisor",
]
