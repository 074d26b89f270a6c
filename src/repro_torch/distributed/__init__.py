"""The reference's ``repro.distributed``: collectives over a mesh's axes,
placing and resharding a state onto a mesh, and fault tolerance."""
from .collectives import psum_compressed, tree_psum
from .elastic import local_tree, make_shardings, reshard_tree
from .fault_tolerance import FailureInjector, TrainSupervisor

__all__ = [
    "psum_compressed",
    "tree_psum",
    "make_shardings",
    "reshard_tree",
    "local_tree",
    "FailureInjector",
    "TrainSupervisor",
]
