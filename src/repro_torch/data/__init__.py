"""Seeded synthetic data, the graph sampler and the step loader of the port."""
from .graph import CSRGraph, sample_hops
from .loader import StepLoader
from .synthetic import batched_molecules, clustered_vectors, ctr_batch, lm_batch, random_graph

__all__ = [
    "CSRGraph",
    "sample_hops",
    "StepLoader",
    "batched_molecules",
    "clustered_vectors",
    "ctr_batch",
    "lm_batch",
    "random_graph",
]
