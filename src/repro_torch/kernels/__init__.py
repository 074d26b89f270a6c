"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions and
the wrappers that dispatch between them by the device of the inputs."""
