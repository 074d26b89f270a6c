"""eCP-FS in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

The retrieval path (build -> convert -> open -> quantized file-mode search
-> ``next(k)``) with its two distance kernels written by hand in CUDA C++
for ``sm_90a`` (``csrc/``), the serving path (the mutable index, snapshots,
packed device search, ``launch/``'s scheduler and ``Server``), and the LM
serving path with its flash-attention kernel.  Entry points run on
``device="cuda"`` unless the caller asks for the CPU.  This package imports nothing of ``repro``
or ``jax``.
"""
