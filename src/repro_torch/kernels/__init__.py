"""Hand-written CUDA kernels for the compute hot spots (Hopper, sm_90a).

  * ``aggregate`` — weighted model aggregation (FedLEO eqs. 4/9): the FL
    server hot spot, a memory-bound streaming reduction over K stacked
    parameter vectors.  Port of the Pallas kernel
    ``src/repro/kernels/aggregate.py::aggregate_flat``.

Each kernel ships as ``<name>.py`` (the wrapper that launches
``csrc/<name>.cu``), ``<name>_ops.py`` (dispatch: the kernel for CUDA
tensors, the plain version for CPU tensors) and ``<name>_ref.py`` (the
plain PyTorch version).  ``build.py`` compiles the sources with ``nvcc``
at first use.  The flash-attention and SSD kernels are not ported yet.
"""
