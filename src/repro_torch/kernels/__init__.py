"""Hand-written CUDA kernels for the compute hot spots (Hopper, sm_90a).

  * ``aggregate`` — weighted model aggregation (FedLEO eqs. 4/9): the FL
    server hot spot, a memory-bound streaming reduction over K stacked
    parameter vectors, one launch over every leaf of a tree, each read
    where it lies.  Port of the Pallas kernel
    ``src/repro/kernels/aggregate.py::aggregate_flat``.
  * ``flash`` — grouped-query flash attention, forward (causal mask,
    sliding window, tanh soft-cap): the attention of the LLM zoo's
    prefill.  Port of the Pallas kernel
    ``src/repro/kernels/flash.py::flash_attention``.
  * ``ssd`` — the Mamba2 SSD chunked scan (an initial state in, y and
    the final state out, in one launch): the sequence mixer of the SSM
    and hybrid models' prefill.  Port of the Pallas kernel
    ``src/repro/kernels/ssd.py::ssd_scan``.
  * ``mamba_fused`` — the Mamba2 block's elementwise chains on the
    prefill path, each one pass over device memory: the causal conv with
    its bias and SiLU, and the skip, gate and RMSNorm (also the block's
    input norm).  They replace no TPU kernel: the reference leaves these
    chains to XLA's fusion.

Each kernel ships as ``<name>.py`` (the wrapper that launches
``csrc/<name>.cu``), ``<name>_ops.py`` (dispatch: the kernel for CUDA
tensors, the plain version for CPU tensors) and ``<name>_ref.py`` (the
plain PyTorch version).  ``build.py`` compiles the sources with ``nvcc``
at first use.
"""
