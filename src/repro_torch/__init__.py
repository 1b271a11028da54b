"""repro_torch: the FedLEO reproduction on PyTorch and CUDA.

A port of the JAX/Pallas package ``repro`` to PyTorch on an NVIDIA
Hopper GPU, with the same subpackage layout and public names.  It
imports neither ``jax`` nor ``repro``: the pure-numpy modules
(orbits, comms, obs, analysis, data, core scheduling/propagation and
the FedLEO strategies) are copies of the reference's, with imports
rebound; models, optimizers, aggregation and training are rewritten in
PyTorch, and the aggregation kernel is CUDA C++ (``kernels/``).
Parameters stay plain dict/list pytrees in the reference layout
(``repro_torch.tree``; ``repro_torch.convert`` carries them across).
"""
