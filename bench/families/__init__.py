"""Everything in the benchmark that depends on a configuration's family,
one module a family: ``bench/families/<family>.py``, found by the
``family`` of the configuration file (``harness.family``).  A module
provides:

  * ``program_config(cfg, **overrides)``: the program's ``ArchConfig``
    holding the file's sizes; it refuses a file whose family is not the
    program's for that architecture;
  * ``leaves(cfg)``: (path, shape, kind, scale) of each leaf between
    ``embed`` and ``ln_final``, in draw order (``bench/weights.py``);
  * ``forward_flops(cfg, b, s, head_positions)``: the model FLOPs of one
    forward pass by term, and ``param_count(cfg)`` (``bench/counts.py``
    sums the terms);
  * ``reference``: the plain reference module of the layers between the
    embedding and the final norm, in ``bench/reference/``, whose
    ``blocks(params, cfg, prec)`` yields each block as a function of the
    residual stream and the embedding output;
  * ``prefill_kernels(cfg, itemsize)``: the ``harness.KernelUse`` of each
    hand-written kernel that the prefill drives;
  * ``SMALL`` and ``SMALL_LIMITS``: the sizes and, by traffic kind, the
    limits at which the CPU tests run the family's cells.
"""
