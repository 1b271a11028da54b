"""Launch layer: the training driver (``train.py``).  The mesh, sharding,
dry-run and calibration modules of the reference are not ported yet."""
