"""Launch layer: production meshes (``mesh``), sharding rules
(``sharding``), abstract inputs (``specs``), the dry run (``dryrun``),
measured calibration (``calibrate``) and the training driver
(``train``)."""
