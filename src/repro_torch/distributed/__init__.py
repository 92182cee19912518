"""Distributed training: logical-axis sharding onto a ``DeviceMesh``
(``sharding``), the ``constrain`` hooks of model code (``api``), gradient
compression and fault tolerance.  The dry run over a fake process group is
``repro_torch.launch.dryrun``."""
