"""Distributed execution: the layer between "one host" and the card
(the JAX package's ``search/remote/`` on the port).

* :mod:`~repro_torch.search.remote.transport` — length-prefixed JSON/pickle
  TCP framing (the JAX package's, byte for byte), handshake (protocol
  version, toolchain salt, fp32 numerics flags);
* :mod:`~repro_torch.search.remote.worker` — the daemon behind
  ``python -m repro_torch.worker``: executes detached-plan trials and
  generic calls, streams pruner reports, heartbeats, applies mid-trial
  pruner refreshes;
* :mod:`~repro_torch.search.remote.client` — :class:`RemoteClient`, the
  connection pool with failure detection and bounded resubmission;
* :mod:`~repro_torch.search.remote.executor` — :class:`RemoteExecutor`, the
  registry-pluggable streaming executor (``executor: remote``), with
  graceful degradation to local execution.

Kept import-light: the registry's ``ensure_builtins`` imports the
executor module; everything else loads on demand.
"""
