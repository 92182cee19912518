"""``python -m repro_torch.worker`` — the remote evaluation worker daemon.

Thin entry-point shim; the implementation lives in
:mod:`repro_torch.search.remote.worker`.  Typical launch, on a machine
with a card::

    python -m repro_torch.worker --host 0.0.0.0 --port 7471 \
        --cache-dir /shared/repro-cache

and on one without (``--device cpu`` never starts CUDA; without it a
machine with no card refuses)::

    python -m repro_torch.worker --device cpu --port 7471

Then point an experiment at it with ``executor: {backend: remote,
workers: [host:7471, ...]}`` (or ``REPRO_REMOTE_WORKERS``, or the
explorer's ``--remote-workers``).  Daemons execute arbitrary pickled
code from connected clients — only expose them on trusted networks.
"""
from __future__ import annotations

import sys

from repro_torch.search.remote.worker import main

if __name__ == "__main__":
    sys.exit(main())
