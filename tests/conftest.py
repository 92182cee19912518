import os
import sys

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see the real single device; only the dry-run
# launcher spoofs 512 devices (see src/repro/launch/dryrun.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
