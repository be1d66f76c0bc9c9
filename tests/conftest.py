"""Test configuration: an 8-device virtual CPU platform by default.

Must run before jax initializes its backends, so environment variables are
set at import time of this conftest (pytest imports conftest before test
modules). Sharding/multi-chip tests rely on the 8 fake devices; numeric tests
just use them as ordinary CPU. ``JAX_PLATFORMS`` is only defaulted, so
``JAX_PLATFORMS=cuda,cpu pytest -m gpu`` reaches the card (see
chip_smoke.py).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# Tests want fresh compiles and no cache directory filling up with CPU
# executables.
jax.config.update("jax_enable_compilation_cache", False)
