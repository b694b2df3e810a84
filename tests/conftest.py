"""Test harness: force an 8-device virtual CPU mesh before jax initialises.

Multi-chip sharding tests run on the host platform per SURVEY §4.7
(xla_force_host_platform_device_count). Tests never need a GPU: those
marked `gpu` skip here, and `python chip_smoke.py` runs the same checks
on the card; bench.py measures it.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from frad_python_tpu.utils import hostmem  # noqa: E402

hostmem.tune()

# Build the native module when absent (it is a gitignored build artifact)
# so the native-parity tests run instead of skipping; the toolchain-less
# fallback keeps the suite green either way.
from frad_python_tpu import native  # noqa: E402

if not native.available() and not os.environ.get("FRAD_TPU_NO_NATIVE"):
    try:
        from frad_python_tpu.native import build as _native_build

        _native_build.build()
        native.reload()
    except Exception:
        pass
