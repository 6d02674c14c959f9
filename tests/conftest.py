"""Test bootstrap: force JAX onto 8 virtual CPU devices.

The reference's tests require physical hardware (`/root/reference/src/utils.rs:60-75`
unwraps /dev/xdma* opens) so its CI never runs them.  Everything here runs
hardware-free on a virtual 8-device CPU mesh, so single-device math AND the
multi-device sharding paths are exercised in CI.  The GPU is checked by
`python chip_smoke.py` (README), not by this suite.
"""
import os

# Must happen before the first JAX backend initialization.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

from blaze_tpu.utils.cache import setup_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
setup_compile_cache()
