"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Tests run on the CPU with 8 fake devices even on a machine with a GPU (the
environment may name another platform, and jax may already be imported);
backends have not been initialized yet when conftest loads, so overriding
via ``jax.config`` (not just the env) is both necessary and sufficient.
Checks that need the card (compiled kernels, device timings) live in
``chip_smoke.py`` at the repo root, run on a machine with a GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except ImportError:  # pragma: no cover
    pass
