"""Pytest bootstrap: force the CPU x64 backend with 8 virtual devices.

The test suite runs on the CPU with x64 enabled and 8 virtual devices (for
mesh / sharding tests without several accelerators, per SURVEY.md section 5).
Backends initialize lazily, so switching via ``jax.config`` here — before any
test module touches a jax array — takes effect cleanly.  The GPU path is
checked by ``chip_smoke.py`` on the card.
"""

import os
import pathlib

import jax

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (the FFTW-wisdom analog, see boltzfft.cache):
# dedupes identical XLA programs across tests within one run and makes
# repeat suite runs faster.  An explicit JAX_COMPILATION_CACHE_DIR wins: JAX reads it itself.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = pathlib.Path(__file__).parent / ".xla_cache_tests"
    _cache_dir.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(_cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
