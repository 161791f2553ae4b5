"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

The tests run on the CPU; sharding tests run against
xla_force_host_platform_device_count=8. Must run before any jax import.
Tests that only run on the GPU carry the `chip` marker and skip here.
"""

import os

# XLA_FLAGS is read lazily at CPU client creation, so setting it here is
# still effective as long as no computation ran yet.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache: the fast tier's cost is dominated by
# per-test jit compiles of distinct option-combo chunk programs; caching
# them on disk cuts warm reruns roughly in half. `JAX_COMPILATION_CACHE_DIR`
# places it when set; otherwise it stays in the user cache directory below
# (wipe it to force cold compiles).
_cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.expanduser(
    "~/.cache/swiftmp3_tpu_xla_tests"
)
os.makedirs(_cache_dir, exist_ok=True)
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
