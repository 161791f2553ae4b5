"""Utilities: WAV I/O for tests/benchmarks, the compile cache."""

import os

from .wav import read_wav, write_wav

__all__ = [
    "compilation_cache_dir",
    "enable_compilation_cache",
    "read_wav",
    "set_xla_flags",
    "write_wav",
]

# Fixed in-checkout location (listed in .gitignore): the path is part of
# the cache key, so a cache that moves between runs never hits.
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


# XLA:GPU autotunes every large dot while compiling; at the corpus batch
# shape that kept the compat program compiling for over ten minutes on an
# H100, against ~20 s without autotuning (PERF.md). Launchers set these
# before JAX starts its backend; they are inert on the CPU.
XLA_FLAGS = ("--xla_gpu_autotune_level=0",)


def set_xla_flags() -> str:
    """Add XLA_FLAGS' entries to the environment's (an explicit setting of
    the same flag wins) and return the result. Call before JAX's backend
    starts."""
    flags = os.environ.get("XLA_FLAGS", "")
    for flag in XLA_FLAGS:
        if flag.split("=")[0] not in flags:
            flags = f"{flags} {flag}".strip()
    os.environ["XLA_FLAGS"] = flags
    return flags


def compilation_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache (the encoder's chunk
    programs take tens of seconds or more to compile cold; cached reloads
    are seconds) and return its directory."""
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return cache_dir
