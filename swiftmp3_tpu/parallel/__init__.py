"""Parallelism: device meshes and batched multi-stream encoding.

The reference's concurrency story is N independent `Sendable` sessions on N
threads (MP3Encoder.swift:132, README.md:152-162); the accelerator
equivalent is batch (data) parallelism — thousands of independent streams
encoded per jitted step, the batch axis sharded over the devices of a flat
mesh. The time axis stays a `lax.scan` (MP3 state is a strict serial chain
per stream). No cross-device collectives exist in the numeric path;
multi-host = more batch shards.
"""

import importlib

# Lazy exports: .batch pulls the whole device pipeline (jnp constants →
# backend init); multi-host users must be able to import
# initialize_multihost from here BEFORE any backend-touching import.
_EXPORTS = {
    "batch_sharding": ".mesh",
    "carry_sharding": ".mesh",
    "initialize_multihost": ".mesh",
    "make_mesh": ".mesh",
    "process_batch_bounds": ".mesh",
    "put_global": ".mesh",
    "time_major_sharding": ".mesh",
    "BatchEncoder": ".batch",
    "encode_batch": ".batch",
    "encode_batch_multihost": ".batch",
    "encode_corpus": ".batch",
    "StreamPool": ".pool",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
