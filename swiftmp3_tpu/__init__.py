"""swiftmp3_tpu — a batched MPEG-1 Layer III (MP3) encoding framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
SwiftMP3 encoder (mierau/swift-mp3): the granule DSP (polyphase filterbank,
MDCT + aliasing reduction, transient detection, psychoacoustic model,
power-law quantization with rate control, table-15 Huffman sizing) runs as
batched fixed-shape tensor programs on the accelerator (a GPU), scaled by encoding many
independent streams per step; the variable-length bitstream (headers, side
info, bit reservoir splicing, Xing/ID3 metadata) is assembled host-side.

Public API parity with the reference:
    MP3Encoder, EncoderSession, MP3EncoderOptions, Mode, ID3Tag
plus the batch APIs in swiftmp3_tpu.parallel.
"""

import importlib

__version__ = "0.1.0"

# Lazy exports (PEP 562): importing the package must not initialize the XLA
# backend (encoder/pipeline create jnp constants at import), or
# jax.distributed.initialize for multi-host runs could never be called after
# `import swiftmp3_tpu` (see parallel.mesh.initialize_multihost).
_EXPORTS = {
    "ID3Tag": ".options",
    "MP3EncoderOptions": ".options",
    "Mode": ".options",
    "EncoderSession": ".encoder",
    "MP3Encoder": ".encoder",
}

__all__ = [*sorted(_EXPORTS), "__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
