"""Native (C++) host runtime: frame rendering at memory speed.

The variable-length byte path (Huffman pack, side info, reservoir splice,
frame assembly) is pure integer/byte work — the one part of the framework
that belongs in native code rather than on the device or in Python. Built as a
shared library loaded via ctypes; the Python path in swiftmp3_tpu.io.framing
remains the behavioral reference (tests assert byte equality).
"""

from .lib import NativeStreamRenderer, native_available

__all__ = ["NativeStreamRenderer", "native_available"]
