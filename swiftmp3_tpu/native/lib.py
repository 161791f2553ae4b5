"""ctypes bindings + on-demand build of the native frame renderer."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..options import MP3EncoderOptions
from ..tables import mode_bits, sample_rate_index

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libmp3render.so")
_SRC = os.path.join(_DIR, "frame_render.cpp")
_HDR = os.path.join(_DIR, "tables_gen.h")  # included by _SRC

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", _SO, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, cwd=_DIR)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
            os.path.getmtime(_SRC), os.path.getmtime(_HDR)
        ):
            if not _build():
                _build_failed = True
                return None
        lib = ctypes.CDLL(_SO)
        lib.mp3_stream_new.restype = ctypes.c_void_p
        lib.mp3_stream_new.argtypes = [ctypes.c_int] * 13
        lib.mp3_stream_free.argtypes = [ctypes.c_void_p]
        lib.mp3_frame_count.restype = ctypes.c_uint32
        lib.mp3_frame_count.argtypes = [ctypes.c_void_p]
        lib.mp3_total_bytes.restype = ctypes.c_uint32
        lib.mp3_total_bytes.argtypes = [ctypes.c_void_p]
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        lib.mp3_render_frames.restype = ctypes.c_int64
        lib.mp3_render_frames.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            i32p, i32p, i32p, i32p,  # bitrate_index, padding, mdb, slot
            i32p, i32p, i32p, i32p,  # part23, big_values, gain, block_type
            i32p, i32p, i32p, i32p,  # preflag, region0, region1, subblock_gain
            i32p, i32p, i32p,        # scalefac_compress, table_select, count1table
            i8p,                     # quantized
            u8p, ctypes.c_int64,     # out, capacity
            i32p,                    # frame_sizes_out
            np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.mp3_render_frames_packed.restype = ctypes.c_int64
        lib.mp3_render_frames_packed.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            i32p, i32p, i32p, i32p,  # bitrate_index, padding, mdb, slot
            i32p, i32p, i32p, i32p,  # part23, big_values, gain, block_type
            i32p, i32p, i32p, i32p,  # preflag, region0, region1, subblock_gain
            i32p, i32p, i32p,        # scalefac_compress, table_select, count1table
            i32p,                    # scfsi [F, ch]
            i32p,                    # mode_ext [F]
            u8p, ctypes.c_int,       # main_data, cap
            i32p,                    # hb
            u8p, ctypes.c_int64,     # out, capacity
            i32p,                    # frame_sizes_out
            np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.mp3_flush_buffered.restype = ctypes.c_int64
        lib.mp3_flush_buffered.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, i32p, i32p
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeStreamRenderer:
    """Per-stream native frame assembler (same contract as FrameAssembler,
    array-driven interface)."""

    def __init__(self, options: MP3EncoderOptions):
        lib = _load()
        if lib is None:
            raise RuntimeError("native renderer unavailable (g++ build failed)")
        self._lib = lib
        self.options = options
        mb, me = mode_bits(options.mode.value)
        self._h = lib.mp3_stream_new(
            options.channels,
            sample_rate_index(options.sample_rate),
            1 if options.crc_protected else 0,
            1 if options.copyright else 0,
            1 if options.original else 0,
            mb,
            me,
            1 if options.reservoir_mode == "aligned" else 0,
            1 if options.iso_crc else 0,
            1 if options.real_scalefactors else 0,
            1 if options.iso_short_blocks else 0,
            int(options.reservoir_depth),
            int(options.lsf),  # 0/1/2 = MPEG-1/2/2.5 (one-granule LSF
            # side info, 8-bit mdb, 255-byte reservoir reach)
        )
        self.frame_sizes: list[int] = []

    def _sideinfo_defaults(self, F: int, scalefac_compress, table_select, count1table):
        """Compat-mode defaults for the spec-strict side-info fields:
        scalefac_compress=0, table_select=(15,15,15), count1table_select=0
        (the reference's hardcoded values)."""
        G = self.options.n_granules * self.options.channels
        if scalefac_compress is None:
            scalefac_compress = np.zeros((F, G), dtype=np.int32)
        if table_select is None:
            table_select = np.full((F, G, 3), 15, dtype=np.int32)
        if count1table is None:
            count1table = np.zeros((F, G), dtype=np.int32)
        return scalefac_compress, table_select, count1table

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mp3_stream_free(h)
            self._h = None

    @property
    def frame_count(self) -> int:
        return int(self._lib.mp3_frame_count(self._h))

    @property
    def total_bytes(self) -> int:
        return int(self._lib.mp3_total_bytes(self._h))

    def render(
        self,
        bitrate_index: np.ndarray,  # [F]
        padding: np.ndarray,
        mdb: np.ndarray,
        slot: np.ndarray,
        part23: np.ndarray,  # [F, G]
        big_values: np.ndarray,
        gain: np.ndarray,
        block_type: np.ndarray,
        preflag: np.ndarray,
        region0: np.ndarray,
        region1: np.ndarray,
        subblock_gain: np.ndarray,  # [F, G, 3]
        quantized: np.ndarray,  # [F, G, 576] int8
        scalefac_compress: np.ndarray = None,  # [F, G]
        table_select: np.ndarray = None,  # [F, G, 3]
        count1table: np.ndarray = None,  # [F, G]
    ) -> bytes:
        if self.options.spec_strict_entropy:
            # The C++ pack_granule packs table-15 pairs only; it cannot
            # produce the strict layout's per-region codes / count1 quads /
            # scalefactor bits, so side info would contradict the bits.
            # Strict streams flow through render_packed (device-packed
            # main_data) or the Python FrameAssembler.
            raise NotImplementedError(
                "NativeStreamRenderer.render() packs the compat (table-15) "
                "layout only; use render_packed for spec-strict options"
            )
        if self.options.iso_mode_ext:
            raise NotImplementedError(
                "render() writes the constant header mode_extension; "
                "iso_mode_ext streams flow through render_packed (per-frame "
                "mode_ext array)"
            )
        F = len(bitrate_index)
        if F == 0:
            return b""
        scalefac_compress, table_select, count1table = self._sideinfo_defaults(
            F, scalefac_compress, table_select, count1table
        )
        cap = int(slot.sum()) + F * 40 + 8192
        out = np.empty(cap, dtype=np.uint8)
        sizes = np.zeros(F, dtype=np.int32)
        n_emitted = np.zeros(1, dtype=np.int32)

        def c(a, dt=np.int32):
            return np.ascontiguousarray(a, dtype=dt)

        n = self._lib.mp3_render_frames(
            self._h, F,
            c(bitrate_index), c(padding), c(mdb), c(slot),
            c(part23), c(big_values), c(gain), c(block_type),
            c(preflag), c(region0), c(region1), c(subblock_gain),
            c(scalefac_compress), c(table_select), c(count1table),
            c(quantized, np.int8),
            out, cap, sizes, n_emitted,
        )
        if n < 0:
            raise RuntimeError("native render buffer overflow")
        self.frame_sizes.extend(int(s) for s in sizes[: int(n_emitted[0])])
        return out[:n].tobytes()

    def render_packed(
        self,
        bitrate_index: np.ndarray,  # [F]
        padding: np.ndarray,
        mdb: np.ndarray,
        slot: np.ndarray,
        part23: np.ndarray,  # [F, G]
        big_values: np.ndarray,
        gain: np.ndarray,
        block_type: np.ndarray,
        preflag: np.ndarray,
        region0: np.ndarray,
        region1: np.ndarray,
        subblock_gain: np.ndarray,  # [F, G, 3]
        main_data: np.ndarray,  # [F, cap] uint8 (device-packed)
        hb: np.ndarray,  # [F]
        scalefac_compress: np.ndarray = None,  # [F, G]
        table_select: np.ndarray = None,  # [F, G, 3]
        count1table: np.ndarray = None,  # [F, G]
        scfsi: np.ndarray = None,  # [F, ch] nibbles (options.scfsi)
        mode_ext: np.ndarray = None,  # [F] per-frame header mode_extension
    ) -> bytes:
        F = len(bitrate_index)
        if F == 0:
            return b""
        scalefac_compress, table_select, count1table = self._sideinfo_defaults(
            F, scalefac_compress, table_select, count1table
        )
        if scfsi is None:
            scfsi = np.zeros((F, self.options.channels), dtype=np.int32)
        if mode_ext is None:
            from ..tables import mode_bits as _mb

            mode_ext = np.full(F, _mb(self.options.mode.value)[1], dtype=np.int32)
        cap = main_data.shape[-1]
        out_cap = int(slot.sum()) + F * 40 + 8192
        out = np.empty(out_cap, dtype=np.uint8)
        sizes = np.zeros(F, dtype=np.int32)
        n_emitted = np.zeros(1, dtype=np.int32)

        def c(a, dt=np.int32):
            return np.ascontiguousarray(a, dtype=dt)

        n = self._lib.mp3_render_frames_packed(
            self._h, F,
            c(bitrate_index), c(padding), c(mdb), c(slot),
            c(part23), c(big_values), c(gain), c(block_type),
            c(preflag), c(region0), c(region1), c(subblock_gain),
            c(scalefac_compress), c(table_select), c(count1table),
            c(scfsi), c(mode_ext),
            c(main_data, np.uint8), cap, c(hb),
            out, out_cap, sizes, n_emitted,
        )
        if n == -2:
            raise RuntimeError(
                "device pack cap exceeded (rate-loop overflow); raise "
                "main_data_cap for this configuration"
            )
        if n < 0:
            raise RuntimeError("native render buffer overflow")
        self.frame_sizes.extend(int(s) for s in sizes[: int(n_emitted[0])])
        return out[:n].tobytes()

    def flush_buffered(self) -> bytes:
        """Emit every still-buffered frame (depth-general drain)."""
        depth = int(self.options.reservoir_depth)
        cap = 8192 * depth
        out = np.empty(cap, dtype=np.uint8)
        sizes = np.zeros(depth, dtype=np.int32)
        n_emitted = np.zeros(1, dtype=np.int32)
        n = self._lib.mp3_flush_buffered(self._h, out, cap, sizes, n_emitted)
        if n < 0:
            raise RuntimeError("native flush buffer overflow")
        self.frame_sizes.extend(int(x) for x in sizes[: int(n_emitted[0])])
        return out[:n].tobytes()
