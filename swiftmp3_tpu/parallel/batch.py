"""Batched multi-stream encoding: the throughput path.

`BatchEncoder` encodes B independent streams in lockstep: PCM rides as
batch-major [B, T, frame] chunks scanned over T on device (batch axis
sharded over the mesh), then each stream's fixed-shape outputs are rendered
to bytes by a per-stream host assembler. Streams of unequal length are handled with
per-(t, b) valid/final masks that freeze the carry and reproduce single-
session semantics exactly (including the zero-padded `isFinal` frame for a
trailing partial frame and the delayed-frame flush).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..io.framing import FrameAssembler
from ..models.pipeline import (
    fetch_outputs,
    frame_results_from_outputs,
    init_carry,
    make_chunk_encoder,
)
from ..options import MP3EncoderOptions, SAMPLES_PER_GRANULE
from .mesh import carry_sharding, make_mesh


class BatchEncoder:
    """Encode a fixed-size batch of streams with one compiled scan program.

    Host rendering uses the native C++ renderer when available (use_native
    defaults to auto); the Python FrameAssembler path is the behavioral
    reference and fallback.
    """

    def __init__(
        self,
        options: MP3EncoderOptions,
        batch: int,
        frames_per_step: int = 64,
        mesh=None,
        use_native: bool | None = None,
        render_threads: int | None = None,
    ):
        self.options = options
        self.batch = batch
        self.frames_per_step = frames_per_step
        self.mesh = mesh
        if render_threads is None:
            render_threads = min(os.cpu_count() or 1, 8)
        self._pool = (
            ThreadPoolExecutor(max_workers=render_threads)
            if render_threads > 1 and batch > 1
            else None
        )
        self._reset_fn = None
        self._run = make_chunk_encoder(options, frames_per_step)
        carry = init_carry(batch, options)
        if mesh is not None:
            sh = carry_sharding(mesh)
            carry = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), carry)
        self.carry = carry
        if use_native is None:
            from ..native import native_available

            use_native = native_available()
        self.use_native = use_native
        if use_native:
            from ..native import NativeStreamRenderer

            self.renderers = [NativeStreamRenderer(options) for _ in range(batch)]
            self.assemblers = None
        else:
            self.renderers = None
            self.assemblers = [FrameAssembler(options) for _ in range(batch)]
        # every chunk tensor is batch-leading, like the carry
        self._xm = carry_sharding(mesh) if mesh is not None else None

    def close(self) -> None:
        """Release the render thread pool (idempotent; the encoder stays
        usable — drain falls back to the serial loop)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _put(self, arr):
        # Explicit device_put even unsharded, so prepare() can start the
        # upload ahead of the step that consumes it.
        if self._xm is None:
            return jax.device_put(arr)
        return jax.device_put(arr, self._xm)

    def prepare(
        self, pcm: np.ndarray, final: np.ndarray, valid: np.ndarray,
        lookahead: np.ndarray = None,
    ):
        """Start the host->device upload of a chunk's inputs (async); pass
        the result to step() later so the transfer overlaps other work."""
        out = (self._put(pcm), self._put(final), self._put(valid))
        if lookahead is not None:
            out = out + (self._put(lookahead),)
        return out

    def step(self, pcm, final, valid, lookahead=None):
        """Run one device scan chunk. pcm: [B, T, 1152*ch] float32 or int16
        (normalized by 1/32768 on device); final/valid: [B, T]. Accepts
        numpy arrays or device arrays from prepare(). Returns stacked
        outputs (device arrays, host copy already in flight).

        window_sequencing: `lookahead` [B, T, 576*ch] is REQUIRED — each
        frame's next raw granule (zeros after a stream's final frame);
        the chunk fn's START decisions read it (see models/pipeline.py)."""
        if self.options.window_sequencing:
            if lookahead is None:
                raise ValueError(
                    "window_sequencing needs the per-frame lookahead "
                    "chunk [B, T, 576*ch] (next raw granule per frame)"
                )
            self.carry, outs = self._run(
                self.carry, self._put(pcm), self._put(final),
                self._put(valid), self._put(lookahead),
            )
        else:
            self.carry, outs = self._run(
                self.carry, self._put(pcm), self._put(final), self._put(valid)
            )
        # Start the device->host copies now so they overlap the next chunk's
        # compute; fetch_outputs() later finds them complete.
        for leaf in jax.tree_util.tree_leaves(outs):
            try:
                leaf.copy_to_host_async()
            except AttributeError:
                break
        return outs

    def reset_lanes(self, lanes: np.ndarray) -> None:
        """Reset the device carry and host renderer state of the masked
        lanes to fresh-stream initial state (continuous batching: a lane
        whose stream finished is recycled for a new stream). lanes: [B]
        bool. Unmasked lanes are untouched bit-for-bit."""
        mask = np.asarray(lanes, dtype=bool)
        if not mask.any():
            return
        if self._reset_fn is None:
            B = self.batch

            @jax.jit
            def _reset(carry, init, m):
                def one(c, i):
                    mm = m.reshape((B,) + (1,) * (c.ndim - 1))
                    return jnp.where(mm, i, c)

                return jax.tree_util.tree_map(one, carry, init)

            self._reset_fn = _reset
            # device-resident init pytree, built once (serving resets a
            # lane nearly every step; re-uploading it each time would pay
            # the host->device transfer repeatedly)
            init = init_carry(self.batch, self.options)
            if self.mesh is not None:
                init = jax.tree_util.tree_map(
                    lambda x: jax.device_put(x, carry_sharding(self.mesh)), init
                )
            else:
                init = jax.tree_util.tree_map(jax.device_put, init)
            self._init_dev = init
        self.carry = self._reset_fn(self.carry, self._init_dev, self._put(mask))
        for b in np.flatnonzero(mask):
            if self.use_native:
                from ..native import NativeStreamRenderer

                self.renderers[int(b)] = NativeStreamRenderer(self.options)
            else:
                self.assemblers[int(b)] = FrameAssembler(self.options)

    def drain(self, outs, valid: np.ndarray) -> List[bytes]:
        """Render one chunk's outputs to bytes per stream. Streams render
        in parallel on a thread pool: per-stream state is independent and
        the C renderer runs GIL-free (ctypes releases the GIL), so this
        scales with cores."""
        outs = fetch_outputs(outs, self.options)
        B, T = valid.shape
        if self.use_native:
            counts = valid.sum(axis=1)  # valid is a prefix along T

            def render_one(b: int) -> bytes:
                F = int(counts[b])
                return self.renderers[b].render_packed(
                    outs["bitrate_index"][b, :F],
                    outs["padding"][b, :F],
                    outs["mdb"][b, :F],
                    outs["slot"][b, :F],
                    outs["part23"][b, :F],
                    outs["big_values"][b, :F],
                    outs["gain"][b, :F],
                    outs["block_type"][b, :F],
                    outs["preflag"][b, :F],
                    outs["region0"][b, :F],
                    outs["region1"][b, :F],
                    outs["subblock_gain"][b, :F],
                    outs["main_data"][b, :F],
                    outs["hb"][b, :F],
                    table_select=outs["table_select"][b, :F],
                    count1table=outs["count1table"][b, :F],
                    scalefac_compress=outs["scalefac_compress"][b, :F],
                    scfsi=outs["scfsi"][b, :F],
                    mode_ext=outs["mode_ext"][b, :F],
                )

            if self._pool is None:
                return [render_one(b) for b in range(B)]
            return list(self._pool.map(render_one, range(B)))
        emitted = [bytearray() for _ in range(B)]
        for t in range(T):
            for b in range(B):
                if not valid[b, t]:
                    continue
                fr = frame_results_from_outputs(outs, self.options, t, b)
                emitted[b] += self.assemblers[b].push(fr)
        return [bytes(e) for e in emitted]

    def flush(self) -> List[bytes]:
        if self.use_native:
            return [r.flush_buffered() for r in self.renderers]
        return [a.flush_buffered() for a in self.assemblers]


def encode_batch(
    options: MP3EncoderOptions,
    streams: Sequence[np.ndarray],
    frames_per_step: int = 64,
    mesh=None,
    use_mesh: bool = False,
    _return_encoder: bool = False,
):
    """Encode N independent PCM streams; returns MP3 bytes per stream.

    Equivalent to running one EncoderSession per stream (encode + flush),
    but batched on device. Streams may have different lengths.
    """
    if use_mesh and mesh is None:
        mesh = make_mesh()
    n_streams = len(streams)
    ch = options.channels
    frame_len = options.samples_per_frame * ch  # 1152 (MPEG-1) / 576 (LSF)
    if options.gapless_info:
        # EncoderSession.flush parity: extend each non-empty stream's tail
        # by delay+529 zeros so every real sample lands inside an emitted
        # frame (see encoder.GAPLESS_ENCODER_DELAY)
        from ..encoder import GAPLESS_DECODER_DELAY, GAPLESS_ENCODER_DELAY

        tail = (GAPLESS_ENCODER_DELAY + GAPLESS_DECODER_DELAY) * ch
        streams = [
            np.concatenate(
                [np.asarray(s), np.zeros(tail, dtype=np.asarray(s).dtype)]
            )
            if len(s)
            else np.asarray(s)
            for s in streams
        ]
    la_len = SAMPLES_PER_GRANULE * ch if options.window_sequencing else 0
    if la_len:
        # window_sequencing: one granule of encoder delay, identical to
        # EncoderSession (byte parity with per-stream sessions); the
        # lookahead granule per frame is sliced from the delayed stream.
        streams = [
            np.concatenate(
                [np.zeros(la_len, dtype=np.asarray(s).dtype), np.asarray(s)]
            )
            if len(s)
            else np.asarray(s)  # empty stream stays empty (session parity)
            for s in streams
        ]

    # Pad the batch to the mesh size if sharded.
    B = n_streams
    if mesh is not None:
        n_dev = mesh.devices.size
        B = ((n_streams + n_dev - 1) // n_dev) * n_dev

    lengths = np.array([len(s) for s in streams], dtype=np.int64)
    rem = lengths % frame_len
    n_frames = np.zeros(B, dtype=np.int64)
    n_frames[:n_streams] = lengths // frame_len + (rem > 0)
    T_total = int(n_frames.max()) if n_streams else 0

    enc = BatchEncoder(options, B, frames_per_step, mesh)
    out = [bytearray() for _ in range(n_streams)]
    Tc = frames_per_step

    # int16 streams upload raw (device normalizes by 1/32768);
    # mixed dtypes fall back to float32.
    pcm_dtype = (
        np.int16
        if n_streams and all(np.asarray(s).dtype == np.int16 for s in streams)
        else np.float32
    )

    def build_chunk(start: int):
        count = min(Tc, T_total - start)
        pcm = np.zeros((B, Tc, frame_len), dtype=pcm_dtype)
        t_idx = start + np.arange(Tc, dtype=np.int64)
        valid = t_idx[None, :] < n_frames[:, None]
        final = np.zeros((B, Tc), dtype=bool)
        for b in range(n_streams):
            lo = start * frame_len
            hi = min((start + count) * frame_len, int(lengths[b]))
            if hi > lo:
                seg = np.asarray(streams[b][lo:hi])
                if seg.dtype == np.int16 and pcm_dtype == np.float32:
                    seg = seg.astype(np.float32) / np.float32(32768.0)
                nrows = (hi - lo + frame_len - 1) // frame_len
                buf = np.zeros(nrows * frame_len, dtype=pcm_dtype)
                buf[: hi - lo] = seg
                pcm[b, :nrows] = buf.reshape(nrows, frame_len)
            # Session flush parity for is_final (the final frame takes no
            # reservoir draw): without sequencing, only a PARTIAL last
            # frame is emitted at flush (exact multiples end inside
            # encode(), never marked final); with the sequencing prepend
            # the flush always emits >= 1 frame, so every nonempty
            # stream's last frame is final — rem alone misses exact
            # multiples (latent until the drop criterion made final
            # frames budget-hungry).
            if (rem[b] or (la_len and lengths[b])) and (
                start <= n_frames[b] - 1 < start + Tc
            ):
                final[b, int(n_frames[b] - 1 - start)] = True
        la = None
        if la_len:
            la = np.zeros((B, Tc, la_len), dtype=pcm_dtype)
            for b in range(n_streams):
                for t in range(count):
                    lo = (start + t + 1) * frame_len
                    hi = min(lo + la_len, int(lengths[b]))
                    if hi > lo:
                        seg = np.asarray(streams[b][lo:hi])
                        if seg.dtype == np.int16 and pcm_dtype == np.float32:
                            seg = seg.astype(np.float32) / np.float32(32768.0)
                        la[b, t, : hi - lo] = seg
        return pcm, final, valid, la

    # Software pipeline, 3 stages deep: while chunk k computes, chunk k+1's
    # PCM uploads (prepare) and chunk k-1's bytes render (drain) — both
    # transfer directions and the host overlap device compute.
    starts = list(range(0, T_total, Tc))
    prepared = None
    prepared_valid = None
    if starts:
        pcm, final, valid, la = build_chunk(starts[0])
        prepared, prepared_valid = enc.prepare(pcm, final, valid, la), valid
    pending = None  # (outs, valid)
    for idx, start in enumerate(starts):
        outs = enc.step(*prepared)
        cur_valid = prepared_valid
        if idx + 1 < len(starts):
            pcm, final, valid, la = build_chunk(starts[idx + 1])
            prepared, prepared_valid = enc.prepare(pcm, final, valid, la), valid
        if pending is not None:
            for b, chunk in enumerate(enc.drain(*pending)):
                if b < n_streams:
                    out[b] += chunk
        pending = (outs, cur_valid)
    if pending is not None:
        for b, chunk in enumerate(enc.drain(*pending)):
            if b < n_streams:
                out[b] += chunk

    for b, tail in enumerate(enc.flush()):
        if b < n_streams:
            out[b] += tail
    result = [bytes(o) for o in out]
    if _return_encoder:
        return result, enc
    return result


def encode_batch_multihost(
    options: MP3EncoderOptions,
    local_streams: Sequence[np.ndarray],
    frames_per_step: int = 64,
    mesh=None,
) -> List[bytes]:
    """Multi-host (DCN) twin of encode_batch.

    Under `jax.distributed` (see parallel.mesh.initialize_multihost), every
    process calls this with ITS OWN list of streams — the same count on
    every host. The global mesh shards the combined batch over all hosts'
    devices; each host uploads only its shard's PCM
    (jax.make_array_from_process_local_data), the jitted step runs globally
    with no cross-device collectives in the numeric path, and each host
    renders only its own streams' bytes from its addressable output shards.
    Returns this host's MP3 byte streams, in local_streams order.

    Single-process it degenerates to the sharded encode_batch (and is
    byte-identical to per-stream sessions, like everything else).
    """
    import jax

    from ..models.pipeline import (
        fetch_outputs,
        frame_results_from_outputs,
        init_carry,
        make_chunk_encoder,
    )
    from ..io.framing import FrameAssembler
    from .mesh import process_batch_bounds, put_global

    if mesh is None:
        mesh = make_mesh()
    n_proc = jax.process_count()
    n_dev = mesh.devices.size
    local_dev = n_dev // n_proc
    ch = options.channels
    frame_len = options.samples_per_frame * ch  # 1152 (MPEG-1) / 576 (LSF)
    la_len = SAMPLES_PER_GRANULE * ch if options.window_sequencing else 0
    if la_len:
        # window_sequencing: one granule of encoder delay (see encode_batch)
        local_streams = [
            np.concatenate(
                [np.zeros(la_len, dtype=np.asarray(s).dtype), np.asarray(s)]
            )
            if len(s)
            else np.asarray(s)
            for s in local_streams
        ]
    n_local = len(local_streams)
    B_local = max(((n_local + local_dev - 1) // local_dev) * local_dev, local_dev)
    B_global = B_local * n_proc

    lo, hi = process_batch_bounds(mesh, B_global)
    assert hi - lo == B_local, (lo, hi, B_local)

    lengths = np.array([len(s) for s in local_streams], dtype=np.int64)
    rem = lengths % frame_len
    n_frames = np.zeros(B_local, dtype=np.int64)
    n_frames[:n_local] = lengths // frame_len + (rem > 0)
    # int16 streams ride raw (device normalizes by 1/32768), like encode_batch
    pcm_dtype = (
        np.int16
        if n_local and all(np.asarray(s).dtype == np.int16 for s in local_streams)
        else np.float32
    )
    t_local = int(n_frames.max()) if n_local else 0
    if n_proc > 1:
        from jax.experimental import multihost_utils

        t_all = multihost_utils.process_allgather(np.array([t_local]))
        t_total = int(np.max(t_all))
    else:
        t_total = t_local

    run = make_chunk_encoder(options, frames_per_step)
    carry = jax.tree_util.tree_map(
        lambda x: put_global(mesh, np.asarray(x), batch_axis=0),
        init_carry(B_local, options),
    )

    from ..native import native_available

    if native_available():
        from ..native import NativeStreamRenderer

        renderers = [NativeStreamRenderer(options) for _ in range(n_local)]
        use_native = True
    else:
        renderers = [FrameAssembler(options) for _ in range(n_local)]
        use_native = False

    out = [bytearray() for _ in range(n_local)]
    Tc = frames_per_step

    def build_local_chunk(start: int):
        pcm = np.zeros((B_local, Tc, frame_len), dtype=pcm_dtype)
        t_idx = start + np.arange(Tc, dtype=np.int64)
        valid = t_idx[None, :] < n_frames[:, None]
        final = np.zeros((B_local, Tc), dtype=bool)
        for b in range(n_local):
            lo_s = start * frame_len
            hi_s = min((start + Tc) * frame_len, int(lengths[b]))
            if hi_s > lo_s:
                seg = np.asarray(local_streams[b][lo_s:hi_s])
                if seg.dtype == np.int16 and pcm_dtype == np.float32:
                    seg = seg.astype(np.float32) / np.float32(32768.0)
                else:
                    seg = seg.astype(pcm_dtype)
                nrows = (hi_s - lo_s + frame_len - 1) // frame_len
                buf = np.zeros(nrows * frame_len, dtype=pcm_dtype)
                buf[: hi_s - lo_s] = seg
                pcm[b, :nrows] = buf.reshape(nrows, frame_len)
            # Session flush parity for is_final (the final frame takes no
            # reservoir draw): without sequencing, only a PARTIAL last
            # frame is emitted at flush (exact multiples end inside
            # encode(), never marked final); with the sequencing prepend
            # the flush always emits >= 1 frame, so every nonempty
            # stream's last frame is final — rem alone misses exact
            # multiples (latent until the drop criterion made final
            # frames budget-hungry).
            if (rem[b] or (la_len and lengths[b])) and (
                start <= n_frames[b] - 1 < start + Tc
            ):
                final[b, int(n_frames[b] - 1 - start)] = True
        la = None
        if la_len:
            la = np.zeros((B_local, Tc, la_len), dtype=pcm_dtype)
            for b in range(n_local):
                for t in range(Tc):
                    lo_s = (start + t + 1) * frame_len
                    hi_s = min(lo_s + la_len, int(lengths[b]))
                    if hi_s > lo_s:
                        seg = np.asarray(local_streams[b][lo_s:hi_s])
                        if seg.dtype == np.int16 and pcm_dtype == np.float32:
                            seg = seg.astype(np.float32) / np.float32(32768.0)
                        la[b, t, : hi_s - lo_s] = seg
        return pcm, final, valid, la

    def local_rows(global_arr) -> np.ndarray:
        """Assemble this host's [B_local, T, ...] rows from its addressable
        shards of a [B_global, T, ...] mesh-sharded array."""
        parts = {}
        for shard in global_arr.addressable_shards:
            b0 = shard.index[0].start or 0
            parts[b0] = np.asarray(shard.data)
        blocks = [parts[k] for k in sorted(parts)]
        return np.concatenate(blocks, axis=0)

    for start in range(0, t_total, Tc):
        pcm, final, valid, la = build_local_chunk(start)
        args = [
            put_global(mesh, pcm, batch_axis=0),
            put_global(mesh, final, batch_axis=0),
            put_global(mesh, valid, batch_axis=0),
        ]
        if la is not None:
            args.append(put_global(mesh, la, batch_axis=0))
        carry, outs = run(carry, *args)
        fetched = fetch_outputs({"packed": local_rows(outs["packed"])}, options)
        if use_native:
            counts = valid.sum(axis=1)
            for b in range(n_local):
                F = int(counts[b])
                out[b] += renderers[b].render_packed(
                    fetched["bitrate_index"][b, :F],
                    fetched["padding"][b, :F],
                    fetched["mdb"][b, :F],
                    fetched["slot"][b, :F],
                    fetched["part23"][b, :F],
                    fetched["big_values"][b, :F],
                    fetched["gain"][b, :F],
                    fetched["block_type"][b, :F],
                    fetched["preflag"][b, :F],
                    fetched["region0"][b, :F],
                    fetched["region1"][b, :F],
                    fetched["subblock_gain"][b, :F],
                    fetched["main_data"][b, :F],
                    fetched["hb"][b, :F],
                    table_select=fetched["table_select"][b, :F],
                    count1table=fetched["count1table"][b, :F],
                    scalefac_compress=fetched["scalefac_compress"][b, :F],
                    scfsi=fetched["scfsi"][b, :F],
                    mode_ext=fetched["mode_ext"][b, :F],
                )
        else:
            for t in range(Tc):
                for b in range(n_local):
                    if valid[b, t]:
                        out[b] += renderers[b].push(
                            frame_results_from_outputs(fetched, options, t, b)
                        )

    for b in range(n_local):
        out[b] += (
            renderers[b].flush_buffered()
        )
    return [bytes(o) for o in out]


def encode_corpus(
    options: MP3EncoderOptions,
    streams: Sequence[np.ndarray],
    tags=None,
    frames_per_step: int = 64,
    mesh=None,
) -> List[bytes]:
    """Encode N streams into COMPLETE MP3 files: per stream
    [ID3v2.3 tag][Xing/Info header][frames] — the batched equivalent of the
    reference's file-encode mode (MP3Encoder.swift:189-230) for e.g. a
    podcast corpus. `tags` is an optional per-stream list of ID3Tag.
    """
    from ..io.id3 import build_id3_tag
    from ..io.xing import build_xing_header

    frames, enc = encode_batch(
        options, streams, frames_per_step=frames_per_step, mesh=mesh,
        _return_encoder=True,
    )
    renderers = enc.renderers if enc.use_native else enc.assemblers
    files = []
    for b, audio in enumerate(frames):
        r = renderers[b]
        tag = tags[b] if tags else options.id3_tag
        id3 = build_id3_tag(tag) if tag else b""
        xing = build_xing_header(options, r.frame_count, r.total_bytes, r.frame_sizes)
        files.append(id3 + xing + audio)
    return files
