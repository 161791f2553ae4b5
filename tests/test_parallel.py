"""Batch-parallel encoding tests: mesh sharding + lockstep multi-stream."""

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.parallel import encode_batch, make_mesh


def test_mesh_has_virtual_devices():
    import jax

    assert len(jax.devices()) == 8  # conftest forces 8 virtual CPU devices
    mesh = make_mesh()
    assert mesh.shape["data"] == 8


def test_batch_matches_sessions_sharded():
    opts = MP3EncoderOptions(mode=Mode.MONO)
    rng = np.random.default_rng(0)
    streams = [
        (rng.standard_normal(1152 * (2 + i % 3) + (211 * i) % 1000) * 0.4).astype(
            np.float32
        )
        for i in range(5)
    ]
    mesh = make_mesh()
    batched = encode_batch(opts, streams, frames_per_step=4, mesh=mesh)
    for i, s in enumerate(streams):
        sess = MP3Encoder(opts, backend="jax").new_session()
        expect = sess.encode(s) + sess.flush()
        assert batched[i] == expect, f"stream {i}"


def test_batch_unsharded_stereo():
    opts = MP3EncoderOptions(mode=Mode.STEREO)
    rng = np.random.default_rng(1)
    streams = [
        (rng.standard_normal(2 * 1152 * 3) * 0.3).astype(np.float32),
        (rng.standard_normal(2 * 1152 * 2 + 500) * 0.3).astype(np.float32),
    ]
    batched = encode_batch(opts, streams, frames_per_step=4)
    for i, s in enumerate(streams):
        sess = MP3Encoder(opts, backend="jax").new_session()
        expect = sess.encode(s) + sess.flush()
        assert batched[i] == expect


def test_empty_stream_in_batch():
    opts = MP3EncoderOptions(mode=Mode.MONO)
    streams = [
        np.zeros(0, dtype=np.float32),
        (np.sin(np.arange(1152 * 2) * 0.1) * 0.4).astype(np.float32),
    ]
    out = encode_batch(opts, streams, frames_per_step=2)
    assert out[0] == b""
    assert len(out[1]) > 0


def test_encode_corpus_complete_files():
    from swiftmp3_tpu import ID3Tag
    from swiftmp3_tpu.decoder import decode_mp3
    from swiftmp3_tpu.parallel import encode_corpus

    opts = MP3EncoderOptions(mode=Mode.MONO)
    rng = np.random.default_rng(4)
    streams = [
        (rng.standard_normal(1152 * 3) * 0.4).astype(np.float32),
        (rng.standard_normal(1152 * 2 + 500) * 0.4).astype(np.float32),
    ]
    tags = [ID3Tag(title=f"Episode {i}", artist="Pod") for i in range(2)]
    files = encode_corpus(opts, streams, tags=tags, frames_per_step=2)
    for i, blob in enumerate(files):
        assert blob[:3] == b"ID3"
        assert f"Episode {i}".encode() in blob[:200]
        dec = decode_mp3(blob)  # skips ID3 + Info frame
        assert dec.frame_count > 0
        # Xing declared counts match
        off = blob.index(b"Info")
        declared = int.from_bytes(blob[off + 8 : off + 12], "big")
        assert declared == dec.frame_count + 1


def test_multihost_single_process_int16_and_float_match():
    """encode_batch_multihost (single-process degenerate case) matches
    per-session encodes for both float32 and raw int16 streams."""
    from swiftmp3_tpu.parallel import encode_batch_multihost

    opts = MP3EncoderOptions(mode=Mode.MONO)
    rng = np.random.default_rng(11)
    f32 = (rng.standard_normal(1152 * 3 + 200) * 0.4).astype(np.float32)
    i16 = (rng.standard_normal(1152 * 2 + 900) * 8000).astype(np.int16)
    for pcm in (f32, i16):
        got = encode_batch_multihost(opts, [pcm], frames_per_step=4)[0]
        sess = MP3Encoder(opts, backend="jax").new_session()
        want = sess.encode(pcm) + sess.flush()
        assert got == want, pcm.dtype
