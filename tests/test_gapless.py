"""options.gapless_info: sample-exact gapless playback.

The family pipeline has a structural 528-sample encoder delay (measured:
1057-sample source->decode latency through libmpg123 minus the standard
529-sample decoder synthesis delay), and flush() emits exactly the frames
the input filled — so the final `delay` samples of every stream are
silently truncated, and players have no delay/padding info to trim with.
gapless_info fixes both: flush covers the tail (+delay+529 zeros) and
generate_xing_header() appends the de-facto-standard LAME info-tag
extension (delay, padding, tag CRC). The reference writes no gapless info
(its Xing frame ends at the TOC, MP3Encoder.swift:415-417).

External validation: libmpg123's own gapless mode (the binding's
gapless=True) must trim the decode to EXACTLY the original sample count,
aligned at lag 0 — a third-party check of the whole chain (delay constant,
padding arithmetic, tag layout, tag CRC)."""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.encoder import GAPLESS_ENCODER_DELAY
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode

SR = 44100


def _chirp(n: int, ch: int = 1) -> np.ndarray:
    t = np.arange(n) / SR
    x = (0.5 * np.sin(2 * np.pi * (300 + 1500 * t / (n / SR)) * t)).astype(
        np.float32
    )
    if ch == 1:
        return x
    out = np.empty(n * 2, dtype=np.float32)
    out[0::2] = x
    out[1::2] = x * 0.7
    return out


def _encode_with_tag(opts, pcm):
    s = MP3Encoder(opts, backend="numpy").new_session()
    audio = s.encode(pcm) + s.flush()
    return s, s.generate_xing_header() + audio


def _parse_lame_fields(xing_frame: bytes, channels: int):
    side = 17 if channels == 1 else 32
    base = 4 + side
    assert xing_frame[base : base + 4] in (b"Xing", b"Info")
    lame_off = base + 4 + 4 + 4 + 4 + 100  # magic+flags+frames+bytes+TOC
    ident = xing_frame[lame_off : lame_off + 9]
    b0, b1, b2 = xing_frame[lame_off + 21 : lame_off + 24]
    delay = (b0 << 4) | (b1 >> 4)
    padding = ((b1 & 0xF) << 8) | b2
    return ident, delay, padding, lame_off


def test_tag_fields_and_crc():
    n = 3 * 1152 + 511
    opts = MP3EncoderOptions.spec_strict(
        mode=Mode.MONO, bitrate_kbps=128, gapless_info=True
    )
    s, blob = _encode_with_tag(opts, _chirp(n))
    from swiftmp3_tpu.io.xing import _crc16_zero
    from tests.util import parse_frames

    frames = parse_frames(blob)
    xf = blob[: frames[0].size]
    ident, delay, padding, lame_off = _parse_lame_fields(xf, 1)
    assert ident.startswith(b"LAME")
    assert delay == GAPLESS_ENCODER_DELAY
    total = s.encoded_frame_count * 1152
    assert padding == total - delay - n
    assert padding >= 529  # the end-trim margin gapless players need
    # every real sample is inside an emitted frame
    assert total >= delay + n + 529
    # info-tag CRC validates (what players check before trusting the tag)
    end = lame_off + 36
    stored = int.from_bytes(xf[end - 2 : end], "big")
    assert stored == _crc16_zero(xf[: end - 2])
    # the frames field holds the TRUE audio frame count (the reference's
    # +1 header-frame quirk would push players' end-trim point past the
    # stream); the non-gapless path keeps the reference quirk
    base = 4 + 17
    assert int.from_bytes(xf[base + 8 : base + 12], "big") == s.encoded_frame_count


def test_flag_off_keeps_reference_tag():
    n = 2 * 1152
    opts = MP3EncoderOptions.spec_strict(mode=Mode.MONO, bitrate_kbps=128)
    s, blob = _encode_with_tag(opts, _chirp(n))
    from tests.util import parse_frames

    xf = blob[: parse_frames(blob)[0].size]
    base = 4 + 17
    # reference quirk intact: frame_count + 1, no LAME ident after the TOC
    assert int.from_bytes(xf[base + 8 : base + 12], "big") == s.encoded_frame_count + 1
    lame_off = base + 16 + 100
    assert xf[lame_off : lame_off + 4] != b"LAME"


def test_drip_feed_matches_whole_buffer():
    n = 4 * 1152 + 333
    pcm = _chirp(n)
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=128, gapless_info=True
    )
    _, whole = _encode_with_tag(opts, pcm)
    s = MP3Encoder(opts, backend="numpy").new_session()
    audio = b"".join(
        s.encode(pcm[i : i + 1000]) for i in range(0, n, 1000)
    ) + s.flush()
    assert s.generate_xing_header() + audio == whole


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
@pytest.mark.parametrize(
    "preset,mode,floor",
    [
        ("strict", Mode.MONO, 15.0),
        ("hq", Mode.MONO, 40.0),
        ("hq", Mode.JOINT_STEREO, 30.0),
    ],
)
def test_mpg123_gapless_is_sample_exact(preset, mode, floor):
    n = 5 * 1152 + 700  # deliberately not frame-aligned
    ch = mode.channels
    pcm = _chirp(n, ch)
    mk = MP3EncoderOptions.spec_strict if preset == "strict" else MP3EncoderOptions.hq
    opts = mk(mode=mode, bitrate_kbps=192, gapless_info=True)
    _, blob = _encode_with_tag(opts, pcm)
    ext, _ = mpg123_decode(blob, gapless=True)
    assert ext.shape[0] == n, (preset, mode, ext.shape)
    x = pcm[0::ch].astype(np.float64) if ch == 2 else pcm.astype(np.float64)
    err = ext[:, 0].astype(np.float64) - x
    snr = 10 * np.log10(
        float(np.dot(x, x)) / max(float(np.dot(err, err)), 1e-15)
    )
    assert snr > floor, (preset, mode, snr)  # lag-0: no alignment search


@pytest.mark.slow
def test_pool_and_batch_match_session_gapless():
    """Byte parity: StreamPool and encode_batch under gapless_info equal
    per-stream sessions (tail zeros + tag fields included).

    Slow tier (round 5): three distinct device programs (~50 s, nearly all
    trace+compile) for pure integration parity; the gapless BYTE surface
    stays fast-covered by the session/oracle/mpg123 tests in this file."""
    from swiftmp3_tpu.parallel import StreamPool, encode_batch

    n = 3 * 1152 + 451
    pcm = _chirp(n)
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=128, gapless_info=True
    )
    # device-backend session: batch/pool ride the device float stack, and
    # byte equality is only guaranteed within a backend
    s = MP3Encoder(opts, backend="jax").new_session()
    want = s.encode(pcm) + s.flush()
    want = s.generate_xing_header() + want

    got_batch = encode_batch(opts, [pcm], frames_per_step=4)[0]
    assert got_batch == want[len(want) - len(got_batch):]  # audio bytes equal

    pool = StreamPool(opts, lanes=2, frames_per_step=4, pipelined=False)
    sid = pool.submit()
    pool.feed(sid, pcm)
    pool.close(sid)
    for _ in range(64):
        if pool.done(sid):
            break
        pool.step()
    assert pool.xing_header(sid) + pool.result(sid) == want
    pool.shutdown()


def test_oracle_gapless_trim_matches_mpg123():
    """decode_mp3(gapless=True) honors the LAME tag exactly like a
    gapless-aware player: sample-exact original length, aligned at lag 0,
    and (when available) equal in length to mpg123's own gapless read."""
    from swiftmp3_tpu.decoder import decode_mp3

    n = 4 * 1152 + 519
    pcm = _chirp(n)
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=192, gapless_info=True
    )
    _, blob = _encode_with_tag(opts, pcm)
    dec = decode_mp3(blob, iso_conventions=True, gapless=True)
    assert dec.pcm.shape[0] == n
    x = pcm.astype(np.float64)
    err = dec.pcm[:, 0].astype(np.float64) - x
    snr = 10 * np.log10(float(np.dot(x, x)) / max(float(np.dot(err, err)), 1e-15))
    assert snr > 40.0, snr  # lag 0, no alignment search
    # corrupting the tag must disable the trim (players' behavior):
    # flip a byte inside the CRC-covered region (the ident field)
    bad2 = bytearray(blob)
    base = 4 + 17 + 4 + 4 + 4 + 4 + 100
    bad2[base] ^= 0x01  # "LAME" -> "MAME"-ish; CRC now mismatches too
    dec2 = decode_mp3(bytes(bad2), iso_conventions=True, gapless=True)
    assert dec2.pcm.shape[0] != n  # untrimmed
    if have_mpg123():
        ext, _ = mpg123_decode(blob, gapless=True)
        assert ext.shape[0] == dec.pcm.shape[0] == n


def test_gapless_survives_checkpoint_resume():
    """state_dict/load_state_dict carries the fed-sample counter: a resumed
    session's flush padding and tag fields equal an uninterrupted one's."""
    n = 5 * 1152 + 207
    pcm = _chirp(n)
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=128, gapless_info=True
    )
    _, want = _encode_with_tag(opts, pcm)

    s1 = MP3Encoder(opts, backend="numpy").new_session()
    head = s1.encode(pcm[: n // 2])
    state = s1.state_dict()
    s2 = MP3Encoder(opts, backend="numpy").new_session()
    s2.load_state_dict(state)
    tail = s2.encode(pcm[n // 2 :]) + s2.flush()
    assert s2.generate_xing_header() + head + tail == want
