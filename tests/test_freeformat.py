"""Free-format (bitrate index 0) decode validation.

ISO 11172-3 2.4.2.3: bitrate index 0 means "free format" — any constant
bitrate; the frame size is NOT derivable from the header, so decoders
measure the sync spacing of the first frames (the padding bit still
modulates per frame). Two independent producers exercise the path:

- libmp3lame with lame_set_free_format(1) emits real free-format streams
  at non-table bitrates (e.g. 150 kbps); libmpg123 arbitrates the reading.
- Header rewriting: a CBR stream from THIS framework's encoder with every
  frame's bitrate index rewritten to 0 has identical sizes and payloads
  (size = base + padding in both laws), so the free-format decode must be
  PCM-identical to the CBR decode — a producer that needs no third-party
  codec and covers CRC re-verification (verify_frame_crcs shares the
  free-size inference with decode_mp3's frame walk).

The size-inference robustness case (a coincidental sync-like byte pattern
inside main_data) is covered directly: _free_format_size must reject a
decoy candidate whose implied spacing the following frames do not confirm.
"""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu.decoder import decode_mp3
from swiftmp3_tpu.decoder.decoder import (
    _crc16,
    _free_format_size,
    _iter_frames,
    parse_frame,
    verify_frame_crcs,
)
from swiftmp3_tpu.encoder import MP3Encoder
from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu.utils.external import have_lame, have_mpg123, lame_encode, mpg123_decode
from swiftmp3_tpu.utils.quality import decode_agreement_snr

external = pytest.mark.skipif(
    not (have_mpg123() and have_lame()), reason="system codecs not available"
)


def _burst(n: int, sr: int = 44100, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 523.0 * np.arange(n) / sr)
    for start in range(2000, n - 600, 4000):
        x[start : start + 300] += 0.5 * rng.standard_normal(300)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _rewrite_free_format(blob: bytes, fix_crc: bool = False) -> bytes:
    """Zero every frame header's bitrate index (-> free format). Frame
    sizes are unchanged (both laws are base + padding). With fix_crc, the
    stored CRC-16 is recomputed (its ISO coverage includes header byte 2,
    which carries the bitrate bits)."""
    out = bytearray(blob)
    for fi in _iter_frames(blob, strict=False):
        i = fi.offset
        out[i + 2] &= 0x0F
        if fix_crc and fi.crc:
            side_len = 17 if fi.channels == 1 else 32
            covered = bytes(out[i + 2 : i + 4]) + bytes(out[i + 6 : i + 6 + side_len])
            crc = _crc16(covered)
            out[i + 4] = crc >> 8
            out[i + 5] = crc & 0xFF
    return bytes(out)


@external
@pytest.mark.parametrize("kbps,mode", [(150, "mono"), (180, "joint")])
def test_free_format_lame_stream_agrees_with_mpg123(kbps, mode):
    """lame free-format streams at NON-TABLE bitrates (impossible to
    express without index 0) decode through the oracle at conformance
    agreement with mpg123. 150/180 kbps at 44.1 kHz are non-integral slot
    counts, so the padding bit modulates — the inference must subtract it."""
    sr = 44100
    base = _burst(int(1.5 * sr), sr)
    pcm = base if mode == "mono" else np.stack([base, np.roll(base, 5) * 0.8], axis=1)
    blob = lame_encode(pcm, sample_rate=sr, bitrate_kbps=kbps, mode=mode, free_format=True)
    # really free format: every frame header carries bitrate index 0
    frames = list(_iter_frames(blob, strict=False))
    assert len(frames) > 10
    assert all(((blob[f.offset + 2] >> 4) & 0xF) == 0 for f in frames)
    assert any(f.padding for f in frames) and any(not f.padding for f in frames)
    dec = decode_mp3(blob, iso_conventions=True)
    ext, xsr = mpg123_decode(blob)
    assert xsr == sr
    m = min(len(ext), len(dec.pcm))
    assert m >= len(base) - 2 * 1152
    for c in range(dec.channels):
        agree = decode_agreement_snr(ext[:m, c], dec.pcm[:m, c])
        assert agree > 60.0, (kbps, mode, c, agree)


def test_free_format_header_rewrite_is_pcm_identical():
    """A CBR stream with headers rewritten to index 0 decodes to the exact
    same PCM: same sizes, same payloads, only the size-derivation law
    differs. Covers the full inference->walk->decode path with no external
    codec dependency."""
    opts = MP3EncoderOptions(bitrate_kbps=64, mode=Mode.MONO)
    s = MP3Encoder(opts, backend="numpy").new_session()
    blob = s.encode(_burst(44100)) + s.flush()
    free = _rewrite_free_format(blob)
    assert free != blob
    a = decode_mp3(blob)
    b = decode_mp3(free)
    assert a.frame_count == b.frame_count and a.frame_count >= 38
    np.testing.assert_array_equal(a.pcm, b.pcm)


def test_free_format_size_inference_rejects_decoy_sync():
    """A sync-like byte pattern planted inside the first frame's main_data
    (matching version/layer/sample-rate bits + bitrate index 0) must NOT be
    taken as the frame size: the follow-up spacing check sees no header at
    the decoy's implied next offset and skips it."""
    opts = MP3EncoderOptions(bitrate_kbps=64, mode=Mode.MONO)
    s = MP3Encoder(opts, backend="numpy").new_session()
    free = bytearray(_rewrite_free_format(s.encode(_burst(44100)) + s.flush()))
    first = parse_frame(bytes(free), 0, free_size=_free_format_size(bytes(free), 0))
    true_base = first.size - first.padding
    # plant a decoy header image 60 bytes in (well inside main_data)
    decoy = 60
    free[decoy] = 0xFF
    free[decoy + 1] = free[1]
    free[decoy + 2] = free[2] & 0x0F  # same sr bits, bitrate index 0
    inferred = _free_format_size(bytes(free), 0)
    assert inferred == true_base, (inferred, true_base, decoy)


def test_verify_frame_crcs_walks_free_format_streams():
    """verify_frame_crcs on a protected free-format stream: the shared
    frame walk infers the size (it used to raise internally and silently
    return []); stored CRCs recomputed for the rewritten header verify
    True, stale ones verify False — never an empty list."""
    opts = MP3EncoderOptions(bitrate_kbps=64, mode=Mode.MONO, crc_protected=True, iso_crc=True)
    s = MP3Encoder(opts, backend="numpy").new_session()
    blob = s.encode(_burst(44100 // 2)) + s.flush()
    n_frames = sum(1 for _ in _iter_frames(blob, strict=False))
    assert verify_frame_crcs(blob) == [True] * n_frames  # sanity: ISO CRC law
    stale = _rewrite_free_format(blob, fix_crc=False)
    assert verify_frame_crcs(stale) == [False] * n_frames
    fixed = _rewrite_free_format(blob, fix_crc=True)
    assert verify_frame_crcs(fixed) == [True] * n_frames


# --- Free-format ENCODING (options.free_format, round 4) ---------------------


def _tone(frames: int) -> np.ndarray:
    t = np.arange(frames * 1152) / 44100.0
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 1870 * t)).astype(np.float32)


def test_free_format_encode_validation():
    with pytest.raises(ValueError, match="CBR-only"):
        MP3EncoderOptions(free_format=True, vbr=True)
    with pytest.raises(ValueError, match="8..640"):
        MP3EncoderOptions(free_format=True, bitrate_kbps=700)


def test_free_format_encode_off_table_rate_roundtrip():
    """Encoding at 150 kbps (an off-table rate, coerced to 160 without the
    flag): every header carries index 0, the own decoder size-infers and
    agrees with the CBR structure, and mpg123 (if present) reads it."""
    pcm = _tone(8)
    opts = MP3EncoderOptions.spec_strict(
        mode=Mode.MONO, bitrate_kbps=150, free_format=True,
        linbits_tables=True,
    )
    s = MP3Encoder(opts, backend="numpy").new_session()
    blob = s.encode(pcm) + s.flush()
    # base size 144*150000/44100 = 489 (+1 padding frames)
    frames = list(_iter_frames(blob))
    assert len(frames) == 8
    for fi in frames:
        assert blob[fi.offset + 2] >> 4 == 0  # bitrate index 0 (free)
    sizes = {fi.size for fi in frames}
    assert sizes <= {489, 490}, sizes
    dec = decode_mp3(blob, iso_conventions=True)
    assert dec.sample_rate == 44100 and len(dec.pcm) >= 7 * 1152
    if have_mpg123():
        theirs, tsr = mpg123_decode(blob)
        assert tsr == 44100
        n = min(len(dec.pcm), len(theirs))
        assert decode_agreement_snr(dec.pcm[:n, 0], theirs[:n, 0]) > 60


def test_free_format_encode_backends_byte_equal():
    # noise content under the ULP-flip contract: fine linbits quantization
    # of pure tones at high rates sits on rounding knife-edges where the
    # two float stacks flip (measured on this clip at plain 160k too —
    # not a free-format effect); the noise clip is flip-free.
    rng = np.random.default_rng(5)
    pcm = (0.3 * rng.standard_normal(6 * 1152)).astype(np.float32)
    opts = MP3EncoderOptions.spec_strict(
        mode=Mode.MONO, bitrate_kbps=150, free_format=True,
        linbits_tables=True,
    )
    a = MP3Encoder(opts, backend="numpy").new_session()
    b = MP3Encoder(opts, backend="jax").new_session()
    assert a.encode(pcm) + a.flush() == b.encode(pcm) + b.flush()


def test_free_format_xing_header_same_frame_size():
    """The Info frame must carry index 0 and the SAME constant size as the
    audio frames (decoders infer the stream's frame size from spacing)."""
    pcm = _tone(4)
    opts = MP3EncoderOptions.spec_strict(
        mode=Mode.MONO, bitrate_kbps=150, free_format=True,
        linbits_tables=True,
    )
    s = MP3Encoder(opts, backend="numpy").new_session()
    blob = s.generate_xing_header() + s.encode(pcm) + s.flush()
    frames = list(_iter_frames(blob))
    assert len(frames) == 5  # Info + 4 audio
    assert blob[2] >> 4 == 0
    assert frames[0].size == 489
    dec = decode_mp3(blob, iso_conventions=True)
    assert len(dec.pcm) >= 3 * 1152
