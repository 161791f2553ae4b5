"""MPEG-2/2.5 (LSF) Layer III ENCODING — beyond-reference capability.

The reference's header writer is MPEG-1-only (MP3Encoder.swift:2533-2544
maps unknown sample rates to the 44.1 kHz index, mislabeling the stream),
so there is no parity surface at 8-24 kHz: LSF streams are only emitted
CONFORMING (options.__post_init__ requires iso_quantization + the aligned
reservoir). Validation is therefore fully external — libmpg123 is the
referee for every stream, and the in-repo decoder (itself mpg123-validated
on libmp3lame LSF streams, tests/test_lsf.py) must agree with mpg123 on
our own output.

Structural deltas from MPEG-1 covered here (ISO 13818-3 2.4.1.7/2.4.3.2):
- ONE granule per frame (576 samples), frame size 72*kbps*1000/sr;
- 8-bit main_data_begin (reservoir reach capped at 255 bytes);
- side info 9 bytes mono / 17 stereo, no scfsi, no preflag bit;
- 9-bit scalefac_compress carrying the case-0 slen decomposition
  (groups (6,5,5,5) long / (9,9,9,9) short at slen caps (4,4,3,3));
- LSF scalefactor band tables (incl. the 24 kHz corrigendum row and the
  8 kHz wide-band rows) — pinned equal to the decoder's machine-extracted
  libavcodec copy so the two independent spec transcriptions stay locked.
"""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu.decoder import decode_mp3
from swiftmp3_tpu.decoder._lsf_data import LSF_BAND_LONG, LSF_BAND_SHORT
from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu.tables import (
    LSF_LONG_BANDS,
    LSF_SHORT_BANDS,
    lsf_version,
    switch_bound,
)
from swiftmp3_tpu.utils.external import have_lame, have_mpg123, lame_encode, mpg123_decode
from swiftmp3_tpu.utils.quality import decode_agreement_snr, measure_quality

external = pytest.mark.skipif(
    not (have_mpg123() and have_lame()), reason="system codecs not available"
)

LSF_RATES = (22050, 24000, 16000, 11025, 12000, 8000)


def _content(sr: int, seconds: float = 1.5, stereo: bool = False, seed: int = 3):
    """Tonal bed + noise + one hard burst: exercises long granules, the
    sequencer's START/SHORT/STOP ladder (hq), and real scalefactors."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float32) / sr
    base = (
        0.35 * np.sin(2 * np.pi * 330.0 * t)
        + 0.1 * np.sin(2 * np.pi * 997.0 * t)
        + 0.04 * rng.standard_normal(n)
    ).astype(np.float32)
    c = n // 2
    base[c : c + 400] += (0.45 * rng.standard_normal(400)).astype(np.float32)
    if not stereo:
        return base
    return np.stack([base, np.roll(base, 5) * 0.8], axis=1).astype(np.float32)


def _encode(opts: MP3EncoderOptions, pcm: np.ndarray) -> bytes:
    sess = EncoderSession(opts, backend="numpy")
    return sess.encode(pcm) + sess.flush()


# --- table lockstep -----------------------------------------------------------


def test_lsf_band_tables_match_decoder_extraction():
    """The encode-side ISO 13818-3 transcriptions equal the decoder's
    machine-extracted libavcodec copy row for row (incl. the 24 kHz
    corrigendum band 17/18 boundary at 332 both sides carry)."""
    for sr in LSF_RATES:
        assert tuple(int(x) for x in LSF_LONG_BANDS[sr]) == LSF_BAND_LONG[sr], sr
        assert tuple(int(x) for x in LSF_SHORT_BANDS[sr]) == LSF_BAND_SHORT[sr], sr


def test_lsf_switch_bounds():
    """Window-switching region-0 boundary is band-derived (first 8 long
    bands for start/stop, 3x first 3 short bands for pure short); every
    MPEG-1 rate must still read exactly 36 — the constant the reference
    hardcodes is a MPEG-1-rate coincidence. MIXED granules follow the
    measured de-facto decoder law instead (tables.mixed_switch_bound;
    pinned with teeth in tests/test_lsf.py)."""
    for sr in (44100, 48000, 32000):
        assert switch_bound(sr, True) == 36
        assert switch_bound(sr, False) == 36
    for sr in (22050, 24000, 16000, 11025, 12000):
        assert switch_bound(sr, False) == 54
        assert switch_bound(sr, True) == 3 * int(np.sum(LSF_SHORT_BANDS[sr][:3]))
    assert switch_bound(8000, False) == 108
    assert switch_bound(8000, True) == 72


def test_lsf_options_guardrails():
    """LSF rates demand the conforming configuration: iso_quantization +
    aligned reservoir (no parity surface exists to be compatible with)."""
    with pytest.raises(ValueError):
        MP3EncoderOptions(sample_rate=22050, bitrate_kbps=64)
    opts = MP3EncoderOptions.spec_strict(sample_rate=22050, bitrate_kbps=64)
    assert opts.lsf == 1 and opts.n_granules == 1
    assert opts.samples_per_frame == 576 and opts.reservoir_cap == 255
    assert lsf_version(8000) == 2 and lsf_version(44100) == 0


# --- structural stream checks -------------------------------------------------


def _walk_lsf_frames(data: bytes, sr: int, channels: int):
    """Minimal LSF frame walker: yields (offset, size, kbps, mdb)."""
    from swiftmp3_tpu.tables import BITRATE_TABLE_V2

    version = lsf_version(sr)
    want_ver = {1: 0b10, 2: 0b00}[version]
    frames = []
    i = 0
    while i + 4 <= len(data):
        b = data[i : i + 4]
        assert b[0] == 0xFF and (b[1] & 0xE0) == 0xE0, f"bad sync at {i}"
        assert (b[1] >> 3) & 0x3 == want_ver, "wrong MPEG version bits"
        assert (b[1] >> 1) & 0x3 == 0b01, "not Layer III"
        kbps = int(BITRATE_TABLE_V2[(b[2] >> 4) & 0xF])
        padding = (b[2] >> 1) & 1
        size = (72 * kbps * 1000) // sr + padding
        side_off = i + 4  # no CRC in these tests
        mdb = data[side_off]  # 8-bit field, byte-aligned
        frames.append((i, size, kbps, mdb))
        i += size
    assert i == len(data), "trailing garbage"
    return frames


@pytest.mark.parametrize("mode", [Mode.MONO, Mode.STEREO])
def test_lsf_stream_structure(mode):
    """One granule per frame, 72-slot size law, 8-bit mdb <= 255, side
    info 9/17 bytes (verified implicitly by mpg123+own decode in the A/B
    tests; here by frame walk + sample count)."""
    sr, kbps = 16000, 48 if mode is Mode.MONO else 64
    pcm = _content(sr, stereo=mode is Mode.STEREO)
    opts = MP3EncoderOptions.spec_strict(sample_rate=sr, bitrate_kbps=kbps, mode=mode)
    blob = _encode(opts, pcm)
    n_in = len(pcm) if pcm.ndim == 1 else len(pcm)
    frames = _walk_lsf_frames(blob, sr, opts.channels)
    assert len(frames) == -(-n_in // 576)  # ceil: one 576-sample granule/frame
    assert all(f[3] <= 255 for f in frames)
    assert all(f[2] == kbps for f in frames)
    # mdb must actually engage on some frame (reservoir alive) at these rates
    assert any(f[3] > 0 for f in frames)


# --- external validation ------------------------------------------------------


@external
@pytest.mark.parametrize("sr", LSF_RATES)
def test_lsf_strict_encode_mono_all_rates(sr):
    """spec_strict mono at every LSF rate: mpg123 must decode our stream,
    the in-repo decoder must agree with mpg123 at conformance level, and
    the decoded audio must resemble the source."""
    kbps = {22050: 64, 24000: 64, 16000: 48, 11025: 32, 12000: 32, 8000: 16}[sr]
    pcm = _content(sr)
    opts = MP3EncoderOptions.spec_strict(sample_rate=sr, bitrate_kbps=kbps, mode=Mode.MONO)
    blob = _encode(opts, pcm)
    ext, xsr = mpg123_decode(blob)
    assert xsr == sr
    dec = decode_mp3(blob, iso_conventions=True)
    assert dec.sample_rate == sr and dec.channels == 1
    m = min(len(ext), len(dec.pcm))
    agree = decode_agreement_snr(ext[:m, 0], dec.pcm[:m, 0])
    assert agree > 100.0, (sr, kbps, agree)  # measured ~128-131 dB
    q = measure_quality(pcm, np.asarray(ext[:, 0], dtype=np.float32), sr)
    assert q.snr_db > 10.0, (sr, kbps, q)


@external
@pytest.mark.parametrize(
    "sr,kbps,mode",
    [(22050, 96, Mode.STEREO), (24000, 80, Mode.JOINT_STEREO), (8000, 24, Mode.JOINT_STEREO)],
)
def test_lsf_hq_stereo(sr, kbps, mode):
    """hq (linbits + sequencing + strict stereo laws) at LSF rates,
    stereo/joint: the full quality preset must stay conforming."""
    pcm = _content(sr, stereo=True)
    opts = MP3EncoderOptions.hq(sample_rate=sr, bitrate_kbps=kbps, mode=mode)
    blob = _encode(opts, pcm)
    ext, xsr = mpg123_decode(blob)
    assert xsr == sr and ext.shape[1] == 2
    dec = decode_mp3(blob, iso_conventions=True)
    m = min(len(ext), len(dec.pcm))
    for ch in range(2):
        agree = decode_agreement_snr(ext[:m, ch], dec.pcm[:m, ch])
        assert agree > 100.0, (sr, kbps, mode, ch, agree)


@external
def test_lsf_hq_transient_sequencing():
    """A burst-heavy LSF stream under hq must carry window-switching
    frames (the sequencer runs with n_gr=1 lookahead = next frame) and
    still decode conformingly."""
    sr = 16000
    rng = np.random.default_rng(7)
    n = 576 * 24
    pcm = (0.02 * rng.standard_normal(n)).astype(np.float32)
    for c in range(2000, n - 600, 3000):
        pcm[c : c + 300] += (0.5 * rng.standard_normal(300)).astype(np.float32)
    opts = MP3EncoderOptions.hq(sample_rate=sr, bitrate_kbps=48, mode=Mode.MONO)
    blob = _encode(opts, pcm)
    dec = decode_mp3(blob, iso_conventions=True)
    # window switching actually engaged: walk side infos directly
    from swiftmp3_tpu.decoder.decoder import parse_frame

    bts, off = [], 0
    while off + 4 <= len(blob):
        fi = parse_frame(blob, off)
        bts += [g.block_type for grs in fi.granules for g in grs]
        off += fi.size
    assert any(bt == 2 for bt in bts), "no short blocks on burst content"
    ext, xsr = mpg123_decode(blob)
    m = min(len(ext), len(dec.pcm))
    agree = decode_agreement_snr(ext[:m, 0], dec.pcm[:m, 0])
    assert agree > 100.0, agree


@external
@pytest.mark.slow
@pytest.mark.parametrize("sr", LSF_RATES)
def test_lsf_hq_quality_comparable_to_lame(sr):
    """The VERDICT bar: LSF output quality comparable to libmp3lame's at
    the same rate, through the neutral mpg123 referee. Floor: within 3 dB
    of lame's SNR on mixed tonal+noise content (hq typically wins; the
    floor only guards against a silent conformance-but-garbage regression)."""
    kbps = {22050: 64, 24000: 64, 16000: 48, 11025: 32, 12000: 32, 8000: 16}[sr]
    pcm = _content(sr, seconds=2.5)
    opts = MP3EncoderOptions.hq(sample_rate=sr, bitrate_kbps=kbps, mode=Mode.MONO)
    ours = _encode(opts, pcm)
    theirs = lame_encode(pcm, sample_rate=sr, bitrate_kbps=kbps, mode="mono")
    d_ours, _ = mpg123_decode(ours)
    d_lame, _ = mpg123_decode(theirs)
    q_ours = measure_quality(pcm, np.asarray(d_ours[:, 0], np.float32), sr).snr_db
    q_lame = measure_quality(pcm, np.asarray(d_lame[:, 0], np.float32), sr).snr_db
    assert q_ours > q_lame - 3.0, (sr, kbps, q_ours, q_lame)


# --- session mechanics at n_gr=1 ----------------------------------------------


def test_lsf_checkpoint_resume_bytes_identical():
    """state_dict/load_state_dict mid-stream at an LSF rate reproduces the
    continuous stream byte for byte (O(1) carry incl. the 255-cap
    reservoir counters and the 1-granule sequencer state)."""
    sr = 22050
    pcm = _content(sr, seconds=1.2)
    opts = MP3EncoderOptions.hq(sample_rate=sr, bitrate_kbps=48, mode=Mode.MONO)
    whole = _encode(opts, pcm)
    cut = 576 * 11 + 123
    a = EncoderSession(opts, backend="numpy")
    out1 = a.encode(pcm[:cut])
    state = a.state_dict()
    b = EncoderSession(opts, backend="numpy")
    b.load_state_dict(state)
    out2 = b.encode(pcm[cut:]) + b.flush()
    assert out1 + out2 == whole


def test_lsf_chunking_invariance():
    sr = 12000
    pcm = _content(sr, seconds=1.0)
    opts = MP3EncoderOptions.spec_strict(sample_rate=sr, bitrate_kbps=40, mode=Mode.MONO)
    whole = _encode(opts, pcm)
    sess = EncoderSession(opts, backend="numpy")
    out = b""
    for i in range(0, len(pcm), 1000):
        out += sess.encode(pcm[i : i + 1000])
    out += sess.flush()
    assert out == whole


# --- device (JAX pipeline) backend at n_gr=1 -----------------------------------


def _both_backends(opts: MP3EncoderOptions, pcm: np.ndarray) -> tuple[bytes, bytes]:
    outs = []
    for be in ("numpy", "jax"):
        sess = EncoderSession(opts, backend=be)
        outs.append(sess.encode(pcm) + sess.flush())
    return outs[0], outs[1]


@pytest.mark.parametrize(
    "sr,kbps,mode,preset",
    [
        (22050, 64, Mode.JOINT_STEREO, "spec_strict"),
        (16000, 48, Mode.MONO, "hq"),  # linbits + sequencing at n_gr=1
    ],
)
def test_lsf_device_backend_byte_equality(sr, kbps, mode, preset):
    """The JAX chunk pipeline at LSF rates (1 granule/frame, 72-slot size
    law, 255-byte reservoir reach, 9-bit case-0 scalefac_compress,
    band-derived switching region boundary) is byte-identical to golden.
    Burst content exercises short blocks and (hq) the START/STOP ladder."""
    rng = np.random.default_rng(11)
    n = (576 * 13 + 200) * (2 if mode is not Mode.MONO else 1)
    pcm = (0.02 * rng.standard_normal(n)).astype(np.float32)
    for c in range(1500, n - 600, 4000):
        pcm[c : c + 350] += (0.5 * rng.standard_normal(350)).astype(np.float32)
    pcm = np.clip(pcm, -1, 1)
    opts = getattr(MP3EncoderOptions, preset)(
        sample_rate=sr, bitrate_kbps=kbps, mode=mode
    )
    a, b = _both_backends(opts, pcm)
    assert a == b


def test_lsf_device_vbr_demand_byte_equality():
    """Demand-driven VBR over the LSF bitrate table (8..160) on device ==
    golden (incl. the Xing frame both write from the same frame sizes)."""
    sr = 22050
    pcm = _content(sr, seconds=1.1, stereo=True)
    opts = MP3EncoderOptions.spec_strict(
        sample_rate=sr, bitrate_kbps=64, vbr=True, vbr_demand=True, quality=3
    )
    a, b = _both_backends(opts, pcm)
    assert a == b


def test_lsf_device_checkpoint_resume():
    """JaxBackend state_dict/resume mid-stream at an LSF rate (the carry
    pytree holds the 255-cap counters and the n_gr=1 sequencer state)."""
    sr = 16000
    pcm = _content(sr, seconds=1.0)
    opts = MP3EncoderOptions.hq(sample_rate=sr, bitrate_kbps=48, mode=Mode.MONO)
    whole_sess = EncoderSession(opts, backend="jax")
    whole = whole_sess.encode(pcm) + whole_sess.flush()
    cut = 576 * 9 + 77
    a = EncoderSession(opts, backend="jax")
    out1 = a.encode(pcm[:cut])
    state = a.state_dict()
    b = EncoderSession(opts, backend="jax")
    b.load_state_dict(state)
    out2 = b.encode(pcm[cut:]) + b.flush()
    assert out1 + out2 == whole


def test_lsf_encode_batch_matches_sessions():
    """encode_batch at an LSF rate (uneven lengths, hq sequencing
    lookahead = the NEXT FRAME's granule at n_gr=1) equals per-stream
    sessions byte for byte (sessions use the Python FrameAssembler, so
    this also pins native==python on LSF bytes when the C++ renderer is
    available — see test_native.test_native_matches_python_lsf)."""
    from swiftmp3_tpu.parallel.batch import encode_batch

    rng = np.random.default_rng(3)
    opts = MP3EncoderOptions.hq(sample_rate=16000, bitrate_kbps=48, mode=Mode.MONO)
    streams = [
        (0.3 * rng.standard_normal(576 * k + j)).astype(np.float32)
        for k, j in ((9, 100), (13, 0), (4, 17))
    ]
    batch_out = encode_batch(opts, streams, frames_per_step=6)
    for i, s in enumerate(streams):
        assert batch_out[i] == _encode(opts, s)


@pytest.mark.slow
@pytest.mark.parametrize("sr", LSF_RATES)
def test_lsf_device_backend_all_rates(sr):
    """Cross-backend byte equality at every LSF rate (slow tier: six
    distinct compiles). 8 kHz also covers the odd-window polyphase pad
    (18T subband windows per chunk is not a multiple of 4 at odd T)."""
    kbps = {22050: 64, 24000: 64, 16000: 48, 11025: 32, 12000: 32, 8000: 16}[sr]
    pcm = _content(sr, seconds=1.0, stereo=True, seed=sr % 97)
    opts = MP3EncoderOptions.spec_strict(sample_rate=sr, bitrate_kbps=kbps)
    a, b = _both_backends(opts, pcm)
    assert a == b


# --- LSF mixed blocks (round 5): 6-band head encode, un-demoted ---------------
# The encode side now emits MIXED granules at LSF rates under
# iso_short_blocks, using the decoder's validated hybrid reading
# (decoder.tables.mixed_head): stream-layout head = the first 3 short
# bands' worth of lines (72 at 8 kHz — the ISO 13818-3 6-long-band head —
# 36 elsewhere), ns (6,9,9,9) case-0 scalefactors, universal 2-subband
# MDCT head, region-0 bound from tables.switch_bound. The round-4 8 kHz
# perm malformation (a 564-entry "permutation" from the hardcoded 36-line
# head: line 12 is mid-band at 8 kHz) is pinned dead by the validity test.


def _mixed_content(sr: int, n_frames: int = 30, seed: int = 3) -> np.ndarray:
    """Tone with noise attacks at granule STARTS: transient_detect reads
    argmax(energies)==0 there, the MIXED verdict."""
    rng = np.random.default_rng(seed)
    n = 576 * n_frames
    t = np.arange(n) / sr
    pcm = (0.25 * np.sin(2 * np.pi * 400.0 * t)).astype(np.float32)
    for k in range(576 * 4, n - 600, 576 * 5):
        pcm[k : k + 120] += (rng.standard_normal(120) * 0.55).astype(np.float32)
    return pcm


def _block_histogram(blob: bytes) -> dict:
    from swiftmp3_tpu.decoder.decoder import parse_frame

    off, hist = 0, {}
    while off < len(blob):
        fi = parse_frame(blob, off)
        for gr in fi.granules:
            for g in gr:
                key = (g.block_type, g.mixed_block_flag)
                hist[key] = hist.get(key, 0) + 1
        off += fi.size
    return hist


def test_lsf_mixed_reorder_perm_valid_all_rates():
    """mixed_reorder_src is a true 576-permutation at every rate, its head
    is the validated hybrid head (3*cumsum(short)[2] natural lines, kept
    in natural order), and the tail follows the short law from sfb 3."""
    from swiftmp3_tpu.tables import mixed_reorder_src, short_band_table

    for sr in LSF_RATES + (44100, 48000, 32000):
        perm = mixed_reorder_src(sr)
        assert perm.shape == (576,), sr
        assert np.array_equal(np.sort(perm), np.arange(576)), sr
        head = 3 * int(np.cumsum(short_band_table(sr))[2])
        assert np.array_equal(perm[:head], np.arange(head)), sr


@pytest.mark.parametrize("sr,kbps", [(8000, 48), (16000, 48)])
def test_lsf_mixed_emitted_and_decodable(sr, kbps):
    """Granule-start attacks yield MIXED granules in the emitted stream
    (block_type 2 + mixed flag — not silently demoted), and the repo's own
    decoder round-trips the stream at a sane SNR."""
    pcm = _mixed_content(sr)
    opts = MP3EncoderOptions.spec_strict(
        mode=Mode.MONO, bitrate_kbps=kbps, sample_rate=sr
    )
    blob = _encode(opts, pcm)
    hist = _block_histogram(blob)
    assert hist.get((2, 1), 0) >= 5, hist
    dec = np.asarray(decode_mp3(blob, iso_conventions=True).pcm).reshape(-1)
    q = measure_quality(pcm[2 * 576 : -2 * 576], dec)
    assert q.snr_db > 10.0, q


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
@pytest.mark.parametrize("sr,kbps", [(8000, 48), (16000, 48), (22050, 64)])
def test_lsf_mixed_mpg123_agreement(sr, kbps):
    """Conformance arbitration: libmpg123 and the oracle agree at ~130 dB
    on LSF mixed streams (the same evidential standard as the decode-side
    8 kHz hybrid-reading work — a wrong head/reorder/scalefactor layout
    reads ~0-11 dB here, so the A/B has teeth)."""
    pcm = _mixed_content(sr)
    opts = MP3EncoderOptions.spec_strict(
        mode=Mode.MONO, bitrate_kbps=kbps, sample_rate=sr
    )
    blob = _encode(opts, pcm)
    assert _block_histogram(blob).get((2, 1), 0) >= 3
    ours = np.asarray(decode_mp3(blob, iso_conventions=True).pcm).reshape(-1)
    ext, esr = mpg123_decode(blob)
    assert esr == sr
    ext = ext.reshape(-1).astype(np.float32)
    m = min(len(ext), len(ours))
    agree = decode_agreement_snr(ext[:m], ours[:m])
    assert agree >= 60.0, agree
    # PER-FRAME agreement too: a single divergent granule vanishes into a
    # whole-stream score (the round-5 mixed region-bound bug hid exactly
    # this way — one ~14 dB granule behind a >60 dB global)
    for f in range(m // 576):
        seg = slice(f * 576, (f + 1) * 576)
        sig = float((ext[seg] ** 2).sum())
        err = float(((ext[seg] - ours[seg]) ** 2).sum())
        if sig > 1e-6:
            fa = 10 * np.log10(sig / (err + 1e-30))
            assert fa > 60.0, (f, fa)


@pytest.mark.parametrize("sr,kbps", [(8000, 48), (16000, 48)])
def test_lsf_mixed_device_parity(sr, kbps):
    """Device == golden bytes on LSF mixed streams (measured exact on
    these seeds; the rate loop's knife-edge flips on noise content are
    the documented cross-backend contract, so isolated flips would be
    re-pinned, not byte-for-byte demanded — see test_ulp_telemetry)."""
    pcm = _mixed_content(sr)
    opts = MP3EncoderOptions.spec_strict(
        mode=Mode.MONO, bitrate_kbps=kbps, sample_rate=sr
    )
    a, b = _both_backends(opts, pcm)
    assert len(a) == len(b)
    ndiff = sum(x != y for x, y in zip(a, b))
    assert ndiff == 0, ndiff


# --- LSF corpus-scale quality floors (round 5) --------------------------------
# tools/quality_vs_lame.py --sr {16000,22050,24000} --bitrates 32 48 64
# --frames 24 (2026-08-20): hq mean SNR over lame +10.3 / +7.6 / +6.0 dB at
# 16/22.05/24 kHz; mean NMR -3.5 / +2.0 / +0.2 (lower=better). Full table +
# attribution in ARCHITECTURE.md ("LSF quality position"). These floors pin
# the per-class position at 48 kbps (measured - 2 dB) so a regression at
# LSF rates becomes a test failure, mirroring the MPEG-1
# test_psy_corpus_regression_floors pattern.


@pytest.mark.slow
@pytest.mark.skipif(
    not (have_mpg123() and have_lame()), reason="external codecs needed"
)
@pytest.mark.parametrize("sr", [16000, 22050, 24000])
def test_lsf_quality_floors_48k(sr):
    import sys

    sys.path.insert(0, "tools")
    from tune_psy import synth
    import tune_psy as _tp

    from swiftmp3_tpu.utils.external import lame_encode
    from swiftmp3_tpu.utils.quality import measure_quality

    old_sr = _tp.SR
    _tp.SR = sr
    try:
        n = 24 * 1152
        kinds = ("speech", "music", "tonal", "noise", "burst")
        signals = {k: synth(k, n, 10 + i) for i, k in enumerate(kinds)}
    finally:
        _tp.SR = old_sr
    floors = {
        16000: {"speech": 23.3, "music": 24.4, "tonal": 57.5, "noise": 11.5, "burst": 30.4},
        22050: {"speech": 20.5, "music": 21.9, "tonal": 58.0, "noise": 7.2, "burst": 29.1},
        24000: {"speech": 19.0, "music": 20.5, "tonal": 54.0, "noise": 6.4, "burst": 25.4},
    }[sr]
    opts = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=48, sample_rate=sr)

    def score(pcm, blob):
        ext, esr = mpg123_decode(blob)
        assert esr == sr
        trim = 2 * 1152
        ref_pcm = pcm[trim:-trim]
        return measure_quality(
            ref_pcm, np.asarray(ext[:, 0], np.float32), sr, compensate_gain=False
        ).snr_db

    for kind, pcm in signals.items():
        ours = score(pcm, _encode(opts, pcm))
        assert ours > floors[kind], (sr, kind, ours)
        if kind in ("tonal", "burst"):
            # the decisive cells: hq's bitrate-scaling fidelity (linbits)
            # and transient machinery (sequencing + onset chain) must keep
            # a clear lead over lame at LSF rates
            lame = score(pcm, lame_encode(pcm, sr, 48, mode="mono"))
            margin = 15.0 if kind == "tonal" else 3.0
            assert ours > lame + margin, (sr, kind, ours, lame)
