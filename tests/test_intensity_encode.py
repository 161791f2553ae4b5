"""Intensity-stereo ENCODING (options.intensity_stereo).

The decode surface (oracle + libmpg123 arbitration) was built in round 3
(tests/test_intensity.py hand-assembles conforming streams); this file
tests the ENCODER's emission of the same surface: all-LONG joint-stereo
frames carry mode_extension 0b01, the left channel codes the per-line L+R
sum above the per-granule bound, the right channel is zero there, and the
right channel's scalefactor slots carry pan positions for every band at or
above its final quantized extent (ops.reference.intensity_encode has the
law; the reference has no intensity mode at all — MP3Encoder.swift:
2547-2556 hardcodes mode_extension 0b10).

Quality floors pin the measured sweep (reference.IS_MIN_SFB note): at the
<= 24 kbps/channel activity window IS wins DOWNMIX SNR at equal rate; the
per-channel SNR cost (7 quantized pan angles) is the documented trade.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from swiftmp3_tpu.decoder import decode_mp3
from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu.tables import bitrate_value
from swiftmp3_tpu.utils import quality
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode

SR = 44100
N = 1152 * 12


def _panned_mix(n=N, seed=3):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    src = (
        0.5 * np.sin(2 * np.pi * 440 * t)
        + 0.3 * np.sin(2 * np.pi * 3100 * t)
        + 0.2 * np.sin(2 * np.pi * 8200 * t)
        + 0.05 * rng.standard_normal(n)
    ).astype(np.float32)
    pan = 0.25 + 0.5 * np.sin(2 * np.pi * 0.3 * t) ** 2
    return (src * pan).astype(np.float32), (src * (1 - pan)).astype(np.float32)


def _interleave(L, R):
    pcm = np.empty(2 * len(L), dtype=np.float32)
    pcm[0::2], pcm[1::2] = L, R
    return pcm


def _encode(pcm, kbps, **kw):
    opts = MP3EncoderOptions.hq(mode=Mode.JOINT_STEREO, bitrate_kbps=kbps, **kw)
    s = EncoderSession(opts, backend="numpy")
    return s.encode(pcm) + s.flush()


def _mode_exts(data: bytes) -> Counter:
    c: Counter = Counter()
    i = 0
    while i + 4 <= len(data):
        if data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0:
            c[(data[i + 3] >> 4) & 3] += 1
            br = (data[i + 2] >> 4) & 0xF
            pad = (data[i + 2] >> 1) & 1
            i += 144 * bitrate_value(br) * 1000 // SR + pad
        else:
            i += 1
    return c


def test_is_frames_emitted_and_stream_decodes():
    L, R = _panned_mix()
    data = _encode(_interleave(L, R), 32, intensity_stereo=True)
    exts = _mode_exts(data)
    assert exts.get(0b01, 0) >= 5, exts  # intensity frames actually emitted
    dec = np.asarray(decode_mp3(data, iso_conventions=True).pcm)
    assert dec.shape[1] == 2 and dec.shape[0] >= N


@pytest.mark.parametrize("kbps", [32, 48])
def test_is_downmix_beats_discrete_at_equal_rate(kbps):
    """The point of the mode: bits saved in the IS region buy a better
    coded sum at starving joint rates (measured +1.45 / +0.78 dB downmix
    SNR at 32/48k on the panned mix; floors leave ~0.4 dB slack)."""
    L, R = _panned_mix()
    pcm = _interleave(L, R)
    d_is = _encode(pcm, kbps, intensity_stereo=True)
    d_lr = _encode(pcm, kbps)
    assert len(d_is) == len(d_lr)  # equal rate: CBR same size
    dm_src = (L.astype(np.float64) + R.astype(np.float64))
    snr = {}
    for name, d in (("is", d_is), ("lr", d_lr)):
        dec = np.asarray(decode_mp3(d, iso_conventions=True).pcm)
        snr[name] = quality.measure_quality(
            dm_src, dec[:, 0] + dec[:, 1], SR, compensate_gain=False
        ).snr_db
    floor = 1.0 if kbps == 32 else 0.4
    assert snr["is"] >= snr["lr"] + floor, snr


def test_rate_gate_is_byte_noop_above_window():
    """intensity_stereo_active gates at <= 24 kbps/channel; at 64 kbps
    stereo the flag must be an exact byte no-op (compare against the same
    options minus the flag — hq(intensity_stereo=True) drops scfsi, so the
    baseline drops it too)."""
    L, R = _panned_mix(n=1152 * 6)
    pcm = _interleave(L, R)
    d_is = _encode(pcm, 64, intensity_stereo=True)
    d_lr = _encode(pcm, 64, scfsi=False)
    assert d_is == d_lr


def test_decorrelated_content_falls_back_to_discrete():
    """No granule qualifies an IS region on decorrelated noise: frames
    fall back to discrete stereo (mode_ext 0b00/0b10), not a pointless
    intensity signal (the region gate also rejects regions holding no
    right-channel energy, e.g. only lowpassed zero bands)."""
    rng = np.random.default_rng(7)
    n = 1152 * 8
    L = (rng.standard_normal(n) * 0.2).astype(np.float32)
    R = (rng.standard_normal(n) * 0.2).astype(np.float32)
    data = _encode(_interleave(L, R), 32, intensity_stereo=True)
    exts = _mode_exts(data)
    # overwhelmingly discrete; allow stray knife-edge engagements
    assert exts.get(0b01, 0) <= 2, exts


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
@pytest.mark.parametrize("kbps", [32, 48])
def test_is_stream_oracle_matches_mpg123(kbps):
    """Conformance: the oracle and libmpg123 read the emitted IS streams
    identically (~131 dB measured) — the same neutral-referee standard as
    the decode-side intensity tests."""
    L, R = _panned_mix()
    data = _encode(_interleave(L, R), kbps, intensity_stereo=True)
    assert _mode_exts(data).get(0b01, 0) >= 5
    ours = np.asarray(decode_mp3(data, iso_conventions=True).pcm)
    ext, esr = mpg123_decode(data)
    assert esr == SR
    for ch in range(2):
        agree = quality.decode_agreement_snr(ext[:, ch], ours[:, ch])
        assert agree >= 60.0, (kbps, ch, agree)


def test_transient_frames_intensity_code():
    """Round 5: transient frames no longer force the discrete fallback —
    every granule layout except MIXED intensity-codes (LONG/START/STOP by
    the long-band law, pure SHORT by the per-(band, window) law), so
    panned content with clicks stays IS throughout and the stream still
    conforms on both decoders."""
    n = 1152 * 12
    rng = np.random.default_rng(5)
    L, R = _panned_mix(n=n, seed=5)
    # hard clicks every ~4 frames
    for k in range(2, n, 1152 * 4):
        click = (rng.standard_normal(96) * 0.7).astype(np.float32)
        L[k : k + 96] += click
        R[k : k + 96] += click
    data = _encode(_interleave(L, R), 32, intensity_stereo=True)
    exts = _mode_exts(data)
    assert exts.get(0b01, 0) >= 10, exts  # transients engage too now
    dec = np.asarray(decode_mp3(data, iso_conventions=True).pcm)
    assert dec.shape[0] >= n
    if have_mpg123():
        ext, _ = mpg123_decode(data)
        m = min(len(ext), len(dec))
        for c in range(2):
            agree = quality.decode_agreement_snr(ext[:m, c], dec[:m, c])
            assert agree > 60.0, (c, agree)


def test_options_validation():
    with pytest.raises(ValueError, match="joint_stereo"):
        MP3EncoderOptions.hq(intensity_stereo=True)  # default mode stereo
    with pytest.raises(ValueError, match="scfsi"):
        MP3EncoderOptions.hq(
            mode=Mode.JOINT_STEREO, intensity_stereo=True, scfsi=True
        )
    with pytest.raises(ValueError, match="real_scalefactors"):
        MP3EncoderOptions(
            mode=Mode.JOINT_STEREO, intensity_stereo=True, iso_mode_ext=True
        )
    with pytest.raises(ValueError, match="MPEG-1"):
        MP3EncoderOptions.hq(
            mode=Mode.JOINT_STEREO, intensity_stereo=True, sample_rate=22050
        )
    # device backend accepts the flag (round-5 device twin)
    EncoderSession(
        MP3EncoderOptions.hq(
            mode=Mode.JOINT_STEREO, bitrate_kbps=32, intensity_stereo=True
        ),
        backend="jax",
    )


# --- Device twin (round 5): the chunk pipeline carries the full IS law ------
# (gate on raw transients / sequencing blocks, L+R transform + region
# qualification, max(sf, 7) pricing pad, knife-edge band-20 zeroing inside
# strict_finalize, post-walk position slots with the illegal marker 7 on
# un-summed bands). Every IS decision is a float reduction shared with the
# golden — knife-edge granules may flip across backends (ULP-flip contract,
# same as the strict preset's short-block test).


def _encode_dev(pcm, kbps, **kw):
    opts = MP3EncoderOptions.hq(mode=Mode.JOINT_STEREO, bitrate_kbps=kbps, **kw)
    s = EncoderSession(opts, backend="jax")
    return s.encode(pcm) + s.flush()


@pytest.mark.parametrize("kbps", [32, 48])
def test_device_twin_bytes_panned(kbps):
    """Panned tonal mix: device == golden byte-for-byte on the measured
    seeds (isolated ULP flips allowed per the cross-backend contract)."""
    L, R = _panned_mix(n=1152 * 10)
    pcm = _interleave(L, R)
    a = _encode(pcm, kbps, intensity_stereo=True)
    b = _encode_dev(pcm, kbps, intensity_stereo=True)
    assert len(a) == len(b)
    assert _mode_exts(b).get(0b01, 0) >= 5  # device path actually emits IS
    ndiff = sum(x != y for x, y in zip(a, b))
    assert ndiff <= max(2, len(a) // 2000), ndiff


def test_device_twin_bytes_decorrelated():
    """Decorrelated noise: both backends fall back to discrete stereo and
    agree byte-for-byte (the no-region law is the same reduction)."""
    rng = np.random.default_rng(7)
    n = 1152 * 8
    L = (rng.standard_normal(n) * 0.2).astype(np.float32)
    R = (rng.standard_normal(n) * 0.2).astype(np.float32)
    pcm = _interleave(L, R)
    a = _encode(pcm, 32, intensity_stereo=True)
    b = _encode_dev(pcm, 32, intensity_stereo=True)
    assert len(a) == len(b)
    ndiff = sum(x != y for x, y in zip(a, b))
    assert ndiff <= max(2, len(a) // 2000), ndiff


def test_device_twin_transient_frame_contract():
    """Transient content under hq trips rate-loop knife-edges WITHOUT the
    IS flag (measured: same divergence budget flag-off), so the contract
    here is structural: equal frame sizes and mode_extension sequence,
    divergent frames bounded (a flipped float decision rewrites that
    frame's payload, not the stream)."""
    n = 1152 * 10
    rng = np.random.default_rng(11)
    t = np.arange(n) / SR
    src = (0.4 * np.sin(2 * np.pi * 600 * t)).astype(np.float32)
    L, R = src.copy(), (0.6 * src).astype(np.float32)
    for k in range(2, n, 1152 * 4):
        c = (rng.standard_normal(96) * 0.7).astype(np.float32)
        L[k : k + 96] += c
        R[k : k + 96] += c
    pcm = _interleave(L, R)
    a = _encode(pcm, 32, intensity_stereo=True)
    b = _encode_dev(pcm, 32, intensity_stereo=True)
    assert len(a) == len(b)

    def walk(data):
        out, i = [], 0
        while i + 4 <= len(data):
            if data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0:
                br = (data[i + 2] >> 4) & 0xF
                pad = (data[i + 2] >> 1) & 1
                sz = 144 * bitrate_value(br) * 1000 // SR + pad
                out.append((i, sz, (data[i + 3] >> 4) & 3))
                i += sz
            else:
                i += 1
        return out

    fa, fb = walk(a), walk(b)
    assert [(s, m) for _, s, m in fa] == [(s, m) for _, s, m in fb]
    bad = sum(
        a[o1 : o1 + s1] != b[o2 : o2 + s2]
        for (o1, s1, _), (o2, s2, _) in zip(fa, fb)
    )
    assert bad <= max(1, len(fa) // 4), (bad, len(fa))


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_device_stream_mpg123():
    """Conformance via the DEVICE path: libmpg123 reads the device-emitted
    IS stream in ~130 dB agreement with the oracle (same standard as the
    golden-path test)."""
    L, R = _panned_mix()
    data = _encode_dev(_interleave(L, R), 32, intensity_stereo=True)
    assert _mode_exts(data).get(0b01, 0) >= 5
    ours = np.asarray(decode_mp3(data, iso_conventions=True).pcm)
    ext, esr = mpg123_decode(data)
    assert esr == SR
    for ch in range(2):
        agree = quality.decode_agreement_snr(ext[:, ch], ours[:, ch])
        assert agree >= 60.0, (ch, agree)


@pytest.mark.slow
def test_batch_and_pool_accept_intensity():
    """encode_batch and StreamPool produce the same bytes as a per-stream
    device session under the IS flag (the VERDICT done-condition: hq/
    batch/pool accept the flag).

    Slow tier (round 5): three distinct device programs (~45 s of
    trace+compile) for integration parity; the IS device byte surface
    stays fast-covered by test_device_twin_bytes_panned."""
    from swiftmp3_tpu.parallel.batch import encode_batch
    from swiftmp3_tpu.parallel.pool import StreamPool

    L, R = _panned_mix(n=1152 * 8)
    pcm = _interleave(L, R)
    pcm2 = pcm[: 2 * 1152 * 5].copy()
    opts = MP3EncoderOptions.hq(
        mode=Mode.JOINT_STEREO, bitrate_kbps=32, intensity_stereo=True
    )
    refs = []
    for p in (pcm, pcm2):
        s = EncoderSession(opts, backend="jax")
        refs.append(s.encode(p) + s.flush())
    outs = encode_batch(opts, [pcm, pcm2])
    assert outs[0] == refs[0] and outs[1] == refs[1]
    pool = StreamPool(opts, lanes=2, frames_per_step=4)
    a, b = pool.submit(), pool.submit()
    pool.feed(a, pcm)
    pool.feed(b, pcm2)
    pool.close(a)
    pool.close(b)
    for _ in range(100):
        pool.step()
        if pool.done(a) and pool.done(b):
            break
    assert pool.result(a) == refs[0] and pool.result(b) == refs[1]


def test_position_law_roundtrip():
    """The position quantizer inverts the decoder's tan split: for a
    hard-panned band pos=6 keeps left exact and right zero; for equal
    energies pos=3 splits the sum evenly."""
    from swiftmp3_tpu.decoder.decoder import _is_factors
    from swiftmp3_tpu.ops import reference as ref

    bounds = np.array([0, 4])
    l_ = np.array([1.0, -2.0, 0.5, 1.5], dtype=np.float32)
    # equal energy, perfectly correlated
    pos = ref.intensity_positions(
        np.pad(l_, (0, 572)), np.pad(l_, (0, 572)),
        np.concatenate([bounds, np.full(20, 576)]),
    )
    assert pos[0] == 3
    kl, kr = _is_factors(3, 0, 0, 0)
    s = l_ + l_
    np.testing.assert_allclose(s * kl, l_, rtol=1e-6)
    np.testing.assert_allclose(s * kr, l_, rtol=1e-6)
    # hard pan left
    pos = ref.intensity_positions(
        np.pad(l_, (0, 572)), np.zeros(576, dtype=np.float32),
        np.concatenate([bounds, np.full(20, 576)]),
    )
    assert pos[0] == 6
    kl, kr = _is_factors(6, 0, 0, 0)
    assert kl == 1.0 and kr == 0.0


# --- short-window intensity ENCODE (round 5) ----------------------------------
# Transient IS frames: LONG/START/STOP granules use the long-band position
# law, pure SHORT granules the ISO per-(band, window) law (per-window
# regions/extents, band 11 carries the per-window tail, illegal 7 on
# un-summed slots, per-window band-11/tail knife edge, max(slot, 7)
# pricing pad). All layout combinations and START/STOP IS granules are
# mpg123-validated decoder-side in tests/test_intensity.py; here the
# ENCODER's emitted streams must read identically on both decoders and
# match across backends.


def _transient_panned(n=1152 * 12, seed=5):
    rng = np.random.default_rng(seed)
    L, R = _panned_mix(n=n, seed=seed)
    for k in range(1152 * 2, n - 200, 1152 * 3):
        b = (rng.standard_normal(140) * 0.6).astype(np.float32)
        L[k : k + 140] += b
        R[k : k + 140] += 0.3 * b
    return L, R


def test_short_is_device_parity_and_conformance():
    """Transient panned content under hq+IS: device == golden bytes
    (measured exact on this seed; knife-edge flips stay under the
    telemetry contract), every frame emits mode_ext 0b01 with
    START/SHORT/STOP granules present, and both decoders read the stream
    identically (~135 dB measured)."""
    L, R = _transient_panned()
    pcm = _interleave(L, R)
    a = _encode(pcm, 32, intensity_stereo=True)
    b = _encode_dev(pcm, 32, intensity_stereo=True)
    assert len(a) == len(b)
    ndiff = sum(x != y for x, y in zip(a, b))
    assert ndiff <= max(2, len(a) // 1000), ndiff
    exts = _mode_exts(a)
    assert exts.get(0b01, 0) >= 10, exts
    from swiftmp3_tpu.decoder.decoder import parse_frame

    off, blocks = 0, set()
    while off < len(a):
        fi = parse_frame(a, off)
        for gr in fi.granules:
            blocks.add(gr[0].block_type if not gr[0].window_switching else gr[0].block_type + 10)
        off += fi.size
    # window_switching granules present (bt+10 marks them)
    assert any(k >= 10 for k in blocks), blocks
    if have_mpg123():
        ours = np.asarray(decode_mp3(a, iso_conventions=True).pcm)
        ext, _ = mpg123_decode(a)
        m = min(len(ext), len(ours))
        for c in range(2):
            agree = quality.decode_agreement_snr(ext[:m, c], ours[:m, c])
            assert agree > 60.0, (c, agree)


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_short_is_downmix_not_worse_than_fallback():
    """The point of the extension: on transient panned content at 32 kbps
    the IS stream's downmix must hold against the discrete fallback
    (equal rate; per-channel SNR is the wrong referee — 7 pan angles)."""
    L, R = _transient_panned(seed=9)
    pcm = _interleave(L, R)
    with_is = _encode(pcm, 32, intensity_stereo=True)
    without = _encode(pcm, 32)
    assert len(with_is) == len(without)
    trim = 2 * 1152
    dm_src = ((L + R) * 0.5)[trim:-trim]

    def dm_snr(blob):
        ext, _ = mpg123_decode(blob)
        mix = ((ext[:, 0] + ext[:, 1]) * 0.5).astype(np.float32)
        return quality.measure_quality(dm_src, mix).snr_db

    s_is, s_plain = dm_snr(with_is), dm_snr(without)
    assert s_is > s_plain - 0.5, (s_is, s_plain)


# --- Noise-flat carrier demotion (round 5; reference.IS_SFM) -----------------
# The corpus referee that motivated the gate is tools/is_corpus.py: per-
# granule broadband ILD trajectory error, the stereo-image metric downmix
# SNR cannot see. Measured record in ARCHITECTURE.md "Intensity stereo at
# corpus scale".


def test_noise_flat_gate_demotes_long_and_short():
    """Noise-like uppers must NOT intensity-code (the summed carrier
    concentrates the frame's energy and starves at the rate floor —
    measured image RMS 71.6 dB vs 2.4 discrete on pan_noise@32k before
    the gate); peaky harmonic uppers must keep their region."""
    from swiftmp3_tpu.ops import reference as ref

    rng = np.random.default_rng(5)
    noise = rng.standard_normal(576).astype(np.float32) * 0.1
    nl, nr, _, b0 = ref.intensity_encode(noise, noise * 0.5, 44100)
    assert b0 is None

    # tonal spectra carry leakage on every line (exact zeros only come
    # from the lowpass mask) — the live-line flatness law depends on it
    tone = (rng.standard_normal(576) * 1e-4).astype(np.float32)
    tone[[30, 200, 400]] += np.float32(1.0), np.float32(0.5), np.float32(0.3)
    _, _, _, b0t = ref.intensity_encode(tone * 0.7, tone * 0.3, 44100)
    assert b0t is not None

    # short law: per-WINDOW flatness (granule-level would be blinded by
    # quiet windows' tiny lines on transient granules — the measured
    # decorr tail). Window 2 noise, windows 0/1 tonal: only window 2
    # demotes.
    sl = np.zeros(576, np.float32)
    sl[0::3] = 0.0
    lines = np.arange(192)
    tonal_w = (rng.standard_normal(192) * 1e-4).astype(np.float32)
    tonal_w[[20, 60, 110]] += np.float32(1.0), np.float32(0.6), np.float32(0.4)
    noise_w = rng.standard_normal(192).astype(np.float32) * 0.2
    spec_l = np.zeros(576, np.float32)
    spec_r = np.zeros(576, np.float32)
    for w, content in ((0, tonal_w), (1, tonal_w), (2, noise_w)):
        spec_l[3 * lines + w] = content * 0.7
        spec_r[3 * lines + w] = content * 0.3
    _, _, _, b0_w = ref.intensity_encode_short(spec_l, spec_r, 44100)
    assert b0_w[0] is not None and b0_w[1] is not None, b0_w
    assert b0_w[2] is None, b0_w


def test_noise_flat_gate_device_parity():
    """The gate's device twin stays byte-exact with golden on gated
    content (noise demotes; the analysis is a float reduction under the
    ULP-flip contract, but this fixed content sits far from the 0.15
    threshold — Gaussian MDCT flatness ~0.28)."""
    rng = np.random.default_rng(11)
    n = 6 * 1152
    L = (rng.standard_normal(n) * 0.2).astype(np.float32)
    R = (rng.standard_normal(n) * 0.1 + 0.5 * L).astype(np.float32)
    pcm = _interleave(np.clip(L, -0.99, 0.99), np.clip(R, -0.99, 0.99))
    opts = MP3EncoderOptions.hq(
        mode=Mode.JOINT_STEREO, bitrate_kbps=32, intensity_stereo=True
    )
    outs = {}
    for backend in ("numpy", "jax"):
        s = EncoderSession(opts, backend=backend)
        outs[backend] = s.encode(pcm) + s.flush()
    assert outs["numpy"] == outs["jax"]


@pytest.mark.slow
@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_is_corpus_floors():
    """Corpus-scale IS floors (tools/is_corpus.py's referees, one seed):
    downmix must not regress vs discrete beyond the pinned margins, the
    image metric must hold on the classes the gate fixed, and noise-flat
    classes must emit ZERO IS frames at 32k (the gate law)."""
    import sys as _sys

    _sys.path.insert(0, "tools")
    from is_corpus import make_class, score

    n = 12 * 1152
    for kind, kbps, dmix_floor, img_ceiling in (
        ("pan_tonal", 48, 1.5, 2.0),     # IS dmix >= disc + 1.5 (measured +2.67)
        ("pan_speech", 32, -0.3, None),  # the pre-gate -1.14 deficit is gone
        ("pan_noise", 32, -0.3, 6.0),    # pre-gate image RMS was 71.6
    ):
        L, R = make_class(kind, n, 0)
        pcm = _interleave(L, R)
        with_is = _encode(pcm, kbps, intensity_stereo=True)
        without = _encode(pcm, kbps)
        s_is, img_is = score(pcm, with_is)
        s_d, _ = score(pcm, without)
        assert s_is >= s_d + dmix_floor, (kind, kbps, s_is, s_d)
        if img_ceiling is not None:
            assert img_is <= img_ceiling, (kind, kbps, img_is)
    # gate law: noise-flat classes emit no IS frames at the rate floor
    for kind in ("pan_noise", "decorr"):
        L, R = make_class(kind, n, 0)
        pcm = _interleave(L, R)
        blob = _encode(pcm, 32, intensity_stereo=True)
        assert _mode_exts(blob).get(0b01, 0) == 0, kind
