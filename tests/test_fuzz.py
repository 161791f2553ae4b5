"""Seeded fuzz: random configs x random signals, numpy vs JAX backend.

Checks the full contract on each draw: identical frame structure across
backends, valid bitstream, decoder-oracle acceptance (with decoded-value
sanity), and exact counter agreement. Compiled chunk encoders are cached
per option set (models/pipeline._cached_chunk_encoder), so trial count
scales without paying a jit compile per trial; seeds make failures
reproducible.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # 48 trials, ~4 min; the inner loop skips them

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder import decode_mp3

from .util import parse_frames

N_TRIALS = 32
N_ALIGNED_TRIALS = 8


def _random_signal(rng, n, kind):
    if kind == 0:
        return np.zeros(n, dtype=np.float32)
    if kind == 1:
        t = np.arange(n) / 44100
        f = rng.uniform(80, 8000)
        return (rng.uniform(0.05, 0.9) * np.sin(2 * np.pi * f * t)).astype(np.float32)
    if kind == 2:
        return (rng.standard_normal(n) * rng.uniform(0.01, 0.8)).astype(np.float32)
    if kind == 3:
        # bursty: silence with loud attacks (forces short blocks)
        x = np.zeros(n, dtype=np.float32)
        for _ in range(max(1, n // 4000)):
            p = rng.integers(0, max(n - 200, 1))
            x[p : p + 200] = (rng.standard_normal(min(200, n - p)) * 0.9).astype(
                np.float32
            )
        return x
    if kind == 5:
        # kind 5 — ANTI-correlated stereo (round 5: ms_symmetric): odd
        # lanes carry a negated, noised copy of the even lanes, with a
        # few common bursts so frames cross the transient machinery while
        # side-dominant. Exercises the symmetric M/S arm's byte path and
        # its interactions (shared_ms_blocks, sequencing, the IS gate
        # opt-out) — the round-3 lesson says decorrelation/anti-phase is
        # its own content axis; until this kind, no fuzz draw was
        # side-dominant.
        t = np.arange(n // 2) / 44100
        src = (0.4 * np.sin(2 * np.pi * rng.uniform(150, 2000) * t)).astype(
            np.float32
        )
        for _ in range(max(1, n // 8000)):
            p = int(rng.integers(0, max(len(src) - 300, 1)))
            src[p : p + 300] += (
                rng.standard_normal(min(300, len(src) - p)) * 0.5
            ).astype(np.float32)
        g = np.float32(rng.uniform(0.7, 1.0))
        x = np.empty(n, dtype=np.float32)
        x[0::2] = np.clip(src, -0.99, 0.99)
        x[1::2] = np.clip(
            -g * src
            + 0.01 * rng.standard_normal(len(src)).astype(np.float32),
            -0.99,
            0.99,
        )
        return x
    # kind 4 — M/S-hazard class (round 3: shared_ms_blocks): a correlated
    # tonal base (keeps the frame's M/S decision on) with bursts gated by
    # independent per-channel envelopes, so the channels' transient
    # detections can diverge inside M/S frames. Interleaved content: even
    # and odd samples get DIFFERENT envelopes. The other kinds are either
    # channel-correlated or (noise) never choose M/S — this class is what
    # exposed the mismatched-window-layout hazard.
    t = np.arange(n) / 44100
    base = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)).astype(np.float32)
    env = np.full(n, 0.2, dtype=np.float32)
    for ph in (0, 1):  # per-channel burst trains on interleaved lanes
        for _ in range(max(1, n // 5000)):
            p = int(rng.integers(0, max(n - 1000, 1)))
            sl = slice(p + ph, p + 1000, 2)
            env[sl] = 1.0
    x = base * env
    x[1::2] = np.clip(
        x[1::2] * 0.8
        + 0.02 * rng.standard_normal(len(x[1::2])).astype(np.float32),
        -0.99,
        0.99,
    )
    return x


@pytest.mark.parametrize("trial", range(N_TRIALS))
def test_fuzz_backend_equivalence(trial):
    rng = np.random.default_rng(1000 + trial)
    mode = [Mode.MONO, Mode.STEREO, Mode.JOINT_STEREO][int(rng.integers(0, 3))]
    sr = [44100, 48000, 32000][int(rng.integers(0, 3))]
    kbps = [64, 96, 128, 192][int(rng.integers(0, 4))]
    vbr = bool(rng.integers(0, 2))
    quality = int(rng.integers(0, 10))
    crc = bool(rng.integers(0, 2))
    ch = mode.channels

    # Long enough to stress the reservoir (it saturates/drains over ~10+
    # frames at low bitrates); occasionally a partial final frame.
    n_frames = int(rng.integers(2, 20))
    extra = int(rng.integers(0, 1152))
    n = (n_frames * 1152 + extra) * ch
    kind = int(rng.integers(0, 4))
    pcm = _random_signal(rng, n, kind)

    opts = dict(
        mode=mode, sample_rate=sr, bitrate_kbps=kbps, vbr=vbr,
        quality=quality, crc_protected=crc,
    )
    outs = {}
    counts = {}
    for be in ["numpy", "jax"]:
        s = MP3Encoder(MP3EncoderOptions(**opts), backend=be).new_session()
        outs[be] = s.encode(pcm) + s.flush()
        counts[be] = (s.encoded_frame_count, s.encoded_byte_count)

    fa = parse_frames(outs["numpy"])
    fb = parse_frames(outs["jax"])
    assert len(fa) == len(fb), opts
    for a, b in zip(fa, fb):
        assert (a.size, a.bitrate_kbps, a.padding, a.mode, a.crc_protected) == (
            b.size, b.bitrate_kbps, b.padding, b.mode, b.crc_protected,
        ), opts
    assert counts["numpy"][0] == counts["jax"][0]
    assert counts["numpy"][1] == counts["jax"][1]

    dec = decode_mp3(outs["jax"])
    assert dec.frame_count == len(fb)
    assert dec.sample_rate == sr and dec.channels == ch
    # decoded-value sanity. In compat mode the reference's reservoir
    # displacement can make individual frames undecodable (the oracle skips
    # them), so duration is bounded, not exact; samples must stay finite,
    # silence silent, and non-silent input non-silent.
    assert dec.pcm.shape[0] % 1152 == 0
    assert dec.pcm.shape[0] <= len(fb) * 1152
    assert np.all(np.isfinite(dec.pcm))
    peak = float(np.abs(dec.pcm).max()) if dec.pcm.size else 0.0
    if kind == 0:
        assert dec.pcm.shape[0] == len(fb) * 1152  # silence always decodes
        assert peak < 0.05
    elif float(np.abs(pcm).max()) > 0.05 and not vbr and dec.pcm.size:
        assert peak > 1e-3, opts


@pytest.mark.parametrize("trial", range(N_ALIGNED_TRIALS))
def test_fuzz_aligned_decodes(trial):
    """Aligned mode: random configs must produce streams the oracle decodes
    with matching frame counts AND faithful audio (granule-exact decode is
    covered in test_aligned_reservoir)."""
    rng = np.random.default_rng(2000 + trial)
    mode = [Mode.MONO, Mode.STEREO][int(rng.integers(0, 2))]
    sr = [44100, 48000][int(rng.integers(0, 2))]
    kbps = [64, 128][int(rng.integers(0, 2))]
    ch = mode.channels
    n = (int(rng.integers(3, 16)) * 1152 + int(rng.integers(0, 1152))) * ch
    kind = int(rng.integers(1, 4))
    pcm = _random_signal(rng, n, kind)
    opts = MP3EncoderOptions(
        mode=mode, sample_rate=sr, bitrate_kbps=kbps, reservoir_mode="aligned"
    )
    s = MP3Encoder(opts, backend="jax").new_session()
    data = s.encode(pcm) + s.flush()
    frames = parse_frames(data)
    dec = decode_mp3(data)
    assert dec.frame_count == len(frames) == s.encoded_frame_count
    # value check: gain-compensated SNR of the decoded audio vs the input
    # (aligned mode is ISO-placed, so the oracle should track the signal)
    from swiftmp3_tpu.utils.quality import measure_quality

    mono_in = pcm[0::ch] if ch > 1 else pcm
    q = measure_quality(mono_in, dec.pcm[:, 0], sr)
    if kind == 1:  # pure sine: clear correlation bound (quality varies with
        # frequency/bitrate draw; this is a sanity floor, not a target)
        assert q.snr_db > 3.0, (trial, q)
    else:  # noise / bursts: coarse-quantized but must stay correlated
        assert q.snr_db > -3.0, (trial, q)


N_STRICT_TRIALS = 8


@pytest.mark.parametrize("trial", range(N_STRICT_TRIALS))
def test_fuzz_spec_strict_flags(trial):
    """Spec-strict flag combinations (incl. psy_scalefactors/scfsi): the
    cross-backend contract on random signals is STRUCTURAL equality (frame
    sizes/headers — float-stack ULP flips in the rate loop can move
    individual bytes on noise-like content; byte equality within a backend
    is pinned by the frozen fixtures), plus a decoded-VALUE check: the
    conforming (iso_conventions) read of every strict draw must be
    near-unit-gain with a raw (UNcompensated) SNR floor — strict decode is
    unit-gain by construction, so level errors count as error. Draws ride
    a small config pool so the per-option-set jit cache bounds compiles."""
    rng = np.random.default_rng(3000 + trial)
    # independent draws: mode cycles all three (incl. joint stereo, whose
    # strict preset emits per-frame mode_ext); psy/scfsi flip on separate
    # trial bits so (mode, psy) combinations get coverage across 8 trials
    mode = [Mode.MONO, Mode.STEREO, Mode.JOINT_STEREO][trial % 3]
    psy = bool(trial & 2)
    scfsi = bool(trial & 4)
    opts = MP3EncoderOptions.spec_strict(
        mode=mode, psy_scalefactors=psy, scfsi=scfsi
    )
    ch = mode.channels
    n = (int(rng.integers(3, 10)) * 1152 + int(rng.integers(0, 1152))) * ch
    # kinds 4/5: the M/S-hazard and anti-correlated classes (stereo-law
    # content axes; kind 5 is interleave-structured, so mono draws demote
    # to the hazard class rather than encode a nyquist-alternating signal)
    kind = int(rng.integers(1, 6))
    if ch == 1 and kind == 5:
        kind = 4
    pcm = _random_signal(rng, n, kind)

    outs = {}
    for be in ["numpy", "jax"]:
        s = MP3Encoder(opts, backend=be).new_session()
        outs[be] = s.encode(pcm) + s.flush()

    fa = parse_frames(outs["numpy"])
    fb = parse_frames(outs["jax"])
    assert len(fa) == len(fb), (trial, psy, scfsi)
    for a, b in zip(fa, fb):
        assert (a.size, a.bitrate_kbps, a.padding, a.mode, a.crc_protected) == (
            b.size, b.bitrate_kbps, b.padding, b.mode, b.crc_protected,
        ), (trial, psy, scfsi)

    from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode
    from swiftmp3_tpu.utils.quality import decode_agreement_snr, measure_quality

    for be, blob in outs.items():
        dec = decode_mp3(blob, iso_conventions=True)
        assert dec.frame_count == len(fb), (trial, be)
        assert dec.pcm.shape[0] == len(fb) * 1152, (trial, be)  # all decode
        assert np.all(np.isfinite(dec.pcm))
        if have_mpg123():
            # EXTERNAL cross-check on every strict draw: a conformance-grade
            # third-party decoder must read the stream exactly like the
            # oracle (float-precision agreement on the common prefix;
            # mpg123's feed API may hold the tail frame back).
            ext, _ = mpg123_decode(blob)
            if ext.shape[0] > 1152:
                agree = decode_agreement_snr(ext[:, 0], dec.pcm[:, 0])
                assert agree > 90.0, (trial, be, agree)
        if float(np.abs(pcm).max()) > 0.05:
            mono_in = pcm[0::ch] if ch == 2 else pcm
            q = measure_quality(
                mono_in, dec.pcm[:, 0], 44100, compensate_gain=False
            )
            # raw unit-gain floors by content kind (sine / noise / bursts /
            # M/S-hazard tone+bursts); sanity floors, not targets — strict
            # decode must track both values AND level
            # kind 5's left channel is tonal+bursts; under the symmetric
            # M/S arm it must decode coherently (the pre-arm law left the
            # mid residual drowned, but the LEFT channel still tracked)
            floor = {1: 8.0, 2: 0.0, 3: 1.0, 4: 3.0, 5: 2.0}[kind]
            assert q.snr_db > floor, (trial, be, kind, q)


@pytest.mark.parametrize("trial", range(2))
def test_fuzz_strict_long_reservoir(trial):
    """Long strict streams (48-64 frames) at 64 kbps: the 511-byte
    reservoir saturates and drains repeatedly. Device backend only (the
    per-granule golden walk would dominate suite time; cross-backend
    equality is covered by the short strict draws) — asserts the reservoir
    is actually exercised (nonzero main_data_begin occurs), every frame
    decodes, and the raw unit-gain SNR floor holds."""
    from swiftmp3_tpu.utils.quality import measure_quality

    rng = np.random.default_rng(4000 + trial)
    n_frames = int(rng.integers(48, 65))
    kind = 2 + trial  # noise, then bursts
    pcm = _random_signal(rng, n_frames * 1152, kind)
    opts = MP3EncoderOptions.spec_strict(mode=Mode.MONO, bitrate_kbps=64)
    s = MP3Encoder(opts, backend="jax").new_session()
    data = s.encode(pcm) + s.flush()
    frames = parse_frames(data)
    assert len(frames) == n_frames

    from swiftmp3_tpu.decoder.decoder import parse_frame

    mdbs = []
    i = 0
    while i + 4 <= len(data):
        fi = parse_frame(data, i)
        mdbs.append(fi.main_data_begin)
        i += fi.size
    assert max(mdbs) > 0, "reservoir never engaged over a long 64 kbps stream"
    assert max(mdbs) <= 511

    dec = decode_mp3(data, iso_conventions=True)
    assert dec.frame_count == n_frames
    assert dec.pcm.shape[0] == n_frames * 1152  # every frame decodes
    q = measure_quality(pcm, dec.pcm[:, 0], 44100, compensate_gain=False)
    assert q.snr_db > (-1.0 if kind == 2 else 0.0), (trial, q)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_aligned_partial_strict_flags(trial):
    """Cross-mode draws: aligned reservoir with PARTIAL strict-flag subsets
    (the fuzz previously covered only all-flags-on or all-off). Structural
    cross-backend equality + full oracle decode of both streams."""
    rng = np.random.default_rng(5000 + trial)
    flag_sets = [
        dict(iso_quantization=True),
        dict(iso_quantization=True, count1_coding=True),
        dict(iso_quantization=True, region_table_select=True,
             real_scalefactors=True),
        dict(iso_quantization=True, count1_coding=True,
             real_scalefactors=True, iso_short_blocks=True),
    ]
    opts = MP3EncoderOptions(
        mode=[Mode.MONO, Mode.STEREO][trial % 2],
        bitrate_kbps=[96, 128][trial % 2],
        reservoir_mode="aligned",
        **flag_sets[trial],
    )
    ch = opts.channels
    n = (int(rng.integers(4, 12)) * 1152 + int(rng.integers(0, 1152))) * ch
    pcm = _random_signal(rng, n, int(rng.integers(1, 4)))

    outs = {}
    for be in ["numpy", "jax"]:
        s = MP3Encoder(opts, backend=be).new_session()
        outs[be] = s.encode(pcm) + s.flush()
    fa, fb = parse_frames(outs["numpy"]), parse_frames(outs["jax"])
    assert len(fa) == len(fb), trial
    for a, b in zip(fa, fb):
        assert (a.size, a.bitrate_kbps, a.padding) == (
            b.size, b.bitrate_kbps, b.padding,
        ), trial
    for be, blob in outs.items():
        dec = decode_mp3(blob)
        assert dec.frame_count == len(fb), (trial, be)
        assert dec.pcm.shape[0] == len(fb) * 1152, (trial, be)
        assert np.all(np.isfinite(dec.pcm))


N_IS_TRIALS = 3


@pytest.mark.parametrize("trial", range(N_IS_TRIALS))
def test_fuzz_intensity_active(trial):
    """IS-ACTIVE fuzz (round 5): hq(intensity_stereo=True) at 32 kbps
    joint — the rate window where the IS machinery actually runs — over
    the stereo content classes incl. the anti-correlated kind (which must
    route to the symmetric M/S arm, not the IS gate). Contract:
    structural cross-backend equality (IS decisions are float reductions
    — the ULP-flip contract), oracle acceptance, finite decode, and
    mpg123 agreement with the oracle on the device stream."""
    rng = np.random.default_rng(5000 + trial)
    kind = [3, 4, 5][trial]
    n = (int(rng.integers(4, 10)) * 1152 + int(rng.integers(0, 1152))) * 2
    pcm = _random_signal(rng, n, kind)
    opts = MP3EncoderOptions.hq(
        mode=Mode.JOINT_STEREO, bitrate_kbps=32, intensity_stereo=True
    )
    outs = {}
    for be in ["numpy", "jax"]:
        s = MP3Encoder(opts, backend=be).new_session()
        outs[be] = s.encode(pcm) + s.flush()
    fa = parse_frames(outs["numpy"])
    fb = parse_frames(outs["jax"])
    assert len(fa) == len(fb), (trial, kind)
    for a, b in zip(fa, fb):
        assert (a.size, a.bitrate_kbps, a.padding, a.mode) == (
            b.size, b.bitrate_kbps, b.padding, b.mode,
        ), (trial, kind)
    dec = decode_mp3(outs["jax"], iso_conventions=True)
    assert dec.frame_count == len(fb)
    assert np.all(np.isfinite(dec.pcm))
    from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode
    from swiftmp3_tpu.utils.quality import decode_agreement_snr

    if have_mpg123():
        ext, _ = mpg123_decode(outs["jax"])
        if ext.shape[0] > 1152:
            agree = decode_agreement_snr(ext[:, 0], dec.pcm[:, 0])
            assert agree > 60.0, (trial, kind, agree)
