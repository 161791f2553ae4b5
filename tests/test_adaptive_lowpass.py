"""Adaptive lowpass (options.adaptive_lowpass).

Static options.lowpass_hz is a measured low-rate win on speech/noise but
removes real content from harmonic-rich wideband material. The adaptive
law (reference.ALP_FRAC / ALP_SFM) engages the cutoff per granule-channel
only where the high band is negligible (energy fraction < 1e-3) or
noise-like (spectral flatness > 0.15 — Gaussian MDCT coefficients sit at
~0.28, harmonic series < 0.05), so the knob is safe on unknown content.
Probe record (tools/probe_adaptive_lowpass.py, 64/96k mono, libmpg123,
interior-scored): adaptive == static BYTES on speech/music/tonal/noise
(100% engage) — the full static win everywhere static wins; on bright
harmonic content it tracks OFF (engage 6%, only filterbank warm-up
granules) where static LOSES 5.2 dB NMR at 96k (1.9 -> 7.1; 64k is
rate-starved either way, 7.5 -> 7.8).

The reference has no lowpass at all (its table-15 cap is the de-facto
quality limiter; MP3Encoder.swift:734-794) — this is a framework
extension, default off.
"""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.ops import dsp, reference as ref
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode
from swiftmp3_tpu.utils.quality import masked_noise_ratio

SR = 44100
needs_mpg123 = pytest.mark.skipif(
    not have_mpg123(), reason="libmpg123 not available"
)


def _encode(options: MP3EncoderOptions, pcm, backend="numpy") -> bytes:
    s = MP3Encoder(options, backend=backend).new_session()
    return s.encode(np.asarray(pcm, np.float32).reshape(-1)) + s.flush()


def _bright(n: int, seed: int = 77) -> np.ndarray:
    """Harmonic series (311 Hz, 1/k amplitudes) out to Nyquist — real
    high-band content the lowpass must not remove."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    phase = 2 * np.pi * 311.0 * t
    x = np.zeros(n)
    for k in range(1, int((SR / 2) // 311)):
        x += (0.55 / k) * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    x *= 0.8 / np.abs(x).max()
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _noisy(n: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    for i in range(1, 6):
        x[i:] += x[:-i] / (i + 1)
    return (0.4 * x / np.abs(x).max()).astype(np.float32)


def _spectra_of(pcm: np.ndarray) -> list[np.ndarray]:
    """Long-block spectra through the golden filterbank+MDCT with REAL
    running history. The first granule of any stream is filterbank
    warm-up (its high band reads flat regardless of content — the law
    legitimately engages there); steady-state granules are the ones the
    decision must classify correctly."""
    hist = np.zeros(512, np.float32)
    ov = np.zeros((32, 18), np.float32)
    specs = []
    for g in range(len(pcm) // 576):
        S, hist = ref.analyze_subbands(pcm[g * 576 : (g + 1) * 576], hist)
        spec, ov = ref.mdct_apply(S, ov, ref.BLOCK_LONG)
        specs.append(np.asarray(spec, np.float32))
    return specs


# ---------------------------------------------------------------- unit law


def test_decision_law_classes():
    """On steady-state granules (filterbank history warmed up): a noise
    high band engages (flat), a harmonic high band keeps (peaky), a
    silent high band engages (negligible) — golden and device agree.
    Measured stats (tools/probe_adaptive_lowpass.py diagnostics): bright
    sfm ~0.01 vs noise ~0.28 vs tone frac ~1e-10."""
    cut_sb = int(10000 * 64 // SR)
    n = 6 * 576
    cases = {
        "noise": (_noisy(n), True),
        "bright": (_bright(n), False),
        "lowband": (
            0.4 * np.sin(2 * np.pi * 440.0 * np.arange(n) / SR).astype(
                np.float32
            ),
            True,
        ),
    }
    for name, (pcm, want) in cases.items():
        for spec in _spectra_of(pcm)[2:]:
            got = ref.adaptive_lowpass_engage(spec, cut_sb)
            assert got == want, (name, got)
            dev = bool(np.asarray(dsp.adaptive_lowpass_engage(spec, cut_sb)))
            assert dev == want, (name, dev)


def test_warmup_granule_engages_then_releases():
    """The first granule of ANY stream is filterbank warm-up: its high
    band reads flat (sfm ~0.29 even on harmonic content) and the law
    engages — harmless (the band holds ramp-up garbage, not content) but
    it means adaptive streams are NOT byte-identical to lowpass-off even
    on pure bright content. Pin the release: by granule 2 the bright
    decision must be KEEP."""
    cut_sb = int(10000 * 64 // SR)
    specs = _spectra_of(_bright(6 * 576))
    decisions = [ref.adaptive_lowpass_engage(s, cut_sb) for s in specs]
    assert decisions[0] is True or decisions[0] == True  # noqa: E712
    assert not any(decisions[2:]), decisions


def test_flag_requires_lowpass_hz():
    with pytest.raises(ValueError):
        MP3EncoderOptions(adaptive_lowpass=True)


# ------------------------------------------------------------- end to end


def test_backends_agree_and_decision_varies():
    """golden == device bytes on mixed content with adaptive on; the
    decision must actually vary by content: on noise the adaptive stream
    equals the static-lowpass stream byte-for-byte (100% engage), on
    bright content it differs from static (the keep decision fired) and
    static differs from off (the knob has teeth)."""
    n = 8 * 1152
    bright = _bright(n)
    noise = _noisy(n)
    mixed = bright.copy()
    mixed[3 * 1152 : 5 * 1152] = _noisy(2 * 1152)
    base = dict(mode=Mode.MONO, bitrate_kbps=64, sample_rate=SR)
    adap = MP3EncoderOptions.hq(
        lowpass_hz=10000, adaptive_lowpass=True, **base
    )
    off = MP3EncoderOptions.hq(lowpass_hz=None, **base)  # disable the preset rule
    static = MP3EncoderOptions.hq(lowpass_hz=10000, **base)

    assert _encode(adap, noise, "numpy") == _encode(static, noise, "numpy")
    assert _encode(adap, bright, "numpy") != _encode(static, bright, "numpy")
    assert _encode(static, bright, "numpy") != _encode(off, bright, "numpy")

    g = _encode(adap, mixed, "numpy")
    d = _encode(adap, mixed, "jax")
    assert g == d


@needs_mpg123
def test_adaptive_matches_best_of_both_externally():
    """Through libmpg123: on noise at 64k the adaptive NMR must track the
    static lowpass win (within 0.5 dB — it IS static there); on bright
    harmonic content at 96k it must track lowpass-OFF (within 1.5 dB)
    while static is materially worse (probe: static +5.2 dB NMR)."""
    n = 16 * 1152
    trim = 2 * 1152

    def nmr(opts, pcm):
        ext, _ = mpg123_decode(_encode(opts, pcm))
        return masked_noise_ratio(pcm[trim:-trim], ext[:, 0], SR)

    def opts3(kbps):
        base = dict(mode=Mode.MONO, bitrate_kbps=kbps, sample_rate=SR)
        return (
            MP3EncoderOptions.hq(lowpass_hz=None, **base),
            MP3EncoderOptions.hq(lowpass_hz=10000, **base),
            MP3EncoderOptions.hq(
                lowpass_hz=10000, adaptive_lowpass=True, **base
            ),
        )

    _, static64, adap64 = opts3(64)
    noise = _noisy(n)
    assert nmr(adap64, noise) <= nmr(static64, noise) + 0.5

    off96, static96, adap96 = opts3(96)
    bright = _bright(n)
    off_n, stat_n, adap_n = (
        nmr(off96, bright), nmr(static96, bright), nmr(adap96, bright),
    )
    assert adap_n <= off_n + 1.5
    assert stat_n > off_n + 3.0, (off_n, stat_n)


# ------------------------------------------ hq preset rate-derived default


def test_hq_preset_rate_derived_lowpass_rule():
    """Round 4: hq engages the adaptive lowpass by default at starving
    rates (<= 96 kbps), is a no-op at 128k+, and any explicit
    lowpass_hz/adaptive_lowpass kwarg (including None/False) disables the
    rule entirely."""
    for kbps in (32, 64, 96):
        o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=kbps)
        assert o.lowpass_hz == 10000 and o.adaptive_lowpass, kbps
    for kbps in (112, 128, 192, 320):
        o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=kbps)
        assert o.lowpass_hz is None and not o.adaptive_lowpass, kbps
    o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=64, lowpass_hz=None)
    assert o.lowpass_hz is None and not o.adaptive_lowpass
    o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=64, lowpass_hz=8000)
    assert o.lowpass_hz == 8000 and not o.adaptive_lowpass
    o = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=64, adaptive_lowpass=False
    )
    assert o.lowpass_hz is None and not o.adaptive_lowpass
    # LSF rates: the 10 kHz cut sits at/above Nyquist for sr <= 16 kHz —
    # the pipeline skips the stage (cut_sb >= 32), bytes unchanged
    o = MP3EncoderOptions.hq(sample_rate=16000, bitrate_kbps=48, mode=Mode.MONO)
    off = MP3EncoderOptions.hq(
        sample_rate=16000, bitrate_kbps=48, mode=Mode.MONO, lowpass_hz=None
    )
    rng = np.random.default_rng(4)
    pcm = (0.3 * rng.standard_normal(576 * 6)).astype(np.float32)
    assert _encode(o, pcm, "numpy") == _encode(off, pcm, "numpy")


@needs_mpg123
def test_hq_preset_reaches_lame_noise_parity_at_64k():
    """The promoted probe claim (VERDICT r3 item 4): the hq preset a user
    reaches for at 64k mono now lands at libmp3lame NMR parity on the
    noise and speech classes through the neutral mpg123 referee (it
    previously lost them by ~1.4/-0.6 dB with full-band allocation;
    probe: off 12.5 -> preset 9.2 NMR on noise at 64k). Measured at the
    floor-setting run: noise 9.2 vs lame 10.5 (we win), speech 9.9 vs
    9.4 (0.6 dB behind = parity within content noise); floor +1.0 dB."""
    from swiftmp3_tpu.utils.external import have_lame, lame_encode

    if not have_lame():
        pytest.skip("libmp3lame not available")
    n = 16 * 1152
    trim = 2 * 1152

    def nmr_of(blob, pcm):
        ext, _ = mpg123_decode(blob)
        return masked_noise_ratio(pcm[trim:-trim], ext[:, 0], SR)

    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from tune_psy import synth

    for kind, seed in (("noise", 13), ("speech", 10)):
        pcm = synth(kind, n, seed)
        opts = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=64, sample_rate=SR)
        ours = nmr_of(_encode(opts, pcm), pcm)
        theirs = nmr_of(
            lame_encode(pcm, sample_rate=SR, bitrate_kbps=64, mode="mono"), pcm
        )
        assert ours <= theirs + 1.0, (kind, ours, theirs)
