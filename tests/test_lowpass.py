"""options.lowpass_hz: subband-granularity encoder lowpass.

The standard low-bitrate knob (libmp3lame lowpasses ~11-12 kHz at 64 kbps;
the reference has nothing): zero all MDCT subbands starting at/above the
cutoff before allocation so the whole bit budget concentrates below it.
Measured through libmpg123 at 64k mono, a 10 kHz cutoff takes speech and
noise masked-noise-ratio to lame parity; clean wideband material should
keep it off (full-band hq beats lame by ~13 dB NMR on tonal music)."""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder import decode_mp3
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode

SR = 44100


def _wideband(n: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.25 * np.sin(2 * np.pi * 14000 * t)
    x = x + 0.05 * rng.standard_normal(n)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _encode(opts, pcm, backend="numpy"):
    s = MP3Encoder(opts, backend=backend).new_session()
    return s.encode(pcm) + s.flush()


def _band_energy(dec_pcm: np.ndarray, lo_hz: float) -> float:
    X = np.fft.rfft(dec_pcm.astype(np.float64))
    f = np.fft.rfftfreq(len(dec_pcm), 1.0 / SR)
    return float(np.sum(np.abs(X[f >= lo_hz]) ** 2))


def test_lowpass_removes_highs_and_keeps_lows():
    pcm = _wideband(8 * 1152)
    on = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128, lowpass_hz=10000)
    off = on.replace(lowpass_hz=None)
    d_on = decode_mp3(_encode(on, pcm), iso_conventions=True).pcm[:, 0]
    d_off = decode_mp3(_encode(off, pcm), iso_conventions=True).pcm[:, 0]
    # cutoff rounds DOWN to a subband boundary: 10 kHz -> sb 14 -> 9.65 kHz
    hi_on = _band_energy(d_on, 11000.0)
    hi_off = _band_energy(d_off, 11000.0)
    assert hi_on < hi_off * 1e-3, (hi_on, hi_off)  # the 14 kHz tone is gone
    lo_on = _band_energy(d_on, 0.0) - _band_energy(d_on, 2000.0)
    lo_off = _band_energy(d_off, 0.0) - _band_energy(d_off, 2000.0)
    assert lo_on > 0.5 * lo_off  # the 440 Hz body survives


@pytest.mark.slow
def test_lowpass_backends_agree():
    from tests.util import parse_frames

    pcm = _wideband(6 * 1152)
    opts = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128, lowpass_hz=10000)
    a = _encode(opts, pcm, "numpy")
    b = _encode(opts, pcm, "jax")
    fa, fb = parse_frames(a), parse_frames(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert (x.size, x.padding) == (y.size, y.padding)


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_lowpass_improves_speechlike_nmr_at_64k():
    """The knob's reason to exist, pinned: at 64 kbps the masked-noise-ratio
    of speech-like content improves by >= 3 dB with a 10 kHz cutoff."""
    import sys as _sys

    _sys.path.insert(0, "tools")
    from tune_psy import synth

    from swiftmp3_tpu.utils.quality import masked_noise_ratio

    pcm = synth("speech", 12 * 1152, 10)
    trim = 2 * 1152
    ref = pcm[trim:-trim]
    vals = {}
    for fc in (None, 10000):
        opts = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=64, lowpass_hz=fc)
        ext, _ = mpg123_decode(_encode(opts, pcm))
        vals[fc] = masked_noise_ratio(ref, ext[:, 0], SR)
    assert vals[10000] < vals[None] - 3.0, vals
