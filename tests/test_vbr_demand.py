"""Demand-driven VBR (options.vbr_demand).

The reference's VBR law wobbles bitrate by a frame-energy ratio
(MP3Encoder.swift:1144-1180) — energy is a poor proxy for coding cost.
vbr_demand picks the smallest bitrate whose slot covers the frame's
exact priced demand at the quality-mapped walk candidate. Measured
frontier on a mixed piece (tonal|speech|sparse-attacks|noise, libmpg123,
interior-scored NMR): dVBR q5 = 130 kbps / 14.4 NMR vs CBR-128 =
133 kbps / 17.2 and energy-VBR ~130 kbps / 17.3-20.4 — ~2.8 dB better
noise-to-mask at equal rate.
"""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder.decoder import _iter_frames
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode
from swiftmp3_tpu.utils.quality import masked_noise_ratio

from .util import parse_frames

SR = 44100
needs_mpg123 = pytest.mark.skipif(
    not have_mpg123(), reason="libmpg123 not available"
)


def _encode(opts, pcm, backend="numpy"):
    s = MP3Encoder(opts, backend=backend).new_session()
    return s.encode(np.asarray(pcm, np.float32)) + s.flush()


def _mixed(seg_frames: int = 4) -> np.ndarray:
    """Varying-difficulty content: quiet tone | loud tone | noise —
    the case VBR exists for."""
    rng = np.random.default_rng(7)
    seg = seg_frames * 1152
    t = np.arange(seg) / SR
    quiet = 0.05 * np.sin(2 * np.pi * 440 * t)
    loud = 0.6 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(
        2 * np.pi * 1337 * t
    )
    noise = 0.4 * rng.standard_normal(seg)
    return np.clip(
        np.concatenate([quiet, loud, noise]), -0.99, 0.99
    ).astype(np.float32)


def test_flag_requires_vbr_and_strict():
    with pytest.raises(ValueError):
        MP3EncoderOptions(vbr_demand=True)  # no vbr
    with pytest.raises(ValueError):
        MP3EncoderOptions(vbr=True, vbr_demand=True)  # no strict entropy


def test_bitrate_tracks_demand_and_backends_agree():
    """Per-frame bitrates must vary with content difficulty (smaller on
    the quiet segment than on noise), stay within the reference band cap,
    and agree exactly between golden and device."""
    pcm = _mixed()
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=128, sample_rate=SR,
        vbr=True, vbr_demand=True, quality=5,
    )
    brs = {}
    for backend in ("numpy", "jax"):
        blob = _encode(opts, pcm, backend)
        parse_frames(blob)
        brs[backend] = [fi.bitrate_kbps for fi in _iter_frames(blob)]
    assert brs["numpy"] == brs["jax"], brs
    b = brs["numpy"]
    max_cap = min(320, 128 + 64 - 5 * 4)
    assert all(32 <= x <= max_cap for x in b), b
    quiet_mean = np.mean(b[:4])
    noise_mean = np.mean(b[8:12])
    assert quiet_mean < noise_mean, (quiet_mean, noise_mean, b)


def test_quality_knob_orders_rates():
    """Finer quality target (lower q) must not produce a smaller stream
    than a coarser one on the same content."""
    pcm = _mixed()
    sizes = []
    for q in (2, 5, 8):
        opts = MP3EncoderOptions.hq(
            mode=Mode.MONO, bitrate_kbps=128, sample_rate=SR,
            vbr=True, vbr_demand=True, quality=q,
        )
        sizes.append(len(_encode(opts, pcm)))
    assert sizes[0] >= sizes[1] >= sizes[2], sizes


def test_reference_vbr_unchanged():
    """The reference-law VBR must stay byte-exact with the flag off
    (vbr_demand reorders internal computation; the energy law's history
    reads must see the same state)."""
    pcm = _mixed()
    opts = MP3EncoderOptions(
        mode=Mode.MONO, bitrate_kbps=128, vbr=True, quality=5
    )
    g = _encode(opts, pcm, "numpy")
    d = _encode(opts, pcm, "jax")
    assert g == d
    parse_frames(g)


def _probe_piece() -> np.ndarray:
    """The frontier probe content: tonal | speech | sparse-attacks |
    half-level noise — high difficulty variance, where fixed-rate CBR
    starves the hard segments (measured: dVBR q5 = 130 kbps / 14.4 NMR
    vs CBR-128 = 133 kbps / 17.2)."""
    import sys as _sys, os as _os

    _sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), "..", "tools"))
    from tune_psy import synth

    rng = np.random.default_rng(3)
    seg = 6 * 1152
    parts = [synth("tonal", seg, 12), synth("speech", seg, 10)]
    t = np.arange(seg) / SR
    bed = 0.08 * np.sin(2 * np.pi * 330 * t)
    for f in (1, 4):
        off = f * 1152 + 400
        bed[off : off + 300] += 0.7 * rng.standard_normal(300)
    parts.append(np.clip(bed, -0.99, 0.99).astype(np.float32))
    parts.append(synth("noise", seg, 13) * 0.5)
    return np.concatenate(parts).astype(np.float32)


def _score(pcm, **kw):
    trim = 2 * 1152
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=128, sample_rate=SR, **kw
    )
    blob = _encode(opts, pcm)
    ext, _ = mpg123_decode(blob)
    return len(blob), masked_noise_ratio(pcm[trim:-trim], ext[:, 0], SR)


@needs_mpg123
def test_dvbr_beats_cbr_at_equal_rate_on_hard_content():
    """The measured frontier claim: on high-difficulty-variance content,
    demand VBR q5 produces a stream no larger than CBR-128's while
    scoring >= 1.5 dB better NMR through libmpg123 (measured 2.8; CBR
    starves the hard segments to feed transparent ones)."""
    pcm = _probe_piece()
    cbr_len, cbr_nmr = _score(pcm)
    dv_len, dv_nmr = _score(pcm, vbr=True, vbr_demand=True, quality=5)
    assert dv_len <= cbr_len * 1.02, (dv_len, cbr_len)
    assert dv_nmr <= cbr_nmr - 1.5, (dv_nmr, cbr_nmr)


@needs_mpg123
def test_dvbr_q0_never_worse_than_cbr():
    """q=0 semantics: never coarser than the walk-start quality anywhere
    — on easy content (where high q trades transparency for rate, the
    documented knob behavior) q0 must be at least as good as CBR-128
    (measured 5.8 vs 10.6 NMR at +21% rate)."""
    pcm = _mixed(6)
    _, cbr_nmr = _score(pcm)
    _, dv_nmr = _score(pcm, vbr=True, vbr_demand=True, quality=0)
    assert dv_nmr <= cbr_nmr + 0.3, (dv_nmr, cbr_nmr)


@needs_mpg123
def test_dvbr_corpus_frontier_floors():
    """Corpus-scale frontier floors (round 4, tools/vbr_frontier.py
    --corpus; full table in ARCHITECTURE.md). Pins the three load-bearing
    cells: (a) q0-never-worse on the hardest class — nburst@64 CBR 19.3
    vs q0 4.9 NMR; (b) the equal-rate pareto win — nburst@96 q3 at <=
    CBR's rate and >= its quality; (c) q0 on steady tonal matches CBR
    (the never-worse floor where high q is documented to undershoot)."""
    import sys as _sys, os as _os

    _sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), "..", "tools"))

    n = 16 * 1152
    t = np.arange(n) / SR
    rng = np.random.default_rng(42)
    x = 0.3 * np.sin(2 * np.pi * 523.25 * t)
    for p in range(900, n - 600, 3000):
        x[p : p + 300] += 0.45 * rng.standard_normal(300)
    nburst = np.clip(x, -0.99, 0.99).astype(np.float32)

    def sc(pcm, base, **kw):
        trim = 2 * 1152
        opts = MP3EncoderOptions.hq(
            mode=Mode.MONO, bitrate_kbps=base, sample_rate=SR, **kw
        )
        blob = _encode(opts, pcm)
        ext, _ = mpg123_decode(blob)
        return len(blob), masked_noise_ratio(pcm[trim:-trim], ext[:, 0], SR)

    # (a) q0-never-worse, hardest cell (measured 19.3 -> 4.9: 10 dB margin)
    _, cbr64 = sc(nburst, 64)
    _, q0_64 = sc(nburst, 64, vbr=True, vbr_demand=True, quality=0)
    assert q0_64 <= cbr64 - 10.0, (q0_64, cbr64)

    # (b) equal-rate pareto win (measured q3 99 kbps/5.54 vs CBR 102/5.64)
    cbr_len, cbr96 = sc(nburst, 96)
    q3_len, q3_96 = sc(nburst, 96, vbr=True, vbr_demand=True, quality=3)
    assert q3_len <= cbr_len * 1.02, (q3_len, cbr_len)
    assert q3_96 <= cbr96 + 0.5, (q3_96, cbr96)

    # (c) q0 on steady tonal: never-worse where q>=3 is documented to
    # undershoot (measured q0 -31.4 vs CBR -18.6 at 64k)
    from tune_psy import synth

    tonal = synth("tonal", n, 12)
    _, cbr_t = sc(tonal, 64)
    _, q0_t = sc(tonal, 64, vbr=True, vbr_demand=True, quality=0)
    assert q0_t <= cbr_t + 0.3, (q0_t, cbr_t)
