"""linbits ESC coding (options.linbits_tables / the hq preset).

The reference family caps |q| at 15 (table-15-only entropy coding), which
caps decoded SNR at a bitrate-INDEPENDENT ceiling. The linbits law quantizes
~38 gain units finer (peak |q| ~ LINBITS_Q_TARGET), codes ESC values with
the ISO B.7 24-family tables, and lets the gain walk coarsen only as far as
the budget requires — quality then scales with bitrate. Golden law:
ops/reference.py (strict_entropy_layout linbits=True, no-floor step table);
device twin: ops/dsp.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder import decode_mp3
from swiftmp3_tpu.decoder.decoder import (
    BitReader,
    GranuleSide,
    _decode_granule_spectrum,
)
from swiftmp3_tpu.io.huffman_pack import pack_chunks
from swiftmp3_tpu.ops import reference as ref
from swiftmp3_tpu.tables import QCAP_LINBITS, linbits_table_for_max
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode
from swiftmp3_tpu.utils.quality import decode_agreement_snr, measure_quality


def _encode(options: MP3EncoderOptions, pcm, backend="numpy") -> bytes:
    s = MP3Encoder(options, backend=backend).new_session()
    return s.encode(np.asarray(pcm, np.float32).reshape(-1)) + s.flush()


def _tonal(n: int) -> np.ndarray:
    t = np.arange(n) / 44100.0
    x = (
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 1870 * t)
        + 0.1 * np.sin(2 * np.pi * 7040 * t)
    )
    return x.astype(np.float32)


def _bursty(n: int, seed: int = 9) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 523.0 * np.arange(n) / 44100.0)
    for s in range(1500, n - 600, 5000):
        x[s : s + 300] += 0.55 * rng.standard_normal(300)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


# ---------------------------------------------------------------- unit laws


def test_linbits_table_selection_law():
    assert linbits_table_for_max(0) == (0, 0)
    assert linbits_table_for_max(15) == (15, 0)  # classic domain untouched
    for m, want in [(16, (24, 4)), (30, (24, 4)), (31, (25, 5)), (46, (25, 5)),
                    (500, (29, 9)), (2062, (30, 11)), (8206, (31, 13))]:
        tid, lb = linbits_table_for_max(m)
        assert (tid, lb) == want, m
        assert 15 + (1 << lb) - 1 >= m  # covers the max


@pytest.mark.parametrize("seed", range(6))
def test_linbits_layout_roundtrips_through_decoder(seed):
    """Golden layout -> pack -> oracle Huffman decode reproduces q exactly,
    across magnitudes spanning every 24-family linbits width."""
    rng = np.random.default_rng(100 + seed)
    scale = float(rng.choice([30.0, 120.0, 900.0, 4000.0]))
    q = np.zeros(576, dtype=np.int64)
    n_big = int(rng.integers(50, 320))
    q[:n_big] = np.round(rng.standard_normal(n_big) * scale).astype(np.int64)
    q = np.clip(q, -QCAP_LINBITS, QCAP_LINBITS)
    tail = int(rng.integers(0, 60))
    if tail:
        q[n_big : n_big + tail] = rng.integers(-1, 2, tail)
    lay = ref.strict_entropy_layout(q, 44100, ref.BLOCK_LONG, True, True, linbits=True)
    assert lay["part23_bits"] == int(lay["nbits"].sum())
    data, _ = pack_chunks(lay["chunks"], lay["nbits"])
    g = GranuleSide(
        part23_length=lay["part23_bits"],
        big_values=lay["big_values"],
        table_select=lay["table_select"],
        region0_count=lay["region0"],
        region1_count=lay["region1"],
        count1table_select=lay["count1table_select"],
    )
    r = BitReader(data + b"\x00" * 8, 0)
    qd = _decode_granule_spectrum(r, g, 44100, 0).astype(np.int64)
    np.testing.assert_array_equal(qd, q)


def test_pack_chunks_wide_chunks():
    """pack_chunks handles 40-bit chunks (regression: the old 15-bit column
    cap silently truncated linbits pairs)."""
    chunks = np.array([0b1010111100001111000011110000111100001111, 0b101], dtype=np.int64)
    nbits = np.array([40, 3], dtype=np.int64)
    data, total = pack_chunks(chunks, nbits)
    assert total == 43
    want_bits = format(chunks[0], "040b") + "101"
    got_bits = "".join(format(b, "08b") for b in data)[:43]
    assert got_bits == want_bits


def test_nofloor_step_table():
    """The linbits quantizer uses the pure ISO step (no 1e-4 floor): below
    gain 157 the floored table diverges (the measured 2^2.46 level bug);
    above, both agree exactly."""
    assert np.array_equal(
        ref.ISO_INV_STEP34[157:], ref.ISO_INV_STEP34_NOFLOOR[157:]
    )
    assert (ref.ISO_INV_STEP34_NOFLOOR[:157] > ref.ISO_INV_STEP34[:157]).all()


# ---------------------------------------------------------------- end-to-end


def test_hq_quality_scales_with_bitrate():
    """The headline property: decoded SNR rises with bitrate under hq,
    while spec_strict saturates at its table-15 ceiling (320k decodes
    identically to 128k). Oracle-decoded, conforming reading."""
    pcm = _tonal(6 * 1152)
    snrs = {}
    for kbps in (64, 128, 256):
        data = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=kbps), pcm)
        dec = decode_mp3(data, iso_conventions=True)
        snrs[kbps] = measure_quality(
            pcm, dec.pcm[:, 0], compensate_gain=False
        ).snr_db
    assert snrs[128] > snrs[64] + 3, snrs
    assert snrs[256] > snrs[128] + 10, snrs

    strict = {}
    for kbps in (128, 256):
        data = _encode(
            MP3EncoderOptions.spec_strict(mode=Mode.MONO, bitrate_kbps=kbps), pcm
        )
        dec = decode_mp3(data, iso_conventions=True)
        strict[kbps] = measure_quality(
            pcm, dec.pcm[:, 0], compensate_gain=False
        ).snr_db
    assert abs(strict[256] - strict[128]) < 1.0, strict  # the ceiling is real
    assert snrs[256] > strict[256] + 15, (snrs, strict)  # and hq breaks it


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_hq_streams_conform_externally():
    """hq streams (ESC tables 24-31 in our OWN emission) decode on a real
    third-party decoder in float-precision agreement with the oracle."""
    for pcm, kbps in ((_tonal(5 * 1152), 256), (_bursty(5 * 1152), 128)):
        data = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=kbps), pcm)
        dec = decode_mp3(data, iso_conventions=True)
        ext, _ = mpg123_decode(data)
        assert decode_agreement_snr(ext[:, 0], dec.pcm[:, 0]) > 100.0


def test_hq_emits_esc_tables_and_caps_part23():
    """High-bitrate hq streams actually select 24-family tables, and every
    part2_3_length fits its 12-bit field."""
    from swiftmp3_tpu.decoder.decoder import _iter_frames

    data = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=320), _tonal(5 * 1152))
    tids = set()
    for fi in _iter_frames(data, strict=False):
        for gr in fi.granules:
            for g in gr:
                tids.update(g.table_select)
                assert g.part23_length <= 4095
    assert any(t >= 24 for t in tids), tids


def test_hq_stereo_and_bursts_decode():
    """Joint-stereo hq with transient content (short blocks + sequenced
    transitions + ESC in one stream) stays conforming and beats strict on
    the same content. Scored over the source INTERIOR: encoder delay and
    end-of-stream coarseness otherwise dominate short clips (see
    tools/quality_vs_lame._score for the measured phantom swings)."""
    x = _bursty(10 * 1152)
    st = np.stack([x, np.roll(x, 5)], axis=1)
    ref = x[2 * 1152 : -2 * 1152]
    hq = _encode(MP3EncoderOptions.hq(mode=Mode.JOINT_STEREO, bitrate_kbps=256), st)
    strict = _encode(
        MP3EncoderOptions.spec_strict(mode=Mode.JOINT_STEREO, bitrate_kbps=256), st
    )
    dh = decode_mp3(hq, iso_conventions=True)
    ds = decode_mp3(strict, iso_conventions=True)
    sh = measure_quality(ref, dh.pcm[:, 0], compensate_gain=False).snr_db
    ss = measure_quality(ref, ds.pcm[:, 0], compensate_gain=False).snr_db
    assert sh > ss + 3, (sh, ss)


# ---------------------------------------------------------------- device twin

import jax.numpy as jnp  # noqa: E402

from swiftmp3_tpu.ops import dsp  # noqa: E402


@pytest.mark.parametrize("seed", range(4))
def test_device_layout_twin_linbits(seed):
    """strict_layout_device(linbits=True) == golden strict_entropy_layout
    on random ESC-range spectra: bits, tables, bv, regions."""
    rng = np.random.default_rng(300 + seed)
    scale = float(rng.choice([25.0, 400.0, 5000.0]))
    q = np.zeros((3, 576), dtype=np.int32)
    for r in range(3):
        n_big = int(rng.integers(40, 300))
        q[r, :n_big] = np.clip(
            np.round(rng.standard_normal(n_big) * scale), -QCAP_LINBITS, QCAP_LINBITS
        ).astype(np.int32)
    lay_d = dsp.strict_layout_device(
        jnp.asarray(q), 44100, jnp.ones(3, bool), True, True, linbits=True
    )
    for r in range(3):
        lay_g = ref.strict_entropy_layout(
            q[r].astype(np.int64), 44100, ref.BLOCK_LONG, True, True, linbits=True
        )
        assert int(lay_d["bits"][r]) == lay_g["part23_bits"], (seed, r)
        assert int(lay_d["bv"][r]) == lay_g["big_values"]
        got_tids = (int(lay_d["tid0"][r]), int(lay_d["tid1"][r]), int(lay_d["tid2"][r]))
        assert got_tids == lay_g["table_select"], (seed, r)
        assert int(lay_d["c1t"][r]) == lay_g["count1table_select"]


@pytest.mark.parametrize("seed", range(4))
def test_device_chunks_twin_linbits(seed):
    """The device 3-slot chunk stream packs to the SAME bits as the golden
    layout's wide chunks (split at ISO field boundaries, order preserved)."""
    rng = np.random.default_rng(400 + seed)
    q = np.zeros(576, dtype=np.int32)
    n_big = int(rng.integers(60, 280))
    q[:n_big] = np.clip(
        np.round(rng.standard_normal(n_big) * 700.0), -QCAP_LINBITS, QCAP_LINBITS
    ).astype(np.int32)
    q[n_big : n_big + 40] = rng.integers(-1, 2, 40)
    lay_g = ref.strict_entropy_layout(
        q.astype(np.int64), 44100, ref.BLOCK_LONG, True, True, linbits=True
    )
    golden_bytes, golden_bits = pack_chunks(lay_g["chunks"], lay_g["nbits"])

    lay_d = dsp.strict_layout_device(
        jnp.asarray(q[None]), 44100, jnp.ones(1, bool), True, True, linbits=True
    )
    ch_d, nb_d = dsp.strict_chunks_device(jnp.asarray(q[None]), lay_d, linbits=True)
    dev_bytes, dev_bits = pack_chunks(
        np.asarray(ch_d[0], dtype=np.int64), np.asarray(nb_d[0], dtype=np.int64)
    )
    assert dev_bits == golden_bits
    assert dev_bytes == golden_bytes


def test_hq_backends_agree():
    """Cross-backend contract under linbits: identical structure + gains +
    tables; bytes may differ by isolated rate-loop ULP flips (amplified by
    the ~137x larger q domain), but decoded quality must match closely and
    both streams must be conforming."""
    import sys

    sys.path.insert(0, "tests")
    from util import parse_frames

    pcm = _tonal(5 * 1152)
    o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=256)
    outs = {be: _encode(o, pcm, backend=be) for be in ("numpy", "jax")}
    fa, fb = parse_frames(outs["numpy"]), parse_frames(outs["jax"])
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert (a.size, a.bitrate_kbps, a.padding, a.mode) == (
            b.size, b.bitrate_kbps, b.padding, b.mode,
        )
    snrs = {}
    for be, blob in outs.items():
        dec = decode_mp3(blob, iso_conventions=True)
        snrs[be] = measure_quality(pcm, dec.pcm[:, 0], compensate_gain=False).snr_db
    assert abs(snrs["numpy"] - snrs["jax"]) < 1.0, snrs
    assert min(snrs.values()) > 40.0, snrs


# ------------------------------------------------ demand-donation budgets


def test_demand_budget_donation_wins_on_starving_transients():
    """options.demand_budget (in the hq preset), donation law: granule-
    channels whose probe demand sits UNDER the equal share donate the
    surplus; granules over it split the donations by deficit. Donation
    fires only at starving bitrates, where transient frames hold a real
    (surplus, deficit) pair — pins the measured +1.4 dB at 64 kbps on 16
    frames of bursty content. Interior-scored: the encoder-delay head
    and the deliberately coarse final frame otherwise dominate the clip
    (see tools/quality_vs_lame._score)."""
    pcm = _bursty(16 * 1152)
    trim = 2 * 1152
    interior = pcm[trim:-trim]
    snr = {}
    for db in (True, False):
        # lowpass_hz=None: isolate the donation mechanism from the hq
        # preset's rate-derived adaptive lowpass (round 4) — with the
        # high band zeroed both arms concentrate low and the measured
        # +1.4 dB margin collapses to ~0.1 (the donation win lives in
        # the band the lowpass removes on this noise-burst clip)
        o = MP3EncoderOptions.hq(
            mode=Mode.MONO, bitrate_kbps=64, demand_budget=db, lowpass_hz=None
        )
        dec = decode_mp3(_encode(o, pcm), iso_conventions=True)
        snr[db] = measure_quality(
            interior, dec.pcm[:, 0], compensate_gain=False
        ).snr_db
    assert snr[True] - snr[False] > 0.8, snr


def test_demand_budget_exact_noop_without_surplus_deficit_pair():
    """The donation law self-gates with no threshold: when no granule
    sits under the equal share (nothing to donate) or none sits over it
    (no deficit), the budgets are untouched and the stream is
    BYTE-identical to demand_budget=False. Both polarities: tonal
    content at 256 kbps (every demand under the share) and bursty
    content at 128 kbps (the share covers every probe demand's
    overflow)."""
    cases = [(_tonal(5 * 1152), 256), (_bursty(6 * 1152), 128)]
    for pcm, kbps in cases:
        outs = [
            _encode(
                MP3EncoderOptions.hq(
                    mode=Mode.MONO, bitrate_kbps=kbps, demand_budget=db
                ),
                pcm,
            )
            for db in (True, False)
        ]
        assert outs[0] == outs[1], kbps


@pytest.mark.slow
def test_demand_budget_backends_agree():
    """Device twin of the donation law (models/pipeline.py scan step):
    same share/surplus/deficit integer arithmetic, same 4095 clamp. Run
    at 64 kbps on 16 bursty frames — the config where donation FIRES
    (128k is a byte-level no-op on this clip) — crossing the device
    backend's CHUNK=8 boundary. Structure must match exactly; decoded
    SNR within the ULP-flip contract."""
    import sys

    sys.path.insert(0, "tests")
    from util import parse_frames

    pcm = _bursty(16 * 1152)
    # lowpass_hz=None: isolate the donation mechanism from the hq preset's
    # rate-derived adaptive lowpass (round 4), which trades raw SNR for NMR
    o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=64, lowpass_hz=None)
    outs = {be: _encode(o, pcm, backend=be) for be in ("numpy", "jax")}
    fa, fb = parse_frames(outs["numpy"]), parse_frames(outs["jax"])
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert (a.size, a.bitrate_kbps, a.padding, a.mode) == (
            b.size, b.bitrate_kbps, b.padding, b.mode,
        )
    trim = 2 * 1152
    interior = pcm[trim:-trim]
    snrs = {}
    for be, blob in outs.items():
        dec = decode_mp3(blob, iso_conventions=True)
        snrs[be] = measure_quality(
            interior, dec.pcm[:, 0], compensate_gain=False
        ).snr_db
    assert abs(snrs["numpy"] - snrs["jax"]) < 1.0, snrs
    assert min(snrs.values()) > 9.0, snrs


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_demand_budget_streams_conform_externally():
    """A demand_budget stream is plain conforming MP3 (the donation only
    moves part2_3_length budgets); libmpg123 must decode it in close
    agreement with the oracle and confirm the 64 kbps transient win
    externally (measured +1.44 dB through mpg123, interior-scored)."""
    pcm = _bursty(16 * 1152)
    trim = 2 * 1152
    interior = pcm[trim:-trim]
    o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=64, lowpass_hz=None)
    blob = _encode(o, pcm)
    ext, _ = mpg123_decode(blob)
    ours = decode_mp3(blob, iso_conventions=True).pcm
    agree = decode_agreement_snr(ext[:, 0], ours[: len(ext), 0])
    assert agree > 100.0, agree
    snr_on = measure_quality(interior, ext[:, 0], compensate_gain=False).snr_db
    o_off = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=64, demand_budget=False, lowpass_hz=None
    )
    ext_off, _ = mpg123_decode(_encode(o_off, pcm))
    snr_off = measure_quality(
        interior, ext_off[:, 0], compensate_gain=False
    ).snr_db
    assert snr_on - snr_off > 0.8, (snr_on, snr_off)


@pytest.mark.slow
@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_hq_corpus_nmr_regression_floors():
    """Masked-noise-ratio regression floors for the hq preset at 128 kbps
    (lower is better; ceilings set ~3 dB above the round-3 measured values
    through libmpg123 — music -28.2, tonal -31.1, speech 6.5, burst 3.5
    with the sequencing hangover, which took burst from 11.6).
    Pins the perceptual referee next to the SNR floors so quality changes
    are judged on both axes."""
    import sys as _sys

    _sys.path.insert(0, "tools")
    from tune_psy import synth

    from swiftmp3_tpu.utils.quality import masked_noise_ratio

    ceilings = {"music": -24.0, "tonal": -27.0, "speech": 9.5, "burst": 6.5}
    trim = 2 * 1152
    for i, (kind, ceil) in enumerate(ceilings.items()):
        pcm = synth(kind, 16 * 1152, 10 + {"speech": 0, "music": 1, "tonal": 2, "burst": 4}[kind])
        opts = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128)
        blob = _encode(opts, pcm)
        ext, _ = mpg123_decode(blob)
        nmr = masked_noise_ratio(pcm[trim:-trim], ext[:, 0], 44100)
        assert nmr < ceil, (kind, nmr)
