"""Component-parity tests for the 'present but unused' reference components
(SURVEY.md §2 items 21, 23, 28-30) plus checkpointing, profiling and int16
ingestion."""

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.io.huffman_pack import (
    pack_chunks,
    pack_pairs_table1,
    pair_chunks_generic,
)
from swiftmp3_tpu.ops import reference as ref
from swiftmp3_tpu.tables import HUFFMAN_TABLES
from swiftmp3_tpu.utils.profiling import ThroughputMeter

from .util import parse_frames, sine


def test_generic_huffman_table_selection():
    # pairs landing in each table size class
    values = np.array([0, 1, 2, 1, 3, 2, 5, 4, 7, 6, 15, 14], dtype=np.int64)
    chunks, nbits = pair_chunks_generic(values)
    # (0,1) -> table 1; (2,1) -> table 2; (3,2) -> table 5; (5,4) -> table 7;
    # (7,6) -> table 10; (15,14) -> table 15
    expect_tables = [1, 2, 5, 7, 10, 15]
    for i, tid in enumerate(expect_tables):
        t = HUFFMAN_TABLES[tid]
        x, y = int(values[2 * i]), int(values[2 * i + 1])
        ln = int(t.lengths[abs(x), abs(y)]) + (x != 0) + (y != 0)
        assert nbits[i] == ln, (i, tid)


def test_table1_pack():
    data, bits = pack_pairs_table1(np.array([1, -1, 0, 0, 0, 1], dtype=np.int64))
    t1 = HUFFMAN_TABLES[1]
    expect = t1.lengths[1, 1] + 2 + t1.lengths[0, 0] + t1.lengths[0, 1] + 1
    assert bits == expect
    assert len(data) == (bits + 7) // 8


def test_scalefactor_band_scale():
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal(576) * 2.0).astype(np.float32)
    scaled, factors = ref.scalefactor_band_scale(spec, 44100)
    assert scaled.shape == (576,) and factors.shape == (576,)
    # within the banded region (418 coeffs at 44.1k) values normalized to <=1
    assert np.all(np.abs(scaled[:418]) <= 1.0 + 1e-6)
    # beyond the bands: untouched spectrum, default factor
    assert np.allclose(factors[418:], 1e-4)
    assert np.array_equal(scaled[418:], spec[418:])


def test_scalefac_compress_heuristic():
    assert ref.scalefactor_compress(np.ones(21, dtype=np.float32)) == 0
    varied = np.array([0.1, 5.0] * 10, dtype=np.float32)
    assert 0 <= ref.scalefactor_compress(varied) <= 15


def test_vbr_unused_methods():
    v = ref.VBRState()
    assert v.global_gain(quality=5) == 188  # empty history -> 180 + 8
    v.update(200, 0.5)
    v.update(210, 0.6)
    assert v.global_gain(quality=9) == 205
    assert v.estimate_part23_length(0) == 450
    assert v.estimate_part23_length(9) == 180


def test_masking_thresholds_device_matches_golden():
    import jax.numpy as jnp

    from swiftmp3_tpu.ops import dsp

    rng = np.random.default_rng(1)
    spec = (rng.standard_normal(576) * 0.1).astype(np.float32)
    for sr in [44100, 48000, 32000]:
        gold = ref.masking_thresholds(spec, sr, quality=4)
        dev = np.asarray(dsp.masking_thresholds(jnp.asarray(spec[None]), sr, 4))[0]
        assert np.allclose(dev, gold, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_session_checkpoint_resume(backend):
    pcm = sine(0.6)
    mid = len(pcm) // 2
    # continuous encode
    s_full = MP3Encoder(MP3EncoderOptions(mode=Mode.MONO), backend=backend).new_session()
    expect = s_full.encode(pcm) + s_full.flush()

    # encode half, checkpoint, resume in a NEW session
    s1 = MP3Encoder(MP3EncoderOptions(mode=Mode.MONO), backend=backend).new_session()
    part1 = s1.encode(pcm[:mid])
    state = s1.state_dict()
    s2 = MP3Encoder(MP3EncoderOptions(mode=Mode.MONO), backend=backend).new_session()
    s2.load_state_dict(state)
    part2 = s2.encode(pcm[mid:]) + s2.flush()
    assert part1 + part2 == expect
    assert s2.encoded_frame_count == s_full.encoded_frame_count


def test_int16_ingestion_matches_float():
    rng = np.random.default_rng(2)
    i16 = (rng.standard_normal(1152 * 6) * 8000).astype(np.int16)
    f32 = i16.astype(np.float32) / np.float32(32768.0)

    from swiftmp3_tpu.parallel import encode_batch

    opts = MP3EncoderOptions(mode=Mode.MONO)
    out_i = encode_batch(opts, [i16], frames_per_step=4)
    out_f = encode_batch(opts, [f32], frames_per_step=4)
    assert out_i[0] == out_f[0]
    parse_frames(out_i[0])


def test_throughput_meter():
    m = ThroughputMeter(sample_rate=44100)
    m.start()
    m.stop(frames=100, bytes_out=41700)
    s = m.summary()
    assert s["frames"] == 100
    assert s["audio_seconds"] == pytest.approx(100 * 1152 / 44100, abs=1e-3)
    assert s["realtime_factor"] > 0


def test_session_accepts_int16():
    rng = np.random.default_rng(3)
    i16 = (rng.standard_normal(1152 * 3) * 8000).astype(np.int16)
    f32 = i16.astype(np.float32) / np.float32(32768.0)
    s1 = MP3Encoder(MP3EncoderOptions(mode=Mode.MONO), backend="numpy").new_session()
    s2 = MP3Encoder(MP3EncoderOptions(mode=Mode.MONO), backend="numpy").new_session()
    assert (s1.encode(i16) + s1.flush()) == (s2.encode(f32) + s2.flush())


def test_quality_report_sine():
    from swiftmp3_tpu.utils.quality import encode_decode_quality

    sr = 44100
    t = np.arange(sr) / sr
    pcm = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    # aligned reservoir mode: ISO decoders read granule-exact data
    rep = encode_decode_quality(
        MP3EncoderOptions(mode=Mode.MONO, reservoir_mode="aligned"), pcm
    )
    assert rep.snr_db > 15.0, rep
    assert 0 < rep.delay_samples < 4096
    assert len(rep.band_snr_db) == 6
    # compat mode reproduces the reference's data displacement (documented);
    # its SNR is bounded by side-info/data mismatch, not coding quality
    rep_c = encode_decode_quality(MP3EncoderOptions(mode=Mode.MONO), pcm)
    assert rep_c.snr_db < rep.snr_db


@pytest.mark.slow
def test_long_stream_batch_matches_session():
    """~45 s of audio (1700+ frames): the 64-frame-chunk batch path and the
    8-frame-chunk session backend agree byte-for-byte — long-run stability
    of the reservoir/padding/VBR carries across chunk boundaries."""
    from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
    from swiftmp3_tpu.parallel import encode_batch

    sr = 44100
    rng = np.random.default_rng(77)
    t = np.arange(int(45.1 * sr)) / sr
    pcm = (
        0.3 * np.sin(2 * np.pi * 220 * t)
        + 0.15 * np.sin(2 * np.pi * 1318.5 * t)
        + 0.05 * rng.standard_normal(len(t))
    ).astype(np.float32)
    opts = MP3EncoderOptions(mode=Mode.MONO, vbr=True, quality=4)
    got = encode_batch(opts, [pcm], frames_per_step=64)[0]
    sess = MP3Encoder(opts, backend="jax").new_session()
    want = sess.encode(pcm) + sess.flush()
    assert got == want
    assert sess.encoded_frame_count > 1700


def test_masked_noise_ratio_metric():
    """NMR sanity: monotone in noise level, ~-200 dB on identity, and the
    masking property SNR is blind to — noise placed UNDER a loud tone's
    skirt scores better than the same-energy noise placed far from it."""
    import numpy as np

    from swiftmp3_tpu.utils.quality import masked_noise_ratio

    sr = 44100
    n = 6 * 1152
    t = np.arange(n) / sr
    x = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    rng = np.random.default_rng(3)
    assert masked_noise_ratio(x, x, sr) < -100
    small = masked_noise_ratio(x, x + 1e-5 * rng.standard_normal(n), sr)
    big = masked_noise_ratio(x, x + 1e-3 * rng.standard_normal(n), sr)
    assert small < big
    # same noise energy, different placement: near the masker (1.1 kHz)
    # vs far above it (12 kHz) — the masked one must score lower
    near = 2e-4 * np.sin(2 * np.pi * 1100.0 * t)
    far = 2e-4 * np.sin(2 * np.pi * 12000.0 * t)
    assert masked_noise_ratio(x, x + near, sr) < masked_noise_ratio(x, x + far, sr) - 6.0
