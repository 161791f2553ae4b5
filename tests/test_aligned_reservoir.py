"""Aligned reservoir mode: ISO-correct main_data placement.

Discovery (round 1): the reference's one-frame delay zero-pads underfull
slots at the END and snapshots main_data_begin BEFORE appending the frame's
data (MP3Encoder.swift:499, 2110-2121), so an ISO decoder reads each frame's
side info against the NEXT frame's Huffman data whenever slots underfill.
`reservoir_mode="aligned"` keeps the same budgets/bit counts but places each
frame's data at the previous slot's tail (stuffing between frames) and
points main_data_begin at it — standard decoders then read granule-exact
data. These tests prove both halves: compat mis-places (decoded != encoded
values), aligned decodes exactly.
"""

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder import decode_mp3
from swiftmp3_tpu.decoder.decoder import BitReader, _decode_granule_spectrum, _iter_frames
from swiftmp3_tpu.ops import reference as ref

from .util import parse_frames, sine


def _encode(pcm, backend="numpy", **kwargs):
    s = MP3Encoder(MP3EncoderOptions(**kwargs), backend=backend).new_session()
    return s.encode(pcm) + s.flush(), s


def _golden_granules(pcm, budget=1524):
    """Expected (gain, q) per granule from the golden DSP (mono, long)."""
    fb = np.zeros(512, np.float32)
    ov = np.zeros((32, 18), np.float32)
    out = []
    for g in range(len(pcm) // 576):
        gs = pcm[g * 576 : (g + 1) * 576]
        S, fb = ref.analyze_subbands(gs, fb)
        spec, ov = ref.mdct_apply(S, ov, ref.BLOCK_LONG)
        g0 = ref.compute_global_gain(spec)
        gain, q, _ = ref.quantize_to_fit_budget(spec, g0, budget)
        out.append((gain, q))
    return out


def _decoded_granules(data, sr=44100):
    store = bytearray()
    out = []
    for fi in _iter_frames(bytes(data)):
        start_bit = (len(store) - fi.main_data_begin) * 8
        store += fi.main_data
        r = BitReader(bytes(store), start_bit)
        for gr in range(2):
            g = fi.granules[gr][0]
            part_start = r.pos
            q = _decode_granule_spectrum(r, g, sr, part_start)
            r.pos = part_start + g.part23_length
            out.append((g.global_gain, q))
    return out


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_aligned_decodes_granule_exact(backend):
    pcm = sine(8 * 1152 / 44100)[: 8 * 1152]
    data, s = _encode(pcm, backend=backend, mode=Mode.MONO, reservoir_mode="aligned")
    parse_frames(data)
    expected = _golden_granules(pcm)
    decoded = _decoded_granules(data)
    assert len(decoded) == len(expected)
    for i, ((ge, qe), (gd, qd)) in enumerate(zip(expected, decoded)):
        assert gd == ge, f"granule {i} gain"
        assert np.array_equal(qd, qe), f"granule {i} values"


def test_compat_misplaces_data():
    # The reference behavior: decoded values do NOT match (documented quirk)
    pcm = sine(8 * 1152 / 44100)[: 8 * 1152]
    data, _ = _encode(pcm, mode=Mode.MONO, reservoir_mode="compat")
    expected = _golden_granules(pcm)
    decoded = _decoded_granules(data)
    mismatches = sum(
        not np.array_equal(qd, qe) for (_, qe), (_, qd) in zip(expected, decoded)
    )
    assert mismatches > 0  # underfull slots shift the data by one frame


def test_aligned_quality_improves():
    from swiftmp3_tpu.utils.quality import encode_decode_quality

    sr = 44100
    t = np.arange(sr) / sr
    pcm = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    rep_compat = encode_decode_quality(
        MP3EncoderOptions(mode=Mode.MONO, reservoir_mode="compat"), pcm
    )
    rep_aligned = encode_decode_quality(
        MP3EncoderOptions(mode=Mode.MONO, reservoir_mode="aligned"), pcm
    )
    assert rep_aligned.snr_db > 15.0, rep_aligned
    assert rep_aligned.snr_db > rep_compat.snr_db + 8.0, (rep_compat, rep_aligned)


def test_aligned_cross_backend_and_native():
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal(1152 * 10) * 0.5).astype(np.float32)
    pcm[: 1152 * 4] *= 0.02
    outs = {}
    for be in ["numpy", "jax"]:
        data, _ = _encode(pcm, backend=be, mode=Mode.MONO, reservoir_mode="aligned")
        outs[be] = data
    fa, fb = parse_frames(outs["numpy"]), parse_frames(outs["jax"])
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert (a.size, a.main_data_begin) == (b.size, b.main_data_begin)

    # batch path (native renderer) matches sessions
    from swiftmp3_tpu.parallel import encode_batch

    opts = MP3EncoderOptions(mode=Mode.MONO, reservoir_mode="aligned")
    batched = encode_batch(opts, [pcm], frames_per_step=4)
    assert batched[0] == outs["jax"]


def test_aligned_vbr_and_stereo_decode():
    rng = np.random.default_rng(8)
    pcm = (rng.standard_normal(2 * 1152 * 8) * 0.4).astype(np.float32)
    data, s = _encode(
        pcm, mode=Mode.STEREO, vbr=True, quality=3, reservoir_mode="aligned"
    )
    dec = decode_mp3(data)
    assert dec.frame_count == s.encoded_frame_count
    assert np.abs(dec.pcm).max() > 0.01


def test_aligned_exact_under_heavy_borrowing():
    """Low-bitrate noise forces reservoir borrowing and split slots; decoded
    values must still match the encoder's quantized values exactly."""
    from swiftmp3_tpu.encoder import GoldenBackend
    from swiftmp3_tpu.io.framing import FrameAssembler

    rng = np.random.default_rng(42)
    n_frames = 40
    pcm = (rng.standard_normal(1152 * n_frames) * 0.7).astype(np.float32)
    pcm[1152 * 10 : 1152 * 20] *= 0.01  # quiet stretch builds the reservoir

    opts = MP3EncoderOptions(
        mode=Mode.MONO, bitrate_kbps=64, reservoir_mode="aligned"
    )
    backend = GoldenBackend(opts)
    assembler = FrameAssembler(opts)
    frames = pcm.reshape(n_frames, 1152)
    results = backend.encode_frames(frames, np.zeros(n_frames, dtype=bool))
    data = bytearray()
    expected = []
    for fr in results:
        data += assembler.push(fr)
        for g in range(2):
            expected.append((fr.granules[g][0].global_gain, fr.quantized[g]))
    data += assembler.flush_buffered()

    frames_parsed = parse_frames(bytes(data))
    assert any(f.main_data_begin > 0 for f in frames_parsed), "no borrowing?"

    decoded = _decoded_granules(bytes(data))
    assert len(decoded) == len(expected)
    for i, ((ge, qe), (gd, qd)) in enumerate(zip(expected, decoded)):
        assert gd == ge, f"granule {i} gain"
        assert np.array_equal(qd, qe), f"granule {i} values differ"
