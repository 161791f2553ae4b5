"""End-to-end tests of the golden (numpy) encoder backend.

Ports the reference test strategy (SwiftMP3Tests.swift): structural unit
tests, bitstream self-parsing of encoder internals, determinism. The same
suite runs against the JAX backend in test_tpu_backend.py.
"""

import numpy as np
import pytest

from swiftmp3_tpu import ID3Tag, MP3Encoder, MP3EncoderOptions, Mode

from .util import parse_frames, silence, sine

BACKEND = "numpy"


def make_session(**kwargs):
    backend = kwargs.pop("backend", BACKEND)
    return MP3Encoder(MP3EncoderOptions(**kwargs), backend=backend).new_session()


def encode_all(session, samples) -> bytes:
    data = session.encode(samples)
    data += session.flush()
    return data


class TestStructural:
    def test_encode_silence(self):
        s = make_session(mode=Mode.MONO)
        data = encode_all(s, silence(0.5))
        assert len(data) > 0
        frames = parse_frames(data)
        assert len(frames) == s.encoded_frame_count
        assert all(f.bitrate_kbps == 128 for f in frames)

    def test_encode_mono_mode_bits(self):
        s = make_session(mode=Mode.MONO)
        frames = parse_frames(encode_all(s, sine(0.2)))
        assert all(f.mode == 0b11 for f in frames)
        assert all(f.channels == 1 for f in frames)

    def test_encode_stereo(self):
        s = make_session(mode=Mode.STEREO)
        frames = parse_frames(encode_all(s, sine(0.2, channels=2)))
        assert all(f.mode == 0b00 for f in frames)

    def test_joint_stereo_mode_extension(self):
        s = make_session(mode=Mode.JOINT_STEREO)
        frames = parse_frames(encode_all(s, sine(0.2, channels=2)))
        # Reference always sets mode_ext=0b10 for joint stereo
        assert all(f.mode == 0b01 and f.mode_extension == 0b10 for f in frames)

    def test_flush_produces_final_frame(self):
        s = make_session(mode=Mode.MONO)
        # 1.5 frames of samples: encode yields nothing until a frame completes
        out1 = s.encode(sine(1152 * 1.5 / 44100))
        out2 = s.flush()
        assert len(out2) > 0
        parse_frames(out1 + out2)

    def test_one_frame_delay(self):
        s = make_session(mode=Mode.MONO)
        first = s.encode(np.zeros(1152, dtype=np.float32))
        assert first == b""  # first frame is buffered
        second = s.encode(np.zeros(1152, dtype=np.float32))
        assert len(second) > 0  # emits the first frame

    def test_flush_emits_buffered_then_empty(self):
        s = make_session(mode=Mode.MONO)
        s.encode(np.zeros(1152, dtype=np.float32))
        out = s.flush()
        assert len(out) > 0
        assert s.flush() == b""  # double flush yields nothing

    def test_empty_input(self):
        s = make_session(mode=Mode.MONO)
        assert s.encode(np.zeros(0, dtype=np.float32)) == b""
        assert s.flush() == b""
        assert s.encoded_frame_count == 0

    def test_options_defaults(self):
        o = MP3EncoderOptions()
        assert o.sample_rate == 44100 and o.bitrate_kbps == 128
        assert not o.vbr and o.mode is Mode.STEREO and o.quality == 5
        assert not o.crc_protected and o.original and not o.copyright
        assert MP3EncoderOptions(quality=42).quality == 9  # clamped


class TestBitstreamInternals:
    def test_frame_sizes_417_418(self):
        s = make_session(mode=Mode.MONO)
        frames = parse_frames(encode_all(s, sine(1.0)))
        sizes = {f.size for f in frames}
        assert sizes <= {417, 418}
        assert 417 in sizes and 418 in sizes

    def test_padding_ratio_matches_theory(self):
        # remainder 42300 per frame at 128k/44.1 -> padding ratio 42300/44100
        s = make_session(mode=Mode.MONO)
        n_frames = 1000
        rng = np.random.default_rng(1)
        pcm = (rng.standard_normal(1152 * n_frames) * 0.3).astype(np.float32)
        frames = parse_frames(encode_all(s, pcm))
        ratio = sum(f.padding for f in frames) / len(frames)
        assert abs(ratio - 42300 / 44100) < 0.02

    def test_bit_reservoir_main_data_begin(self):
        # Complex noise underflows some frames; some later frame must carry
        # a nonzero main_data_begin (SwiftMP3Tests.swift:304)
        s = make_session(mode=Mode.MONO)
        rng = np.random.default_rng(2)
        pcm = (rng.standard_normal(1152 * 50) * 0.8).astype(np.float32)
        frames = parse_frames(encode_all(s, pcm))
        assert any(f.main_data_begin > 0 for f in frames[1:])
        assert frames[0].main_data_begin == 0

    def test_final_frame_main_data_begin_zero(self):
        s = make_session(mode=Mode.MONO)
        pcm = sine(0.5)
        # leave a partial frame so flush encodes an isFinal frame
        data = s.encode(np.concatenate([pcm, np.zeros(100, np.float32)]))
        data += s.flush()
        frames = parse_frames(data)
        assert frames[-1].main_data_begin == 0

    def test_counters_accuracy(self):
        s = make_session(mode=Mode.MONO)
        data = encode_all(s, sine(1.0))
        frames = parse_frames(data)
        assert s.encoded_frame_count == len(frames)
        assert s.encoded_byte_count == len(data)
        avg = len(data) / len(frames)
        assert 417 <= avg <= 418

    def test_frame_contiguity_exact_count(self):
        s = make_session(mode=Mode.MONO)
        n = 20
        pcm = sine(n * 1152 / 44100)[: n * 1152]
        frames = parse_frames(encode_all(s, pcm))
        assert len(frames) == n  # all n frames emitted (delay + flush)

    def test_crc_protected_frames(self):
        from swiftmp3_tpu.io.crc import crc16_mpeg

        s = make_session(mode=Mode.MONO, crc_protected=True)
        data = encode_all(s, sine(0.2))
        frames = parse_frames(data)
        for f in frames:
            assert f.crc_protected
            header = data[f.offset : f.offset + 4]
            stored = int.from_bytes(data[f.offset + 4 : f.offset + 6], "big")
            assert stored == crc16_mpeg(header)

    def test_vbr_bitrate_varies_or_valid(self):
        s = make_session(mode=Mode.MONO, vbr=True, quality=2)
        rng = np.random.default_rng(3)
        loud = (rng.standard_normal(1152 * 10) * 0.9).astype(np.float32)
        quiet = (rng.standard_normal(1152 * 10) * 0.01).astype(np.float32)
        frames = parse_frames(encode_all(s, np.concatenate([quiet, loud, quiet])))
        rates = {f.bitrate_kbps for f in frames}
        assert all(32 <= r <= 320 for r in rates)
        assert len(rates) > 1  # bitrate actually adapts

    @pytest.mark.parametrize("sr", [44100, 48000, 32000])
    def test_sample_rates(self, sr):
        s = make_session(mode=Mode.MONO, sample_rate=sr)
        frames = parse_frames(encode_all(s, sine(0.2, sample_rate=sr)))
        assert all(f.sample_rate == sr for f in frames)

    @pytest.mark.parametrize("kbps", [64, 128, 192, 320])
    def test_bitrates(self, kbps):
        s = make_session(mode=Mode.MONO, bitrate_kbps=kbps)
        frames = parse_frames(encode_all(s, sine(0.2)))
        assert all(f.bitrate_kbps == kbps for f in frames)


class TestDeterminism:
    def test_identical_input_identical_output(self):
        pcm = sine(0.5, freq=523.25)
        outs = []
        for _ in range(2):
            s = make_session(mode=Mode.MONO)
            outs.append(encode_all(s, pcm))
        assert outs[0] == outs[1]

    def test_chunking_invariance(self):
        # Same PCM fed in different chunk sizes must yield identical bytes
        pcm = sine(0.5)
        s1 = make_session(mode=Mode.MONO)
        whole = encode_all(s1, pcm)
        s2 = make_session(mode=Mode.MONO)
        parts = bytearray()
        for i in range(0, len(pcm), 1000):
            parts += s2.encode(pcm[i : i + 1000])
        parts += s2.flush()
        assert bytes(parts) == whole


class TestMetadata:
    def test_xing_header_prepend(self):
        s = make_session(mode=Mode.MONO)
        data = encode_all(s, sine(0.3))
        xing = s.generate_xing_header()
        assert b"Info" in xing[:40]
        parse_frames(xing + data)  # xing frame is itself a parseable frame

    def test_id3_generation(self):
        s = make_session(mode=Mode.MONO, id3_tag=ID3Tag(title="T", artist="A"))
        tag = s.generate_id3_tag()
        assert tag[:3] == b"ID3"
        s2 = make_session(mode=Mode.MONO)
        assert s2.generate_id3_tag() == b""


class TestRobustness:
    def test_nan_input_produces_valid_stream(self):
        s = make_session(mode=Mode.MONO)
        pcm = np.full(1152 * 2, np.nan, dtype=np.float32)
        pcm[100:200] = np.inf
        data = encode_all(s, pcm)
        frames = parse_frames(data)
        assert len(frames) == 2  # encoded as silence, not a crash

    def test_vbr_quality_sweep_with_xing(self):
        # BASELINE config 4: VBR quality sweep + Xing seek-table validation
        rng = np.random.default_rng(21)
        pcm = (rng.standard_normal(1152 * 8) * 0.5).astype(np.float32)
        pcm[: 1152 * 3] *= 0.02
        for q in range(0, 10, 3):
            s = make_session(mode=Mode.MONO, vbr=True, quality=q)
            data = encode_all(s, pcm)
            frames = parse_frames(data)
            assert all(32 <= f.bitrate_kbps <= 320 for f in frames)
            xing = s.generate_xing_header()
            assert b"Xing" in xing[:40]
            off = xing.index(b"Xing")
            declared_frames = int.from_bytes(xing[off + 8 : off + 12], "big")
            declared_bytes = int.from_bytes(xing[off + 12 : off + 16], "big")
            assert declared_frames == len(frames) + 1
            assert declared_bytes == len(data) + len(xing)
            toc = xing[off + 16 : off + 116]
            assert list(toc) == sorted(toc)

    def test_session_continues_after_flush(self):
        # The reference allows further encoding after flush (state persists)
        pcm = sine(0.4)
        s = make_session(mode=Mode.MONO)
        a = s.encode(pcm)
        a += s.flush()
        b = s.encode(pcm)
        b += s.flush()
        frames = parse_frames(a + b)
        assert s.encoded_frame_count == len(frames)
