"""JAX backend tests: structural suite + cross-backend parity.

Runs on the CPU platform in CI (see conftest). Cross-backend contract:
- identical frame structure (sizes, headers, padding, bitrate choices)
- near-identical numerics: quantized spectra may differ in rare ULP-boundary
  decisions between the XLA and numpy float stacks; byte-exactness is
  guaranteed within a backend, not across.
"""

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder import decode_mp3

from .util import parse_frames, silence, sine


def session(**kwargs):
    backend = kwargs.pop("backend", "jax")
    return MP3Encoder(MP3EncoderOptions(**kwargs), backend=backend).new_session()


def encode_all(s, pcm):
    return s.encode(pcm) + s.flush()


class TestTPUStructural:
    def test_sine_stream(self):
        s = session(mode=Mode.MONO)
        data = encode_all(s, sine(0.4))
        frames = parse_frames(data)
        assert len(frames) == s.encoded_frame_count
        assert {f.size for f in frames} <= {417, 418}

    def test_one_frame_delay_and_flush(self):
        s = session(mode=Mode.MONO)
        assert s.encode(np.zeros(1152, np.float32)) == b""
        assert len(s.encode(np.zeros(1152, np.float32))) > 0
        assert len(s.flush()) > 0
        assert s.flush() == b""

    def test_determinism(self):
        pcm = sine(0.3, freq=880.0)
        a = encode_all(session(mode=Mode.MONO), pcm)
        b = encode_all(session(mode=Mode.MONO), pcm)
        assert a == b

    def test_chunking_invariance(self):
        pcm = sine(0.4)
        whole = encode_all(session(mode=Mode.MONO), pcm)
        s = session(mode=Mode.MONO)
        parts = bytearray()
        for i in range(0, len(pcm), 3000):
            parts += s.encode(pcm[i : i + 3000])
        parts += s.flush()
        assert bytes(parts) == whole

    def test_roundtrip_decode(self):
        s = session(mode=Mode.MONO)
        data = encode_all(s, sine(0.5))
        dec = decode_mp3(data)
        assert dec.frame_count == s.encoded_frame_count
        assert np.abs(dec.pcm).max() > 0.05

    def test_joint_stereo(self):
        s = session(mode=Mode.JOINT_STEREO)
        frames = parse_frames(encode_all(s, sine(0.3, channels=2)))
        assert all(f.mode == 0b01 and f.mode_extension == 0b10 for f in frames)

    def test_reservoir_active_on_noise(self):
        rng = np.random.default_rng(11)
        pcm = (rng.standard_normal(1152 * 30) * 0.8).astype(np.float32)
        s = session(mode=Mode.MONO)
        frames = parse_frames(encode_all(s, pcm))
        assert any(f.main_data_begin > 0 for f in frames[1:])


class TestCrossBackend:
    def _structural_compare(self, pcm, **kwargs):
        outs = {}
        for be in ["numpy", "jax"]:
            s = session(backend=be, **kwargs)
            outs[be] = encode_all(s, pcm)
        fa = parse_frames(outs["numpy"])
        fb = parse_frames(outs["jax"])
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            assert (a.size, a.bitrate_kbps, a.padding, a.mode) == (
                b.size,
                b.bitrate_kbps,
                b.padding,
                b.mode,
            )
        # numeric closeness: fraction of differing bytes is tiny
        a, b = outs["numpy"], outs["jax"]
        ndiff = sum(x != y for x, y in zip(a, b))
        assert ndiff / max(len(a), 1) < 0.02, ndiff
        return outs

    def test_sine_identical(self):
        outs = self._structural_compare(sine(0.3), mode=Mode.MONO)
        # pure tones hit no decision boundaries: bytes match exactly
        assert outs["numpy"] == outs["jax"]

    def test_noise_structural(self):
        rng = np.random.default_rng(12)
        pcm = (rng.standard_normal(1152 * 12) * 0.5).astype(np.float32)
        self._structural_compare(pcm, mode=Mode.MONO)

    def test_stereo_structural(self):
        rng = np.random.default_rng(13)
        pcm = (rng.standard_normal(1152 * 2 * 8) * 0.4).astype(np.float32)
        self._structural_compare(pcm, mode=Mode.STEREO)

    def test_vbr_structural(self):
        rng = np.random.default_rng(14)
        pcm = (rng.standard_normal(1152 * 12) * 0.5).astype(np.float32)
        pcm[: 1152 * 4] *= 0.02
        self._structural_compare(pcm, mode=Mode.MONO, vbr=True, quality=3)


class TestDSPParity:
    """Op-level golden comparison: jnp ops vs the numpy reference."""

    def test_polyphase_frame(self):
        import jax.numpy as jnp

        from swiftmp3_tpu.ops import dsp
        from swiftmp3_tpu.ops import reference as ref

        rng = np.random.default_rng(0)
        pcm = (rng.standard_normal(1152) * 0.5).astype(np.float32)
        hist = (rng.standard_normal(480) * 0.1).astype(np.float32)

        S_dev, hist_dev = dsp.polyphase_frame(jnp.asarray(hist[None]), jnp.asarray(pcm[None]))
        S_dev = np.asarray(S_dev)[0]  # [36, 32]

        buffer = np.concatenate([np.zeros(32, np.float32), hist])
        S_gold = np.zeros((36, 32), np.float32)
        for t in range(18 * 2):
            sb, buffer = ref.polyphase_analyze(pcm[t * 32 : (t + 1) * 32], buffer)
            S_gold[t] = sb
        assert np.allclose(S_dev, S_gold, atol=2e-5), np.abs(S_dev - S_gold).max()
        assert np.array_equal(np.asarray(hist_dev)[0], np.concatenate([hist, pcm])[1152:])

    def test_rate_loop_matches_walk(self):
        import jax.numpy as jnp

        from swiftmp3_tpu.ops import dsp
        from swiftmp3_tpu.ops import reference as ref

        rng = np.random.default_rng(1)
        # exercise: normal, loud (overflow), quiet (all-zero rescue), silent
        specs = [
            (rng.standard_normal(576) * 0.05).astype(np.float32),
            (rng.standard_normal(576) * 50.0).astype(np.float32),
            (rng.standard_normal(576) * 1e-7).astype(np.float32),
            np.zeros(576, np.float32),
        ]
        budgets = [3000, 500, 3000, 3000]
        for spec, budget in zip(specs, budgets):
            g0 = ref.compute_global_gain(spec)
            gain_g, q_g, bits_g = ref.quantize_to_fit_budget(spec, g0, budget)
            gain_d, q_d, bits_d, bv_d = dsp.rate_loop(
                jnp.asarray(spec[None]),
                jnp.asarray(np.array([g0], np.int32)),
                jnp.asarray(np.array([budget], np.int32)),
            )
            assert int(gain_d[0]) == gain_g
            assert int(bits_d[0]) == bits_g
            assert np.array_equal(np.asarray(q_d)[0], q_g)
            assert int(bv_d[0]) == ref.big_values_of(q_g)

    def test_transient_parity(self):
        import jax.numpy as jnp

        from swiftmp3_tpu.ops import dsp
        from swiftmp3_tpu.ops import reference as ref

        rng = np.random.default_rng(2)
        cases = []
        flat = (rng.standard_normal(576) * 0.3).astype(np.float32)
        cases.append(flat)
        attack = flat.copy()
        attack[:192] *= 0.01  # loud tail -> short
        cases.append(attack)
        decay = flat.copy()
        decay[192:] *= 0.01  # loud start -> mixed
        cases.append(decay)
        for pcm576 in cases:
            b_g, g_g = ref.transient_detect(pcm576)
            b_d, g_d = dsp.transient_frame(jnp.asarray(pcm576.reshape(1, 1, 1, 576)))
            assert int(b_d[0, 0, 0]) == b_g
            assert list(np.asarray(g_d)[0, 0, 0]) == g_g

    def test_region_counts_parity(self):
        import jax.numpy as jnp

        from swiftmp3_tpu.ops import dsp
        from swiftmp3_tpu.ops import reference as ref

        for sr in [44100, 48000, 32000]:
            bvs = np.arange(0, 289, dtype=np.int32)  # every possible big_values
            r0_d, r1_d = dsp.region_counts(jnp.asarray(bvs), sr)
            for i, bv in enumerate(bvs):
                r0_g, r1_g = ref.region_counts(int(bv), sr)
                assert int(r0_d[i]) == r0_g, (sr, bv)
                assert int(r1_d[i]) == r1_g, (sr, bv)


def test_gather_free_lookups_exact():
    from swiftmp3_tpu.ops.dsp import validate_gather_free_lookups

    validate_gather_free_lookups()


def test_session_continues_after_flush_matches_numpy():
    from .util import sine

    pcm = sine(0.3)
    outs = {}
    for be in ["numpy", "jax"]:
        s = session(backend=be, mode=Mode.MONO)
        data = s.encode(pcm) + s.flush()
        data += s.encode(pcm) + s.flush()
        outs[be] = data
    assert outs["numpy"] == outs["jax"]
