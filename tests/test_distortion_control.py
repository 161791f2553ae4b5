"""options.distortion_control: one-shot in-walk noise shaping.

The law (ops/reference.distortion_bumps + the encoder's probe-walk stage):
a state-free probe walk at the base-rate equal-share budget measures each
band's actual reconstruction error against the spread-mask target; bands
over DC_RATIO bump by DC_BUMP scalefactor steps and the real walk runs
once with the bumped magnitudes. Gates: all-LONG frames only, >= 112
kbps/channel, MPEG-1 (see options.distortion_control_active). Measured
economics in the flag's docstring; the floors here pin the direction.
"""

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.ops import reference as ref
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode
from swiftmp3_tpu.utils.quality import masked_noise_ratio

from .util import sine

SR = 44100


def _speech(frames: int, seed: int = 14) -> np.ndarray:
    """Synthetic voiced content (the class the flag targets): harmonic
    source under a slow envelope plus a noise floor — wide per-band
    violations with spare precision at 128 kbps."""
    rng = np.random.default_rng(seed)
    n = frames * 1152
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    voiced = np.sin(2 * np.pi * f0 * t) + 0.4 * np.sin(2 * np.pi * 2 * f0 * t)
    env = np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t), 0, 1)
    return (0.4 * voiced * env + rng.standard_normal(n) * 0.02).astype(
        np.float32
    )


def _encode(opts: MP3EncoderOptions, pcm: np.ndarray, backend="numpy") -> bytes:
    s = MP3Encoder(opts, backend=backend).new_session()
    return s.encode(pcm) + s.flush()


def test_validation_gates():
    with pytest.raises(ValueError, match="linbits"):
        MP3EncoderOptions.spec_strict(distortion_control=True)
    with pytest.raises(ValueError, match="scfsi"):
        MP3EncoderOptions.hq(distortion_control=True, scfsi=True)
    # hq() drops scfsi automatically
    opts = MP3EncoderOptions.hq(
        distortion_control=True, bitrate_kbps=128, mode=Mode.MONO
    )
    assert not opts.scfsi and opts.distortion_control_active
    # rate gate: below 112 kbps/channel the flag is inert
    assert not MP3EncoderOptions.hq(
        distortion_control=True, bitrate_kbps=96
    ).distortion_control_active
    assert not MP3EncoderOptions.hq(
        distortion_control=True, bitrate_kbps=128, mode=Mode.STEREO
    ).distortion_control_active
    assert MP3EncoderOptions.hq(
        distortion_control=True, bitrate_kbps=256, mode=Mode.STEREO
    ).distortion_control_active


def test_below_gate_is_byte_noop():
    pcm = _speech(6)
    a = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=96,
                                     scfsi=False), pcm)
    b = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=96,
                                     distortion_control=True), pcm)
    assert a == b


def test_engages_and_stays_conforming():
    """At 128 kbps mono the flag changes bytes, bumps scalefactors on
    violating bands, and the stream still decodes through libmpg123 in
    close agreement with the repo oracle."""
    pcm = _speech(16)  # 8-frame clips can be all transition frames
    base_opts = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128,
                                     scfsi=False)
    dc_opts = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128,
                                   distortion_control=True)
    a, b = _encode(base_opts, pcm), _encode(dc_opts, pcm)
    assert a != b and len(a) == len(b)  # CBR: same sizes, different bits
    if have_mpg123():
        from swiftmp3_tpu.decoder import decode_mp3
        from swiftmp3_tpu.utils.quality import decode_agreement_snr

        ours = decode_mp3(b, iso_conventions=True)
        theirs, _ = mpg123_decode(b)
        n = min(len(ours.pcm), len(theirs))
        assert (
            decode_agreement_snr(ours.pcm[:n, 0], theirs[:n, 0]) > 60
        )


@pytest.mark.skipif(not have_mpg123(), reason="system libmpg123 not available")
def test_nmr_improvement_floor_speech_128k():
    """Regression floor for the flag's reason to exist: >= 1 dB mpg123 NMR
    improvement on 16-frame speech at 128 kbps mono (measured -1.8)."""
    pcm = _speech(16)
    base = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128,
                                        scfsi=False), pcm)
    dc = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128,
                                      distortion_control=True), pcm)
    trim = 2 * 1152
    nb, _ = mpg123_decode(base)
    nd, _ = mpg123_decode(dc)
    nmr_b = masked_noise_ratio(pcm[trim:-trim], nb[:, 0], SR)
    nmr_d = masked_noise_ratio(pcm[trim:-trim], nd[:, 0], SR)
    assert nmr_d <= nmr_b - 1.0, (nmr_b, nmr_d)


def test_transient_frames_are_exact_noops():
    """A frame holding any short/transition granule is byte-identical with
    the flag on (the all-LONG gate): an alternating tone/burst clip where
    EVERY frame has a transition must produce identical bytes."""
    n = 8 * 1152
    t = np.arange(n) / SR
    pcm = (0.35 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    env = np.zeros(n, dtype=np.float32)
    for p in range(400, n - 900, 1152):  # one attack per frame
        env[p : p + 700] = 1.0
    pcm = pcm * env
    a = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128,
                                     scfsi=False), pcm)
    b = _encode(MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=128,
                                     distortion_control=True), pcm)
    assert a == b


def test_bump_law_unit():
    """distortion_bumps fires exactly on the construction: a strong masker
    band plus a far, quiet band whose error exceeds its low spread mask."""
    rng = np.random.default_rng(0)
    spec = np.zeros(576, dtype=np.float32)
    spec[0:12] = 1000.0 * rng.standard_normal(12).astype(np.float32)
    spec[300:340] = 0.5 * rng.standard_normal(40).astype(np.float32)
    sf = np.zeros(21, dtype=np.int64)
    # coarse quantization: everything rounds to zero in the quiet band
    q = np.zeros(576, dtype=np.int32)
    q[0:12] = np.round(spec[0:12] / 50.0).astype(np.int32)
    gain = 210 + 4 * 8
    bumps = ref.distortion_bumps(spec, q, gain, sf, SR)
    assert bumps.shape == (21,)
    assert bumps.max() == ref.DC_BUMP
    # the quiet far band (inside bands covering lines 300-340) violated
    bounds = np.concatenate([[0], np.cumsum(
        __import__("swiftmp3_tpu.tables", fromlist=["band_table"]).band_table(SR)
    )])
    hit = [b for b in range(21)
           if bumps[b] and bounds[b + 1] > 300 and bounds[b] < 340]
    assert hit, bumps


@pytest.mark.parametrize(
    "mode,kbps,vbr,seed",
    [
        (Mode.MONO, 128, False, 14),
        (Mode.STEREO, 256, False, 3),
        (Mode.MONO, 128, True, 14),
    ],
)
def test_device_backend_byte_equality(mode, kbps, vbr, seed):
    """Device twin (probe select + bump + second sweep + pass-2 selection
    scan, models/pipeline.py) is byte-identical to golden with the flag on,
    including under VBR (probe budget is the static base-rate share) and
    stereo at an engaged per-channel rate.

    Content is chosen under the ULP-flip contract (CLAUDE.md): the bump
    decision compares band error-energy SUMS (float reductions whose
    order differs across backends) against the exponent-exact mask, so a
    knife-edge granule can flip the decision and diverge its frame's
    bytes (seed 14 stereo@256k flips one frame; base hq is byte-equal
    there — verified while choosing these seeds)."""
    pcm = _speech(10, seed=seed)
    if mode != Mode.MONO:
        pcm = np.stack([pcm, 0.8 * pcm], axis=-1).reshape(-1)
    kw = dict(mode=mode, bitrate_kbps=kbps, distortion_control=True)
    if vbr:
        kw.update(vbr=True, quality=3)
    opts = MP3EncoderOptions.hq(**kw)
    golden = _encode(opts, pcm, backend="numpy")
    device = _encode(opts, pcm, backend="jax")
    assert golden == device


@pytest.mark.parametrize("passes,prop", [(3, True), (2, False)])
def test_depth_device_backend_byte_equality(passes, prop):
    """Round-5 depth knobs (options.dc_passes / dc_proportional): the
    unrolled device probe loop + the threshold-ladder proportional step
    count are byte-identical to golden (the ladder is EXACT vs the
    golden's f64 log2 — see dsp.distortion_bumps_device — so depth adds
    no new flip surface beyond the pass-1 bump compare)."""
    pcm = _speech(8, seed=14)
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=128, distortion_control=True,
        dc_passes=passes, dc_proportional=prop,
    )
    golden = _encode(opts, pcm, backend="numpy")
    device = _encode(opts, pcm, backend="jax")
    assert golden == device


def test_depth_options_validation():
    with pytest.raises(ValueError, match="dc_passes"):
        MP3EncoderOptions.hq(mode=Mode.MONO, dc_passes=2)
    with pytest.raises(ValueError, match="dc_passes"):
        MP3EncoderOptions.hq(
            mode=Mode.MONO, distortion_control=True, dc_passes=0
        )
    with pytest.raises(ValueError, match="dc_"):
        MP3EncoderOptions.hq(mode=Mode.MONO, dc_proportional=True)


def test_depth_changes_bytes_when_engaged():
    """Depth must actually do something: (3, proportional) diverges from
    the one-shot on speech at 128k (the measured -1.95 vs -1.08 dB NMR
    distribution — see tools/probe_dc_depth.py; the probe corpus's
    synth() speech, whose every seed improved under depth)."""
    import sys

    sys.path.insert(0, "tools")
    from tune_psy import synth

    pcm = synth("speech", 16 * 1152, 10)
    base = _encode(
        MP3EncoderOptions.hq(
            mode=Mode.MONO, bitrate_kbps=128, distortion_control=True
        ),
        pcm,
    )
    deep = _encode(
        MP3EncoderOptions.hq(
            mode=Mode.MONO, bitrate_kbps=128, distortion_control=True,
            dc_passes=3, dc_proportional=True,
        ),
        pcm,
    )
    assert base != deep
