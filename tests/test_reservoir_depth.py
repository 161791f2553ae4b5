"""reservoir_depth: K-frame emission delay / full ISO reservoir reach.

The one-frame delay (reference behavior, depth=1) physically caps a
frame's main_data back-reach at one slot; depth=K extends it to
min(511, K slots) with FRONT-aligned placement (ARCHITECTURE.md
"Reservoir depth"). depth=1 byte-identity with the historical law is
covered by the frozen fixture suite; these tests cover K>1.
"""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder import decode_mp3
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
    return s.encode(np.asarray(pcm, np.float32)) + s.flush(), s


def _sparse(n: int, seed: int = 21) -> np.ndarray:
    """Quiet tone bed + short sparse noise hits: the content class the
    deep reservoir exists for (quiet frames bank candidate slack, attacks
    draw beyond one slot). Matches the measured-win probe content
    (ARCHITECTURE.md "Reservoir depth": -4.1 dB NMR at 96k, depth 3)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.08 * np.sin(2 * np.pi * 330 * t)
    for f in range(3, n // 1152, 8):
        off = f * 1152 + 400
        x[off : off + 300] += 0.7 * rng.standard_normal(300)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def test_depth_requires_aligned():
    with pytest.raises(ValueError):
        MP3EncoderOptions(reservoir_depth=3)  # compat mode
    with pytest.raises(ValueError):
        MP3EncoderOptions(reservoir_mode="aligned", reservoir_depth=0)


def test_deep_reach_is_exercised_and_streams_conform():
    """A depth-3 hq stream on sparse-transient content must (a) contain a
    frame whose main_data_begin exceeds the one-slot cap (proving the
    deeper reach is real, not just permitted), (b) emit every frame
    (drain-all flush), and (c) decode through the oracle."""
    pcm = _sparse(20 * 1152)
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=96, reservoir_depth=3
    )
    blob, s = _encode(opts, pcm)
    frames = parse_frames(blob)
    assert len(frames) == 20 + 1  # +1: window_sequencing lookahead frame
    slot = 144 * 96000 // SR - 21
    mdbs = [fi.main_data_begin for fi in _iter_frames(blob)]
    assert max(mdbs) > slot, (max(mdbs), slot)
    assert max(mdbs) <= 511
    pcm_dec = decode_mp3(blob, iso_conventions=True).pcm
    assert pcm_dec.shape[0] >= 20 * 1152


def test_depth_noop_on_steady_content():
    """Steady content: depth must be DECODE-exact vs depth 1 (the
    zero-cost claim). Bytes are allowed to shift — front-alignment moves
    main_data placement (mdb + stuffing position) even when every
    quantized value is identical; the decoded samples must be bit-equal
    and the frame sizes unchanged."""
    t = np.arange(10 * 1152) / SR
    pcm = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    base = dict(mode=Mode.MONO, bitrate_kbps=96, sample_rate=SR)
    b1, _ = _encode(MP3EncoderOptions.hq(**base), pcm)
    b3, _ = _encode(MP3EncoderOptions.hq(reservoir_depth=3, **base), pcm)
    assert [f.size for f in parse_frames(b1)] == [
        f.size for f in parse_frames(b3)
    ]
    d1 = decode_mp3(b1, iso_conventions=True).pcm
    d3 = decode_mp3(b3, iso_conventions=True).pcm
    assert np.array_equal(d1, d3)


def test_backends_agree_at_depth():
    """golden vs device at depth 3: structural equality (frame sizes,
    frame count) always; decoded output within the ULP-flip contract
    (depth's different budget point can flip a borderline candidate by
    one notch on a single granule — the documented cross-backend
    float-stack behavior; see CLAUDE.md). Both must exercise the deep
    reach."""
    sparse = _sparse(16 * 1152)
    opts96 = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=96, reservoir_depth=3
    )
    g, _ = _encode(opts96, sparse, "numpy")
    d, _ = _encode(opts96, sparse, "jax")
    assert [f.size for f in parse_frames(g)] == [
        f.size for f in parse_frames(d)
    ]
    slot = 144 * 96000 // SR - 21
    for blob in (g, d):
        mdbs = [fi.main_data_begin for fi in _iter_frames(blob)]
        assert max(mdbs) > slot, (max(mdbs), slot)
    pg = decode_mp3(g, iso_conventions=True).pcm
    pd = decode_mp3(d, iso_conventions=True).pcm
    assert pg.shape == pd.shape
    num = float(np.sum((pg - pd) ** 2))
    den = float(np.sum(pg**2)) + 1e-12
    # isolated candidate flips only: backends agree to >= 40 dB
    assert num <= den * 1e-4, (num, den)


def test_checkpoint_resume_at_depth():
    """state_dict/load_state_dict mid-stream at depth 3 must reproduce the
    uninterrupted stream byte-for-byte (the slot fifo and the K-deep
    assembler buffer are checkpointed state)."""
    pcm = _sparse(16 * 1152)
    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=96, reservoir_depth=3
    )
    whole, _ = _encode(opts, pcm)

    enc = MP3Encoder(opts, backend="numpy")
    s1 = enc.new_session()
    head = s1.encode(pcm[: 7 * 1152])
    state = s1.state_dict()
    s2 = enc.new_session()
    s2.load_state_dict(state)
    tail = s2.encode(pcm[7 * 1152 :]) + s2.flush()
    assert head + tail == whole


@needs_mpg123
def test_depth_quality_win_on_sparse_transients():
    """The measured claim (round-4 re-pin): depth 3 still beats depth 1
    through libmpg123 on sparse-transient content at 96k and never loses
    at 128k. The original -4.1 dB gap (floor was -2.0) collapsed to -0.7
    when the onset/drop chain detector landed — the sequencer now handles
    most of what the deep reservoir was buying on this content (depth-1
    NMR fell 4.x -> 0.9). Both mechanisms stay: the ABSOLUTE quality
    floor pins the combined win; the relative assert pins that depth
    still never hurts."""
    pcm = _sparse(24 * 1152)
    trim = 2 * 1152

    def nmr(kbps, depth):
        opts = MP3EncoderOptions.hq(
            mode=Mode.MONO, bitrate_kbps=kbps, reservoir_depth=depth
        )
        blob, _ = _encode(opts, pcm)
        ext, _ = mpg123_decode(blob)
        return masked_noise_ratio(pcm[trim:-trim], ext[:, 0], SR)

    d1_96, d3_96 = nmr(96, 1), nmr(96, 3)
    assert d3_96 <= d1_96 + 0.1  # depth never hurts at 96k
    assert d3_96 <= 1.0, d3_96  # absolute: measured 0.22 (was 4.x pre-chain)
    assert d1_96 <= 2.0, d1_96  # the detector win itself stays pinned
    assert nmr(128, 3) <= nmr(128, 1) + 0.3


def test_native_matches_python_at_depth():
    """C++ renderer == Python assembler bytes at depth 3 (the deep
    placement law has four twins; this pins the native one on content
    that exercises the deep reach)."""
    from swiftmp3_tpu.native import native_available

    if not native_available():
        pytest.skip("native renderer build failed")
    import swiftmp3_tpu.parallel.batch as batch_mod
    from swiftmp3_tpu.parallel import encode_batch

    opts = MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=96, reservoir_depth=3
    )
    streams = [_sparse(12 * 1152), _sparse(10 * 1152, seed=5)]
    native = encode_batch(opts, streams, frames_per_step=4)

    class _PB(batch_mod.BatchEncoder):
        def __init__(self, *a, **kw):
            kw["use_native"] = False
            super().__init__(*a, **kw)

    orig = batch_mod.BatchEncoder
    batch_mod.BatchEncoder = _PB
    try:
        python = encode_batch(opts, streams, frames_per_step=4)
    finally:
        batch_mod.BatchEncoder = orig
    for i, (a, b) in enumerate(zip(native, python)):
        assert a == b, f"stream {i}: {len(a)} vs {len(b)} bytes"
        parse_frames(a)
