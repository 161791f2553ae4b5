"""Aggregate ULP-flip telemetry (slow tier).

Cross-backend BYTE equality is guaranteed within a backend, not across:
float-REDUCTION decisions shared golden/device (the rate-loop candidate
selection on noise-like content, distortion_control's bump compare,
intensity stereo's region/position laws, vbr_demand's bitrate choice)
can flip on knife-edge granules — the ULP-flip contract each feature's
own tests honor with isolated-flip allowances.

What no per-feature test watches is the AGGREGATE: every new
reduction-based decision widens the class of content where byte equality
silently degrades to structural equality. This suite pins the flip RATE
(frames with any byte divergence / total frames) per flag configuration
on a fixed mixed corpus, so creep becomes a test failure instead of an
archaeology project.

Ceilings are measured rates (2026-08-20, the seeds below, CPU device
backend) plus slack of max(2x, +2 frames). A failure here means a change
added cross-backend divergence on content that previously agreed —
either make the new decision integer/structural, or re-measure, justify,
and re-pin with a note.

Structural equality (frame count/sizes) must hold EXACTLY everywhere —
that part of the contract has no flip allowance.
"""

from __future__ import annotations

import numpy as np
import pytest

from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.options import MP3EncoderOptions, Mode

SR = 44100
FRAMES = 12  # per corpus item
N = 1152 * FRAMES

pytestmark = pytest.mark.slow


def _corpus_stereo() -> dict:
    """Fixed mixed corpus, interleaved stereo float32. Classes chosen to
    cover the known flip axes: tonal (agrees), correlated noise (rate-loop
    knife edges), noise bursts on tone (transient machinery), speech-like
    AR noise (distortion control's class), decorrelated noise (stereo
    decision), panned tonal (intensity's class)."""
    rng = np.random.default_rng(20260820)
    t = np.arange(N) / SR
    out = {}

    tone = 0.4 * np.sin(2 * np.pi * 441.0 * t) + 0.15 * np.sin(
        2 * np.pi * 1320.0 * t
    )
    out["tonal"] = (tone, 0.8 * tone)

    ar = rng.standard_normal(N + 8).astype(np.float64)
    for i in range(1, 8):
        ar[i:] += ar[:-i] / (i + 1)
    ar = 0.25 * ar[:N] / np.abs(ar[:N]).max()
    out["noise"] = (ar, ar + 0.01 * rng.standard_normal(N))

    burst = 0.3 * np.sin(2 * np.pi * 600.0 * t)
    for k in range(1152 * 2, N, 1152 * 3):
        burst[k : k + 96] += rng.standard_normal(96) * 0.6
    out["burst"] = (burst, burst * 0.9)

    # speech-like: pitch-pulsed AR noise with syllable-rate envelope
    exc = np.zeros(N)
    exc[:: int(SR / 120)] = 1.0
    exc += 0.3 * rng.standard_normal(N)
    sp = np.copy(exc)
    for i in range(1, 10):
        sp[i:] += sp[:-i] * (0.75 / i)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t))
    sp = 0.3 * env * sp / np.abs(sp).max()
    out["speech"] = (sp, sp)

    out["decorr"] = (
        0.2 * rng.standard_normal(N),
        0.2 * rng.standard_normal(N),
    )

    pan = 0.35 * np.sin(2 * np.pi * 523.25 * t) + 0.1 * np.sin(
        2 * np.pi * 2093.0 * t
    )
    out["panned"] = (pan, 0.25 * pan)
    return {
        k: np.stack(
            [np.asarray(l, np.float32), np.asarray(r, np.float32)], axis=-1
        ).reshape(-1)
        for k, (l, r) in out.items()
    }


def _mono(pcm_st: np.ndarray) -> np.ndarray:
    x = pcm_st.reshape(-1, 2)
    return ((x[:, 0] + x[:, 1]) * 0.5).astype(np.float32)


def _walk(data: bytes) -> list[tuple[int, int]]:
    """(offset, size) per frame; raises on malformed streams."""
    frames, i = [], 0
    br_tab = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0]
    while i + 4 <= len(data):
        assert data[i] == 0xFF and (data[i + 1] & 0xE0) == 0xE0, i
        br = br_tab[(data[i + 2] >> 4) & 0xF]
        pad = (data[i + 2] >> 1) & 1
        size = 144 * br * 1000 // SR + pad
        frames.append((i, size))
        i += size
    assert i == len(data)
    return frames


def _flips(opts: MP3EncoderOptions, pcm: np.ndarray) -> tuple[int, int]:
    """(divergent_frames, total_frames) golden vs device for one stream."""
    outs = {}
    for be in ("numpy", "jax"):
        s = EncoderSession(opts, backend=be)
        outs[be] = s.encode(pcm) + s.flush()
    fa, fb = _walk(outs["numpy"]), _walk(outs["jax"])
    # structural equality is unconditional — no flip allowance
    assert [s for _, s in fa] == [s for _, s in fb], "structural divergence"
    a, b = outs["numpy"], outs["jax"]
    bad = sum(
        1 for (o, s), (o2, s2) in zip(fa, fb) if a[o : o + s] != b[o2 : o2 + s2]
    )
    return bad, len(fa)


# (name, ceiling_frames, options factory, corpus transform)
# Ceilings: measured divergent-frame counts on this corpus (see module
# docstring) + max(2x, +2). Total frames per config: 6 classes x ~13
# frames (stereo) or as noted.
_CONFIGS = [
    (
        "compat",
        2,  # measured 0/72 (2026-08-20)
        lambda: MP3EncoderOptions(
            mode=Mode.STEREO, bitrate_kbps=128, sample_rate=SR
        ),
        None,
    ),
    (
        "strict",
        16,  # measured 8/72: tonal 1, burst 4, panned 3 (2026-08-20)
        lambda: MP3EncoderOptions.spec_strict(
            mode=Mode.JOINT_STEREO, bitrate_kbps=128, sample_rate=SR
        ),
        None,
    ),
    (
        "hq",
        24,  # measured 16/78: tonal 2, burst 11, panned 3 (2026-08-20) —
        # a flipped sequencing want cascades START/STOP over several
        # frames, so the burst class is near-bimodal by stream
        lambda: MP3EncoderOptions.hq(
            mode=Mode.JOINT_STEREO, bitrate_kbps=128, sample_rate=SR
        ),
        None,
    ),
    (
        "hq_dc_mono128",
        42,  # measured 34/78: tonal 12, burst 11, panned 11 (2026-08-20)
        # — on STATIONARY content a knife-edge bump compare recurs every
        # frame, so divergence is 0-or-most-frames per class by design
        lambda: MP3EncoderOptions.hq(
            mode=Mode.MONO,
            bitrate_kbps=128,
            sample_rate=SR,
            distortion_control=True,
        ),
        _mono,
    ),
    (
        "hq_vbr_demand_q5",
        20,  # measured 12/78: tonal 3, burst 9 (2026-08-20)
        lambda: MP3EncoderOptions.hq(
            mode=Mode.MONO,
            bitrate_kbps=128,
            sample_rate=SR,
            vbr=True,
            vbr_demand=True,
            quality=5,
        ),
        _mono,
    ),
    (
        "hq_is_32k",
        19,  # measured 11/78: burst 11, all other classes 0 (2026-08-20)
        lambda: MP3EncoderOptions.hq(
            mode=Mode.JOINT_STEREO,
            bitrate_kbps=32,
            sample_rate=SR,
            intensity_stereo=True,
        ),
        None,
    ),
]


@pytest.mark.parametrize(
    "name,ceiling,make_opts,transform",
    _CONFIGS,
    ids=[c[0] for c in _CONFIGS],
)
def test_flip_rate(name, ceiling, make_opts, transform):
    corpus = _corpus_stereo()
    opts = make_opts()
    bad = total = 0
    per_class = {}
    for cls, pcm in corpus.items():
        if transform is not None:
            pcm = transform(pcm)
        d, n = _flips(opts, pcm)
        per_class[cls] = (d, n)
        bad += d
        total += n
    assert bad <= ceiling, (
        f"{name}: {bad}/{total} divergent frames (ceiling {ceiling}); "
        f"per-class {per_class} — a reduction-based decision got noisier; "
        "see module docstring before re-pinning"
    )
