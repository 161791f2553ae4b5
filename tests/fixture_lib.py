"""Frozen byte-fixture definitions shared by the generator and the test.

Fixtures pin today's encoder bytes (per backend) against silent drift while
perf work rewrites the hot path — this framework's analogue of the
reference's determinism test (SwiftMP3Tests.swift:775-799). Inputs are
regenerated deterministically (PCG64 is a stable algorithm across numpy
versions/platforms), encoded through the PUBLIC API, and compared to the
committed bytes exactly.

Cross-backend note (CLAUDE.md invariants): byte equality is guaranteed
within a backend, not across, on noise-like signals — so each backend's
bytes are frozen separately (files are shared when they happen to match).
"""

from __future__ import annotations

import os

import numpy as np

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
BACKENDS = ("numpy", "jax")


def _sine(n: int, sr: int, freq: float, amp: float) -> np.ndarray:
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _noise(n: int, seed: int, amp: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    for i in range(1, 5):  # correlate: reservoir-stressing but audio-like
        x[i:] += x[:-i] / (i + 1)
    return (amp * x / np.abs(x).max()).astype(np.float32)


def _burst(n: int, sr: int, seed: int) -> np.ndarray:
    """Tonal signal with hard amplitude attacks: forces the transient
    detector's short AND mixed granules (the iso_short_blocks surface)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    x = (0.35 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    env = np.zeros(n, dtype=np.float32)
    p = 700
    while p < n - 1200:
        env[p : p + 500] = 1.0
        p += int(rng.integers(1900, 2700))
    return (x * (0.2 + 0.8 * env)).astype(np.float32)


def make_signal(kind: str, seconds: float, sr: int, channels: int, seed: int) -> np.ndarray:
    n = int(seconds * sr)
    if kind == "sine":
        mono = _sine(n, sr, 440.0, 0.5)
    elif kind == "noise":
        mono = _noise(n, seed, 0.35)
    elif kind == "mix":
        mono = _sine(n, sr, 523.25, 0.3) + _noise(n, seed, 0.2)
    elif kind == "burst":
        mono = _burst(n, sr, seed)
    else:
        raise ValueError(kind)
    if channels == 1:
        return mono
    # slightly decorrelated channels so the M/S decision is exercised
    right = np.roll(mono, 7) * np.float32(0.9)
    return np.stack([mono, right], axis=-1).reshape(-1)


# (name, options-kwargs, signal kind, seconds, seed). Durations include a
# trailing partial frame so flush()'s zero-padded isFinal path is pinned too.
FIXTURES = [
    ("mono_cbr128_44k_sine", dict(mode=Mode.MONO), "sine", 0.40, 1),
    ("stereo_cbr128_44k_noise", dict(mode=Mode.STEREO), "noise", 0.40, 2),
    (
        "joint_cbr192_48k_mix",
        dict(mode=Mode.JOINT_STEREO, bitrate_kbps=192, sample_rate=48000),
        "mix",
        0.37,
        3,
    ),
    ("mono_vbr_q3_44k_noise", dict(mode=Mode.MONO, vbr=True, quality=3), "noise", 0.40, 4),
    ("stereo_crc_cbr128_44k_sine", dict(mode=Mode.STEREO, crc_protected=True), "sine", 0.40, 5),
    (
        "mono_cbr64_32k_noise",
        dict(mode=Mode.MONO, bitrate_kbps=64, sample_rate=32000),
        "noise",
        0.45,
        6,
    ),
    (
        "stereo_aligned_cbr128_44k_mix",
        dict(mode=Mode.STEREO, reservoir_mode="aligned"),
        "mix",
        0.40,
        7,
    ),
    (
        "joint_vbr_q7_crc_aligned_48k_noise",
        dict(
            mode=Mode.JOINT_STEREO,
            vbr=True,
            quality=7,
            crc_protected=True,
            sample_rate=48000,
            reservoir_mode="aligned",
        ),
        "noise",
        0.37,
        8,
    ),
    # spec-strict surface (round 2 flags), pinned like the compat surface
    (
        "strict_full_mono_44k_noise",
        dict(
            mode=Mode.MONO,
            reservoir_mode="aligned",
            iso_quantization=True,
            iso_crc=True,
            crc_protected=True,
            count1_coding=True,
            region_table_select=True,
            real_scalefactors=True,
        ),
        "noise",
        0.40,
        9,
    ),
    (
        "strict_full_stereo_48k_mix",
        dict(
            mode=Mode.STEREO,
            sample_rate=48000,
            bitrate_kbps=160,
            reservoir_mode="aligned",
            iso_quantization=True,
            iso_crc=True,
            crc_protected=True,
            count1_coding=True,
            region_table_select=True,
            real_scalefactors=True,
        ),
        "mix",
        0.37,
        10,
    ),
    # round-3 conformance surface: short/mixed granules with real short
    # scalefactors + ISO reordering, and the sqrt(2) M/S matrices
    (
        "strict_shortblocks_mono_44k_burst",
        dict(
            mode=Mode.MONO,
            reservoir_mode="aligned",
            iso_quantization=True,
            count1_coding=True,
            region_table_select=True,
            real_scalefactors=True,
            iso_short_blocks=True,
        ),
        "burst",
        0.42,
        11,
    ),
    (
        "strict_msmatrix_joint_48k_burst",
        dict(
            mode=Mode.JOINT_STEREO,
            sample_rate=48000,
            reservoir_mode="aligned",
            iso_quantization=True,
            count1_coding=True,
            region_table_select=True,
            real_scalefactors=True,
            iso_short_blocks=True,
            iso_mode_ext=True,
            iso_ms_matrix=True,
        ),
        "burst",
        0.40,
        12,
    ),
]


def encode_fixture(name: str, backend: str) -> bytes:
    cfg = {f[0]: f for f in FIXTURES}[name]
    _, opts_kw, kind, seconds, seed = cfg
    options = MP3EncoderOptions(**opts_kw)
    pcm = make_signal(kind, seconds, options.sample_rate, options.channels, seed)
    session = MP3Encoder(options, backend=backend).new_session()
    return session.encode(pcm) + session.flush()


def fixture_path(name: str, backend: str) -> str:
    return os.path.join(FIXTURE_DIR, f"{name}.{backend}.mp3")
