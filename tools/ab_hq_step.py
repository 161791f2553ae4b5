"""Focused full-step hq chained timing for back-to-back A/B runs.

Usage: python tools/ab_hq_step.py [B] [T] [reps]
Prints the median chained per-step time for the hq preset at 128 kbps
stereo — the A/B protocol for perf changes (run HEAD, `git stash`, run
old, `git stash pop`, run HEAD again, on one card within one session:
only back-to-back comparisons are valid).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHAIN = 8


def main():
    import jax

    from swiftmp3_tpu.models.pipeline import init_carry, make_chunk_fn
    from swiftmp3_tpu.options import MP3EncoderOptions, Mode
    from swiftmp3_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    ch = 2
    n = 1152 * ch
    sr = 44100
    audio_seconds = B * T * 1152 / sr
    print(f"B={B} T={T} platform={jax.devices()[0].platform} chain={CHAIN}")

    rng = np.random.default_rng(0)
    pcm_d = [
        jax.device_put(
            (np.clip(rng.standard_normal((B, T, n)) * 0.2, -0.99, 0.99) * 32767
             ).astype(np.int16)
        )
        for _ in range(CHAIN)
    ]
    la_d = [
        jax.device_put(
            (np.clip(rng.standard_normal((B, T, 576 * ch)) * 0.2, -0.99, 0.99)
             * 32767).astype(np.int16)
        )
        for _ in range(CHAIN)
    ]
    fin_d = jax.device_put(np.zeros((B, T), dtype=bool))
    val_d = jax.device_put(np.ones((B, T), dtype=bool))
    jax.block_until_ready(pcm_d)
    jax.block_until_ready(la_d)

    options = MP3EncoderOptions.hq(mode=Mode.STEREO, bitrate_kbps=128)
    run = jax.jit(make_chunk_fn(options))
    carry = init_carry(B, options)
    t0 = time.perf_counter()
    c, out = run(carry, pcm_d[0], fin_d, val_d, la_d[0])
    jax.block_until_ready(out)
    print(f"compile+first: {time.perf_counter() - t0:.1f} s")
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        c = carry
        last = None
        for k in range(CHAIN):
            c, last = run(c, pcm_d[k], fin_d, val_d, la_d[k])
        jax.block_until_ready(last)
        ts.append((time.perf_counter() - t0) / CHAIN)
    med = float(np.median(ts))
    print(f"hq chained step: {med*1e3:.2f} ms  ({audio_seconds/med:.0f}x rt)"
          f"  all={[f'{t*1e3:.1f}' for t in ts]}")


if __name__ == "__main__":
    main()
