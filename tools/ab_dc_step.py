"""Device cost of distortion_control: hq vs hq(distortion_control=True).

Usage: python tools/ab_dc_step.py [B] [T] [reps] [kbps]

Runs BOTH configs in one process, alternating reps (only back-to-back
comparisons on one card are valid), at a bitrate where the dc gate is ACTIVE (>= 112 kbps per
channel; default 256 kbps stereo). Prints median chained per-step time for
each and the ratio — the number quoted for dc's "costs a second walk pass"
claim in ARCHITECTURE.md.
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
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    kbps = int(sys.argv[4]) if len(sys.argv) > 4 else 256
    ch = 2
    n = 1152 * ch
    sr = 44100
    audio_seconds = B * T * 1152 / sr
    print(f"B={B} T={T} kbps={kbps} platform={jax.devices()[0].platform} "
          f"chain={CHAIN}")

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

    configs = {
        "hq": MP3EncoderOptions.hq(mode=Mode.STEREO, bitrate_kbps=kbps),
        "hq+dc": MP3EncoderOptions.hq(
            mode=Mode.STEREO, bitrate_kbps=kbps, distortion_control=True
        ),
        # passes ladder: the marginal per-pass delta attributes the dc cost
        # (each pass = probe select + 1-gain quantize + bump law + sfd
        # rebuild + a FULL second pricing sweep; if the marginal cost ~=
        # the sweep's stub delta, the pass is sweep-dominated)
        "hq+dc2": MP3EncoderOptions.hq(
            mode=Mode.STEREO, bitrate_kbps=kbps, distortion_control=True,
            dc_passes=2,
        ),
        "hq+dc3": MP3EncoderOptions.hq(
            mode=Mode.STEREO, bitrate_kbps=kbps, distortion_control=True,
            dc_passes=3,
        ),
    }
    runs = {}
    for name, options in configs.items():
        assert name == "hq" or options.distortion_control_active, (
            "dc gate must be active for the A/B to measure anything"
        )
        run = jax.jit(make_chunk_fn(options))
        carry = init_carry(B, options)
        t0 = time.perf_counter()
        _, out = run(carry, pcm_d[0], fin_d, val_d, la_d[0])
        jax.block_until_ready(out)
        print(f"{name}: compile+first {time.perf_counter() - t0:.1f} s")
        runs[name] = (run, carry)

    ts = {name: [] for name in configs}
    for _ in range(reps):
        for name, (run, carry) in runs.items():  # alternate configs per rep
            t0 = time.perf_counter()
            c = carry
            last = None
            for k in range(CHAIN):
                c, last = run(c, pcm_d[k], fin_d, val_d, la_d[k])
            jax.block_until_ready(last)
            ts[name].append((time.perf_counter() - t0) / CHAIN)

    meds = {}
    for name in configs:
        med = float(np.median(ts[name]))
        meds[name] = med
        print(f"{name}: {med*1e3:.2f} ms/step ({audio_seconds/med:.0f}x rt)"
              f"  all={[f'{t*1e3:.1f}' for t in ts[name]]}")
    print(f"dc overhead: {meds['hq+dc']/meds['hq']:.3f}x "
          f"(+{(meds['hq+dc']-meds['hq'])*1e3:.1f} ms)")
    if "hq+dc2" in meds:
        print(f"marginal per pass: p1 +{(meds['hq+dc']-meds['hq'])*1e3:.1f} "
              f"p2 +{(meds['hq+dc2']-meds['hq+dc'])*1e3:.1f} "
              f"p3 +{(meds['hq+dc3']-meds['hq+dc2'])*1e3:.1f} ms")


if __name__ == "__main__":
    main()
