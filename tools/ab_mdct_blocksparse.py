"""A/B the block-sparse MDCT (dsp.mdct_chunk_blocksparse) vs the dense fold
on the GPU.

Protocol: standalone chained medians for both MDCT variants, then FULL-STEP
chained medians A/B built back-to-back in one process (compare two variants
only within one run). Run on the GPU with no platform override:

    python tools/ab_mdct_blocksparse.py [--batch 128] [--frames 64]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from swiftmp3_tpu.models import pipeline  # noqa: E402
from swiftmp3_tpu.models.pipeline import init_carry, make_chunk_fn  # noqa: E402
from swiftmp3_tpu.options import MP3EncoderOptions, Mode  # noqa: E402
from swiftmp3_tpu.ops import dsp  # noqa: E402
from swiftmp3_tpu.utils import enable_compilation_cache  # noqa: E402


def chained_median(fn, args_list, chain, reps=3, carry_mode=False, carry=None):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        if carry_mode:
            c = carry
            last = None
            for k in range(chain):
                c, last = fn(c, *args_list[k % len(args_list)])
            jax.block_until_ready(last)
        else:
            last = None
            for k in range(chain):
                last = fn(*args_list[k % len(args_list)])
            jax.block_until_ready(last)
        times.append((time.perf_counter() - t0) / chain)
    return float(np.median(times)), [round(t * 1e3, 2) for t in times]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--frames", type=int, default=64)
    args = p.parse_args()
    enable_compilation_cache()
    B, T = args.batch, args.frames
    options = MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128)
    ch = 2
    G = 2 * T
    rng = np.random.default_rng(0)

    # ---- standalone MDCT A/B (resident inputs, chained) ----
    n_in = 4
    Ss = [
        jax.device_put(
            (rng.standard_normal((B, ch, 18 * G, 32)) * 0.1).astype(np.float32)
        )
        for _ in range(n_in)
    ]
    ov = jax.device_put(np.zeros((B, ch, 576), np.float32))
    bts = [
        jax.device_put(rng.integers(0, 3, (B, ch, G)).astype(np.int32))
        for _ in range(n_in)
    ]
    fold = jax.jit(lambda s, o, b: dsp.mdct_chunk(s, o, b)[0])
    bsp = jax.jit(lambda s, o, b: dsp.mdct_chunk_blocksparse(s, o, b)[0])
    for f in (fold, bsp):
        jax.block_until_ready(f(Ss[0], ov, bts[0]))  # compile
    argsets = [(Ss[i], ov, bts[i]) for i in range(n_in)]
    t_fold, r_fold = chained_median(fold, argsets, chain=8)
    t_bsp, r_bsp = chained_median(bsp, argsets, chain=8)
    # alternate again (drift check)
    t_fold2, r_fold2 = chained_median(fold, argsets, chain=8)
    t_bsp2, r_bsp2 = chained_median(bsp, argsets, chain=8)
    print(
        f"standalone MDCT ms/call (B={B} G={G}): fold {t_fold*1e3:.2f} / "
        f"{t_fold2*1e3:.2f}  blocksparse {t_bsp*1e3:.2f} / {t_bsp2*1e3:.2f}"
    )
    print(f"  reps: fold {r_fold}+{r_fold2} bsp {r_bsp}+{r_bsp2}")

    # ---- full-step A/B: swap dsp.mdct_chunk at trace time ----
    real_mdct = dsp.mdct_chunk
    n = 1152 * ch
    pcms = [
        jax.device_put(
            (rng.standard_normal((B, T, n)) * 0.3).astype(np.float32)
        )
        for _ in range(n_in)
    ]
    final = jax.device_put(np.zeros((B, T), bool))
    valid = jax.device_put(np.ones((B, T), bool))
    steps = {}
    outs0 = {}
    for name, impl in (("fold", real_mdct), ("blocksparse", dsp.mdct_chunk_blocksparse)):
        dsp.mdct_chunk = impl
        try:
            step = jax.jit(make_chunk_fn(options))
        finally:
            dsp.mdct_chunk = real_mdct
        carry = init_carry(B, options)
        c2, o = step(carry, pcms[0], final, valid)
        jax.block_until_ready(o)
        steps[name] = (step, carry)
        outs0[name] = np.asarray(o["packed"])

    same = np.array_equal(outs0["fold"], outs0["blocksparse"])
    nd = int((outs0["fold"] != outs0["blocksparse"]).sum())
    print(f"first-chunk packed outputs identical: {same} (diff bytes {nd} "
          f"of {outs0['fold'].size})")

    def run_full(name):
        step, carry = steps[name]
        return chained_median(
            step,
            [(pcms[i], final, valid) for i in range(n_in)],
            chain=8,
            carry_mode=True,
            carry=carry,
        )

    # alternate twice each (back-to-back comparisons only)
    t_f1, rr_f1 = run_full("fold")
    t_b1, rr_b1 = run_full("blocksparse")
    t_f2, rr_f2 = run_full("fold")
    t_b2, rr_b2 = run_full("blocksparse")
    print(
        f"full step ms (B={B} T={T}): fold {t_f1*1e3:.2f} / {t_f2*1e3:.2f}  "
        f"blocksparse {t_b1*1e3:.2f} / {t_b2*1e3:.2f}"
    )
    print(f"  reps: fold {rr_f1}+{rr_f2} bsp {rr_b1}+{rr_b2}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
