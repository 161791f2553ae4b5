"""Smoke test of the batched MP3 encoder on NVIDIA GPUs.

    python chip_smoke.py               # one GPU: phases 1-5 below
    python chip_smoke.py --four-cards  # four GPUs: the sharded batch path only

Runs the system's main path once, at deployment size, through the entry
points users call, and checks what comes out:

1. device: refuses anything but a GPU, and a missing native renderer;
2. main path: the compat and hq corpus jobs (`encode_batch`, B=256 streams
   x T=128 frames per step, 3 steps after a compile warm-up) and 64-lane
   `StreamPool` serving; every output stream must frame-walk and decode
   through the in-repo decoder;
3. plain reference: a seeded slice of each job re-encoded by the golden
   numpy backend; frame sizes and headers must be equal, and the share of
   frames whose bytes differ must stay under the ULP-flip ceiling that
   tests/test_ulp_telemetry.py pins for the preset;
4. frozen fixtures: every tests/fixture_lib config against its committed
   device-backend bytes;
5. kernels: the fused rate-sweep kernel against its jnp twin at full
   width, alone and inside the whole compat step.

Every measurement line carries the card's name and power limit. The last
line of standard output is one JSON object; any failure exits non-zero
before it is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SR = 44100
BATCH, FRAMES, STEPS = 256, 128, 3
POOL_LANES, POOL_FRAMES, POOL_STREAMS = 64, 32, 96
GOLDEN_STREAMS = {"compat": 4, "hq": 2}
# ULP-flip ceilings as shares of frames: tests/test_ulp_telemetry.py pins
# compat at 2 divergent frames of 72 and hq at 24 of 78 on its corpus.
FLIP_SHARE = {"compat": 2 / 72, "hq": 24 / 78}
SWEEP_WIDTH = BATCH * FRAMES * 2 * 2  # granules per compat step: 131,072

_CARD = ""


def say(*parts) -> None:
    """One measurement line, tagged with the card (stderr keeps stdout's
    last line for the JSON result)."""
    print(f"[{_CARD}]", *parts, file=sys.stderr, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# ---- inputs ------------------------------------------------------------------


def make_streams(seed: int, n_streams: int, lengths) -> list[np.ndarray]:
    """Seeded speech/music-like stereo int16 PCM, interleaved: a few tones
    with per-stream pitch over correlated noise with a syllable-rate
    envelope; the right channel is a delayed, scaled left plus its own
    noise, so the channels correlate without being equal."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_streams):
        n = int(lengths[i])
        t = np.arange(n, dtype=np.float32) / np.float32(SR)
        f0 = rng.uniform(110.0, 440.0)
        tone = sum(
            np.float32(a) * np.sin(np.float32(2 * np.pi * f0 * k) * t)
            for a, k in ((0.3, 1), (0.12, 2.01), (0.05, 3.7))
        )
        noise = rng.standard_normal(n + 8).astype(np.float32)
        for j in range(1, 8):
            noise[j:] += noise[:-j] / np.float32(j + 1)
        noise = noise[:n] * np.float32(0.06 / (np.abs(noise).max() + 1e-9))
        env = np.float32(0.6) + np.float32(0.4) * np.sin(
            np.float32(2 * np.pi * rng.uniform(1.0, 4.0)) * t
        )
        left = np.clip((tone + noise) * env, -0.99, 0.99)
        right = np.clip(
            np.float32(0.85) * np.roll(left, 11)
            + np.float32(0.02) * rng.standard_normal(n).astype(np.float32),
            -0.99,
            0.99,
        )
        st = np.stack([left, right], axis=-1).reshape(-1)
        out.append((st * np.float32(32767.0)).astype(np.int16))
    return out


# ---- checks run in worker processes (no JAX) ----------------------------------


def _walk_and_decode(args):
    blob, n_frames, iso = args
    from swiftmp3_tpu.decoder import decode_mp3
    from tests.util import parse_frames

    frames = parse_frames(blob)
    dec = decode_mp3(blob, iso_conventions=iso)
    return (
        len(frames),
        dec.frame_count,
        dec.pcm.shape[0],
        bool(np.isfinite(dec.pcm).all()),
    )


def verify_blobs(name: str, blobs, frames_each, iso: bool, workers) -> None:
    """Every stream frame-walks, decodes, and has the expected frames."""
    t0 = time.perf_counter()
    jobs = [(b, n, iso) for b, n in zip(blobs, frames_each)]
    results = list(workers.map(_walk_and_decode, jobs, chunksize=4))
    for i, (nf, ndec, nsamp, finite) in enumerate(results):
        want = frames_each[i]
        check(nf == want, f"{name} stream {i}: {nf} frames, want {want}")
        check(ndec == want, f"{name} stream {i}: decoder read {ndec} frames")
        check(nsamp > 0, f"{name} stream {i}: decoded no samples")
        check(finite, f"{name} stream {i}: non-finite decoded PCM")
    say(
        f"{name}: {len(blobs)} streams, {sum(frames_each)} frames walked and "
        f"decoded ({time.perf_counter() - t0:.1f} s)"
    )


def frame_diff(a: bytes, b: bytes) -> tuple[int, int]:
    """(divergent frames, frames); raises Failed on structural mismatch."""
    from tests.util import parse_frames

    fa, fb = parse_frames(a), parse_frames(b)
    check(
        [f.size for f in fa] == [f.size for f in fb],
        "frame sizes differ from the reference",
    )
    check(
        all(a[x.offset : x.offset + 4] == b[y.offset : y.offset + 4] for x, y in zip(fa, fb)),
        "frame headers differ from the reference",
    )
    bad = sum(
        a[x.offset : x.offset + x.size] != b[y.offset : y.offset + y.size]
        for x, y in zip(fa, fb)
    )
    return bad, len(fa)


# ---- phases ---------------------------------------------------------------------


class Compiles:
    """Seconds XLA spent compiling, from JAX's monitoring events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.count = 0

        def listen(event, duration, **_):
            if event.endswith("backend_compile_duration"):
                self.seconds += duration
                self.count += 1

        jax.monitoring.register_event_duration_secs_listener(listen)


def peak_gb(device) -> str:
    stats = device.memory_stats() or {}
    return f"{stats.get('peak_bytes_in_use', 0) / 1e9:.2f} GB"


def job_options():
    from swiftmp3_tpu.options import MP3EncoderOptions, Mode

    return {
        "compat": MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128, sample_rate=SR),
        "hq": MP3EncoderOptions.hq(mode=Mode.STEREO, bitrate_kbps=128, sample_rate=SR),
    }


def job_streams(name, opts, seed, batch, frames, steps):
    """batch streams of steps*frames frames each (the hq preset's one
    granule of sequencing delay is taken off, so both jobs run exactly
    `steps` device steps)."""
    n = steps * frames * 1152 - (576 if opts.window_sequencing else 0)
    return make_streams(seed + (0 if name == "compat" else 1), batch, [n] * batch)


def warm_up(opts, batch, frames, mesh=None):
    """Compile the job's chunk program with one step on silence."""
    from swiftmp3_tpu.parallel.batch import BatchEncoder

    enc = BatchEncoder(opts, batch, frames_per_step=frames, mesh=mesh)
    pcm = np.zeros((batch, frames, 1152 * opts.channels), np.int16)
    la = (
        np.zeros((batch, frames, 576 * opts.channels), np.int16)
        if opts.window_sequencing
        else None
    )
    outs = enc.step(pcm, np.zeros((batch, frames), bool), np.ones((batch, frames), bool), la)
    import jax

    jax.block_until_ready(outs)
    enc.close()


def run_job(name, opts, streams, frames, steps, compiles, device, workers, mesh=None):
    """Compile, then encode the corpus through encode_batch; returns blobs."""
    import jax

    from swiftmp3_tpu.parallel.batch import encode_batch

    c0, t0 = compiles.seconds, time.perf_counter()
    warm_up(opts, len(streams), frames, mesh)
    say(
        f"{name}: compile {compiles.seconds - c0:.1f} s "
        f"(warm-up step {time.perf_counter() - t0:.1f} s wall)"
    )
    n0, t0 = compiles.count, time.perf_counter()
    blobs = encode_batch(opts, streams, frames_per_step=frames, mesh=mesh)
    wall = time.perf_counter() - t0
    check(compiles.count == n0, f"{name}: {compiles.count - n0} compiles after warm-up")
    audio_s = len(streams) * steps * frames * 1152 / SR
    say(
        f"{name}: encode_batch B={len(streams)} T={frames} x {steps} steps: "
        f"{wall:.2f} s wall, {wall / steps * 1e3:.1f} ms/step steady, "
        f"{audio_s / wall:.0f}x realtime end to end; peak device memory "
        f"{peak_gb(device)}"
    )
    verify_blobs(name, blobs, [steps * frames] * len(streams),
                 opts.iso_ms_matrix or opts.iso_short_blocks, workers)
    return blobs


def against_golden(name, opts, streams, blobs, seed) -> int:
    from swiftmp3_tpu import MP3Encoder

    rng = np.random.default_rng(seed)
    picks = sorted(rng.choice(len(streams), GOLDEN_STREAMS[name], replace=False))
    bad = total = 0
    for i in picks:
        s = MP3Encoder(opts, backend="numpy").new_session()
        ref = s.encode(streams[i]) + s.flush()
        d, n = frame_diff(ref, blobs[i])
        bad += d
        total += n
        say(f"{name}: stream {i} vs golden numpy: {d}/{n} divergent frames")
    share = bad / total
    say(
        f"{name}: golden slice {bad}/{total} divergent frames "
        f"({100 * share:.2f}%, ceiling {100 * FLIP_SHARE[name]:.2f}%)"
    )
    check(share <= FLIP_SHARE[name], f"{name}: divergent share over the ceiling")
    return bad


def run_pool(opts, seed, lanes, frames, n_streams, compiles, device, workers,
             mesh=None, label="serving"):
    """Serve n_streams > lanes streams of mixed length, fed chunk by chunk;
    finished lanes are recycled for waiting streams. Returns (blobs, pcm)."""
    from swiftmp3_tpu.parallel import StreamPool

    rng = np.random.default_rng(seed + 2)
    n_frames = rng.integers(2 * frames, 6 * frames, n_streams)
    # a partial last frame on every other stream (the padded final frame)
    lengths = n_frames * 1152 - np.where(np.arange(n_streams) % 2, 300, 0)
    pcm = make_streams(seed + 2, n_streams, lengths)
    pool = StreamPool(opts, lanes=lanes, frames_per_step=frames, mesh=mesh)
    sids = [pool.submit() for _ in range(n_streams)]
    chunk = frames * 1152 * opts.channels
    pos = [0] * n_streams
    step_times, c0 = [], compiles.seconds
    steps = 0
    while not pool.idle:
        for i, sid in enumerate(sids):
            if pos[i] < len(pcm[i]):
                pool.feed(sid, pcm[i][pos[i] : pos[i] + chunk])
                pos[i] += chunk
                if pos[i] >= len(pcm[i]):
                    pool.close(sid)
        t0 = time.perf_counter()
        check(pool.step() > 0 or pool.idle, "StreamPool stalled")
        step_times.append(time.perf_counter() - t0)
        steps += 1
        check(steps < 200, "StreamPool did not finish")
    pool.shutdown()
    blobs = [pool.result(sid) for sid in sids]
    recycled = sum(1 for sid in sids[lanes:] if pool.frame_count(sid) > 0)
    check(recycled > 0, "no lane was recycled")
    steady = step_times[1:]
    say(
        f"{label}: StreamPool lanes={lanes} T={frames}: {n_streams} streams, "
        f"{steps} steps, compile {compiles.seconds - c0:.1f} s (first step "
        f"{step_times[0]:.1f} s wall), steady step median "
        f"{np.median(steady) * 1e3:.1f} ms (min {min(steady) * 1e3:.1f}, max "
        f"{max(steady) * 1e3:.1f}); {recycled} lanes recycled; peak device "
        f"memory {peak_gb(device)}"
    )
    want = [int(np.ceil(len(p) / 2 / 1152)) for p in pcm]
    verify_blobs(label, blobs, want, False, workers)
    return blobs, pcm


def run_fixtures(compiles) -> None:
    import tests.fixture_lib as fl

    flips = []
    for name, _kw, kind, *_ in fl.FIXTURES:
        with open(fl.fixture_path(name, "jax"), "rb") as f:
            frozen = f.read()
        c0, t0 = compiles.seconds, time.perf_counter()
        got = fl.encode_fixture(name, "jax")
        dt = time.perf_counter() - t0
        if got == frozen:
            say(f"fixture {name}: equal ({len(got)} B, {dt:.1f} s, compile {compiles.seconds - c0:.1f} s)")
            continue
        # noise-like content may flip under the ULP contract; tonal may not
        d, n = frame_diff(frozen, got)
        say(f"fixture {name}: {d}/{n} frames differ ({kind})")
        check(kind in ("noise", "mix"), f"fixture {name} ({kind}) differs")
        flips.append((d, n))
    if flips:
        # the loosest ceiling the flip telemetry pins (hq), as a share
        bad, total = sum(d for d, _ in flips), sum(n for _, n in flips)
        check(bad / total <= FLIP_SHARE["hq"], "fixture flips over the contract")


def run_kernels(compiles, device, seed) -> None:
    """The fused sweep kernel vs its jnp twin at full width: exact equality,
    the kernel alone, and the whole compat step with each."""
    import jax
    import jax.numpy as jnp

    from swiftmp3_tpu.models import pipeline
    from swiftmp3_tpu.ops import dsp, pallas_kernels

    check(pallas_kernels.sweep_kernel_enabled(), "sweep kernel not selected on this GPU")
    rng = np.random.default_rng(seed + 3)
    n = SWEEP_WIDTH
    spec = (rng.standard_normal((n, 576)) * 10 ** rng.uniform(-4, 0, (n, 1))).astype(np.float32)
    spec[::97] = 0.0  # silent granules
    mag = jnp.asarray((np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32))
    sign = jnp.asarray(spec < 0)
    g0 = jnp.asarray(rng.integers(100, 230, n).astype(np.int32))

    def timed(fn, *args, reps=20):
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps, out

    for iso in (False, True):
        plain = jax.jit(lambda m, s, g: dsp._t15_sweep(m, s, g, iso, False))
        fused = jax.jit(lambda m, g: pallas_kernels.rate_sweep(m, g, iso=iso))
        t_p, (bp, vp) = timed(plain, mag, sign, g0)
        t_k, (bk, vk) = timed(fused, mag, g0)
        same = bool(jnp.array_equal(bp, bk)) and bool(jnp.array_equal(vp, vk))
        say(
            f"rate_sweep kernel (Pallas/Triton) iso={iso} N={n}: kernel "
            f"{t_k * 1e3:.3f} ms, jnp {t_p * 1e3:.3f} ms, bits/bv equal: {same}"
        )
        check(same, f"rate_sweep kernel differs from the jnp sweep (iso={iso})")

    # whole compat step, chained over resident inputs, kernel vs plain
    opts = job_options()["compat"]
    pcm = [
        jax.device_put(
            np.stack(make_streams(seed + 4 + k, BATCH, [FRAMES * 1152] * BATCH)).reshape(
                BATCH, FRAMES, 2304
            )
        )
        for k in range(4)
    ]
    fin = jax.device_put(np.zeros((BATCH, FRAMES), bool))
    val = jax.device_put(np.ones((BATCH, FRAMES), bool))
    steps = {}
    for label, use in (("kernel", True), ("plain", False), ("kernel", True), ("plain", False)):
        pipeline._cached_chunk_encoder.cache_clear()
        pipeline.sweep_kernel_enabled = lambda use=use: use
        run = pipeline.make_chunk_encoder(opts, FRAMES)
        carry = pipeline.init_carry(BATCH, opts)
        carry, out = run(carry, pcm[0], fin, val)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for k in range(4):
            carry, out = run(carry, pcm[k], fin, val)
        jax.block_until_ready(out)
        steps.setdefault(label, []).append((time.perf_counter() - t0) / 4)
    pipeline._cached_chunk_encoder.cache_clear()
    pipeline.sweep_kernel_enabled = pallas_kernels.sweep_kernel_enabled
    say(
        "compat step B=256 T=128 (chained, resident inputs): with kernel "
        + ", ".join(f"{t * 1e3:.2f}" for t in steps["kernel"])
        + " ms; plain jnp "
        + ", ".join(f"{t * 1e3:.2f}" for t in steps["plain"])
        + f" ms; peak device memory {peak_gb(device)}"
    )


def four_cards(compiles, seed, workers) -> None:
    """The batch axis sharded over 4 GPUs vs the same inputs on one."""
    import jax

    from swiftmp3_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    check(len(devices) == 4, f"--four-cards needs 4 GPUs, found {len(devices)}")
    mesh = make_mesh(devices)
    opts = job_options()["compat"]
    streams = job_streams("compat", opts, seed, BATCH, FRAMES, 1)
    sharded = run_job("compat on 4 cards", opts, streams, FRAMES, 1, compiles, devices[0], workers, mesh)
    for d in devices:
        say(f"card {d.id}: peak device memory {peak_gb(d)}")
    single = run_job("compat on 1 card", opts, streams, FRAMES, 1, compiles, devices[0], workers)
    bad = sum(frame_diff(a, b)[0] for a, b in zip(single, sharded))
    say(f"compat 4 cards vs 1: {sum(a == b for a, b in zip(single, sharded))}/{len(single)} streams byte-equal, {bad} divergent frames")
    check(bad / (BATCH * FRAMES) <= FLIP_SHARE["compat"], "4-card compat over the flip ceiling")

    pool4, pcm = run_pool(opts, seed, POOL_LANES, POOL_FRAMES, POOL_STREAMS, compiles,
                          devices[0], workers, mesh, label="serving on 4 cards")
    pool1, _ = run_pool(opts, seed, POOL_LANES, POOL_FRAMES, POOL_STREAMS, compiles,
                        devices[0], workers, label="serving on 1 card")
    bad = sum(frame_diff(a, b)[0] for a, b in zip(pool1, pool4))
    frames = sum(int(np.ceil(len(p) / 2 / 1152)) for p in pcm)
    say(f"serving 4 cards vs 1: {sum(a == b for a, b in zip(pool1, pool4))}/{len(pool1)} streams byte-equal, {bad} divergent frames")
    check(bad / frames <= FLIP_SHARE["compat"], "4-card serving over the flip ceiling")
    for d in devices:
        say(f"card {d.id}: peak device memory {peak_gb(d)}")


def device_check():
    """Phase 1: a GPU, its name and power limit, the cache, the renderer."""
    global _CARD
    from swiftmp3_tpu.utils import enable_compilation_cache, set_xla_flags

    flags = set_xla_flags()
    import jax

    cache = enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise Failed(f"needs a GPU; JAX's first device is {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    _CARD = smi.splitlines()[0]
    say(
        f"device {dev.device_kind} x{len(jax.devices())}, jax {jax.__version__}, "
        f"compile cache {cache}, XLA_FLAGS {flags!r}"
    )
    from swiftmp3_tpu.native import native_available

    check(native_available(), "native C++ renderer did not build")
    return dev


def result_line(devices) -> str:
    """The last line of standard output: the device as JAX reports it."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded path and its 1-GPU twin")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        dev = device_check()
        import jax

        compiles = Compiles()
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=min(16, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
        ) as workers:
            if args.four_cards:
                four_cards(compiles, args.seed, workers)
            else:
                opts = job_options()
                for name in ("compat", "hq"):
                    streams = job_streams(name, opts[name], args.seed, BATCH, FRAMES, STEPS)
                    blobs = run_job(name, opts[name], streams, FRAMES, STEPS, compiles, dev, workers)
                    against_golden(name, opts[name], streams, blobs, args.seed)
                    del streams, blobs
                run_pool(opts["compat"], args.seed, POOL_LANES, POOL_FRAMES,
                         POOL_STREAMS, compiles, dev, workers)
                run_fixtures(compiles)
                run_kernels(compiles, dev, args.seed)
        say(f"total compile {compiles.seconds:.1f} s over {compiles.count} programs")
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
