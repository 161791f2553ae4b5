"""StreamPool continuous batching: streams joining/leaving a fixed-lane
batch must produce byte-for-byte the same MP3 as one EncoderSession per
stream (same backend float stack), across staggered arrivals, mixed
lengths, partial tails, lane reuse, and incremental feeding."""

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.parallel import StreamPool

from .util import parse_frames


def _session_encode(opts, pcm):
    s = MP3Encoder(opts, backend="jax").new_session()
    return s.encode(pcm) + s.flush()


def _sig(rng, n_samples, ch, kind=1):
    n = n_samples * ch
    if kind == 0:
        return np.zeros(n, dtype=np.float32)
    t = np.arange(n) / 44100
    f = rng.uniform(100, 4000)
    return (rng.uniform(0.1, 0.8) * np.sin(2 * np.pi * f * t)).astype(np.float32)


def test_pool_matches_sessions_staggered():
    """More streams than lanes, different lengths (incl. partial tails and
    an exact frame boundary), arrivals staggered across steps."""
    opts = MP3EncoderOptions(mode=Mode.MONO, bitrate_kbps=64)
    rng = np.random.default_rng(1)
    lengths = [3 * 1152 + 400, 2 * 1152, 5 * 1152 + 1, 1152 // 2, 4 * 1152]
    sigs = [_sig(rng, L, 1) for L in lengths]

    pool = StreamPool(opts, lanes=2, frames_per_step=2)
    sids = []
    # submit the first two immediately, the rest as steps progress
    for i in range(2):
        sid = pool.submit()
        pool.feed(sid, sigs[i])
        pool.close(sid)
        sids.append(sid)
    pending = list(range(2, len(sigs)))
    for _ in range(200):
        if pool.idle and not pending:
            break
        if pending:
            i = pending.pop(0)
            sid = pool.submit()
            pool.feed(sid, sigs[i])
            pool.close(sid)
            sids.append(sid)
        pool.step()
    pool.run_until_idle()

    for i, sid in enumerate(sids):
        want = _session_encode(opts, sigs[i])
        got = pool.result(sid)
        assert got == want, f"stream {i} (len {lengths[i]})"


def test_pool_incremental_feed_matches_whole():
    """Feeding in odd-sized chunks with interleaved steps equals one-shot."""
    opts = MP3EncoderOptions(mode=Mode.STEREO)
    rng = np.random.default_rng(2)
    pcm = _sig(rng, 4 * 1152 + 777, 2)
    pool = StreamPool(opts, lanes=1, frames_per_step=2)
    sid = pool.submit()
    pos = 0
    for chunk in (1000, 3000, 500, 10, len(pcm)):
        end = min(pos + chunk, len(pcm))
        pool.feed(sid, pcm[pos:end])
        pos = end
        pool.step()
        if pos == len(pcm):
            break
    pool.close(sid)
    pool.run_until_idle()
    assert pool.result(sid) == _session_encode(opts, pcm)


def test_pool_lane_reuse_is_fresh():
    """A lane recycled after a loud stream must encode a new stream exactly
    as a fresh session would (carry + reservoir + renderer fully reset)."""
    opts = MP3EncoderOptions(mode=Mode.MONO)
    rng = np.random.default_rng(3)
    loud = (_sig(rng, 3 * 1152, 1) * 1.2).clip(-0.99, 0.99)
    quiet = _sig(rng, 3 * 1152 + 100, 1) * 0.1

    pool = StreamPool(opts, lanes=1, frames_per_step=4)
    a = pool.submit()
    pool.feed(a, loud)
    pool.close(a)
    pool.run_until_idle()
    b = pool.submit()
    pool.feed(b, quiet)
    pool.close(b)
    pool.run_until_idle()

    assert pool.result(a) == _session_encode(opts, loud)
    assert pool.result(b) == _session_encode(opts, quiet)
    assert pool.frame_count(b) == 4  # 3 full + padded tail


def test_pool_empty_and_silent_streams():
    opts = MP3EncoderOptions(mode=Mode.MONO)
    pool = StreamPool(opts, lanes=2, frames_per_step=2)
    empty = pool.submit()
    pool.close(empty)
    silent = pool.submit()
    pool.feed(silent, np.zeros(2 * 1152, dtype=np.float32))
    pool.close(silent)
    pool.run_until_idle()
    assert pool.result(empty) == b""
    want = _session_encode(opts, np.zeros(2 * 1152, dtype=np.float32))
    assert pool.result(silent) == want
    frames = parse_frames(pool.result(silent))
    assert len(frames) == 2


def test_pool_feed_after_close_raises():
    pool = StreamPool(MP3EncoderOptions(mode=Mode.MONO), lanes=1)
    sid = pool.submit()
    pool.close(sid)
    with pytest.raises(ValueError):
        pool.feed(sid, np.zeros(10, dtype=np.float32))
    with pytest.raises(ValueError):
        pool.result(pool.submit())  # not finished


def test_pool_xing_header_matches_session():
    opts = MP3EncoderOptions(mode=Mode.MONO)
    rng = np.random.default_rng(5)
    pcm = _sig(rng, 3 * 1152 + 200, 1)
    pool = StreamPool(opts, lanes=1, frames_per_step=2)
    sid = pool.submit()
    pool.feed(sid, pcm)
    pool.close(sid)
    pool.run_until_idle()
    s = MP3Encoder(opts, backend="jax").new_session()
    body = s.encode(pcm) + s.flush()
    assert pool.result(sid) == body
    assert pool.xing_header(sid) == s.generate_xing_header()


def test_pool_int16_feed_matches_float():
    """int16 feeds ride the int16 transport and still produce bytes equal
    to the float session (device 1/32768 normalization is exact)."""
    opts = MP3EncoderOptions(mode=Mode.MONO)
    rng = np.random.default_rng(6)
    f = _sig(rng, 3 * 1152 + 300, 1)
    i16 = (f * 32767).astype(np.int16)
    pool = StreamPool(opts, lanes=2, frames_per_step=2)
    a = pool.submit()
    pool.feed(a, i16)
    pool.close(a)
    # second lane runs a float stream concurrently (mixed-dtype step path)
    b = pool.submit()
    pool.feed(b, f)
    pool.close(b)
    pool.run_until_idle()
    s = MP3Encoder(opts, backend="jax").new_session()
    want_i16 = s.encode(i16) + s.flush()
    assert pool.result(a) == want_i16
    assert pool.result(b) == _session_encode(opts, f)


def test_pool_release_and_stall_detection():
    opts = MP3EncoderOptions(mode=Mode.MONO)
    pool = StreamPool(opts, lanes=1, frames_per_step=2)
    sid = pool.submit()
    pool.feed(sid, np.zeros(500, dtype=np.float32))  # sub-frame, never closed
    with pytest.raises(RuntimeError, match="stalled"):
        pool.run_until_idle()
    pool.close(sid)
    pool.run_until_idle()
    _ = pool.result(sid)
    pool.release(sid)
    with pytest.raises(KeyError):
        pool.result(sid)
    pool.shutdown()


def test_pool_pipelined_matches_synchronous():
    """pipelined=True (default) defers each chunk's drain one step; the
    emitted bytes, frame counts, and Xing headers must equal the strictly
    synchronous pool's (and the per-stream sessions') exactly."""
    opts = MP3EncoderOptions(mode=Mode.MONO, bitrate_kbps=96)
    rng = np.random.default_rng(7)
    lengths = [4 * 1152 + 300, 2 * 1152, 6 * 1152 + 900, 1152]
    sigs = [_sig(rng, L, 1) for L in lengths]

    results = {}
    for pipelined in (False, True):
        pool = StreamPool(opts, lanes=2, frames_per_step=2, pipelined=pipelined)
        sids = [pool.submit() for _ in sigs]
        for sid, sig in zip(sids, sigs):
            pool.feed(sid, sig)
            pool.close(sid)
        pool.run_until_idle()
        results[pipelined] = [
            (pool.result(sid), pool.frame_count(sid), pool.xing_header(sid))
            for sid in sids
        ]
        pool.shutdown()
    assert results[False] == results[True]
    for (data, frames, _), sig in zip(results[True], sigs):
        assert data == _session_encode(opts, sig)
        assert frames == len(parse_frames(data))


def test_pool_pipelined_done_defers_one_step():
    """A finishing chunk's results surface on the NEXT step (the in-flight
    chunk drains after the following dispatch); idle stays False while a
    chunk is pending."""
    opts = MP3EncoderOptions(mode=Mode.MONO)
    pool = StreamPool(opts, lanes=1, frames_per_step=4, pipelined=True)
    sid = pool.submit()
    pool.feed(sid, np.zeros(2 * 1152, dtype=np.float32))
    pool.close(sid)
    pool.step()  # dispatches the final chunk
    assert not pool.done(sid) and not pool.idle  # in flight
    pool.step()  # drains it
    assert pool.done(sid)
    assert pool.result(sid) == _session_encode(opts, np.zeros(2 * 1152, np.float32))
    pool.shutdown()
