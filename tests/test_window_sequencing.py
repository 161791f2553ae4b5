"""ISO window sequencing (options.window_sequencing) + the aligned-mode
>511-byte reservoir placement fix.

The reference family jumps long<->short directly (its MDCT law never uses
the start/stop windows it defines, MP3Encoder.swift:1470-1503 vs
:1512-1565), which breaks TDAC aliasing cancellation at both junctions:
a quantization-INDEPENDENT reconstruction ceiling (~14 dB on transient
content, measured). Sequencing long->START(bt1)->short->STOP(bt3)->long
restores the lossless round trip (~87 dB) at the cost of one granule of
encoder delay (lookahead).

The reservoir fix: in aligned mode a frame with > 511 data bytes used to
be tail-aligned deeper than main_data_begin's 9-bit field can express —
silent corruption on high-bitrate linbits streams (>= 192 kbps). At most
511 bytes may precede the header now; the rest spills into the frame's
own slot.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from swiftmp3_tpu import MP3Encoder, MP3EncoderOptions, Mode
from swiftmp3_tpu.decoder import decode_mp3
from swiftmp3_tpu.decoder.decoder import _iter_frames
from swiftmp3_tpu.io.framing import BitReservoir
from swiftmp3_tpu.ops import reference as ref
from swiftmp3_tpu.utils.external import have_mpg123, mpg123_decode
from swiftmp3_tpu.utils.quality import decode_agreement_snr, measure_quality


def _encode(options: MP3EncoderOptions, pcm, backend="numpy") -> bytes:
    s = MP3Encoder(options, backend=backend).new_session()
    return s.encode(np.asarray(pcm, np.float32).reshape(-1)) + s.flush()


def _bursty(n: int, seed: int = 9) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 523.0 * np.arange(n) / 44100.0)
    for s in range(1500, n - 600, 5000):
        x[s : s + 300] += 0.55 * rng.standard_normal(300)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _hq(seq=True, **kw):
    return MP3EncoderOptions.hq(window_sequencing=seq, **kw)


# ---------------------------------------------------------------- unit laws


def test_sequencer_law():
    """Every (want, prev, next) combination; the emitted sequence can
    never place a full long window against a short granule."""
    L, S, A, O = ref.BLOCK_LONG, ref.BLOCK_SHORT, ref.BLOCK_START, ref.BLOCK_STOP
    assert ref.sequence_block_type(False, False, False) == L
    assert ref.sequence_block_type(True, False, False) == S
    assert ref.sequence_block_type(False, False, True) == A
    assert ref.sequence_block_type(False, True, False) == O
    assert ref.sequence_block_type(False, True, True) == S  # joins the run
    assert ref.sequence_block_type(True, True, True) == S
    # exhaustive junction check: run the law over every 10-granule want
    # pattern and assert no illegal junction appears
    short_right = {S, A}  # window types whose RIGHT half is short-facing
    short_left = {S, O}  # whose LEFT half is short-facing
    for bits in range(1 << 10):
        wants = [(bits >> i) & 1 == 1 for i in range(10)]
        prev_s = False
        seq = []
        for j in range(10):
            nxt = wants[j + 1] if j + 1 < 10 else False
            bt = ref.sequence_block_type(wants[j], prev_s, nxt)
            seq.append(bt)
            prev_s = bt == S
        for a, b in zip(seq, seq[1:]):
            right_short = a in short_right
            left_short = b in short_left
            assert right_short == left_short, (wants, seq)


def test_hangover_and_drop_extend_short_run():
    """Post-transient run shape around a LONE attack: START, SHORT
    (attack), SHORT (drop: the quiet aftermath granule — the round-4
    decay criterion, reference.OFFSET_RATIO), SHORT (hangover), STOP —
    the run extends two granules past the attack so the STOP window
    (whose long-layout MDCT straddles the previous granule) never
    covers loud content. Placing STOP near the attack ties its noise
    floor to the loud half and spreads that noise over the quiet half
    (post-echo) — measured as the dominant burst NMR source
    (tools/diag_err_sources.py: STOP granules alone carried +10.6 of
    the +11.6 dB hq-vs-lame NMR gap at 128k pre-hangover, and +24.8 of
    the remaining +25.2 dB nburst gap pre-drop; hangover wins
    -5.8/-8.1/-7.7 dB NMR at 64/128/256k, the drop takes nburst at
    128k from 28.2 to 12.9 — both via mpg123).

    The round-4 cross-granule onset chain also fires at the two stream
    edges of this clip, and that is intended: the tone RISING out of
    the sequencing preroll silence is a genuine onset (pre-echo
    through a long window), and the tone CUTTING to the flush tail
    silence is a genuine decay (post-echo), so the expected block-type
    sequence pins three runs. Output granule j+1 carries input granule
    j (the sequencing lookahead delay)."""
    rng = np.random.default_rng(3)
    n = 9 * 1152
    x = 0.2 * np.sin(2 * np.pi * 440.0 * np.arange(n) / 44100.0)
    # one attack confined to granule 9's middle subblock (offset 250..450)
    g = 9
    x[g * 576 + 250 : g * 576 + 450] += 0.6 * rng.standard_normal(200)
    pcm = np.clip(x, -0.99, 0.99).astype(np.float32)
    # runs: [0-3] stream-start onset (rise at output granule 1 +
    # hangover); [9-13] the attack (rise at 10 = input granule 9, drop
    # at 11, hangover at 12); [18-19] flush decay (drop at 19, run
    # truncated by stream end — legal, nothing follows).
    expect = [1, 2, 2, 3, 0, 0, 0, 0, 0, 1, 2, 2, 2, 3, 0, 0, 0, 0, 1, 2]
    for backend in ("numpy", "jax"):
        blob = _encode(_hq(mode=Mode.MONO, bitrate_kbps=128), pcm, backend)
        bts = []
        for fi in _iter_frames(blob, strict=False):
            for gr in fi.granules:
                for gg in gr:
                    bts.append(gg.block_type if gg.window_switching else 0)
        assert bts == expect, (backend, bts)


def test_onset_detector_catches_early_attack():
    """An attack landing EARLY in a granule keeps all three 192-sample
    subblocks loud, so the family max/min ratio detector reads LONG
    (measured remaining burst NMR mass at 128k after the hangover) — the
    6x96 consecutive-jump onset criterion must fire, and the emitted
    stream must sequence a short run around the attack on BOTH backends
    with identical block sequences. Measured win: -6..-16 dB NMR on
    noise-burst content via mpg123 (ops/reference.ONSET_RATIO)."""
    rng = np.random.default_rng(5)
    g576 = 0.04 * np.sin(2 * np.pi * 440.0 * np.arange(576) / 44100.0)
    g576[128:] += 0.55 * rng.standard_normal(576 - 128)
    g576 = np.clip(g576, -0.99, 0.99).astype(np.float32)
    # unit law: family detector is fooled, onset is not
    blk, _ = ref.transient_detect(g576)
    assert blk == ref.BLOCK_LONG
    assert ref._onset_fires(g576)
    assert ref.wants_short([g576])
    # end-to-end: quiet tone with the early-attack granule at granule 9
    n = 8 * 1152
    x = 0.04 * np.sin(2 * np.pi * 440.0 * np.arange(n) / 44100.0)
    x[9 * 576 : 10 * 576] = g576
    # decay back toward the tone so only the onset granule wants short
    x[10 * 576 : 10 * 576 + 400] += np.linspace(0.3, 0.0, 400) * (
        rng.standard_normal(400).astype(np.float32) * 0.3
    )
    pcm = np.clip(x, -0.99, 0.99).astype(np.float32)
    bt_seqs = {}
    for backend in ("numpy", "jax"):
        blob = _encode(_hq(mode=Mode.MONO, bitrate_kbps=128), pcm, backend)
        bts = []
        for fi in _iter_frames(blob, strict=False):
            for gr in fi.granules:
                for gg in gr:
                    bts.append(gg.block_type if gg.window_switching else 0)
        bt_seqs[backend] = bts
        assert 2 in bts, (backend, bts)  # the short run fired
        assert 1 in bts and 3 in bts, (backend, bts)
    assert bt_seqs["numpy"] == bt_seqs["jax"], bt_seqs


def test_onset_chain_crosses_granule_boundary():
    """Round-4 respec regressions, unit level (reference._onset_fires):

    (a) an attack starting exactly AT a granule boundary leaves no
    within-granule jump — only the cross-granule chain (prev2 = the
    previous granule's last two block energies) can fire it. The round-3
    per-granule law left such granules LONG (one carried +37.3 of a
    +38.5 dB clip NMR, tools/diag_err_sources.py per-granule rows).

    (b) a point-onset straddling a 96-block boundary dilutes into two
    sub-threshold consecutive jumps — the 2-back MIN baseline restores
    the pre-attack reference.

    (c) the DROP criterion: a granule holding the quiet aftermath of a
    decay (loud prev2, quiet head) wants short, so the hangover pushes
    STOP past the loud tail. +inf (unknown past) must fire neither."""
    rng = np.random.default_rng(11)
    quiet = (0.02 * np.sin(2 * np.pi * 440.0 * np.arange(576) / 44100.0)).astype(
        np.float32
    )
    loud = quiet + 0.5 * rng.standard_normal(576).astype(np.float32)
    # (a) attack fills the granule from sample 0: flat inside, loud
    blk, _ = ref.transient_detect(loud)
    assert blk == ref.BLOCK_LONG  # family detector reads flat
    assert not ref._onset_fires(loud)  # no baseline: cannot fire...
    prev2 = ref.onset_tail_energies([quiet])[0]
    assert ref._onset_fires(loud, prev2)  # ...chain context fires it
    assert ref.wants_short([loud], [prev2])
    # steady content must not fire through the chain
    assert not ref._onset_fires(quiet, ref.onset_tail_energies([quiet])[0])
    # (b) straddling onset over a loud bed: the attack enters 3/4 into
    # block 1, so EVERY consecutive ratio dilutes below ONSET_RATIO
    # (the entry splits across two blocks) — only the 2-back min
    # baseline (pre-attack block 0) fires
    bed = (0.3 * np.sin(2 * np.pi * 440.0 * np.arange(576) / 44100.0)).astype(
        np.float32
    )
    stra = bed.copy()
    stra[168:432] += np.sqrt(0.2) * rng.standard_normal(264).astype(np.float32)
    e = ref._onset_energies(stra)
    for i in range(5):  # every consecutive jump is subthreshold
        assert e[i + 1] <= ref.ONSET_RATIO * max(e[i], 1e-4), (i, e)
    fam, _ = ref.transient_detect(stra)
    assert fam == ref.BLOCK_LONG  # family detector reads flat too
    assert ref._onset_fires(stra)  # min(e0, e1) baseline fires
    # (c) drop: quiet granule after a loud one
    assert ref._onset_fires(quiet, ref.onset_tail_energies([loud])[0])
    # drop must NOT fire from an unknown (+inf) past
    assert not ref._onset_fires(quiet, None)
    # device twin agrees on all four chains
    import jax.numpy as jnp

    from swiftmp3_tpu.ops import dsp

    for grs, p2, want in (
        ([quiet, loud], None, [False, True]),
        ([quiet, quiet], None, [False, False]),
        ([stra], None, [True]),
        ([loud, quiet], None, [False, True]),  # drop
    ):
        g = jnp.asarray(np.stack(grs)[None])  # [1, G, 576]
        carry = jnp.full((1, 2), np.inf, jnp.float32) if p2 is None else p2
        w, tails = dsp.onset_wants_chunk(g, carry)
        assert [bool(v) for v in np.asarray(w[0])] == want, (want, np.asarray(w))
        np.testing.assert_allclose(
            np.asarray(tails[0, -1]),
            ref.onset_tail_energies([grs[-1]])[0],
            rtol=1e-6,
        )


def test_onset_chain_survives_chunk_boundary():
    """The device onset/drop chain carries across CHUNK boundaries
    (pipeline carry onset_prev2): byte equality vs golden on a bursty
    stream long enough to cross the JAX backend's chunking, with bursts
    placed so detector decisions land near frame 8/16 boundaries."""
    rng = np.random.default_rng(21)
    n = 21 * 1152 + 333
    x = 0.02 * rng.standard_normal(n).astype(np.float32)
    x += (0.25 * np.sin(2 * np.pi * 523.0 * np.arange(n) / 44100.0)).astype(
        np.float32
    )
    for c in range(1700, n - 700, 2900):
        x[c : c + 300] += 0.5 * rng.standard_normal(300).astype(np.float32)
    pcm = np.clip(x, -1, 1).astype(np.float32)
    opts = _hq(mode=Mode.MONO, bitrate_kbps=64)
    outs = {b: _encode(opts, pcm, b) for b in ("numpy", "jax")}
    assert outs["numpy"] == outs["jax"]


def test_tdac_restored_through_transitions():
    """Unquantized analysis->synthesis round trip: the family's direct
    long|short|long jump caps reconstruction ~14 dB; sequenced start/stop
    restores the all-long floor (~87 dB). Pure-DSP regression of the
    measured result that motivated the feature."""
    from swiftmp3_tpu.decoder import decoder as dec

    class G:
        def __init__(self, bt):
            self.window_switching = bt != 0
            self.block_type = bt
            self.mixed_block_flag = False

    hdr_bt = {
        ref.BLOCK_LONG: 0,
        ref.BLOCK_START: 1,
        ref.BLOCK_SHORT: 2,
        ref.BLOCK_STOP: 3,
    }

    def roundtrip(pcm, blocks):
        fb = np.zeros(512, dtype=np.float32)
        ov = np.zeros((32, 18), dtype=np.float32)
        dov = np.zeros((32, 18))
        synth = dec.SynthesisFilterbank()
        outs = []
        for g, bt in enumerate(blocks):
            S, fb = ref.analyze_subbands(pcm[g * 576 : (g + 1) * 576], fb)
            spec, ov = ref.mdct_apply(S, ov, bt)
            und = dec._alias_reduce_decode(spec.astype(np.float64)) \
                if bt != ref.BLOCK_SHORT else spec.astype(np.float64)
            sub = dec._imdct_granule(und, G(hdr_bt[bt]), dov)
            for t in range(18):
                outs.append(synth.run(sub[:, t]))
        return np.concatenate(outs)

    rng = np.random.default_rng(9)
    n = 8 * 576
    pcm = 0.3 * np.sin(2 * np.pi * 523.0 * np.arange(n) / 44100.0)
    pcm[3 * 576 + 100 : 3 * 576 + 400] += 0.55 * rng.standard_normal(300)
    pcm = np.clip(pcm, -0.99, 0.99).astype(np.float32)

    def snr(blocks):
        out = roundtrip(pcm, blocks)
        best = None
        for lag in range(0, 1200):
            m = n - lag
            e = pcm[:m] - out[lag : lag + m]
            en = float(e @ e)
            if best is None or en < best[0]:
                best = (en, m)
        en, m = best
        return 10 * np.log10(float(pcm[:m] @ pcm[:m]) / max(en, 1e-30))

    L, S, A, O = ref.BLOCK_LONG, ref.BLOCK_SHORT, ref.BLOCK_START, ref.BLOCK_STOP
    direct = snr([L, L, L, S, L, L, L, L])
    sequenced = snr([L, L, A, S, O, L, L, L])
    assert direct < 20.0, direct
    assert sequenced > 60.0, sequenced


def test_fill_slot_keeps_remainder_past_511():
    """BitReservoir.fill_slot: with tail_bytes > 511, only 511 bytes of the
    newest frame ride ahead of its header; the remainder stays in the
    stream (and stuffing never lands inside a frame's data)."""
    r = BitReservoir()
    old = bytes(range(100)) * 1  # 100 bytes of older data
    data = bytes([0xAB]) * 700  # newest frame, 700 B
    r.append(old)
    r.append(data)
    slot = r.fill_slot(650, tail_bytes=700)
    assert len(slot) == 650
    # layout: [old 100][stuffing 39][data prefix 511]
    assert slot[:100] == old
    assert slot[100:139] == bytes(39)
    assert slot[139:] == data[:511]
    assert bytes(r.stream) == data[511:]  # 189 B spill into the next slot

    # tail <= 511 keeps the historical tail-alignment
    r2 = BitReservoir()
    r2.append(bytes([1]) * 10)
    r2.append(bytes([2]) * 20)
    slot2 = r2.fill_slot(50, tail_bytes=20)
    assert slot2 == bytes([1]) * 10 + bytes(20) + bytes([2]) * 20
    assert len(r2.stream) == 0


# ---------------------------------------------------------------- end-to-end


def test_highrate_reservoir_streams_decode():
    """Regression: hq at >= 192 kbps with >= 7 frames used to corrupt the
    stream (frames with > 511 data bytes tail-aligned past mdb's reach).
    The oracle must now decode long high-rate streams at full quality."""
    pcm = _bursty(10 * 1152)
    for kbps in (192, 256, 320):
        o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=kbps)
        blob = _encode(o, pcm)
        for fi in _iter_frames(blob, strict=False):
            assert fi.main_data_begin <= 511
        dec = decode_mp3(blob, iso_conventions=True)
        q = measure_quality(pcm, dec.pcm[:, 0], compensate_gain=False).snr_db
        assert q > 18.0, (kbps, q)


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_highrate_reservoir_conforms_externally():
    pcm = _bursty(10 * 1152)
    o = MP3EncoderOptions.hq(mode=Mode.MONO, bitrate_kbps=256)
    blob = _encode(o, pcm)
    ext, _ = mpg123_decode(blob)
    ours = decode_mp3(blob, iso_conventions=True).pcm
    assert decode_agreement_snr(ext[:, 0], ours[: len(ext), 0]) > 100.0


def test_sequenced_stream_structure():
    """Sequenced streams emit bt 1/2/3 around transients, add exactly one
    granule of delay to the frame count, and never abut long<->short."""
    pcm = _bursty(6 * 1152)
    o = _hq(mode=Mode.MONO, bitrate_kbps=128)
    blob = _encode(o, pcm)
    bts = []
    for fi in _iter_frames(blob, strict=False):
        for gr in fi.granules:
            for g in gr:
                bts.append(g.block_type if g.window_switching else 0)
    assert len(bts) == 2 * math.ceil((len(pcm) + 576) / 1152)
    assert 1 in bts and 2 in bts and 3 in bts  # start, short, stop all live
    short_right = {1, 2}  # header bt whose right half faces short
    short_left = {2, 3}
    for a, b in zip(bts, bts[1:]):
        assert (a in short_right) == (b in short_left), bts


def test_sequenced_quality_floors():
    """The TDAC win on transient content, oracle-decoded: at 256 kbps the
    ceiling was bit-starved nowhere — sequencing is worth > 15 dB; at
    128 kbps quantization noise dominates but sequencing must not lose."""
    pcm = _bursty(10 * 1152)
    snr = {}
    for kbps in (128, 256):
        for seq in (False, True):
            o = _hq(seq=seq, mode=Mode.MONO, bitrate_kbps=kbps)
            dec = decode_mp3(_encode(o, pcm), iso_conventions=True)
            snr[kbps, seq] = measure_quality(
                pcm, dec.pcm[:, 0], compensate_gain=False
            ).snr_db
    assert snr[256, True] - snr[256, False] > 15.0, snr
    assert snr[128, True] - snr[128, False] > 0.5, snr


@pytest.mark.skipif(not have_mpg123(), reason="libmpg123 not available")
def test_sequenced_streams_conform_externally():
    """bt=1/3 emission is our own (the reference never writes them):
    a third-party decoder must agree with the oracle at float precision,
    and confirm the transient win externally."""
    pcm = _bursty(8 * 1152)
    o = _hq(mode=Mode.MONO, bitrate_kbps=256)
    blob = _encode(o, pcm)
    ext, _ = mpg123_decode(blob)
    ours = decode_mp3(blob, iso_conventions=True).pcm
    assert decode_agreement_snr(ext[:, 0], ours[: len(ext), 0]) > 100.0
    q_seq = measure_quality(pcm, ext[:, 0], compensate_gain=False).snr_db
    ext0, _ = mpg123_decode(_encode(_hq(seq=False, mode=Mode.MONO, bitrate_kbps=256), pcm))
    q_no = measure_quality(pcm, ext0[:, 0], compensate_gain=False).snr_db
    assert q_seq - q_no > 15.0, (q_seq, q_no)


def test_sequenced_stereo_decodes():
    x = _bursty(4 * 1152)
    st = np.stack([x, np.roll(x, 5)], axis=1)
    o = _hq(mode=Mode.JOINT_STEREO, bitrate_kbps=256)
    blob = _encode(o, st)
    dec = decode_mp3(blob, iso_conventions=True)
    q = measure_quality(x, dec.pcm[:, 0], compensate_gain=False).snr_db
    assert q > 15.0, q


def test_sequenced_drip_feed_and_resume():
    """The session's lookahead holdback must keep streams byte-identical
    under arbitrary chunking, and survive checkpoint/resume."""
    pcm = _bursty(5 * 1152 + 700)
    o = _hq(mode=Mode.MONO, bitrate_kbps=128)
    whole = _encode(o, pcm)
    for step in (577, 5000):
        s = MP3Encoder(o, backend="numpy").new_session()
        drip = b"".join(s.encode(pcm[i : i + step]) for i in range(0, len(pcm), step))
        assert drip + s.flush() == whole, step
    s1 = MP3Encoder(o, backend="numpy").new_session()
    a1 = s1.encode(pcm[:4000])
    st = s1.state_dict()
    tail1 = s1.encode(pcm[4000:]) + s1.flush()
    s2 = MP3Encoder(o, backend="numpy").new_session()
    s2.load_state_dict(st)
    assert s2.encode(pcm[4000:]) + s2.flush() == tail1
    # empty session flush emits nothing (the delay preroll alone is dropped)
    s3 = MP3Encoder(o, backend="numpy").new_session()
    assert s3.flush() == b""


def test_sequenced_encode_batch_matches_sessions():
    """encode_batch under hq (window_sequencing): the batch layer's
    one-granule stream delay + per-frame lookahead slices must reproduce
    per-stream session bytes exactly, across a partial tail, an exact
    frame multiple, and an empty stream."""
    from swiftmp3_tpu.parallel import encode_batch

    o = _hq(mode=Mode.MONO, bitrate_kbps=128)
    streams = [
        _bursty(4 * 1152 + 700, seed=21),
        _bursty(3 * 1152, seed=22),  # exact frame multiple
        np.zeros(0, dtype=np.float32),  # empty stream stays empty
        _bursty(5 * 1152 + 1, seed=23),
    ]
    batched = encode_batch(o, streams, frames_per_step=3)
    for i, s in enumerate(streams):
        sess = MP3Encoder(o, backend="jax").new_session()
        expect = sess.encode(s) + sess.flush()
        assert batched[i] == expect, f"stream {i}"


def test_sequenced_pool_matches_sessions():
    """StreamPool under hq (window_sequencing): the holdback rule (a
    frame is emitted only once its lookahead granule has arrived), the
    preroll delay on first feed, and the exact-frame-multiple final flag
    must reproduce per-stream session bytes — including a drip-fed
    stream and a stream closed without any PCM."""
    from swiftmp3_tpu.parallel import StreamPool

    o = _hq(mode=Mode.MONO, bitrate_kbps=128)
    sigs = [
        _bursty(3 * 1152 + 500, seed=31),
        _bursty(2 * 1152, seed=32),  # exact frame multiple
        _bursty(4 * 1152 + 1, seed=33),
    ]
    pool = StreamPool(o, lanes=2, frames_per_step=2)
    # stream 0 drip-feeds across steps; 1 and 2 arrive one-shot, staggered
    sid0 = pool.submit()
    sid_empty = pool.submit()
    pool.close(sid_empty)  # closed with no PCM: emits nothing
    pos = 0
    sched = [900, 2500, 3333, None, None]  # None => one-shot arrivals
    sids = [sid0, None, None]
    arrivals = [1, 2]
    for chunk in sched:
        if chunk is not None:
            end = min(pos + chunk, len(sigs[0]))
            pool.feed(sid0, sigs[0][pos:end])
            pos = end
        elif arrivals:
            i = arrivals.pop(0)
            sids[i] = pool.submit()
            pool.feed(sids[i], sigs[i])
            pool.close(sids[i])
        pool.step()
    pool.feed(sid0, sigs[0][pos:])
    pool.close(sid0)
    pool.run_until_idle()

    assert pool.result(sid_empty) == b""
    for i, sid in enumerate(sids):
        sess = MP3Encoder(o, backend="jax").new_session()
        expect = sess.encode(sigs[i]) + sess.flush()
        assert pool.result(sid) == expect, f"stream {i}"


def test_sequenced_backends_agree():
    """Device twin (models/pipeline.py win_seq path + dsp.mdct_chunk
    start/stop corrections + dsp.sequence_blocks_chunk): identical frame
    structure AND identical block-type sequences; decoded SNR within the
    ULP-flip contract."""
    import sys

    sys.path.insert(0, "tests")
    from util import parse_frames

    pcm = _bursty(6 * 1152)
    o = _hq(mode=Mode.MONO, bitrate_kbps=256)
    outs = {be: _encode(o, pcm, backend=be) for be in ("numpy", "jax")}
    fa, fb = parse_frames(outs["numpy"]), parse_frames(outs["jax"])
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert (a.size, a.bitrate_kbps, a.padding) == (
            b.size, b.bitrate_kbps, b.padding,
        )
    bt_seqs = {}
    snrs = {}
    for be, blob in outs.items():
        bts = []
        for fi in _iter_frames(blob, strict=False):
            bts.append(tuple(
                g.block_type if g.window_switching else 0
                for gr in fi.granules for g in gr
            ))
        bt_seqs[be] = bts
        dec = decode_mp3(blob, iso_conventions=True)
        snrs[be] = measure_quality(
            pcm, dec.pcm[:, 0], compensate_gain=False
        ).snr_db
    assert bt_seqs["numpy"] == bt_seqs["jax"], bt_seqs
    assert abs(snrs["numpy"] - snrs["jax"]) < 1.0, snrs
    assert min(snrs.values()) > 30.0, snrs


def test_sequenced_backends_agree_stereo_chunked():
    """Stereo + a stream long enough to cross the JAX backend's CHUNK=8
    boundary: the seq_prev_short carry and per-chunk lookahead must keep
    the device block sequence identical to golden's."""
    import sys

    sys.path.insert(0, "tests")
    from util import parse_frames

    x = _bursty(11 * 1152, seed=17)
    st = np.stack([x, np.roll(x, 7)], axis=1)
    o = _hq(mode=Mode.JOINT_STEREO, bitrate_kbps=192)
    outs = {be: _encode(o, st, backend=be) for be in ("numpy", "jax")}
    fa, fb = parse_frames(outs["numpy"]), parse_frames(outs["jax"])
    assert len(fa) == len(fb) and len(fa) == 12
    bt_seqs = {}
    for be, blob in outs.items():
        bts = []
        for fi in _iter_frames(blob, strict=False):
            bts.append(tuple(
                g.block_type if g.window_switching else 0
                for gr in fi.granules for g in gr
            ))
        bt_seqs[be] = bts
    assert bt_seqs["numpy"] == bt_seqs["jax"], bt_seqs
