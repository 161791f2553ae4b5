"""The frame-encode pipeline: chunk-parallel DSP + tiny integer scan.

Accelerator structure (SURVEY.md §7, refined): per chunk of T frames x B
streams, almost everything is data-parallel —

  Phase 1 (parallel): stereo decision, whole-chunk polyphase filterbank
    (the filterbank 'state' is just trailing PCM), transient detection,
    whole-chunk MDCT (the overlap chain is 'previous granule's subbands'),
    initial gains and the 20-candidate rate-sweep bit counts
    (budget-independent).
  Phase 2 (lax.scan over T, integers only): VBR bitrate choice, frame
    sizing/padding, reservoir snapshot + budget, candidate selection
    (O(20) int ops/granule), reservoir mirror update, VBR history push.
    This is the *only* sequential dependence in MP3 encoding.
  Phase 3 (parallel): re-quantize at the selected gains, big_values,
    region counts, preflag; assemble outputs.

Chunk masking contract: `valid[b, t]` must be a PREFIX in t for each stream
(invalid frames only at the tail of a chunk). Both the session backend and
encode_batch construct chunks this way; the carry-out state is gathered at
each stream's last valid frame.

Carry layout (per stream):
    fb_hist   [B, ch, 480]  f32  trailing PCM for the polyphase filterbank
    overlap   [B, ch, 576]  f32  MDCT overlap: last granule's frequency-
              inverted subband samples, flat (t*32 + sb) filterbank order
    stream_len [B] i32  reservoir byte-stream length mirror
    avail      [B] i32  reservoir borrowing counter (MP3Encoder.swift:2096)
    pad_rem    [B] i32  Bresenham padding accumulator (MP3Encoder.swift:456)
    slot_fifo  [B, K] i32  buffered frames' slot sizes, oldest first
               (K = options.reservoir_depth; zeros while the fifo fills —
               a zero splices nothing, replacing the has_buffered flag)
    vbr_ehist  [B, 10] f32  granule energy history (MP3Encoder.swift:1144)
    vbr_count  [B] i32
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..io.framing import FrameResult
from ..io.sideinfo import GranuleInfo
from ..ops.reference import K_DEMAND as LINBITS_K_DEMAND
from ..ops.reference import LINBITS_Q_TARGET
from ..ops.reference import LSF_L3_BITRATES as LSF_VBR_BITRATES
from ..ops.reference import MPEG1_L3_BITRATES as VBR_BITRATES
from ..options import (
    MP3EncoderOptions,
    Mode,
    SAMPLES_PER_FRAME,
    SAMPLES_PER_GRANULE,
)
from ..tables import (
    bitrate_index,
    bitrate_value,
    bitrate_value_lsf,
    mixed_switch_bound,
    mode_bits,
    switch_bound,
)
from ..ops import dsp
from ..ops.pallas_kernels import sweep_kernel_enabled


def init_carry(batch: int, options: MP3EncoderOptions):
    ch = options.channels
    return {
        "fb_hist": jnp.zeros((batch, ch, 480), dtype=jnp.float32),
        "overlap": jnp.zeros((batch, ch, 576), dtype=jnp.float32),
        "stream_len": jnp.zeros(batch, dtype=jnp.int32),
        # strict-entropy walk respec: the selection scan prices candidates
        # with the t15+delta law and tracks its own PRICED stream-length
        # mirror (est_stream_len + avail); the real stream_len/mdb are
        # recomputed by a second tiny scan from the finalize stage's ACTUAL
        # bits. Unused (zeros) in compat mode.
        "est_stream_len": jnp.zeros(batch, dtype=jnp.int32),
        "avail": jnp.zeros(batch, dtype=jnp.int32),
        "pad_rem": jnp.zeros(batch, dtype=jnp.int32),
        # buffered-slot FIFO (options.reservoir_depth; oldest first, zeros
        # while filling — a zero splices nothing, so no has_buffered flag)
        "slot_fifo": jnp.zeros(
            (batch, options.reservoir_depth), dtype=jnp.int32
        ),
        "vbr_ehist": jnp.zeros((batch, 10), dtype=jnp.float32),
        "vbr_count": jnp.zeros(batch, dtype=jnp.int32),
        **(
            {
                "seq_prev_short": jnp.zeros(batch, dtype=bool),
                "seq_prev_want": jnp.zeros(batch, dtype=bool),
                # onset/drop chain context: previous granule's last two
                # 96-block energies per channel (+inf = unknown past; see
                # dsp.onset_wants_chunk)
                "onset_prev2": jnp.full(
                    (batch, ch, 2), jnp.inf, dtype=jnp.float32
                ),
            }
            if options.window_sequencing
            else {}
        ),
    }


def main_data_cap(options: MP3EncoderOptions) -> int:
    """Static per-frame cap (bytes) for the device-packed main_data image.

    A frame's Huffman bytes are bounded by its slot plus the maximum
    reservoir borrow (511 bytes); the rate loop's overflow quirk can in
    principle exceed the budget, so the host verifies hb <= cap when
    rendering and raises rather than emitting a corrupt stream. Hard upper
    bound: 1152 pair slots x 15 bits = 2160 bytes.
    """
    from ..ops.dsp import MAX_FRAME_MAIN_BITS

    sr = options.sample_rate
    lsf = options.lsf
    top = 160 if lsf else 320
    if options.vbr:
        max_kbps = min(top, options.bitrate_kbps + 64 - options.quality * 4)
    else:
        max_kbps = options.bitrate_kbps
    if options.free_format:
        br_val = options.bitrate_kbps  # exact off-table rate (CBR-only)
    else:
        bi = bitrate_index(max_kbps, sr)
        br_val = bitrate_value_lsf(bi) if lsf else bitrate_value(bi)
    if lsf:
        side = 9 if options.channels == 1 else 17
    else:
        side = 17 if options.channels == 1 else 32
    crc = 2 if options.crc_protected else 0
    slots_per_kbps = 72 if lsf else 144
    slot_max = (slots_per_kbps * br_val * 1000) // sr + 1 - 4 - crc - side
    cap = min(MAX_FRAME_MAIN_BITS // 8, slot_max + options.reservoir_cap + 1)
    return cap + (cap & 1)  # even (halfword-aligned)


def make_chunk_fn(options: MP3EncoderOptions):
    """Build the chunk encode function
    (carry, pcm [B,T,1152*ch], final [B,T], valid [B,T]) -> (carry, outputs).

    All chunk tensors are BATCH-MAJOR (batch axis leading, matching the
    carry and the mesh sharding axis, so every input/output shards as
    P('data') with no per-tensor special case, and host renderers slice
    contiguous [b, :F] rows). Only the small per-frame integer tensors are
    transposed for the time scan.
    `valid` must be a prefix along T per stream (see module docstring).
    """
    sr = options.sample_rate
    ch = options.channels
    lsf = options.lsf  # 0 MPEG-1, 1 MPEG-2, 2 MPEG-2.5 (one granule/frame)
    n_gr = options.n_granules
    spf = options.samples_per_frame  # 1152 (MPEG-1) or 576 (LSF)
    res_cap = options.reservoir_cap  # 511 (9-bit mdb) or 255 (LSF, 8-bit)
    n_gran = n_gr * ch
    if lsf:
        side_size = 9 if ch == 1 else 17
    else:
        side_size = 17 if ch == 1 else 32
    crc_size = 2 if options.crc_protected else 0
    is_vbr = options.vbr
    base_kbps = options.bitrate_kbps
    quality = options.quality
    mode = options.mode
    if options.free_format:
        # ISO 2.4.2.3: header index 0, exact off-table rate sizes the frame
        cbr_index, cbr_value = 0, base_kbps
    else:
        cbr_index = bitrate_index(base_kbps, sr)
        cbr_value = bitrate_value_lsf(cbr_index) if lsf else bitrate_value(cbr_index)
    slots_per_kbps = 72 if lsf else 144  # LSF frames carry ONE granule
    cap_bytes = main_data_cap(options)
    aligned = options.reservoir_mode == "aligned"
    iso_quant = options.iso_quantization
    strict_entropy = options.spec_strict_entropy
    win_seq = options.window_sequencing

    def run(carry, pcm, final, valid, la=None):
        if pcm.dtype == jnp.int16:
            # int16 ingestion: devices normalize by 1/32768 (exact in f32);
            # halves host->device transfer for the common PCM16 case.
            pcm = pcm.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
        else:
            # Non-finite samples would otherwise poison the integer outputs
            # (the reference traps on NaN); zero them deterministically.
            pcm = jnp.nan_to_num(
                pcm.astype(jnp.float32), nan=0.0, posinf=0.0, neginf=0.0
            )
        if la is not None:
            # lookahead granules get the identical ingestion treatment so
            # the transient decisions match the golden backend's
            if la.dtype == jnp.int16:
                la = la.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
            else:
                la = jnp.nan_to_num(
                    la.astype(jnp.float32), nan=0.0, posinf=0.0, neginf=0.0
                )
        B, T = pcm.shape[0], pcm.shape[1]

        # ---------------- Phase 1: parallel DSP (batch-major) ----------------
        # pcm arrives batch-major: the reshape to [B, T*n] is free, and every
        # [.., 576] tensor afterwards stays in [B, ch, 2T, ...] layout — only
        # scalar-ish per-granule tensors are reordered for the time scan.
        pcm_bt = pcm.reshape(B, T * pcm.shape[-1])
        use_ms = None  # per-frame M/S decision (joint stereo only)
        left = right = None
        if ch == 2:
            left = pcm_bt[:, 0::2].reshape(B, T, spf)
            right = pcm_bt[:, 1::2].reshape(B, T, spf)

        if win_seq:
            # ISO window sequencing (twin of GoldenBackend): shared-across-
            # channels short wants from the RAW pre-matrix PCM; the NEXT
            # granule's want comes from within the chunk, and the chunk's
            # last granule's from the lookahead input `la` [B, 576*ch]
            # per frame (the session/batch layer holds frames back one
            # granule — see EncoderSession). MIXED demotes to SHORT.
            if la is None:
                raise ValueError(
                    "window_sequencing chunk encode requires the per-frame "
                    "lookahead input la [B, T, 576*ch]"
                )
            if ch == 1:
                raw_g = pcm_bt.reshape(B, 1, T, n_gr, 576)
                la_g = la.reshape(B, 1, T, 576)
            else:
                raw_g = jnp.stack([left, right], axis=1).reshape(
                    B, 2, T, n_gr, 576
                )
                la_g = jnp.stack(
                    [la[..., 0::2], la[..., 1::2]], axis=1
                )  # [B, 2, T, 576]
            rb, _ = dsp.transient_frame(raw_g)  # [B, chs, T, n_gr]
            chs = raw_g.shape[1]
            raw_flat = raw_g.reshape(B, chs, T * n_gr, 576)
            # onset/drop chain runs across granule AND chunk boundaries:
            # carry["onset_prev2"] holds the previous chunk's last valid
            # granule's trailing block energies (+inf = unknown past)
            ow, ow_tails = dsp.onset_wants_chunk(
                raw_flat, carry["onset_prev2"]
            )  # [B, chs, G], [B, chs, G, 2]
            want_b = jnp.any(
                (rb != dsp.BLOCK_LONG) | ow.reshape(B, chs, T, n_gr), axis=1
            )  # [B, T, n_gr]
            lb, _ = dsp.transient_frame(la_g[..., None, :])  # [B, chs, T, 1]
            # lookahead granule of frame t = the granule AFTER frame t's
            # last: its chain context is that granule's tails (in-chunk)
            la_prev2 = ow_tails.reshape(B, chs, T, n_gr, 2)[..., -1, :]
            ow_la, _ = dsp.onset_wants_chunk(
                la_g[..., None, :].reshape(B, chs, T, 1, 576), la_prev2
            )
            want_la = jnp.any(
                (lb[..., 0] != dsp.BLOCK_LONG) | ow_la[..., 0],
                axis=1,
            )  # [B, T]
            # flush: golden forces want_next=False past the stream end
            # (trailing zeros never attack) — without this mask the DROP
            # criterion would fire on the zero lookahead after a loud
            # ending and diverge from the golden law on final frames
            want_la = want_la & ~final
            # next-granule wants: within the frame for granules 0..n_gr-2,
            # the lookahead granule for the frame's last (only, at LSF)
            want_next = jnp.concatenate(
                [want_b[..., 1:], want_la[..., None]], axis=-1
            )
            valid_g = jnp.repeat(valid, n_gr, axis=1)  # [B, n_gr*T]
            bts, seq_ps, seq_pw = dsp.sequence_blocks_chunk(
                want_b.reshape(B, n_gr * T),
                want_next.reshape(B, n_gr * T),
                valid_g,
                carry["seq_prev_short"],
                carry["seq_prev_want"],
            )
            block_b = jnp.broadcast_to(
                bts.reshape(B, 1, T, n_gr), (B, ch, T, n_gr)
            )
            sb_gain_b = jnp.zeros((B, ch, T, n_gr, 3), jnp.int32)

        # Intensity-stereo frame gate (options.intensity_stereo; twin of
        # GoldenBackend): frames whose every granule is LONG-layout or
        # pure SHORT on the RAW pre-matrix channels are IS-eligible —
        # only MIXED granules force the discrete fallback (round 5; the
        # per-(band, window) short law joined the long law). Eligible
        # frames code raw L/R and may emit mode_extension 0b01 (decided
        # after the spectra exist). The gate must not depend on the
        # matrix choice it overrides, so it runs on raw transients (or
        # the sequencing blocks, which are raw-derived and channel-shared
        # already); transient IS frames share ONE window layout across
        # channels (the decoder's short-IS contract) via is_shared_blk.
        is_gate = None  # [B, T] bool
        is_shared_blk = None  # [B, T, n_gr] shared raw verdict (non-seq)
        if options.intensity_stereo_active and ch == 2:
            if win_seq:
                is_gate = jnp.all(
                    bts.reshape(B, T, n_gr) != dsp.BLOCK_MIXED, axis=-1
                )
            else:
                raw_g2 = jnp.stack([left, right], axis=1).reshape(
                    B, 2, T, n_gr, 576
                )
                rb_raw, _ = dsp.transient_frame(raw_g2)
                is_shared_blk = jnp.max(rb_raw, axis=1)  # [B, T, n_gr]
                is_gate = jnp.all(
                    is_shared_blk != dsp.BLOCK_MIXED, axis=-1
                )

        if ch == 1:
            pcm_chunk = pcm_bt[:, None, :]  # [B, 1, T*spf]
        else:
            if mode is Mode.JOINT_STEREO:
                use_ms, c0, c1 = dsp.stereo_decide(
                    left, right, iso_matrix=options.iso_ms_matrix,
                    symmetric=options.ms_symmetric,
                )  # [B, T]
            else:
                c0, c1 = left, right
            if is_gate is not None:
                if options.ms_symmetric:
                    # Side-dominant M/S frames opt OUT of the IS gate (twin
                    # of GoldenBackend): anti-correlated content cancels in
                    # the L+R sum, so pre-committing it to raw L/R forfeits
                    # the symmetric-arm win (antiphase@32k downmix 14.5 ->
                    # 1.5 dB measured). Same mid/side energies as
                    # stereo_decide — XLA CSEs the recompute away.
                    half = (
                        dsp._F32(1.0 / np.sqrt(2.0))
                        if options.iso_ms_matrix
                        else dsp._F32(0.5)
                    )
                    mid_t = (left + right) * half
                    side_t = (left - right) * half
                    n_t = dsp._F32(left.shape[-1])
                    sd = (jnp.sum(mid_t * mid_t, axis=-1) / n_t) < (
                        jnp.sum(side_t * side_t, axis=-1) / n_t
                    ) * dsp._F32(0.4)
                    is_gate = is_gate & ~(use_ms & sd)
                # IS-eligible frames code raw L/R (twin of GoldenBackend);
                # use_ms is masked so the shared-blocks law and the header
                # mode_extension see the discrete coding on those frames.
                g = is_gate[..., None]
                c0 = jnp.where(g, left, c0)
                c1 = jnp.where(g, right, c1)
                if use_ms is not None:
                    use_ms = use_ms & ~is_gate
            pcm_chunk = jnp.stack([c0, c1], axis=1).reshape(B, ch, T * spf)

        granule_pcm = pcm_chunk.reshape(B, ch, T, n_gr, 576)  # free view

        # Filterbank: folded five-matmul form (see
        # dsp.polyphase_chunk_matmul), one HLO on every platform. (36T is
        # always a multiple of 4, so the folded form's 128-sample row
        # packing is always exact.)
        S, full_x = dsp.polyphase_chunk_matmul(carry["fb_hist"], pcm_chunk)  # [B,ch,36T,32]

        if not win_seq:
            block_b, sb_gain_b = dsp.transient_frame(granule_pcm)  # [B,ch,T,n_gr],[..,3]
            if lsf and not options.iso_short_blocks:
                # LSF mixed blocks need the ISO layout machinery (6-band
                # head reorder + ns (6,9,9,9) scalefactors, carried by
                # iso_short_blocks); without it, demote to SHORT (golden
                # twin does the same; lame never emits mixed at LSF)
                block_b = jnp.where(
                    block_b == dsp.BLOCK_MIXED, dsp.BLOCK_SHORT, block_b
                )
            if options.shared_ms_blocks and use_ms is not None:
                # M/S frames must carry ONE window layout across both
                # channels (options.shared_ms_blocks; twin of
                # GoldenBackend): detect on the raw pre-matrix L/R and let
                # the more-transient verdict win (LONG < MIXED < SHORT).
                # L/R frames keep the per-channel post-matrix decision.
                raw_g = jnp.stack([left, right], axis=1).reshape(
                    B, 2, T, n_gr, 576
                )
                rb, _ = dsp.transient_frame(raw_g)  # [B, 2, T, n_gr]
                if lsf and not options.iso_short_blocks:
                    # pre-max demotion == the golden's post-max demotion
                    # (MIXED=1 -> SHORT=2 commutes with the max here)
                    rb = jnp.where(rb == dsp.BLOCK_MIXED, dsp.BLOCK_SHORT, rb)
                shared = jnp.max(rb, axis=1, keepdims=True)  # [B, 1, T, n_gr]
                block_b = jnp.where(use_ms[:, None, :, None], shared, block_b)
            if is_shared_blk is not None:
                # IS-gated frames carry the shared raw verdict across
                # channels (golden twin: shared_blocks on IS frames)
                block_b = jnp.where(
                    is_gate[:, None, :, None],
                    is_shared_blk[:, None],
                    block_b,
                )
            if iso_quant:
                # The quantizer never applies per-window gains, so the
                # reference's heuristic subblock_gain values make conforming
                # decoders attenuate short windows by 2^(-2*sbg) spuriously;
                # the unit-gain law emits zeros (mirrors preflag suppression).
                sb_gain_b = jnp.zeros_like(sb_gain_b)
        block_seq = block_b.reshape(B, ch, n_gr * T)  # granule-sequence order
        spectra, cur = dsp.mdct_chunk(
            S, carry["overlap"], block_seq,
            iso_mixed_alias=options.iso_short_blocks,
            window_seq=win_seq,
        )
        spectra = spectra.reshape(B, ch, T, n_gr, 576)  # [B,ch,T,gr,576]
        if options.lowpass_hz is not None and (
            options.lowpass_hz * 64 // options.sample_rate
        ) < 32:
            # subband-granularity lowpass (options.lowpass_hz; twin of
            # GoldenBackend) — static mask, fuses into the MDCT epilogue.
            # adaptive_lowpass gates it per granule-channel on the
            # negligible-or-noise-like decision (dsp.adaptive_lowpass_engage).
            # Cut at/above Nyquist (LSF rates under the hq rate-derived
            # default): whole stage skipped, nothing to zero.
            cut_sb = int(options.lowpass_hz * 64 // options.sample_rate)
            lp_mask = jnp.asarray(
                (np.arange(576) < cut_sb * 18).astype(np.float32)
            )
            if options.adaptive_lowpass:
                # non-LONG granules always engage (twin of the golden
                # law: the sfm statistic is calibrated on long-window
                # spectra, and a transient granule's high band is attack
                # noise — cutting it IS the static behavior)
                eng = (block_b != dsp.BLOCK_LONG) | dsp.adaptive_lowpass_engage(
                    spectra, cut_sb
                )
                spectra = jnp.where(
                    eng[..., None], spectra * lp_mask, spectra
                )
            else:
                spectra = spectra * lp_mask

        # Intensity analysis + transform (options.intensity_stereo; twin of
        # GoldenBackend's stage between the spectra pass and scalefactors):
        # gated frames with any qualifying granule region emit mode_ext
        # 0b01 — their left spectrum carries the per-line L+R sum on region
        # lines, the right is zero there; gated frames with NO region fall
        # back to discrete stereo (channels are already raw L/R). Every
        # decision here is a float reduction shared with the golden —
        # knife-edge granules flip across backends (ULP-flip contract).
        is_emit = None  # [B, T] bool — frames that emit mode_extension 0b01
        if is_gate is not None:
            # per-granule layout kind (blocks are channel-shared on gated
            # frames — the gate forces the shared verdict)
            is_short_g = block_b[:, 0] == dsp.BLOCK_SHORT  # [B, T, gr]
            is_pos, is_region, is_hasr, is_lmask = dsp.intensity_analyze_device(
                spectra[:, 0], spectra[:, 1], sr
            )  # [B,T,gr,21] i32, [B,T,gr,21] bool, [B,T,gr], [B,T,gr,576]
            # per-(band, window) law for pure-short granules (round 5;
            # NATURAL layout — the reorder happens inside the sweep)
            is_pos_s, is_region_s, is_hasr_s, is_lmask_s = (
                dsp.intensity_analyze_short_device(
                    spectra[:, 0], spectra[:, 1], sr
                )
            )  # [B,T,gr,12,3], ..., [B,T,gr,3], [B,T,gr,576]
            hasr_g = jnp.where(
                is_short_g, jnp.any(is_hasr_s, axis=-1), is_hasr
            )  # [B, T, gr]
            is_emit = is_gate & jnp.any(hasr_g, axis=-1)
            mask_l = is_lmask * (
                (is_emit[:, :, None] & is_hasr)[..., None]
            ).astype(jnp.float32)
            # the short line mask already folds per-window has_region
            mask_s = is_lmask_s * is_emit[:, :, None, None].astype(
                jnp.float32
            )
            m = jnp.where(is_short_g[..., None], mask_s, mask_l)
            spectra = jnp.stack(
                [
                    spectra[:, 0] + spectra[:, 1] * m,
                    spectra[:, 1] * (1.0 - m),
                ],
                axis=1,
            )
            # bands actually SUMMED (carry real positions; un-summed slots
            # above the final extent get the illegal marker 7 post-walk)
            is_summed = is_region & is_hasr[..., None]
            is_summed_s = is_region_s & is_hasr_s[..., None, :]
            # [B, ch, T, gr] — the right channel of emitted IS frames,
            # split by granule layout kind (the two post-walk laws)
            is_right = (jnp.arange(ch)[None, :, None, None] == 1) & is_emit[
                :, None, :, None
            ]
            is_right_long = is_right & ~is_short_g[:, None]
            is_right_short = is_right & is_short_g[:, None]

        if strict_entropy:
            is_long_b = block_b == dsp.BLOCK_LONG  # [B, ch, T, 2]
            # START/STOP granules: LONG scalefactor layout + scfsi
            # eligibility, but NOT long for the entropy regions (is_long_b
            # stays strict — the 36/576 switching split applies)
            sf_block_b = (
                jnp.where(block_b > dsp.BLOCK_SHORT, dsp.BLOCK_LONG, block_b)
                if win_seq
                else block_b
            )
            long_layout_b = (
                is_long_b | (block_b > dsp.BLOCK_SHORT)
                if win_seq
                else is_long_b
            )
            if options.real_scalefactors:
                sfd = dsp.granule_scalefactors_device(
                    spectra, sr, sf_block_b,
                    psy=options.psy_scalefactors,
                    iso_short=options.iso_short_blocks,
                    lsf=bool(lsf),
                )
                g0 = dsp.initial_gain_scaled(
                    spectra, sfd["mag_scale"],
                    target=LINBITS_Q_TARGET if options.linbits_tables else 15.0,
                )
                mag_scale, part2 = sfd["mag_scale"], sfd["part2"]
                if options.scfsi and not lsf:
                    # granule 1 skips retransmitting groups equal to granule
                    # 0's; the saved part2 bits return to the rate budget
                    scfsi_nib, sf_write = dsp.scfsi_device(
                        sfd["sf"], long_layout_b
                    )
                    part2 = dsp.scfsi_part2_device(sfd, sf_write)
                else:
                    scfsi_nib = sf_write = None
            else:
                sfd = None
                g0 = dsp.initial_gain(spectra, iso=iso_quant)
                mag_scale = part2 = scfsi_nib = sf_write = None

            def price_part2(p2):
                # Intensity pricing pad (twin of GoldenBackend's up-front
                # pricing): the post-walk slot overwrite can grow any of
                # the right channel's slens to cover the illegal marker 7,
                # and actual emitted bits must never exceed the PRICED
                # bits (the est-reservoir world the selection scan runs
                # in). dc never touches IS frames, so the pad computed
                # from the pre-dc sf is valid at both pre computations.
                # Long-layout granules pad the 21-band sf; pure-short
                # granules pad all 36 (band, window) slots (round 5).
                if is_emit is None or sfd is None:
                    return p2
                pad_l = dsp.intensity_padded_part2_device(sfd, spectra, sr)
                pad_s = dsp.intensity_padded_part2_short_device(sfd)
                return jnp.where(
                    is_right_long,
                    pad_l,
                    jnp.where(is_right_short, pad_s, p2),
                )

            if lsf:
                # switching region-0 boundary (LSF only; at MPEG-1 rates
                # every expression is exactly 36 and the device keeps the
                # historical literal): band-derived for short/start/stop
                # (tables.switch_bound), the de-facto decoder constant
                # for MIXED (tables.mixed_switch_bound — 36 except 108
                # at 8 kHz, measured vs libmpg123)
                b0_sw = jnp.where(
                    block_b == dsp.BLOCK_SHORT,
                    switch_bound(sr, True),
                    jnp.where(
                        block_b == dsp.BLOCK_MIXED,
                        mixed_switch_bound(sr),
                        switch_bound(sr, False),
                    ),
                ).astype(jnp.int32)
            else:
                b0_sw = None
            pre = dsp.rate_loop_precompute_strict(
                spectra,
                g0,
                sr,
                is_long_b,
                iso_quant,
                options.count1_coding,
                options.region_table_select,
                mag_scale=mag_scale,
                part2=price_part2(part2),
                block=block_b,
                iso_short=options.iso_short_blocks,
                linbits=options.linbits_tables,
                b0_switch=b0_sw,
            )
            demand_pre = pre
            if options.distortion_control_active and sfd is not None:
                # One-shot distortion control (twin of encoder.py's probe-
                # walk stage; law in dsp.distortion_bumps_device): a
                # vectorized probe selection at the STATIC base-rate
                # equal-share budget (state-free, so it runs before the
                # budget scan) quantizes once, band violations bump the
                # scalefactors in all-LONG frames, and a SECOND sweep
                # prices the bumped magnitudes. The budget scan then
                # selects from the pass-2 table (the est-reservoir world
                # evolves on pass-2 priced bits, same as golden), while
                # the demand probes (vbr_demand / demand_budget) keep the
                # pass-1 table — golden computes them at staging, before
                # any bump. Costs a full second sweep; flag-gated.
                base_main = (
                    ((72 if lsf else 144) * options.bitrate_kbps * 1000)
                    // sr - 4 - crc_size - side_size
                )
                # equal share per granule-channel unit (n_gran == n_gr*ch
                # already — golden divides by n_gr*channels; an earlier
                # extra *channels halved the stereo probe share, latent
                # because generous budgets saturate the finest candidate)
                probe_budget = min((base_main * 8) // n_gran, 4095)
                pb = jnp.full(g0.shape, probe_budget, dtype=jnp.int32)
                from ..tables import QCAP_LINBITS

                # engage per FRAME: every granule of every channel LONG
                frame_long = jnp.all(
                    block_b == dsp.BLOCK_LONG, axis=(1, 3)
                )  # [B, T]
                if is_emit is not None:
                    # IS positions overwrite bumped slots (golden twin's
                    # dc_frame gate excludes emitted IS frames)
                    frame_long = frame_long & ~is_emit
                engaged = jnp.broadcast_to(
                    frame_long[:, None, :, None], block_b.shape
                )
                # options.dc_passes probe->bump iterations, unrolled (a
                # zero-bump pass rebuilds the identical sfd, so the fixed
                # unroll reaches the golden's early-break fixpoint); each
                # pass costs a full probe sweep (rate_loop_precompute).
                for _dc_pass in range(options.dc_passes):
                    kp, fitp, _ = dsp.rate_loop_select(
                        pre["bits"], pre["evaluated"], pre["k_budget"], pb
                    )
                    gains_p = pre["gstart"] + 4 * kp
                    q_p = dsp.quantize_at_gains(
                        pre["mag"], pre["sign_neg"], gains_p[..., None],
                        iso=pre["iso"],
                        qcap=QCAP_LINBITS, floor=False,
                    )[..., 0, :]
                    gain_p = jnp.where(
                        fitp, gains_p, jnp.minimum(gains_p + 4, 255)
                    ).astype(jnp.int32)
                    bumps = dsp.distortion_bumps_device(
                        spectra, q_p, gain_p, sfd["sf"], sr,
                        proportional=options.dc_proportional,
                    )
                    sfd = dsp.distortion_sfd_device(
                        sfd, bumps, engaged, spectra, sr
                    )
                    mag_scale, part2 = sfd["mag_scale"], sfd["part2"]
                    g0 = dsp.initial_gain_scaled(
                        spectra, mag_scale, target=LINBITS_Q_TARGET
                    )
                    pre = dsp.rate_loop_precompute_strict(
                        spectra,
                        g0,
                        sr,
                        is_long_b,
                        iso_quant,
                        options.count1_coding,
                        options.region_table_select,
                        mag_scale=mag_scale,
                        part2=price_part2(part2),
                        block=block_b,
                        iso_short=options.iso_short_blocks,
                        linbits=options.linbits_tables,
                        b0_switch=b0_sw,
                    )
        else:
            sfd = scfsi_nib = sf_write = None
            g0 = dsp.initial_gain(spectra, iso=iso_quant)  # [B, ch, T, gr]
            pre = dsp.rate_loop_precompute(
                spectra,
                g0,
                iso=iso_quant,
                use_kernel=sweep_kernel_enabled(),
            )

        def tm(x):  # [B, ch, T, gr, ...] -> time-major granule-major [T, B, G, ...]
            return jnp.transpose(
                x, (2, 0, 3, 1) + tuple(range(4, x.ndim))
            ).reshape((T, B, n_gran) + x.shape[4:])

        frame_e = (
            jnp.swapaxes(dsp.mean_square(pcm), 0, 1)  # [B,T] -> [T,B], tiny
            if is_vbr
            else jnp.zeros((T, B), jnp.float32)
        )
        granule_e = tm(dsp.mean_square(granule_pcm))
        final_t = jnp.swapaxes(final, 0, 1)  # [B,T] -> [T,B], tiny
        valid_t = jnp.swapaxes(valid, 0, 1)

        # ---------------- Phase 2: integer scan over T ----------------
        int_carry = {
            k: carry[k]
            for k in (
                "stream_len",
                "avail",
                "pad_rem",
                "slot_fifo",
                "vbr_ehist",
                "vbr_count",
            )
        }
        if strict_entropy:
            # Walk respec (round 3): this scan selects candidates in the
            # PRICED (t15+delta) world, so its stream mirror is
            # est_stream_len; the real stream_len + mdb are recomputed by
            # the post-finalize scan below from the ACTUAL strict bits.
            int_carry["stream_len"] = carry["est_stream_len"]

        def step(c, x):
            # demand_k: the PASS-1 priced table (staging-time probes —
            # vbr_demand target + demand_budget donation, twin of golden's
            # staged demands); bits_k: the table selection runs on (pass-2
            # under distortion_control, otherwise the same array).
            demand_k, bits_k, evaluated, k_budget, fe, ge, fin, val = x
            if is_vbr and options.vbr_demand:
                # Demand-driven VBR (twin of encoder.py; law note in
                # options.vbr_demand): smallest in-band bitrate whose slot
                # covers the frame's priced demand at the quality-mapped
                # candidate — the priced grid is already computed, so the
                # choice is a tiny static where-select.
                d = jnp.sum(demand_k[..., min(quality, 19)], axis=-1)  # [B]
                table = LSF_VBR_BITRATES if lsf else VBR_BITRATES
                min_b = 8 if lsf else 32  # full downward freedom (twin of encoder.py)
                max_b = min(table[-1], base_kbps + 64 - quality * 4)
                cands = [b for b in table if min_b <= b <= max_b]
                if not cands:  # band above the table top (base at top, high q)
                    bi = bitrate_index(max_b, sr)
                    cands = [
                        bitrate_value_lsf(bi) if lsf else bitrate_value(bi)
                    ]
                slots_b = np.array(
                    [
                        ((slots_per_kbps * b * 1000) // sr - 4 - crc_size - side_size) * 8
                        for b in cands
                    ],
                    dtype=np.int32,
                )
                fits = d[:, None] <= jnp.asarray(slots_b)[None, :]  # [B, n]
                first = jnp.argmax(fits, axis=1)
                vals = jnp.asarray(np.array(cands, dtype=np.int32))
                sel = jnp.sum(
                    jnp.where(
                        jnp.arange(len(cands)) == first[:, None],
                        vals[None, :],
                        0,
                    ),
                    axis=1,
                )
                target = jnp.where(jnp.any(fits, axis=1), sel, cands[-1])
                br_idx = dsp.bitrate_index_device(target, sr)
                br_val = dsp.bitrate_value_device(br_idx, lsf=bool(lsf))
            elif is_vbr:
                target = dsp.vbr_choose_bitrate(
                    fe, c["vbr_ehist"], c["vbr_count"], base_kbps, quality
                )
                br_idx = dsp.bitrate_index_device(target, sr)
                br_val = dsp.bitrate_value_device(br_idx, lsf=bool(lsf))
            else:
                br_idx = jnp.full(B, cbr_index, dtype=jnp.int32)
                br_val = jnp.full(B, cbr_value, dtype=jnp.int32)

            numerator = slots_per_kbps * br_val * 1000
            base_size = numerator // sr
            remainder = numerator % sr
            pad_acc = c["pad_rem"] + remainder
            padding = (pad_acc >= sr).astype(jnp.int32)
            pad_rem = pad_acc - padding * sr
            slot = base_size + padding - 4 - crc_size - side_size

            sum_fifo = jnp.sum(c["slot_fifo"], axis=1)  # [B]
            oldest = c["slot_fifo"][:, 0]  # spliced this frame (0 = filling)
            res_bits = jnp.where(fin, 0, c["avail"] * 8)
            usable = (res_bits * 9) // 10
            if aligned:
                # depth-general expressibility cap: a frame's data can only
                # land in the still-buffered slots, never deeper than the
                # 9-bit main_data_begin reach (twin of encoder.py; at K=1
                # the min(.,511) never binds — the 90% rule caps usable at
                # 0.9*511 bytes)
                gap_b = sum_fifo - c["stream_len"]
                usable = jnp.minimum(usable, jnp.clip(gap_b, 0, res_cap) * 8)
            bits_per_granule = (slot * 8 + usable) // n_gran
            if options.linbits_tables:
                # part2_3_length is a 12-bit field; ESC coding can genuinely
                # reach it at high bitrates (the t15 cap never does), and
                # selecting past it would wrap the side info (golden twin
                # clamps identically in quantize_to_fit_budget_strict)
                bits_per_granule = jnp.minimum(bits_per_granule, 4095)

            if strict_entropy and options.demand_budget:
                # Donation law (options.demand_budget; twin of encoder.py
                # stage-2 budgets): granules whose probe demand — exact
                # priced bits at the K_DEMAND grid candidate, free here —
                # sits UNDER the equal share donate surplus; granules over
                # it split the donations by deficit. Exact no-op on frames
                # with no (surplus, deficit) pair, so steady frames keep
                # the equal split bit-for-bit.
                d = demand_k[..., LINBITS_K_DEMAND]  # [B, G]
                sum_d = jnp.sum(d, axis=-1, keepdims=True)
                total_b = (slot * 8 + usable)[:, None]
                share = total_b // n_gran
                sur = jnp.maximum(share - d, 0)
                defi = jnp.maximum(d - share, 0)
                pool = jnp.sum(sur, axis=-1, keepdims=True)
                sdef = jnp.sum(defi, axis=-1, keepdims=True)
                take = jnp.minimum(pool, sdef)
                prop = (
                    share
                    - (sur * take) // jnp.maximum(pool, 1)
                    + (take * defi) // jnp.maximum(sdef, 1)
                )
                prop = jnp.minimum(prop, 4095)
                max_b = jnp.where(sum_d > 0, prop, bits_per_granule[:, None])
            else:
                max_b = bits_per_granule[:, None]
            k_sel, has_fit, bits_sel = dsp.rate_loop_select(
                bits_k, evaluated, k_budget, max_b
            )
            total_used = jnp.sum(bits_sel, axis=-1)
            huffman_bytes = (total_used + 7) // 8
            if aligned:
                # depth-general placement law (twin of encoder.py): depth 1
                # tail-aligns data against its own header (historical
                # byte-exact law); depth > 1 FRONT-aligns (mdb = full gap,
                # stuffing only past the 511 horizon) so banked space
                # survives within the buffered window. Unused space
                # expires as end-padding when its slot emits (the floor).
                gap = sum_fifo - c["stream_len"]
                if options.reservoir_depth > 1:
                    mdb = jnp.clip(gap, 0, res_cap)
                else:
                    mdb = jnp.clip(jnp.minimum(gap, huffman_bytes), 0, res_cap)
                stream_len = jnp.maximum(
                    c["stream_len"] + (gap - mdb) + huffman_bytes - oldest, 0
                )
            else:
                mdb = jnp.where(fin, 0, jnp.minimum(c["stream_len"], res_cap))
                stream_len = jnp.maximum(
                    c["stream_len"] + huffman_bytes - oldest, 0
                )
            avail = jnp.clip(c["avail"] + slot - huffman_bytes, 0, res_cap)
            vbr_ehist = jnp.concatenate([c["vbr_ehist"][:, n_gran:], ge], axis=1)
            vbr_count = jnp.minimum(c["vbr_count"] + n_gran, 10)

            new_c = {
                "stream_len": stream_len,
                "avail": avail,
                "pad_rem": pad_rem,
                "slot_fifo": jnp.concatenate(
                    [c["slot_fifo"][:, 1:], slot[:, None]], axis=1
                ),
                "vbr_ehist": vbr_ehist,
                "vbr_count": vbr_count,
            }

            def keep(new, old):
                v = val.reshape((B,) + (1,) * (new.ndim - 1))
                return jnp.where(v, new, old)

            merged = jax.tree_util.tree_map(keep, new_c, c)
            ys = (br_idx, padding, mdb, slot, k_sel, has_fit, bits_sel)
            return merged, ys

        int_carry, ys = jax.lax.scan(
            step,
            int_carry,
            (
                tm(demand_pre["bits"]) if strict_entropy else tm(pre["bits"]),
                tm(pre["bits"]),
                tm(pre["evaluated"]),
                tm(pre["k_budget"]),
                frame_e,
                granule_e,
                final_t,
                valid_t,
            ),
        )
        br_idx, padding, mdb, slot, k_sel, has_fit, bits_sel = ys

        def bm(x):  # inverse of tm: [T, B, G, ...] -> [B, ch, T, gr, ...]
            y = x.reshape((T, B, n_gr, ch) + x.shape[3:])
            return jnp.transpose(y, (1, 3, 0, 2) + tuple(range(4, y.ndim)))

        # ---------------- Phase 3: parallel finalize (batch-major) --------
        part23_t = bits_sel  # [T, B, G]; strict mode replaces with actuals
        if strict_entropy:
            # Intensity post-walk fixups (twin of encoder.py stage 2): the
            # knife-edge zeroing runs INSIDE finalize (the entropy layout
            # must see the fixed q), then the right channel's scalefactor
            # slots at/above the final extent become positions (real on
            # summed bands, illegal 7 on un-summed) and the sfd rebuilds.
            q_fixup = None
            if is_emit is not None:

                def q_fixup(q):
                    # long-layout granules: band-20/sfb21 knife edge on
                    # the NATURAL layout (their q is unreordered). Pure
                    # short granules: per-window band-11/tail knife edge —
                    # their q is STREAM-ordered inside the sweep, so
                    # round-trip through the static slice/transpose
                    # reorder (round 5; IS frames only pay this).
                    q = dsp.intensity_q_fixup(q, is_right_long, sr)
                    q_nat = dsp.reorder_stream_to_natural(q, sr, False)
                    q_nat = dsp.intensity_q_fixup_short(
                        q_nat, is_right_short, sr
                    )
                    q_s = dsp.reorder_natural_to_stream(q_nat, sr, False)
                    any_short = is_right_short[..., None]
                    return jnp.where(any_short, q_s, q)

            gain_b, quantized, lay = dsp.strict_finalize(
                pre, bm(k_sel), bm(has_fit), q_fixup=q_fixup
            )
            if is_emit is not None and sfd is not None:
                sfd = dsp.intensity_sfd_device(
                    sfd,
                    quantized,
                    jnp.broadcast_to(
                        is_pos[:, None], (B, ch, T, n_gr, 21)
                    ),
                    jnp.broadcast_to(
                        is_summed[:, None], (B, ch, T, n_gr, 21)
                    ),
                    is_right_long,
                    spectra,
                    sr,
                )
                # pure-short granules: per-window overwrite on the
                # NATURAL view of the fixed quantization
                q_nat = dsp.reorder_stream_to_natural(quantized, sr, False)
                sfd = dsp.intensity_sfd_short_device(
                    sfd,
                    q_nat,
                    jnp.broadcast_to(
                        is_pos_s[:, None], (B, ch, T, n_gr, 12, 3)
                    ),
                    jnp.broadcast_to(
                        is_summed_s[:, None], (B, ch, T, n_gr, 12, 3)
                    ),
                    is_right_short,
                    sr,
                )
                part2 = sfd["part2"]  # actual (padded pricing dominated it)
            # part2_3_length and the reservoir accounting use the ACTUAL
            # strict bits of the selected gain (the scan's bits_sel are the
            # priced estimates — selection policy only; see
            # dsp.rate_loop_precompute_strict).
            part23_b = lay["bits"] + (part2 if part2 is not None else 0)
            part23_t = tm(part23_b)
            hb_t = (jnp.sum(part23_t, axis=-1) + 7) // 8  # [T, B] bytes

            carry2 = {
                "stream_len": carry["stream_len"],
                "slot_fifo": carry["slot_fifo"],
            }

            def step2(c, x):
                slot_f, hb_f, fin_f, val_f = x
                sum_f2 = jnp.sum(c["slot_fifo"], axis=1)
                oldest2 = c["slot_fifo"][:, 0]
                if aligned:
                    # depth-general placement law on the REAL byte counts
                    # (twin of the selection scan's est-world form)
                    gap2 = sum_f2 - c["stream_len"]
                    if options.reservoir_depth > 1:
                        mdb_f = jnp.clip(gap2, 0, res_cap)
                    else:
                        mdb_f = jnp.clip(jnp.minimum(gap2, hb_f), 0, res_cap)
                    sl = jnp.maximum(
                        c["stream_len"] + (gap2 - mdb_f) + hb_f - oldest2, 0
                    )
                else:
                    mdb_f = jnp.where(
                        fin_f, 0, jnp.minimum(c["stream_len"], res_cap)
                    )
                    sl = jnp.maximum(c["stream_len"] + hb_f - oldest2, 0)
                new_c = {
                    "stream_len": sl,
                    "slot_fifo": jnp.concatenate(
                        [c["slot_fifo"][:, 1:], slot_f[:, None]], axis=1
                    ),
                }

                def keep2(new, old):
                    v = val_f.reshape((B,) + (1,) * (new.ndim - 1))
                    return jnp.where(v, new, old)

                return jax.tree_util.tree_map(keep2, new_c, c), mdb_f

            carry2, mdb = jax.lax.scan(
                step2, carry2, (slot, hb_t, final_t, valid_t)
            )
            big_values_b = lay["bv"]
            region0_b, region1_b = lay["r0"], lay["r1"]
            ts0_b, ts1_b, ts2_b = lay["tid0"], lay["tid1"], lay["tid2"]
            c1t_b = lay["c1t"]
            chunks, nb = dsp.strict_chunks_device(
                quantized, lay, linbits=options.linbits_tables
            )
            if sfd is not None:
                # scalefactor bits lead each granule's main_data (part2)
                sf_chunks, sf_nbits = dsp.scalefactor_chunks_device(sfd, sf_write)
                chunks = jnp.concatenate([sf_chunks, chunks], axis=-1)
                nb = jnp.concatenate([sf_nbits, nb], axis=-1)
                scfc_b = sfd["compress"]
            else:
                scfc_b = jnp.zeros_like(big_values_b)
        else:
            gain_b, quantized, big_values_b = dsp.rate_loop_finalize(
                pre, bm(k_sel), bm(has_fit)
            )
            region0_b, region1_b = dsp.region_counts(big_values_b, sr)
            fifteen = jnp.full_like(big_values_b, 15)
            ts0_b = ts1_b = ts2_b = fifteen
            c1t_b = jnp.zeros_like(big_values_b)
            scfc_b = jnp.zeros_like(big_values_b)
            chunks, nb = dsp.pair_chunks_device(quantized, big_values_b)
        if iso_quant:
            # With the unit-gain law no pre-emphasis is applied in the
            # quantizer, so emitting preflag=1 would make ISO decoders
            # attenuate the top bands spuriously (the reference's heuristic
            # flag is one of its decode-accuracy quirks).
            pref_b = jnp.zeros_like(big_values_b)
        else:
            pref_b = dsp.preflag(spectra)

        # Device-side Huffman packing: each frame's main_data byte image.
        # Frames are (b, t) pairs; within a frame the write order is
        # granule-major (gr, then ch).
        def frame_major(x):  # [B, ch, T, gr, W] -> [B*T, n_gran*W]
            return jnp.transpose(x, (0, 2, 3, 1, 4)).reshape(
                B * T, n_gran * x.shape[-1]
            )

        with jax.named_scope("pack"):
            main_data, _total_bits = dsp.pack_main_data(
                frame_major(chunks), frame_major(nb), cap_bytes
            )
        main_data = main_data.reshape(B, T, cap_bytes)

        # Pack ALL outputs into ONE uint8 tensor, so each chunk comes back
        # in one device->host transfer: the int32 metadata rides as a
        # bitcast byte tail behind each frame's main_data image. The meta
        # block is assembled time-major (the scan's natural order) and
        # swapped once — it is ~100x smaller than main_data. Layout must
        # match fetch_outputs below.
        table_sel = jnp.stack(
            [tm(ts0_b), tm(ts1_b), tm(ts2_b)], axis=-1
        ).reshape(T, B, 3 * n_gran)
        # per-frame header mode_extension: intensity frames signal
        # 0b01; others the actual M/S decision under iso_mode_ext
        # (use_ms already masked on IS-gated frames), else the
        # reference's constant (0b10-always for joint stereo)
        if use_ms is not None and options.iso_mode_ext:
            mode_ext_t = jnp.where(jnp.swapaxes(use_ms, 0, 1), 2, 0)
        else:
            mode_ext_t = jnp.full(
                (T, B), mode_bits(mode.value)[1], jnp.int32
            )
        if is_emit is not None:
            mode_ext_t = jnp.where(
                jnp.swapaxes(is_emit, 0, 1), 1, mode_ext_t
            )
        meta = jnp.concatenate(
            [
                br_idx[..., None],
                padding[..., None],
                mdb[..., None],
                slot[..., None],
                part23_t,
                tm(big_values_b),
                tm(gain_b),
                tm(block_b),
                tm(pref_b),
                tm(region0_b),
                tm(region1_b),
                tm(sb_gain_b).reshape(T, B, 3 * n_gran),
                table_sel,
                tm(c1t_b),
                tm(scfc_b),
                (
                    jnp.transpose(scfsi_nib, (2, 0, 1))
                    if scfsi_nib is not None
                    else jnp.zeros((T, B, ch), jnp.int32)
                ),
                mode_ext_t[..., None].astype(jnp.int32),
            ],
            axis=-1,
        ).astype(jnp.int32)
        meta_bytes = jax.lax.bitcast_convert_type(
            jnp.swapaxes(meta, 0, 1), jnp.uint8
        ).reshape(B, T, -1)
        outputs = {
            "packed": jnp.concatenate([main_data, meta_bytes], axis=-1)
        }

        # ---------------- Carry-out state at each stream's last valid ----
        # One-hot einsum selects (HIGHEST precision, so exact) pick each
        # stream's carry-out at its last valid frame.
        count_valid = jnp.sum(valid.astype(jnp.int32), axis=1)  # [B]
        # trailing-480 slab t lives at full_x[spf*t : spf*t+480]: pad to
        # (T+1)*spf so slab t is the head of padded row t.
        pad_to = (T + 1) * spf - full_x.shape[-1]
        slabs = jnp.pad(full_x, ((0, 0), (0, 0), (0, pad_to))).reshape(
            B, ch, T + 1, spf
        )[..., :480]
        sel_t = (count_valid[:, None] == jnp.arange(T + 1)).astype(jnp.float32)
        fb_hist = jnp.einsum(
            "bt,bctj->bcj", sel_t, slabs, precision=jax.lax.Precision.HIGHEST
        )
        all_ov = jnp.concatenate([carry["overlap"][:, :, None, :], cur], axis=2)
        sel_g = (
            (n_gr * count_valid)[:, None] == jnp.arange(n_gr * T + 1)
        ).astype(jnp.float32)
        overlap = jnp.einsum(
            "bg,bcgj->bcj", sel_g, all_ov, precision=jax.lax.Precision.HIGHEST
        )

        new_carry = dict(int_carry)
        if strict_entropy:
            new_carry["est_stream_len"] = int_carry["stream_len"]
            new_carry["stream_len"] = carry2["stream_len"]
        else:
            new_carry["est_stream_len"] = carry["est_stream_len"]
        new_carry["fb_hist"] = fb_hist
        new_carry["overlap"] = overlap
        if win_seq:
            new_carry["seq_prev_short"] = seq_ps
            new_carry["seq_prev_want"] = seq_pw
            # last VALID granule's tail energies (index 0 = keep the old
            # carry when nothing valid). where+sum, not einsum: the +inf
            # "unknown past" sentinel would turn 0*inf into NaN in a dot.
            ext_tails = jnp.concatenate(
                [carry["onset_prev2"][:, :, None, :], ow_tails], axis=2
            )  # [B, chs, G+1, 2]
            sel_o = (
                (n_gr * count_valid)[:, None]
                == jnp.arange(n_gr * T + 1)
            )  # [B, G+1]
            new_carry["onset_prev2"] = jnp.sum(
                jnp.where(sel_o[:, None, :, None], ext_tails, 0.0), axis=2
            )
        return new_carry, outputs

    return run


@functools.lru_cache(maxsize=64)
def _cached_chunk_encoder(options: MP3EncoderOptions):
    return jax.jit(make_chunk_fn(options))


def make_chunk_encoder(options: MP3EncoderOptions, chunk: int):
    """jit-compiled chunk encoder (the `chunk` length is set by the caller's
    array shapes; one compiled program per distinct T).

    Cached per options value: sessions with equal options share one traced
    callable, so e.g. a fuzz suite creating many short-lived sessions pays
    one trace+compile per distinct (options, shape), not per session."""
    return _cached_chunk_encoder(options)


_GRANULE_FIELDS = (
    "part23",
    "big_values",
    "gain",
    "block_type",
    "preflag",
    "region0",
    "region1",
)


def fetch_outputs(outs, options: MP3EncoderOptions) -> dict:
    """Transfer the packed chunk output to host and unpack to named arrays
    (all BATCH-MAJOR, [B, T, ...], matching the device layout)."""
    n_gran = options.n_granules * options.channels
    packed = np.asarray(outs["packed"])
    cap = main_data_cap(options)
    main_data = packed[..., :cap]
    meta = packed[..., cap:].copy().view(np.int32)
    B, T = meta.shape[0], meta.shape[1]
    d = {
        "bitrate_index": meta[..., 0],
        "padding": meta[..., 1],
        "mdb": meta[..., 2],
        "slot": meta[..., 3],
        "main_data": main_data,
    }
    o = 4
    for name in _GRANULE_FIELDS:
        d[name] = meta[..., o : o + n_gran]
        o += n_gran
    d["subblock_gain"] = meta[..., o : o + 3 * n_gran].reshape(B, T, n_gran, 3)
    o += 3 * n_gran
    d["table_select"] = meta[..., o : o + 3 * n_gran].reshape(B, T, n_gran, 3)
    o += 3 * n_gran
    d["count1table"] = meta[..., o : o + n_gran]
    o += n_gran
    d["scalefac_compress"] = meta[..., o : o + n_gran]
    o += n_gran
    d["scfsi"] = meta[..., o : o + options.channels]  # [B, T, ch] nibbles
    o += options.channels
    d["mode_ext"] = meta[..., o]  # [B, T] per-frame header mode_extension
    # per-frame main_data byte counts (incl. part2 scalefactor bits when
    # real_scalefactors is on); pack truncation is checked by renderers
    d["hb"] = (d["part23"].sum(axis=-1) + 7) // 8
    return d


def frame_results_from_outputs(
    outs: dict, options: MP3EncoderOptions, t: int, b: int
) -> FrameResult:
    """Convert one (stream, time) slice of stacked chunk outputs to a
    FrameResult for the host assembler (outputs are batch-major)."""
    ch = options.channels
    n_gr = options.n_granules
    n_gran = n_gr * ch
    granules = [[None] * ch for _ in range(n_gr)]
    for g in range(n_gran):
        gr, c = divmod(g, ch)
        block = int(outs["block_type"][b, t, g])
        granules[gr][c] = GranuleInfo(
            part23_length=int(outs["part23"][b, t, g]),
            big_values=int(outs["big_values"][b, t, g]),
            global_gain=int(outs["gain"][b, t, g]),
            scalefac_compress=int(outs["scalefac_compress"][b, t, g]),
            window_switching=0 if block == dsp.BLOCK_LONG else 1,
            # iso_short_blocks: ISO encoding block_type=2 + mixed_block_flag
            # (the reference's raw enum signals mixed as block_type=1 =
            # ISO "start"; see GoldenBackend twin). window_sequencing's
            # transition granules map to ISO header values (START->1,
            # STOP->3).
            block_type=(
                1
                if block == dsp.BLOCK_START
                else 3
                if block == dsp.BLOCK_STOP
                else 2
                if (options.iso_short_blocks and block == dsp.BLOCK_MIXED)
                else block
            ),
            mixed_block_flag=1 if block == dsp.BLOCK_MIXED else 0,
            table_select=tuple(int(x) for x in outs["table_select"][b, t, g]),
            subblock_gain=tuple(int(x) for x in outs["subblock_gain"][b, t, g]),
            region0_count=int(outs["region0"][b, t, g]),
            region1_count=int(outs["region1"][b, t, g]),
            preflag=int(outs["preflag"][b, t, g]),
            # 1 iff real_scalefactors: the encoder amplifies amplitudes by
            # 2^sf, which the ISO factor 2^(-(1+scalefac_scale)/2 * sf)
            # cancels exactly at scalefac_scale=1 (ISO 2.4.3.4.7.1).
            scalefac_scale=1 if options.real_scalefactors else 0,
            count1table_select=int(outs["count1table"][b, t, g]),
        )
    hb = int(outs["hb"][b, t])
    cap = outs["main_data"].shape[-1]
    if hb > cap:
        raise RuntimeError(
            f"frame main_data ({hb} B) exceeds the device pack cap ({cap} B); "
            "rate-loop overflow beyond the reservoir bound — raise "
            "main_data_cap for this configuration"
        )
    return FrameResult(
        bitrate_index=int(outs["bitrate_index"][b, t]),
        padding=int(outs["padding"][b, t]),
        main_data_begin=int(outs["mdb"][b, t]),
        slot_size=int(outs["slot"][b, t]),
        granules=granules,
        big_values=np.asarray(outs["big_values"][b, t], dtype=np.int32),
        main_data=outs["main_data"][b, t, :hb].tobytes(),
        scfsi=[
            [(int(outs["scfsi"][b, t, c]) >> (3 - g)) & 1 for g in range(4)]
            for c in range(ch)
        ],
        mode_ext=int(outs["mode_ext"][b, t]),
    )


class JaxBackend:
    """Single-stream session backend: fixed-size jitted chunks of frames.

    Keeps the carry on device between calls; pads partial chunks with
    valid=False lanes so there is exactly one compiled program.
    """

    CHUNK = 8

    def __init__(self, options: MP3EncoderOptions):
        self.options = options
        self._run = make_chunk_encoder(options, self.CHUNK)
        self.carry = init_carry(1, options)

    def encode_frames(
        self,
        frames: np.ndarray,
        is_final: np.ndarray,
        lookahead: np.ndarray = None,
    ) -> List[FrameResult]:
        n = self.options.samples_per_frame * self.options.channels
        F = len(frames)
        results: List[FrameResult] = []
        la_n = SAMPLES_PER_GRANULE * self.options.channels
        for start in range(0, F, self.CHUNK):
            count = min(self.CHUNK, F - start)
            pcm = np.zeros((1, self.CHUNK, n), dtype=np.float32)
            fin = np.zeros((1, self.CHUNK), dtype=bool)
            val = np.zeros((1, self.CHUNK), dtype=bool)
            pcm[0, :count] = frames[start : start + count]
            fin[0, :count] = is_final[start : start + count]
            val[0, :count] = True
            if self.options.window_sequencing:
                la = np.zeros((1, self.CHUNK, la_n), dtype=np.float32)
                if lookahead is not None:
                    la[0, :count] = lookahead[start : start + count]
                self.carry, outs = self._run(self.carry, pcm, fin, val, la)
            else:
                self.carry, outs = self._run(self.carry, pcm, fin, val)
            outs = fetch_outputs(outs, self.options)
            for t in range(count):
                results.append(frame_results_from_outputs(outs, self.options, t, 0))
        return results

    def notify_flush(self) -> None:
        fifo = np.asarray(self.carry["slot_fifo"]).copy()  # [B, K]
        for key in ("stream_len", "est_stream_len"):
            sl = np.asarray(self.carry[key]).copy()
            for k in range(fifo.shape[1]):  # drain oldest-first
                sl = np.maximum(sl - fifo[:, k], 0)
            self.carry[key] = jnp.asarray(sl)
        self.carry["slot_fifo"] = jnp.zeros_like(self.carry["slot_fifo"])

    def state_dict(self) -> dict:
        """The scan-carry pytree IS the checkpoint (SURVEY.md §5)."""
        return {k: np.asarray(v) for k, v in self.carry.items()}

    def load_state_dict(self, state: dict) -> None:
        self.carry = {k: jnp.asarray(v) for k, v in state.items()}
        if "slot_fifo" not in self.carry and "prev_slot" in self.carry:
            # pre-depth checkpoint: one buffered frame at most
            ps = np.asarray(self.carry.pop("prev_slot"))
            hb = np.asarray(self.carry.pop("has_buffered"))
            K = self.options.reservoir_depth
            fifo = np.zeros((ps.shape[0], K), dtype=np.int32)
            fifo[:, -1] = np.where(hb, ps, 0)
            self.carry["slot_fifo"] = jnp.asarray(fifo)
        if "seq_prev_short" in self.carry and "seq_prev_want" not in self.carry:
            # pre-hangover checkpoint: no raw-want carry was saved
            self.carry["seq_prev_want"] = jnp.zeros_like(
                self.carry["seq_prev_short"]
            )
        if "seq_prev_short" in self.carry and "onset_prev2" not in self.carry:
            # pre-round-4 checkpoint: no onset-chain carry was saved
            B = self.carry["seq_prev_short"].shape[0]
            self.carry["onset_prev2"] = jnp.full(
                (B, self.options.channels, 2), jnp.inf, dtype=jnp.float32
            )
