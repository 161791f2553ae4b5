"""Batched granule DSP: fixed-shape jnp programs over [N, ...] tensors.

Accelerator reformulation of the reference's per-granule scalar pipeline
(SURVEY.md §7): all 36 filterbank window positions of a frame are computed as
one windowed-sum + [64,32] matmul; long/short/mixed MDCT are three fixed
matmuls selected by masks; aliasing butterflies are a static slice/concat
pattern (the 31 boundaries touch disjoint coefficients); the reference's
sequential <=20-iteration gain walk (MP3Encoder.swift:734-794) becomes a
vectorized 20-candidate gain sweep whose selection rule replicates the walk's
exact stopping semantics, including its overflow quirks.

Everything here is batch-leading and jit-friendly: no data-dependent shapes,
matmuls in float32 at highest precision (integer outputs are the parity
surface; bf16 would flip quantization decisions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..options import SUBBANDS
from ..tables import (
    ALIASING_CA,
    ALIASING_CS,
    ANALYSIS_MATRIX,
    BITRATE_TABLE_V1,
    BITRATE_TABLE_V2,
    ISO_WINDOW,
    LONG_MDCT_MATRIX,
    LONG_WINDOW,
    SHORT_MDCT_MATRIX,
    SHORT_WINDOW,
    START_WINDOW,
    STOP_WINDOW,
    TABLE15_LEN,
    band_table,
)

_F32 = jnp.float32
_HIGHEST = jax.lax.Precision.HIGHEST

# --- Precomputed constants ---------------------------------------------------

# Reversal folded into constants (see polyphase_frame): the reference reverses
# the 512 buffer before windowing (MP3Encoder.swift:1386-1389); equivalently
# window with W[511-i] and matrix with M[k, 63-j] on the unreversed buffer.
_WINDOW_REV = jnp.asarray(ISO_WINDOW[::-1].copy())  # [512]
_MATRIX_REV_T = jnp.asarray(ANALYSIS_MATRIX[:, ::-1].T.copy())  # [64, 32]

_LONG_WIN = jnp.asarray(LONG_WINDOW)  # [36]
_LONG_MAT_T = jnp.asarray(LONG_MDCT_MATRIX.T.copy())  # [36, 18]
_SHORT_WIN = jnp.asarray(SHORT_WINDOW)  # [12]
_SHORT_MAT_T = jnp.asarray(SHORT_MDCT_MATRIX.T.copy())  # [12, 6]
_CS = jnp.asarray(ALIASING_CS)  # [8]
_CA = jnp.asarray(ALIASING_CA)  # [8]
_T15_LEN = jnp.asarray(TABLE15_LEN.astype(np.int32))  # [256]

BLOCK_LONG = 0
BLOCK_MIXED = 1
BLOCK_SHORT = 2
# window_sequencing transition windows (twins of reference.BLOCK_START/STOP;
# long layout everywhere except the switching 36/576 entropy regions)
BLOCK_START = 3
BLOCK_STOP = 4

N_GAIN_CANDIDATES = 20  # the reference's maxIterations (MP3Encoder.swift:745)

# Strict walk respec anchors: law + rationale in ops.reference (the spec).
from .reference import (  # noqa: E402
    LSF_NSF_LONG,
    LSF_NSF_MIXED,
    LSF_NSF_SHORT,
    OFFSET_RATIO,
    ONSET_RATIO,
    STRICT_ANCHORS,
    _anchor_segment,
)

# Sequencing want-detector ratios: the golden module owns the knobs (and
# their sweep records); the device twins bake them at trace time.
ONSET_RATIO_F = float(ONSET_RATIO)
OFFSET_RATIO_F = float(OFFSET_RATIO)


def _quantizer_step_tables() -> tuple[np.ndarray, np.ndarray]:
    """Per-gain quantizer steps, computed exactly as the reference does
    (float64 2^((g-210)/4), floored at 1e-4, cast to float32; inverse taken
    in float32 — MP3Encoder.swift:798-800). A 256-entry table removes any
    exp/pow transcendental mismatch between backends."""
    g = np.arange(256, dtype=np.float64)
    step = np.maximum(2.0 ** ((g - 210.0) / 4.0), 0.0001).astype(np.float32)
    inv = (np.float32(1.0) / step).astype(np.float32)
    return step, inv


_STEP_TABLE_NP, _INV_STEP_TABLE_NP = _quantizer_step_tables()
_INV_STEP_TABLE = jnp.asarray(_INV_STEP_TABLE_NP)


# --- Gather-free lookups -----------------------------------------------------
# The hot table lookups (~100M per chunk) are fused elementwise computations
# rather than gathers (whether gathers win on the GPU is not measured yet):
#  - table-15 lengths: 4-bit values nibble-packed into 32 uint32 words,
#    selected with a 5-level binary where-tree + variable shift (~33 VPU ops
#    per element, fully fusable).
#  - quantizer inverse steps: 2^((g-210)/4) factors exactly as
#    2^q * 2^(frac/4); power-of-two scaling is exact in float32, so
#    ldexp(1/2^(frac/4), -q) reproduces the float64-built table bit-exactly
#    (asserted below at import time).


def _pack_nibbles(values: np.ndarray) -> np.ndarray:
    assert values.max() < 16 and len(values) % 8 == 0
    words = np.zeros(len(values) // 8, dtype=np.uint32)
    for i, v in enumerate(values):
        words[i // 8] |= np.uint32(int(v) << ((i % 8) * 4))
    return words


_T15_LEN_WORDS = _pack_nibbles(TABLE15_LEN)  # 32 uint32 words


def _select_tree(idx: jax.Array, values: np.ndarray, lo: int, hi: int) -> jax.Array:
    """Balanced binary where-tree: values[idx] for constant `values`."""
    if hi - lo == 1:
        return jnp.full(idx.shape, int(values[lo]), dtype=jnp.uint32)
    mid = (lo + hi) // 2
    return jnp.where(
        idx < mid, _select_tree(idx, values, lo, mid), _select_tree(idx, values, mid, hi)
    )


def _nibble_lookup(words: np.ndarray, idx: jax.Array) -> jax.Array:
    """values[idx] for 4-bit values nibble-packed into uint32 `words`."""
    word = _select_tree(idx >> 3, words, 0, len(words))
    shift = ((idx & 7) * 4).astype(jnp.uint32)
    return ((word >> shift) & 15).astype(jnp.int32)


def t15_length_lookup(idx: jax.Array) -> jax.Array:
    """TABLE15_LEN[idx] for idx in [0, 256), gather-free."""
    return _nibble_lookup(_T15_LEN_WORDS, idx)


def _inv_quarter_constants() -> np.ndarray:
    # f32(1.0) / f32(2^(frac/4)) for frac = 0..3, matching the table build.
    c = (2.0 ** (np.arange(4) / 4.0)).astype(np.float32)
    return (np.float32(1.0) / c).astype(np.float32)


_INV_QUARTER = _inv_quarter_constants()
_INV_STEP_FLOOR = np.float32(1.0) / np.float32(0.0001)  # gain < 157 regime


def inv_step_lookup(gains: jax.Array) -> jax.Array:
    """float32 1/step for integer gains in [0, 255], gather-free.

    step = f32(max(2^((g-210)/4), 1e-4)) built in float64; the power-of-two
    factorization makes the float32 reconstruction exact (validated against
    the table at import time)."""
    d = gains - 210
    q = d >> 2  # floor division (d can be negative)
    frac = d - (q << 2)  # 0..3
    c0, c1, c2, c3 = (float(x) for x in _INV_QUARTER)
    invc = jnp.where(
        frac < 2,
        jnp.where(frac == 0, c0, c1),
        jnp.where(frac == 2, c2, c3),
    ).astype(jnp.float32)
    val = jnp.ldexp(invc, -q).astype(jnp.float32)
    return jnp.where(gains < 157, _INV_STEP_FLOOR, val)


# --- ISO unit-gain quantizer (options.iso_quantization) -----------------------
# step^-0.75 = 2^(-3(g-210)/16): sixteenth-power constants + exact ldexp.
# For g < 157 the step floors at 1e-4, so inv34 = f32(f64(1e-4)^-0.75).

def _iso_inv_step34_table() -> np.ndarray:
    g = np.arange(256, dtype=np.float64)
    step = np.maximum(2.0 ** ((g - 210.0) / 4.0), 0.0001)
    return (step ** -0.75).astype(np.float32)


_INV_STEP34_NP = _iso_inv_step34_table()
_SIXTEENTH = (2.0 ** (np.arange(16) / 16.0)).astype(np.float32)  # 2^(r/16)
_INV_STEP34_FLOOR = float(np.float64(0.0001) ** -0.75)  # == 1000.0 in f32


def inv_step34_lookup(gains: jax.Array, floor: bool = True) -> jax.Array:
    """float32 step^-0.75 for integer gains in [0, 255], gather-free
    (exactness vs the float64-built table validated at import/test time).

    floor=False drops the reference's 1e-4 step floor (gain < 157 regime)
    — the pure ISO step the linbits law quantizes with (twin:
    reference.ISO_INV_STEP34_NOFLOOR; the floor would bake a level error
    into streams decoded with the true 2^((g-210)/4))."""
    e = -3 * (gains - 210)
    q = e >> 4
    r = e - (q << 4)  # 0..15
    c = _select_tree(r, _SIXTEENTH.view(np.uint32), 0, 16)
    invc = jax.lax.bitcast_convert_type(c, jnp.float32)
    val = jnp.ldexp(invc, q).astype(jnp.float32)
    if not floor:
        return val
    return jnp.where(gains < 157, jnp.float32(_INV_STEP34_FLOOR), val)


def validate_gather_free_lookups() -> None:
    """Assert the arithmetic lookups reproduce the tables exactly (called
    from tests; cheap)."""
    g = np.arange(256, dtype=np.int32)
    got = np.asarray(inv_step_lookup(jnp.asarray(g)))
    assert np.array_equal(got, _INV_STEP_TABLE_NP), "inv_step_lookup mismatch"
    got34 = np.asarray(inv_step34_lookup(jnp.asarray(g)))
    assert np.array_equal(got34, _INV_STEP34_NP), "inv_step34_lookup mismatch"
    from .reference import ISO_INV_STEP34_NOFLOOR

    got34nf = np.asarray(inv_step34_lookup(jnp.asarray(g), floor=False))
    assert np.array_equal(
        got34nf, ISO_INV_STEP34_NOFLOOR
    ), "inv_step34_lookup(floor=False) mismatch"
    idx = np.arange(256, dtype=np.int32)
    got_len = np.asarray(t15_length_lookup(jnp.asarray(idx)))
    assert np.array_equal(got_len, TABLE15_LEN), "t15_length_lookup mismatch"


# --- Polyphase analysis filterbank ------------------------------------------


def polyphase_frame(hist: jax.Array, pcm: jax.Array) -> tuple[jax.Array, jax.Array]:
    """All 36 filterbank outputs of one frame in one shot.

    hist: [..., 480] trailing PCM history; pcm: [..., 1152] new samples.
    Returns (S [..., 36, 32] subband samples, new hist [..., 480]).

    Equivalent to 36 sequential 32-sample steps of the ISO filterbank
    (MP3Encoder.swift:1367-1411): window t covers x[32t : 32t+512] of the
    concatenated (hist | pcm) signal.
    """
    x = jnp.concatenate([hist, pcm], axis=-1)  # [..., 1632]
    windows = jnp.stack(
        [jax.lax.slice_in_dim(x, t * 32, t * 32 + 512, axis=-1) for t in range(36)],
        axis=-2,
    )  # [..., 36, 512]
    windowed = windows * _WINDOW_REV
    partial_sums = windowed.reshape(*windowed.shape[:-1], 8, 64).sum(axis=-2)
    S = jnp.matmul(partial_sums, _MATRIX_REV_T, precision=_HIGHEST)  # [..., 36, 32]
    new_hist = jax.lax.slice_in_dim(x, 1152, 1632, axis=-1)
    return S.astype(_F32), new_hist


_W8 = jnp.asarray(ISO_WINDOW[::-1].copy().reshape(8, 64))  # [8, 64] reversed window


def polyphase_chunk(hist: jax.Array, pcm: jax.Array) -> tuple[jax.Array, jax.Array]:
    """All filterbank outputs of a whole chunk of frames in one shot.

    hist: [..., 480]; pcm: [..., T*1152]. Returns (S [..., 36T, 32],
    full signal x [..., 480 + T*1152] for carry-out gathering).

    Key reformulation: window position t needs x[32t : 32t+512], and the
    partial sum is partial[t, j] = sum_m x[32(t+2m) + j] * Wrev[64m + j]
    (j < 64). With A = x reshaped to 32-sample rows and Y[u] = (A[u], A[u+1])
    the whole chunk is 8 shifted multiply-adds on Y plus one [64,32] matmul —
    no sequential state, no 512-wide window materialization.
    """
    x = jnp.concatenate([hist, pcm], axis=-1)
    n_steps = x.shape[-1] // 32  # 15 + 36T
    T36 = n_steps - 15
    A = x.reshape(*x.shape[:-1], n_steps, 32)
    Y = jnp.concatenate([A[..., :-1, :], A[..., 1:, :]], axis=-1)  # [..., n-1, 64]
    partial = None
    for m in range(8):
        term = jax.lax.slice_in_dim(Y, 2 * m, 2 * m + T36, axis=-2) * _W8[m]
        partial = term if partial is None else partial + term
    S = jnp.matmul(partial, _MATRIX_REV_T, precision=_HIGHEST)  # [..., 36T, 32]
    return S.astype(_F32), x


def _build_polyphase_fold() -> list[np.ndarray]:
    """Fold reversed-window x cosine-matrix into five [128, 128] matrices.

    S[pos, k] = sum_u x[32*pos + u] * C[u, k], C[u, k] =
    Wrev[u] * MrevT[u % 64, k] (u < 512). Packing x into 128-sample rows and
    4 window positions per output row (pos = 4r + c -> out col c*32 + k)
    gives S4[r] = sum_d row[r+d] @ C3[d] — [*, 128] x [128, 128] matmuls
    instead of the K=32/N=32 shapes of the stepwise form.
    """
    Wrev = np.asarray(ISO_WINDOW[::-1], dtype=np.float64)  # [512]
    MrevT = np.asarray(ANALYSIS_MATRIX[:, ::-1].T, dtype=np.float64)  # [64, 32]
    C = Wrev[:, None] * MrevT[np.arange(512) % 64]  # [512, 32]
    mats = []
    for d in range(5):
        M = np.zeros((128, 128))
        for c in range(4):
            for l in range(128):
                u = 128 * d + l - 32 * c
                if 0 <= u < 512:
                    M[l, c * 32 : (c + 1) * 32] = C[u]
        mats.append(M.astype(np.float32))
    return mats


_POLY_FOLD = [jnp.asarray(m) for m in _build_polyphase_fold()]


def polyphase_chunk_matmul(
    hist: jax.Array, pcm: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """polyphase_chunk via five folded [128, 128] matmuls (same contract:
    returns (S [..., 36T, 32], full signal x); 36T is a multiple of 4 for
    every integer T, so the 4-positions-per-row packing is always exact).
    ULP-level differences from the stepwise form only (constant fold + one
    dot-accumulation order); integer parity pinned by fixtures/stream tests.
    """
    x_full = jnp.concatenate([hist, pcm], axis=-1)
    L = x_full.shape[-1]
    T36 = (L - 480) // 32
    # LSF chunks have 18 windows/frame, so T36 % 4 can be 2 (odd T): pad
    # the signal with zero windows to the 4-per-row packing and slice the
    # extra rows off the output (the padded windows are never consumed).
    n_pad = (-T36) % 4
    if n_pad:
        x_full_p = jnp.pad(
            x_full, [(0, 0)] * (x_full.ndim - 1) + [(0, 32 * n_pad)]
        )
        L += 32 * n_pad
    else:
        x_full_p = x_full
    R_out = (T36 + n_pad) // 4
    x = jnp.pad(x_full_p, [(0, 0)] * (x_full_p.ndim - 1) + [(0, 32)])
    A = x.reshape(*x.shape[:-1], (L + 32) // 128, 128)
    S4 = None
    for d in range(5):
        term = jnp.matmul(
            jax.lax.slice_in_dim(A, d, d + R_out, axis=-2),
            _POLY_FOLD[d],
            precision=_HIGHEST,
        )
        S4 = term if S4 is None else S4 + term
    S = S4.reshape(*S4.shape[:-2], T36 + n_pad, 32)
    if n_pad:
        S = jax.lax.slice_in_dim(S, 0, T36, axis=-2)
    return S.astype(_F32), x_full


# --- MDCT + aliasing reduction ----------------------------------------------


def _freq_inversion_sign() -> jax.Array:
    """[18, 32] sign pattern: -1 where (within-granule time index odd) and
    (subband odd) — MP3Encoder.swift:1520-1524."""
    t_odd = (np.arange(18) % 2 == 1)[:, None]
    sb_odd = (np.arange(32) % 2 == 1)[None, :]
    return jnp.asarray(np.where(t_odd & sb_odd, -1.0, 1.0).astype(np.float32))


_INV_SIGN = _freq_inversion_sign()


def _mdct_long_batch(combined: jax.Array) -> jax.Array:
    """combined [..., 32, 36] -> [..., 32, 18]."""
    windowed = combined * _LONG_WIN
    return (
        jnp.matmul(windowed, _LONG_MAT_T, precision=_HIGHEST) / _F32(9.0)
    ).astype(_F32)


def _mdct_short_batch(combined: jax.Array) -> jax.Array:
    """combined [..., 32, 36] -> [..., 32, 18] with output index w + 3m
    (MP3Encoder.swift:1639-1662)."""
    outs = []
    for w in range(3):
        offset = w * 6 + 6
        ws = jax.lax.slice_in_dim(combined, offset, offset + 12, axis=-1) * _SHORT_WIN
        outs.append(
            (jnp.matmul(ws, _SHORT_MAT_T, precision=_HIGHEST) / _F32(3.0)).astype(_F32)
        )
    stacked = jnp.stack(outs, axis=-1)  # [..., 32, 6(m), 3(w)]
    return stacked.reshape(*stacked.shape[:-2], 18)  # index = 3m + w


def _aliasing_reduce(spec: jax.Array) -> jax.Array:
    """ISO Table B.9 butterflies across the 31 subband boundaries.

    spec: [..., 32, 18]. All butterflies touch disjoint coefficients
    (positions 10..17 of subband sb and 0..7 of sb+1), so they are applied
    fully in parallel (MP3Encoder.swift:1581-1616).
    """
    upper = spec[..., :31, 17:9:-1]  # [..., 31, 8] = positions 17,16,...,10
    lower = spec[..., 1:, 0:8]  # [..., 31, 8]
    new_upper = lower * _CA + upper * _CS
    new_lower = lower * _CS - upper * _CA

    # Rebuild: positions 0..7 come from the boundary below (subbands 1..31),
    # 8..9 unchanged, 10..17 from the boundary above (subbands 0..30).
    lo = jnp.concatenate([spec[..., :1, 0:8], new_lower], axis=-2)  # [..., 32, 8]
    hi_rev = jnp.concatenate(
        [new_upper[..., ::-1], spec[..., 31:, 10:18]], axis=-2
    )  # [..., 32, 8] in position order 10..17
    return jnp.concatenate([lo, spec[..., 8:10], hi_rev], axis=-1)


def mdct_frame(
    S: jax.Array, overlap: jax.Array, block_type: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """MDCT for both granules of a frame.

    S: [..., 36, 32] subband samples (both granules); overlap: [..., 32, 18]
    carried from the previous frame (stored post-frequency-inversion, as the
    reference does — MP3Encoder.swift:1534-1539); block_type: [..., 2] int.
    Returns (spectra [..., 2, 576] subband-major, new overlap [..., 32, 18]).
    """
    g = S.reshape(*S.shape[:-2], 2, 18, 32) * _INV_SIGN  # [..., 2, 18, 32]
    cur = jnp.swapaxes(g, -1, -2)  # [..., 2, 32, 18]
    cur0 = cur[..., 0, :, :]
    cur1 = cur[..., 1, :, :]
    prev = jnp.stack([overlap, cur0], axis=-3)  # [..., 2, 32, 18]
    combined = jnp.concatenate([prev, cur], axis=-1)  # [..., 2, 32, 36]

    long_coeffs = _mdct_long_batch(combined)
    short_coeffs = _mdct_short_batch(combined)

    bt = block_type[..., None]  # [..., 2, 1]
    sb_idx = jnp.arange(SUBBANDS, dtype=jnp.int32)
    use_long = (bt == BLOCK_LONG) | ((bt == BLOCK_MIXED) & (sb_idx < 2))
    coeffs = jnp.where(use_long[..., None], long_coeffs, short_coeffs)

    reduced = _aliasing_reduce(coeffs)
    coeffs = jnp.where((bt == BLOCK_LONG)[..., None], reduced, coeffs)

    spectra = coeffs.reshape(*coeffs.shape[:-2], 576)
    return spectra, cur1


def _build_mdct_fold() -> dict:
    """Fold window x MDCT matrix x norm (x aliasing) into dense [576, 576]
    float64-built matrices over the flat (t*32 + sb) granule layout.

    The chunk MDCT then becomes plain `granule_flat @ M` matmuls with no
    [.., 32, 36] combined-window intermediates: rows are the granule's 576
    subband samples in filterbank order (free reshape of the [18, 32]
    filterbank output), columns are the spectrum's (sb*18 + m) layout.
    Subband independence makes the matrices block-sparse; zero terms add
    exactly 0.0 in f32, so the dense matmul sums only the real 36-term
    window like the two-step formulation (ULP-level grouping differences
    only — integer parity on the test surface is unchanged, enforced by the
    frozen fixtures and golden stream tests).
    """
    W36 = np.asarray(LONG_WINDOW, dtype=np.float64)  # [36]
    ML = np.asarray(LONG_MDCT_MATRIX, dtype=np.float64)  # [18, 36]
    SW = np.asarray(SHORT_WINDOW, dtype=np.float64)  # [12]
    MS = np.asarray(SHORT_MDCT_MATRIX, dtype=np.float64)  # [6, 12]

    # unaliased long law: out[sb*18+m] = sum_t combined[t]*W36[t]*ML[m,t]/9
    # prev rows cover combined positions 0..17, cur rows 18..35.
    blk_p = np.einsum("t,mt->tm", W36[:18], ML[:, :18]) / 9.0  # [18, 18]
    blk_c = np.einsum("t,mt->tm", W36[18:], ML[:, 18:]) / 9.0
    Lp = np.zeros((576, 576))
    Lc = np.zeros((576, 576))
    for sb in range(32):
        rows = np.arange(18) * 32 + sb
        cols = sb * 18 + np.arange(18)
        Lp[np.ix_(rows, cols)] = blk_p
        Lc[np.ix_(rows, cols)] = blk_c

    # aliasing butterflies as an in->out matrix over the (sb*18+m) space
    # (MP3Encoder.swift:1581-1616; see _aliasing_reduce)
    A = np.eye(576)
    cs = np.asarray(ALIASING_CS, dtype=np.float64)
    ca = np.asarray(ALIASING_CA, dtype=np.float64)
    for b in range(31):
        for i in range(8):
            pu = b * 18 + (17 - i)  # upper position of subband b
            pl = (b + 1) * 18 + i  # lower position of subband b+1
            A[pu, pu] = cs[i]
            A[pl, pu] = ca[i]
            A[pl, pl] = cs[i]
            A[pu, pl] = -ca[i]

    # short law: window w at combined offset 6w+6, out index 3m+w, /3 norm
    Sp = np.zeros((576, 576))
    Sc = np.zeros((576, 576))
    for w in range(3):
        for j in range(12):
            u = 6 * w + 6 + j
            tgt = Sp if u < 18 else Sc
            t = u if u < 18 else u - 18
            for m in range(6):
                wgt = SW[j] * MS[m, j] / 3.0
                for sb in range(32):
                    tgt[t * 32 + sb, sb * 18 + 3 * m + w] += wgt

    # Stack the three laws' columns side by side so the whole MDCT is ONE
    # (prev, cur) matmul pair of [.., 576] @ [576, 1188]: cols 0-575 the
    # aliased long law, 576-1151 the short law, 1152-1187 the mixed
    # granules' unaliased-long head (subbands 0-1). Column stacking keeps
    # every output dot product bit-identical to separate per-law matmuls.
    #
    # iso_mixed_alias (options.iso_short_blocks): the mixed head columns
    # get the subband-0/1 boundary butterfly folded in (Lp @ A1) — the one
    # boundary a conforming ISO decoder inverts for mixed blocks; the
    # compat head stays butterfly-free (reference law). Both laws' fold
    # shapes are identical, so the flag costs nothing at runtime.
    A1 = np.eye(576)
    for i in range(8):
        pu, pl = 17 - i, 18 + i  # subband 0 top / subband 1 bottom
        A1[pu, pu] = cs[i]
        A1[pl, pu] = ca[i]
        A1[pl, pl] = cs[i]
        A1[pu, pl] = -ca[i]
    MP = np.concatenate([Lp @ A, Sp, Lp[:, :36]], axis=1)
    MC = np.concatenate([Lc @ A, Sc, Lc[:, :36]], axis=1)
    MPi = np.concatenate([Lp @ A, Sp, (Lp @ A1)[:, :36]], axis=1)
    MCi = np.concatenate([Lc @ A, Sc, (Lc @ A1)[:, :36]], axis=1)

    # START/STOP (options.window_sequencing) as INPUT window ratios: each
    # transition window differs from LONG on exactly one half of the
    # 36-sample window (start: current half, stop: overlap half), and the
    # sine window has no zeros, so scaling that half's INPUT samples by
    # STW/W36 (resp. SPW/W36) per window position makes the existing
    # aliased long fold compute the transition law directly —
    # (cur * r) @ MC sums cur_t * (STW_t/W36_t) * (W36_t * ML) per column,
    # aliasing included by linearity. Two masked elementwise multiplies
    # replace the round-3 [18, 18] correction einsums + their separate
    # aliasing-reduce passes (which paid a [.., 32, 18] relayout and two
    # butterfly where-trees per chunk; measured ~2x the MDCT stage cost).
    # Ratios are benign: numerators are zero wherever the denominator is
    # small, max ratio ~1.13.
    STW = np.asarray(START_WINDOW, dtype=np.float64)
    SPW = np.asarray(STOP_WINDOW, dtype=np.float64)
    r_start = np.repeat(STW[18:] / W36[18:], 32)  # flat (t*32+sb), cur half
    r_stop = np.repeat(SPW[:18] / W36[:18], 32)  # flat (t*32+sb), prev half

    f32 = lambda x: jnp.asarray(x.astype(np.float32))  # noqa: E731
    return {
        "p": f32(MP),
        "c": f32(MC),
        "p_iso": f32(MPi),
        "c_iso": f32(MCi),
        "r_start": f32(r_start),
        "r_stop": f32(r_stop),
    }


_MDCT_FOLD = _build_mdct_fold()
_SIGN_FLAT = jnp.asarray(
    np.asarray(_freq_inversion_sign()).reshape(576)
)  # (t*32+sb) order


def mdct_chunk(
    S: jax.Array,
    overlap: jax.Array,
    block_type: jax.Array,
    iso_mixed_alias: bool = False,
    window_seq: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """MDCT for all 2T granules of a chunk at once (folded-matrix form).

    S: [..., 36T, 32]; overlap: [..., 576] carried into the chunk — the
    previous granule's frequency-inverted subband samples in flat
    (t*32 + sb) order; block_type: [..., 2T]. The overlap chain across
    granules is just 'previous granule's inverted samples', so the whole
    chunk is parallel: prev_g = cur_{g-1} with g = -1 the incoming overlap
    (MP3Encoder.swift:1512-1616).

    Each law (long+aliasing, short, mixed's unaliased-long head) is one
    dense [576, 576] matmul pair over (prev, cur) — see _build_mdct_fold.
    Returns (spectra [..., 2T, 576], signed [..., 2T, 576] post-inversion
    subband samples; select index 2*valid_count - 1 for the carry-out).
    """
    lead = S.shape[:-2]
    n_gran = S.shape[-2] // 18
    flat = S.reshape(*lead, n_gran, 576)  # free: rows are (t, sb)
    signed = flat * _SIGN_FLAT
    # prev_g = signed_{g-1}: slice one padded buffer instead of concatenating
    # a shifted copy — XLA reads `ext` twice (offset 0 and 1), no extra
    # 2T x 576 materialization.
    ext = jnp.concatenate([overlap[..., None, :], signed], axis=-2)
    prev = jax.lax.slice_in_dim(ext, 0, n_gran, axis=-2)
    cur = jax.lax.slice_in_dim(ext, 1, n_gran + 1, axis=-2)

    mp = _MDCT_FOLD["p_iso" if iso_mixed_alias else "p"]
    mc = _MDCT_FOLD["c_iso" if iso_mixed_alias else "c"]
    if window_seq:
        # START/STOP via input window ratios (see _build_mdct_fold): the
        # fold's aliased long columns then compute the transition law for
        # those granules; short/head columns see scaled inputs but are
        # never selected for START/STOP granules.
        bt_in = block_type[..., None]
        mul_c = jnp.where(bt_in == BLOCK_START, _MDCT_FOLD["r_start"], _F32(1.0))
        mul_p = jnp.where(bt_in == BLOCK_STOP, _MDCT_FOLD["r_stop"], _F32(1.0))
        prev = prev * mul_p
        cur = cur * mul_c
    all_laws = jnp.matmul(prev, mp, precision=_HIGHEST) + jnp.matmul(
        cur, mc, precision=_HIGHEST
    )
    long_aliased = all_laws[..., :576]
    short = all_laws[..., 576:1152]
    head36 = all_laws[..., 1152:]

    bt = block_type[..., None]
    out = jnp.where(bt == BLOCK_LONG, long_aliased, short)
    # mixed: unaliased long for subbands 0-1, short above
    mixed = jnp.concatenate([head36, short[..., 36:]], axis=-1)
    out = jnp.where(bt == BLOCK_MIXED, mixed, out)
    if window_seq:
        # START/STOP inputs were ratio-scaled above, so the aliased long
        # output IS the transition law for those granules.
        out = jnp.where(
            (bt == BLOCK_START) | (bt == BLOCK_STOP), long_aliased, out
        )
    return out.astype(_F32), signed


# --- Transient detection -----------------------------------------------------


def transient_frame(granule_pcm: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Block-type decision per granule (MP3Encoder.swift:1944-1968).

    granule_pcm: [..., 2, 576]. Returns (block_type [..., 2] int32,
    subblock_gain [..., 2, 3] int32).
    """
    sub = granule_pcm.reshape(*granule_pcm.shape[:-1], 3, 192)
    energies = jnp.sum(sub * sub, axis=-1) / _F32(192.0)  # [..., 2, 3]
    emax = jnp.max(energies, axis=-1)
    emin = jnp.min(energies, axis=-1)
    ratio = emax / jnp.maximum(emin, _F32(1e-4))
    first_loudest = jnp.argmax(energies, axis=-1) == 0  # first-tie, as Swift
    block = jnp.where(
        ratio > _F32(6.0),
        jnp.where(first_loudest, BLOCK_MIXED, BLOCK_SHORT),
        BLOCK_LONG,
    ).astype(jnp.int32)
    normalized = jnp.clip(
        energies / jnp.maximum(emax[..., None], _F32(1e-4)), 0.0, 1.0
    )
    gain = jnp.trunc((_F32(1.0) - normalized) * _F32(7.0)).astype(jnp.int32)
    return block, gain


def onset_wants_chunk(
    granules: jax.Array, prev2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Chunk-level onset/drop want detector (twin of reference._onset_fires
    round-4 law; reference.ONSET_RATIO / OFFSET_RATIO document the two
    criteria and their sweeps). The 96-block energy chain runs ACROSS
    granule boundaries: prev2 carries the previous chunk's last two block
    energies (+inf = unknown past — no rise baseline, no phantom drops).

    - rise: block b fires granule b//6 when e[b] > ONSET x min of the two
      preceding chain blocks (a point-onset straddles at most two blocks);
    - drop: loud block l fires granule (l+2)//6 — the granule holding the
      quiet AFTERMATH — when e[l] > OFFSET x min of the two following
      blocks (the hangover then pushes the STOP window past the loud
      tail; see the golden law's measured post-echo numbers).

    granules: [..., G, 576] raw PCM per granule (per channel);
    prev2: [..., 2]. Returns (wants [..., G] bool, tails [..., G, 2] —
    every granule's trailing two block energies: tails[..., g, :] is
    granule g+1's prev2, and the caller one-hot selects the last VALID
    granule's tails as the next chunk's carry)."""
    lead = granules.shape[:-2]
    G = granules.shape[-2]
    sub = granules.reshape(*lead, G * 6, 96)
    e = jnp.sum(sub * sub, axis=-1) / _F32(96.0)  # [..., 6G]
    chain = jnp.concatenate([prev2.astype(jnp.float32), e], axis=-1)
    # rise: e[b] vs min(chain[b], chain[b+1]) (chain index of e[b] is b+2)
    base = jnp.minimum(chain[..., :-2], chain[..., 1:-1])  # [..., 6G]
    rise = e > _F32(ONSET_RATIO_F) * jnp.maximum(base, _F32(1e-4))
    wants = jnp.any(rise.reshape(*lead, G, 6), axis=-1)
    if OFFSET_RATIO_F > 0.0:
        # drop: loud chain[l+2]=e[l] vs min(e[l+1], e[l+2]); quiet side
        # beyond the chunk is unknown (+inf pad — the next chunk's chain
        # sees it through the carry, exactly like the golden per-granule
        # walk). Loud side includes the carried prev2 blocks (chain l=0,1
        # fire granule 0); +inf loud (unknown past) must not fire.
        inf_pad = jnp.full((*lead, 2), jnp.inf, dtype=jnp.float32)
        ext = jnp.concatenate([chain, inf_pad], axis=-1)  # [..., 6G+4]
        loud = ext[..., :-2]  # chain[l], l = 0..6G+1
        quiet = jnp.minimum(ext[..., 1:-1], ext[..., 2:])
        drop = jnp.isfinite(loud) & (
            loud > _F32(OFFSET_RATIO_F) * jnp.maximum(quiet, _F32(1e-4))
        )
        # drop at chain index l belongs to granule (l + 2 - 2) // 6 = l//6
        # in e-coordinates... golden: loud chain[j] of granule g sits at
        # e-index 6g + j - 2, j = 0..5 -> granule = (e_idx + 2) // 6; with
        # chain l = e_idx + 2 the granule is l // 6, l = 0..6G+1. Indices
        # l >= 6G fire nothing (quiet side is the +inf pad).
        drop6 = drop[..., : G * 6].reshape(*lead, G, 6)
        wants = wants | jnp.any(drop6, axis=-1)
    tails = e.reshape(*lead, G, 6)[..., 4:6]
    return wants, tails


def adaptive_lowpass_engage(spectra: jax.Array, cut_sb: int) -> jax.Array:
    """Per-granule adaptive-lowpass decision (twin of
    reference.adaptive_lowpass_engage; reference.ALP_FRAC/ALP_SFM document
    the law and calibration — this twin carries the same literals).
    Engage the cutoff where the high band is negligible (energy fraction
    < 1e-3) or noise-like (spectral flatness > 0.15); peaky harmonic high
    bands keep the full band. Both statistics are permutation-invariant,
    so the decision is layout-invariant across long/short/mixed granules.

    spectra: [..., 576] subband-major MDCT coefficients. Returns bool
    [...]."""
    spec = spectra.astype(jnp.float32)
    hb2 = spec[..., cut_sb * 18 :] ** 2
    m_hb = jnp.mean(hb2, axis=-1)
    m_tot = jnp.mean(spec * spec, axis=-1)
    frac = m_hb * _F32(hb2.shape[-1]) / jnp.maximum(
        m_tot * _F32(spec.shape[-1]), _F32(1e-30)
    )
    sfm = jnp.exp(jnp.mean(jnp.log(hb2 + _F32(1e-20)), axis=-1)) / (
        m_hb + _F32(1e-20)
    )
    return (frac < _F32(1e-3)) | (sfm > _F32(0.15))


def sequence_blocks_chunk(
    want: jax.Array,
    want_next: jax.Array,
    valid_g: jax.Array,
    prev_short: jax.Array,
    prev_want: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """ISO window sequencing over a chunk's granule sequence (twin of the
    GoldenBackend law: reference.sequence_block_type granule-by-granule on
    hangover-extended wants).

    Post-transient hangover: the effective want is the raw want OR the
    previous granule's raw want, so every short run extends one granule
    past the last transient and the STOP window never straddles loud
    content (post-echo — the measured dominant burst NMR source; see the
    GoldenBackend sequencing comment for the numbers).

    want/want_next/valid_g: [B, 2T] bool (shared-across-channels RAW short
    wants, the NEXT granule's raw want — the last granule's comes from the
    lookahead input — and the frame valid mask repeated per granule);
    prev_short/prev_want: [B] carries (previous granule's emitted-short
    state and raw want). Returns (block [B, 2T] int32, new prev_short,
    new prev_want). The recurrence is sequential (a sandwiched long
    granule joins the short run), but it is a [B]-wide boolean scan —
    negligible cost."""

    def step(carry, x):
        ps, pw = carry
        w_raw, wn_raw, v = x
        w = w_raw | pw  # hangover-extended want
        wn = wn_raw | w_raw  # next granule's hangover-extended want
        s = w | (ps & wn)
        bt = jnp.where(
            s,
            BLOCK_SHORT,
            jnp.where(wn, BLOCK_START, jnp.where(ps, BLOCK_STOP, BLOCK_LONG)),
        )
        new = (jnp.where(v, s, ps), jnp.where(v, w_raw, pw))
        return new, bt.astype(jnp.int32)

    (ps, pw), bts = jax.lax.scan(
        step, (prev_short, prev_want), (want.T, want_next.T, valid_g.T)
    )
    return bts.T, ps, pw


# --- Gain init, quantization sweep, bit counting -----------------------------


def initial_gain(spectrum: jax.Array, iso: bool = False) -> jax.Array:
    """210 + trunc(4*log2(peak^0.75/15)), clamped 0-255; 210 for silent
    granules (MP3Encoder.swift:989-1006). iso=True uses multiplier 16/3 (the
    unit-gain law's exponent is step^-0.75, see reference.compute_global_gain).
    """
    peak = jnp.max(jnp.abs(spectrum), axis=-1)
    peak_pow = jnp.power(peak, _F32(0.75))
    ratio = peak_pow / _F32(15.0)
    safe_ratio = jnp.maximum(ratio, _F32(1e-30))
    mult = _F32(16.0 / 3.0) if iso else _F32(4.0)
    gain = 210 + jnp.trunc(mult * jnp.log2(safe_ratio)).astype(jnp.int32)
    gain = jnp.clip(gain, 0, 255)
    return jnp.where(peak > 0, gain, 210).astype(jnp.int32)


def _count_bits_pairs(q: jax.Array) -> jax.Array:
    """Table-15 bit count per pair: code length + sign bits.

    q: [..., 576] int32. Returns per-pair bits [..., 288] int32.
    """
    x = q[..., 0::2]
    y = q[..., 1::2]
    ax = jnp.minimum(jnp.abs(x), 15)
    ay = jnp.minimum(jnp.abs(y), 15)
    lens = t15_length_lookup(ax * 16 + ay)  # gather-free LUT
    return lens + (ax != 0).astype(jnp.int32) + (ay != 0).astype(jnp.int32)


def _last_nonzero_count(q: jax.Array) -> jax.Array:
    """Count through the last nonzero coefficient: 0 if all zero."""
    idx = jnp.arange(1, q.shape[-1] + 1, dtype=jnp.int32)
    return jnp.max(jnp.where(q != 0, idx, 0), axis=-1)


def big_values_from_quantized(q: jax.Array) -> jax.Array:
    """min(((last_nonzero+1) & ~1) // 2, 288) (MP3Encoder.swift:692-700)."""
    last = _last_nonzero_count(q)
    significant = jnp.minimum((last + 1) & ~1, 576)
    return jnp.minimum(significant // 2, 288)


def quantize_at_gains(
    mag: jax.Array,
    sign_neg: jax.Array,
    gains: jax.Array,
    iso: bool = False,
    qcap: int = 15,
    floor: bool = True,
) -> jax.Array:
    """Quantize |x|^0.75 magnitudes at several gains.

    mag: [..., 576] precomputed max(|x|,1e-10)^0.75 (shared across gains —
    the reference recomputes the pow every iteration, but it is
    gain-independent); sign_neg: [..., 576] bool; gains: [..., K] int32.
    Returns q [..., K, 576] int32 (signed, clamped to +-qcap).

    iso=True multiplies by step^-0.75 instead of step^-1 — the unit-gain law
    (q = (|x|/step)^(3/4), options.iso_quantization); mag is unchanged since
    (|x|/step)^(3/4) = |x|^(3/4) * step^(-3/4). qcap/floor: the linbits law
    passes QCAP_LINBITS and floor=False (pure ISO step; see
    inv_step34_lookup).
    """
    if iso:
        inv = inv_step34_lookup(jnp.clip(gains, 0, 255), floor=floor)
    else:
        inv = inv_step_lookup(jnp.clip(gains, 0, 255))
    scaled = mag[..., None, :] * inv[..., :, None]
    q = jnp.minimum(jnp.floor(scaled + _F32(0.5)).astype(jnp.int32), qcap)
    return jnp.where(sign_neg[..., None, :], -q, q)


def _t15_sweep(
    mag: jax.Array,
    sign_neg: jax.Array,
    gstart: jax.Array,
    iso: bool,
    use_kernel: bool,
) -> tuple[jax.Array, jax.Array]:
    """20-candidate table-15 bit counts + big_values from precomputed
    magnitudes. Returns (bits [..., 20], bv [..., 20])."""
    if use_kernel:
        # fused GPU sweep (ops.pallas_kernels), equal to the jnp form below
        from .pallas_kernels import rate_sweep

        return rate_sweep(mag, gstart, iso=iso)
    gains = gstart[..., None] + 4 * jnp.arange(N_GAIN_CANDIDATES, dtype=jnp.int32)
    qk = quantize_at_gains(mag, sign_neg, gains, iso=iso)  # [..., 20, 576]
    pair_bits = _count_bits_pairs(qk)  # [..., 20, 288]
    bv = big_values_from_quantized(qk)  # [..., 20]
    pair_idx = jnp.arange(288, dtype=jnp.int32)
    bits = jnp.sum(jnp.where(pair_idx < bv[..., None], pair_bits, 0), axis=-1)
    return bits, bv


def rate_loop_precompute(
    spectrum: jax.Array,
    init_gain: jax.Array,
    iso: bool = False,
    use_kernel: bool = False,
) -> dict:
    """Budget-independent half of the gain walk: candidate bit counts.

    This is the heavy part (20 quantization+bit-count passes per granule) and
    depends only on the spectrum, NOT on the bit budget — so it runs fully
    parallel across all frames of a chunk while the budget (reservoir) chain
    stays in a cheap integer scan (see rate_loop_select).

    Returns dict with: mag, sign_neg [..., 576]; gstart, k_budget [...];
    bits, bv, evaluated [..., 20].
    """
    absx = jnp.maximum(jnp.abs(spectrum), _F32(1e-10))
    mag = jnp.power(absx, _F32(0.75))
    sign_neg = spectrum < 0

    g0 = jnp.clip(init_gain, 0, 255)
    q0 = quantize_at_gains(mag, sign_neg, g0[..., None], iso=iso)[..., 0, :]
    allzero0 = _last_nonzero_count(q0) == 0

    gstart = jnp.where(allzero0, jnp.maximum(g0 - 40, 0), g0).astype(jnp.int32)
    k_budget = jnp.where(allzero0, N_GAIN_CANDIDATES - 1, N_GAIN_CANDIDATES)

    k = jnp.arange(N_GAIN_CANDIDATES, dtype=jnp.int32)
    gains = gstart[..., None] + 4 * k  # [..., 20]
    bits, bv = _t15_sweep(mag, sign_neg, gstart, iso, use_kernel)
    evaluated = (k == 0) | (gains < 255)
    return {
        "mag": mag,
        "sign_neg": sign_neg,
        "gstart": gstart,
        "k_budget": k_budget.astype(jnp.int32),
        "bits": bits.astype(jnp.int32),
        "bv": bv.astype(jnp.int32),
        "evaluated": evaluated,
        "iso": iso,  # static: which quantization law the sweep used
    }


def rate_loop_select(
    bits: jax.Array,
    evaluated: jax.Array,
    k_budget: jax.Array,
    max_bits: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Budget-dependent selection: O(20) integer work per granule.

    Returns (k_sel, has_fit, bits_sel). Walk semantics (MP3Encoder.swift:
    745-776): first evaluated in-budget candidate fitting wins; otherwise the
    last evaluated candidate's quantization is kept.
    """
    k = jnp.arange(N_GAIN_CANDIDATES, dtype=jnp.int32)
    in_budget = k < k_budget[..., None]
    fits = evaluated & in_budget & (bits <= max_bits[..., None])
    has_fit = jnp.any(fits, axis=-1)
    k_fit = jnp.argmax(fits, axis=-1)
    k_eval = jnp.where(evaluated & in_budget, k, -1)
    k_last = jnp.max(k_eval, axis=-1)
    k_sel = jnp.where(has_fit, k_fit, k_last).astype(jnp.int32)
    # where-sum select over the 20 candidates, not take_along_axis
    bits_sel = jnp.sum(jnp.where(k == k_sel[..., None], bits, 0), axis=-1)
    return k_sel, has_fit, bits_sel


def rate_loop_finalize(
    pre: dict, k_sel: jax.Array, has_fit: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Recompute the selected quantization (cheaper than materializing all 20
    candidates). Returns (gain_reported, quantized, big_values).

    Reported-gain quirk reproduced: on overflow (no fit) the reported gain is
    stepped once past the gain actually used, capped at 255."""
    gains_sel = pre["gstart"] + 4 * k_sel
    q_sel = quantize_at_gains(
        pre["mag"], pre["sign_neg"], gains_sel[..., None], iso=pre.get("iso", False)
    )[..., 0, :]
    k = jnp.arange(N_GAIN_CANDIDATES, dtype=jnp.int32)
    bv_sel = jnp.sum(jnp.where(k == k_sel[..., None], pre["bv"], 0), axis=-1)
    gain_out = jnp.where(has_fit, gains_sel, jnp.minimum(gains_sel + 4, 255))
    return gain_out.astype(jnp.int32), q_sel, bv_sel


def rate_loop(
    spectrum: jax.Array,
    init_gain: jax.Array,
    max_bits: jax.Array,
    iso: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Vectorized replica of the reference's gain walk (MP3Encoder.swift:734-794).

    spectrum: [..., 576] f32; init_gain, max_bits: [...] int32.
    Returns (gain [...], quantized [..., 576] int32, part23_bits [...],
    big_values [...]).

    Walk semantics reproduced exactly:
    - candidates are gstart + 4k, k = 0..19 (gstart = initial gain, or
      max(g-40, 0) if the initial quantization is all-zero, consuming one
      iteration);
    - a candidate is only 'evaluated' if the walk would reach it (k == 0 or
      its gain < 255);
    - first evaluated candidate fitting the budget wins;
    - if none fits, the returned quantized spectrum comes from the *last
      evaluated* candidate while the reported gain is stepped once more and
      capped at 255 (the reference's overflow quirk).
    """
    pre = rate_loop_precompute(spectrum, init_gain, iso=iso)
    k_sel, has_fit, bits_sel = rate_loop_select(
        pre["bits"], pre["evaluated"], pre["k_budget"], max_bits
    )
    gain_out, q_sel, bv_sel = rate_loop_finalize(pre, k_sel, has_fit)
    return gain_out, q_sel, bits_sel, bv_sel


# --- Device-side Huffman bit packing ------------------------------------------
# The north-star architecture (BASELINE.json): a device-side pack stage with
# host finalization. Variable-length codes are placed into the frame's
# main_data byte image entirely on the device:
#   1. per pair: chunk = codeword | sign bits (<= 15 bits), length l
#   2. bit offsets O = exclusive cumsum over the frame's 1152 pair slots
#   3. each chunk straddles <= 2 16-bit halfwords: h = O >> 4, s = O & 15;
#      the 32-bit window (chunk << (32-s-l)) splits into hi/lo halfwords
#   4. out_half[h] = sum of hi parts with h_p == h  +  lo parts with
#      h_p+1 == h. Bits are disjoint, so OR == SUM, and per 8-bit plane the
#      sums stay < 256 — exact in float32.
#   5. the scatter is factorized: one-hot(h) = one-hot(h>>5) x one-hot(h&31),
#      so each plane reduces to a [34,P]x[P,32] batched matmul —
#      no gathers, no scatters.

def _pack_code_words() -> np.ndarray:
    """Table-15 codewords (<=13 bits) packed 2 per uint32 word: 128 words."""
    from ..tables import TABLE15_CODE as codes

    words = np.zeros(128, dtype=np.uint32)
    for i, c in enumerate(codes):
        words[i // 2] |= np.uint32(int(c) << ((i % 2) * 16))
    return words


_T15_CODE_WORDS = _pack_code_words()


def t15_code_lookup(idx: jax.Array) -> jax.Array:
    """TABLE15_CODE[idx] for idx in [0, 256), gather-free (7-level tree)."""
    word = _select_tree(idx >> 1, _T15_CODE_WORDS, 0, 128)
    shift = ((idx & 1) * 16).astype(jnp.uint32)
    return ((word >> shift) & 0xFFFF).astype(jnp.int32)


MAX_FRAME_MAIN_BITS = 1152 * 15  # hard upper bound: all pair slots, 15 bits
_N_HALF = MAX_FRAME_MAIN_BITS // 16 + 2  # 1082 halfwords (+straddle margin)
_HI_DIM = (_N_HALF + 31) // 32  # 34
_LO_DIM = 32


def pair_chunks_device(q: jax.Array, big_values: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-pair (chunk, nbits) for table-15 coding, masked beyond big_values.

    q: [..., 576] int32; big_values: [...]. Returns chunk [..., 288] int32,
    nbits [..., 288] int32 (0 for masked pairs). Chunk layout matches the
    host packer: codeword, then sign of x if |x|>0, then sign of y.
    """
    x = q[..., 0::2]
    y = q[..., 1::2]
    ax = jnp.minimum(jnp.abs(x), 15)
    ay = jnp.minimum(jnp.abs(y), 15)
    idx = ax * 16 + ay
    code = t15_code_lookup(idx)
    nbits = t15_length_lookup(idx)
    sx = (x < 0).astype(jnp.int32)
    has_x = ax != 0
    chunk = jnp.where(has_x, (code << 1) | sx, code)
    nbits = nbits + has_x.astype(jnp.int32)
    sy = (y < 0).astype(jnp.int32)
    has_y = ay != 0
    chunk = jnp.where(has_y, (chunk << 1) | sy, chunk)
    nbits = nbits + has_y.astype(jnp.int32)
    pair_idx = jnp.arange(288, dtype=jnp.int32)
    mask = pair_idx < big_values[..., None]
    return jnp.where(mask, chunk, 0), jnp.where(mask, nbits, 0)


def pack_main_data(chunks: jax.Array, nbits: jax.Array, cap_bytes: int) -> tuple[jax.Array, jax.Array]:
    """Pack each frame's chunks into its main_data byte image on device.

    chunks/nbits: [F, P] (P = n_granules*288, granule-major — the frame's
    full write order). cap_bytes: static output width (must be even).
    Returns (bytes [F, cap_bytes] uint8, total_bits [F] int32). Frames whose
    byte image exceeds cap_bytes are truncated — callers size cap_bytes from
    the config and verify hb <= cap_bytes host-side.
    """
    F, P = chunks.shape
    offsets = jnp.cumsum(nbits, axis=-1) - nbits  # exclusive prefix sum
    total_bits = offsets[:, -1] + nbits[:, -1]

    h = offsets >> 4  # [F, P] halfword index
    s = offsets & 15
    win = (chunks.astype(jnp.uint32)) << (32 - s - nbits).astype(jnp.uint32)
    win = jnp.where(nbits > 0, win, 0)
    hi = (win >> 16).astype(jnp.int32)
    lo = (win & 0xFFFF).astype(jnp.int32)

    n_half = cap_bytes // 2
    # hi-factor dimension sized to the ACTUAL cap, not the theoretical
    # 2160-byte worst case: scatter FLOPs scale with hi_dim, and targets
    # beyond the cap are dropped either way (truncated frames are rejected
    # host-side via hb > cap). 34 -> 14 at the 128 kbps stereo cap, ~2.4x
    # less matmul work.
    hi_dim = (n_half + _LO_DIM - 1) // _LO_DIM

    def scatter_halfwords(values: jax.Array, target: jax.Array) -> jax.Array:
        """sum_{p: target_p == h} values_p for h < n_half, via factorized
        one-hot matmuls. One-hots and byte-plane values are exact in
        bfloat16 (integers <= 255); accumulation is f32."""
        t_hi = (target >> 5)[..., None] == jnp.arange(hi_dim, dtype=jnp.int32)
        t_lo = (target & 31)[..., None] == jnp.arange(_LO_DIM, dtype=jnp.int32)
        Bm = t_lo.astype(jnp.bfloat16)  # [blk, P, 32]
        out = 0
        for plane_shift in (0, 8):
            v = ((values >> plane_shift) & 0xFF).astype(jnp.bfloat16)
            Av = t_hi.astype(jnp.bfloat16) * v[..., None]  # [blk, P, hi_dim]
            S = jax.lax.dot_general(
                Av,
                Bm,
                dimension_numbers=(((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )  # [blk, hi_dim, 32]
            plane = S.reshape(S.shape[0], hi_dim * _LO_DIM).astype(jnp.int32)
            out = out + (plane << plane_shift)
        return out[:, :n_half]

    # Block over frames: materializing the one-hots for all frames at once
    # would cost O(F * P * 66) floats (~1 GB at F=4096); 256-frame blocks
    # keep it ~40 MB while each block is still a large matmul.
    BLK = 256
    F_pad = ((F + BLK - 1) // BLK) * BLK
    def pad(a):
        return jnp.pad(a, ((0, F_pad - F), (0, 0)))

    hi_b = pad(hi).reshape(F_pad // BLK, BLK, P)
    lo_b = pad(lo).reshape(F_pad // BLK, BLK, P)
    h_b = pad(h).reshape(F_pad // BLK, BLK, P)

    def pack_block(args):
        hi_i, lo_i, h_i = args
        return scatter_halfwords(hi_i, h_i) + scatter_halfwords(lo_i, h_i + 1)

    halfwords = jax.lax.map(pack_block, (hi_b, lo_b, h_b)).reshape(F_pad, n_half)[:F]
    hi8 = (halfwords >> 8).astype(jnp.uint8)
    lo8 = (halfwords & 0xFF).astype(jnp.uint8)
    out_bytes = jnp.stack([hi8, lo8], axis=-1).reshape(F, cap_bytes)
    return out_bytes, total_bits.astype(jnp.int32)


# --- Region counts, preflag --------------------------------------------------


def region_counts(big_values: jax.Array, sample_rate: int) -> tuple[jax.Array, jax.Array]:
    """region0/region1 from band boundaries (MP3Encoder.swift:856-887).

    Boundaries are strictly increasing, so each loop walks a prefix:
    region0 = (count of the first 15 boundaries <= big_values*2) - 1, and
    region1 counts consecutive satisfying boundaries in the next 7 slots
    (nonzero once big_values*2 exceeds boundary 14 — the loop's 15-cap).
    """
    bounds_np = np.cumsum(band_table(sample_rate)).astype(np.int32)
    boundaries = jnp.asarray(bounds_np)  # [21]
    n_bounds = bounds_np.shape[0]
    bvr = (big_values * 2)[..., None]
    c_all = jnp.sum((boundaries <= bvr).astype(jnp.int32), axis=-1)
    region0 = jnp.maximum(jnp.minimum(c_all, 15) - 1, 0)
    start = region0 + 1
    # consecutive satisfying boundaries in [start, min(start+7, n_bounds))
    n_sat = jnp.maximum(jnp.minimum(jnp.minimum(c_all, start + 7), n_bounds) - start, 0)
    region1 = jnp.maximum(n_sat - 1, 0)
    return region0, jnp.minimum(region1, 7)


def masking_thresholds(
    spectrum: jax.Array, sample_rate: int, quality: int
) -> jax.Array:
    """Psychoacoustic masking thresholds: per-band mean energy x quality
    scale, floor 1e-4 (MP3Encoder.swift:1983-2013).

    Component parity note: the reference computes this every granule but its
    output never influences quantization (thresholds are passed to, and
    ignored by, the rate loop — MP3Encoder.swift:734-744). The op exists for
    the future spec-strict mode and for API completeness; the pipeline skips
    it by default since it cannot affect any output byte.
    """
    bands = band_table(sample_rate)
    quality_scale = np.float32(max(0.1, (10 - quality) / 10.0))
    starts = np.concatenate([[0], np.cumsum(bands)[:-1]]).astype(np.int32)
    ends = np.cumsum(bands).astype(np.int32)
    coef = np.arange(576, dtype=np.int32)
    # [n_bands, 576] membership mask (static)
    member = jnp.asarray((coef[None, :] >= starts[:, None]) & (coef[None, :] < ends[:, None]))
    widths = jnp.asarray(bands.astype(np.float32))
    e = spectrum * spectrum
    band_energy = jnp.einsum(
        "...c,bc->...b", e, member.astype(jnp.float32), precision=_HIGHEST
    )
    avg = band_energy / widths
    thr_band = jnp.maximum(avg * quality_scale, _F32(1e-4))
    thr = jnp.einsum(
        "...b,bc->...c", thr_band, member.astype(jnp.float32), precision=_HIGHEST
    )
    return jnp.where(jnp.any(member, axis=0), thr, _F32(1e-4))


def preflag(spectrum: jax.Array) -> jax.Array:
    """Top-quarter energy > 1.5x rest (MP3Encoder.swift:2042-2066; the
    scalefactor clause is constant-true with unity scalefactors)."""
    high = jnp.sum(spectrum[..., 432:] ** 2, axis=-1)
    low = jnp.sum(spectrum[..., :432] ** 2, axis=-1)
    return (high > low * _F32(1.5)).astype(jnp.int32)


# --- Stereo decision ---------------------------------------------------------


def stereo_decide(
    left: jax.Array, right: jax.Array, iso_matrix: bool = False,
    symmetric: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Joint-stereo M/S decision per frame (MP3Encoder.swift:2140-2162).

    left/right: [..., 1152]. Returns (use_ms [...] bool, ch0, ch1).
    mid = (L+R)/2, side = (L-R)/2; M/S when side energy < 0.4 * mid energy.
    iso_matrix: (L+-R)/sqrt(2), the ISO 2.4.3.4.9.2 convention (twin of
    reference.stereo_decide; the decision is scale-invariant).
    symmetric (options.ms_symmetric): also M/S when mid < 0.4 * side —
    anti-correlated stereo compacts into the side channel; see the golden
    twin's docstring for the measured record.
    """
    half = _F32(1.0 / np.sqrt(2.0)) if iso_matrix else _F32(0.5)
    mid = (left + right) * half
    side = (left - right) * half
    n = _F32(left.shape[-1])
    mid_e = jnp.sum(mid * mid, axis=-1) / n
    side_e = jnp.sum(side * side, axis=-1) / n
    use_ms = side_e < mid_e * _F32(0.4)
    if symmetric:
        use_ms = use_ms | (mid_e < side_e * _F32(0.4))
    ch0 = jnp.where(use_ms[..., None], mid, left)
    ch1 = jnp.where(use_ms[..., None], side, right)
    return use_ms, ch0, ch1


# --- Frame energy & VBR ------------------------------------------------------


def mean_square(x: jax.Array) -> jax.Array:
    return jnp.sum(x * x, axis=-1) / _F32(x.shape[-1])


def vbr_choose_bitrate(
    energy: jax.Array,
    ehist: jax.Array,
    ecount: jax.Array,
    base: int,
    quality: int,
) -> jax.Array:
    """VBR bitrate from energy vs running average (MP3Encoder.swift:1177-1189).

    ehist: [..., 10] with zeros in unused slots; ecount: [...] valid count.
    """
    have = ecount > 0
    avg = jnp.where(
        have, jnp.sum(ehist, axis=-1) / jnp.maximum(ecount, 1).astype(_F32), energy
    )
    ratio = jnp.clip(energy / jnp.maximum(avg, _F32(1e-4)), _F32(0.5), _F32(2.0))
    quality_factor = np.float32(9 - quality) / np.float32(9.0)
    max_adjustment = int(np.float32(32.0) + np.float32(32.0) * quality_factor)
    adjustment = jnp.trunc((ratio - _F32(1.0)) * _F32(max_adjustment)).astype(jnp.int32)
    min_bitrate = max(32, base - 64 + quality * 8)
    max_bitrate = min(320, base + 64 - quality * 4)
    # max-of-min, NOT clip: when min_bitrate > max_bitrate (e.g. base=320,
    # quality=9) the reference's max() wins (MP3Encoder.swift:1188).
    return jnp.maximum(min_bitrate, jnp.minimum(base + adjustment, max_bitrate))


def bitrate_index_device(bitrate: jax.Array, sample_rate: int) -> jax.Array:
    """Closest-match bitrate index (MP3Encoder.swift:2509-2523): exact match
    first (== earliest minimal distance, which argmin provides)."""
    table = BITRATE_TABLE_V1 if sample_rate >= 32000 else BITRATE_TABLE_V2
    t = jnp.asarray(table)
    return jnp.argmin(jnp.abs(t - bitrate[..., None]), axis=-1).astype(jnp.int32)


_BITRATE_VALUES = jnp.asarray(BITRATE_TABLE_V1)
_BITRATE_VALUES_V2 = jnp.asarray(BITRATE_TABLE_V2)


def bitrate_value_device(index: jax.Array, lsf: bool = False) -> jax.Array:
    return jnp.take(_BITRATE_VALUES_V2 if lsf else _BITRATE_VALUES, index, axis=0)


# --- Spec-strict entropy layout (device twin of reference.strict_entropy_layout)
# Per-region smallest-table selection + count1 quadruple coding, fully
# vectorized over any leading dims (including the 20-gain sweep axis). All
# lookups are gather-free nibble/halfword where-trees like the table-15 hot
# path. Laws are defined by ops.reference.strict_entropy_layout; exact
# integer agreement is enforced by tests.

from ..tables import (  # noqa: E402  (late import keeps the hot-path header tidy)
    COUNT1A_CODE,
    COUNT1A_LEN,
    HUFFMAN_TABLES,
    QCAP_LINBITS,
)

_STRICT_TIDS = (1, 2, 5, 7)  # + 15 (existing LUTs); table_for_max order


def _padded_table_flat(tid: int, attr: str) -> np.ndarray:
    """Small table padded to a flat 16x16 layout (index = x*16 + y)."""
    t = HUFFMAN_TABLES[tid]
    n = t.max_value + 1
    out = np.zeros((16, 16), dtype=np.uint32)
    out[:n, :n] = getattr(t, attr)
    return out.reshape(-1)


_PAIR_LEN_WORDS = {
    tid: _pack_nibbles(_padded_table_flat(tid, "lengths")) for tid in _STRICT_TIDS
}


def _pack_halfwords(values: np.ndarray) -> np.ndarray:
    assert values.max() < 1 << 16 and len(values) % 2 == 0
    words = np.zeros(len(values) // 2, dtype=np.uint32)
    for i, v in enumerate(values):
        words[i // 2] |= np.uint32(int(v) << ((i % 2) * 16))
    return words


_PAIR_CODE_WORDS = {
    tid: _pack_halfwords(_padded_table_flat(tid, "codes")) for tid in _STRICT_TIDS
}


def _dense_table_flat(tid: int, attr: str) -> np.ndarray:
    """Small table packed DENSE (stride = its own n, not 16; padded to an
    even count for halfword packing). The where-tree over the padded 16x16
    layout costs 127 nodes per table regardless of real size; t1/t2/t5/t7
    carry only 4/9/16/36 real entries, so dense repacking cuts the code
    select-tree from 508 nodes to 29 across the four small tables (codes
    only; the len tables of the sweep keep the 16x16 layout)."""
    t = HUFFMAN_TABLES[tid]
    n = t.max_value + 1
    flat = np.asarray(getattr(t, attr))[:n, :n].reshape(-1).astype(np.uint32)
    if len(flat) % 2:
        flat = np.concatenate([flat, np.zeros(1, np.uint32)])
    return flat


_PAIR_CODE_WORDS_DENSE = {
    tid: _pack_halfwords(_dense_table_flat(tid, "codes")) for tid in (1, 2, 5, 7)
}
_DENSE_N = {tid: HUFFMAN_TABLES[tid].max_value + 1 for tid in (1, 2, 5, 7)}
# linbits family shared pair table (ids 24-31; options.linbits_tables).
# Max code length 12 -> nibble-packable like the others.
_T24_LEN_WORDS = _pack_nibbles(_padded_table_flat(24, "lengths"))
_T24_CODE_WORDS = _pack_halfwords(_padded_table_flat(24, "codes"))
_COUNT1A_LEN_WORDS = _pack_nibbles(COUNT1A_LEN.astype(np.uint32))
_COUNT1A_CODE_WORDS = _pack_nibbles(COUNT1A_CODE.astype(np.uint32))


def _code_lookup(words: np.ndarray, idx: jax.Array) -> jax.Array:
    word = _select_tree(idx >> 1, words, 0, len(words))
    shift = ((idx & 1) * 16).astype(jnp.uint32)
    return ((word >> shift) & 0xFFFF).astype(jnp.int32)


def _table_for_max_device(m: jax.Array, linbits: bool = False) -> jax.Array:
    """tables.table_for_max, vectorized: 0,1,2,5,7,15 by region max; with
    linbits, maxima above 15 select the smallest covering 24-family id
    (twin of tables.linbits_table_for_max)."""
    base = jnp.where(
        m == 0,
        0,
        jnp.where(
            m <= 1, 1, jnp.where(m <= 2, 2, jnp.where(m <= 3, 5, jnp.where(m <= 5, 7, 15)))
        ),
    ).astype(jnp.int32)
    if not linbits:
        return base
    e = m - 15  # needs bit_length(e) linbits; family widths 4,5,6,7,8,9,11,13
    esc = jnp.where(
        e <= 15,
        24,
        jnp.where(
            e <= 31,
            25,
            jnp.where(
                e <= 63,
                26,
                jnp.where(
                    e <= 127, 27, jnp.where(e <= 255, 28, jnp.where(e <= 511, 29, jnp.where(e <= 2047, 30, 31)))
                ),
            ),
        ),
    ).astype(jnp.int32)
    return jnp.where(m <= 15, base, esc)


def _linbits_of_tid(tid: jax.Array) -> jax.Array:
    """linbits width per table id (0 for the classic tables; ids 24-29 map
    to tid-20, 30 -> 11, 31 -> 13 per the ISO B.7 headers)."""
    return jnp.where(
        tid < 24,
        0,
        jnp.where(tid <= 29, tid - 20, jnp.where(tid == 30, 11, 13)),
    ).astype(jnp.int32)


def _pair_len_by_tid(tid: jax.Array, idx: jax.Array, linbits: bool = False) -> jax.Array:
    """Code length of pair `idx` (= min(ax,15)*16+min(ay,15)) under per-pair
    table id `tid` (0 -> 0 bits; ids >= 24 share table 24's lengths)."""
    l15 = t15_length_lookup(idx)
    l1 = _nibble_lookup(_PAIR_LEN_WORDS[1], idx)
    l2 = _nibble_lookup(_PAIR_LEN_WORDS[2], idx)
    l5 = _nibble_lookup(_PAIR_LEN_WORDS[5], idx)
    l7 = _nibble_lookup(_PAIR_LEN_WORDS[7], idx)
    out = jnp.where(
        tid == 0,
        0,
        jnp.where(
            tid == 1,
            l1,
            jnp.where(tid == 2, l2, jnp.where(tid == 5, l5, jnp.where(tid == 7, l7, l15))),
        ),
    )
    if linbits:
        l24 = _nibble_lookup(_T24_LEN_WORDS, idx)
        out = jnp.where(tid >= 24, l24, out)
    return out


def _pair_code_by_tid(tid: jax.Array, idx: jax.Array, linbits: bool = False) -> jax.Array:
    c15 = t15_code_lookup(idx)
    # Dense small-table trees: recover (x, y) from the 16-stride idx and
    # re-stride by each table's own n. No clamp needed — an out-of-range
    # dense index only happens when tid selects a DIFFERENT table, and
    # _select_tree returns (harmless) junk beyond its last leaf.
    x16, y16 = idx >> 4, idx & 15

    def dense(tid_k):
        n = _DENSE_N[tid_k]
        return _code_lookup(_PAIR_CODE_WORDS_DENSE[tid_k], x16 * n + y16)

    c1 = dense(1)
    c2 = dense(2)
    c5 = dense(5)
    c7 = dense(7)
    out = jnp.where(
        tid == 0,
        0,
        jnp.where(
            tid == 1,
            c1,
            jnp.where(tid == 2, c2, jnp.where(tid == 5, c5, jnp.where(tid == 7, c7, c15))),
        ),
    )
    if linbits:
        c24 = _code_lookup(_T24_CODE_WORDS, idx)
        out = jnp.where(tid >= 24, c24, out)
    return out


_BOUNDS_BY_SR = {
    sr: np.cumsum(band_table(sr)).astype(np.int32)
    for sr in (44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000)
}


def _region_bounds(r0: jax.Array, r1: jax.Array, sample_rate: int):
    """(b0, b1) value-index region boundaries as decoders read them."""
    bounds = _BOUNDS_BY_SR.get(sample_rate, _BOUNDS_BY_SR[44100])
    j = jnp.arange(len(bounds), dtype=jnp.int32)
    b0 = jnp.sum(jnp.where(j == r0[..., None], bounds, 0), axis=-1)
    k = r0 + 1 + r1
    b1k = jnp.sum(jnp.where(j == k[..., None], bounds, 0), axis=-1)
    b1 = jnp.where(k < len(bounds), b1k, 576)
    return b0, b1


def _count1_alignment_bits(nz: jax.Array, align: int):
    """Per-quad (pattern, nsigns) for quads at positions align + 4j.

    nz: [..., 576] int32 0/1; returns pattern [..., 144], nsigns [..., 144]
    (alignment-2 quad 143 padded with zeros)."""
    if align == 0:
        quads = nz[..., :576].reshape(*nz.shape[:-1], 144, 4)
    else:
        body = nz[..., 2:574].reshape(*nz.shape[:-1], 143, 4)
        quads = jnp.pad(body, [(0, 0)] * (nz.ndim - 1) + [(0, 1), (0, 0)])
    pattern = (
        quads[..., 0] * 8 + quads[..., 1] * 4 + quads[..., 2] * 2 + quads[..., 3]
    )
    return pattern, jnp.sum(quads, axis=-1)


def strict_layout_device(
    q: jax.Array,
    sample_rate: int,
    is_long: jax.Array,
    count1_coding: bool,
    region_table_select: bool,
    assume_abs: bool = False,
    linbits: bool = False,
    b0_switch: jax.Array | None = None,
) -> dict:
    """Layout integers for quantized spectra [..., 576] (leading dims free).

    is_long: [...] bool (block_type == LONG), broadcastable against q's
    leading dims. Returns per-item: bv, n1, c1t, tid0/1/2, r0, r1, bits.
    Twin of reference.strict_entropy_layout (see its docstring for laws).
    assume_abs: q is already nonnegative and capped (the sweep passes
    unsigned quantized magnitudes — the bit count is sign-invariant, so
    the sweep skips applying and re-stripping signs). linbits: |values|
    above 15 select 24-family ESC tables; per-pair bits gain the region's
    linbits width per escaped member (requires region_table_select).
    b0_switch: per-granule switching-granule region-0 line boundary
    (LSF rates only; None keeps the MPEG-1 constant 36).
    """
    cap = QCAP_LINBITS if linbits else 15
    av = q if assume_abs else jnp.minimum(jnp.abs(q), cap)
    pos = jnp.arange(1, 577, dtype=jnp.int32)
    l0c = jnp.max(jnp.where(av > 0, pos, 0), axis=-1)
    if count1_coding:
        c1c = jnp.max(jnp.where(av > 1, pos, 0), axis=-1)
        bv2 = jnp.minimum((c1c + 1) & ~1, 576)
        n1 = (jnp.maximum(l0c - bv2, 0) + 3) // 4
        overflow = bv2 + 4 * n1 > 576
        bv2 = jnp.where(overflow, bv2 + 2, bv2)
        n1 = (jnp.maximum(l0c - bv2, 0) + 3) // 4
    else:
        bv2 = jnp.minimum((l0c + 1) & ~1, 576)
        n1 = jnp.zeros_like(bv2)
    bv = bv2 >> 1

    r0, r1 = region_counts(bv, sample_rate)
    b0l, b1l = _region_bounds(r0, r1, sample_rate)
    # Switching-granule region-0 boundary: BAND-DERIVED (tables.switch_bound
    # — 36 at every MPEG-1 rate, so the literal is kept there for the
    # historical HLO; 54/72/108 in the LSF family, varying by pure-short
    # vs start/stop, so LSF callers pass the per-granule b0_switch).
    b0 = jnp.where(is_long, b0l, 36 if b0_switch is None else b0_switch)
    b1 = jnp.where(is_long, b1l, 576)

    x = av[..., 0::2]
    y = av[..., 1::2]
    m_pair = jnp.maximum(x, y)
    pairpos = jnp.arange(288, dtype=jnp.int32) * 2
    region = jnp.where(
        pairpos < b0[..., None], 0, jnp.where(pairpos < b1[..., None], 1, 2)
    )
    valid = pairpos < bv2[..., None]

    if region_table_select:
        tids = []
        for r in range(3):
            sel = jnp.where((region == r) & valid, m_pair, 0)
            tids.append(_table_for_max_device(jnp.max(sel, axis=-1), linbits=linbits))
        tids[2] = jnp.where(is_long, tids[2], 0)
    else:
        shape = bv.shape
        tids = [jnp.full(shape, 15, dtype=jnp.int32) for _ in range(3)]

    tid_pair = jnp.where(
        region == 0,
        tids[0][..., None],
        jnp.where(region == 1, tids[1][..., None], tids[2][..., None]),
    )
    if linbits:
        idx = jnp.minimum(x, 15) * 16 + jnp.minimum(y, 15)
    else:
        idx = x * 16 + y
    plen = _pair_len_by_tid(tid_pair, idx, linbits=linbits)
    psign = (x != 0).astype(jnp.int32) + (y != 0).astype(jnp.int32)
    if linbits:
        lb_pair = _linbits_of_tid(tid_pair)
        plen = plen + lb_pair * (
            (x >= 15).astype(jnp.int32) + (y >= 15).astype(jnp.int32)
        )
    pair_bits = jnp.sum(
        jnp.where(valid & (tid_pair != 0), plen + psign, 0), axis=-1
    )

    if count1_coding:
        nz = (av > 0).astype(jnp.int32)
        qpos = jnp.arange(144, dtype=jnp.int32) * 4  # + align
        bits_opts = []
        for align in (0, 2):
            patt, nsign = _count1_alignment_bits(nz, align)
            start = qpos + align
            vq = (start >= bv2[..., None]) & (start < (bv2 + 4 * n1)[..., None])
            la = _nibble_lookup(_COUNT1A_LEN_WORDS, patt)
            bits_a = jnp.sum(jnp.where(vq, la + nsign, 0), axis=-1)
            bits_b = jnp.sum(jnp.where(vq, 4 + nsign, 0), axis=-1)
            bits_opts.append((bits_a, bits_b))
        use2 = (bv2 & 2) == 2
        bits_a = jnp.where(use2, bits_opts[1][0], bits_opts[0][0])
        bits_b = jnp.where(use2, bits_opts[1][1], bits_opts[0][1])
        c1t = (bits_b < bits_a).astype(jnp.int32)
        c1_bits = jnp.minimum(bits_a, bits_b)
    else:
        c1t = jnp.zeros_like(bv)
        c1_bits = jnp.zeros_like(bv)

    return {
        "bv": bv.astype(jnp.int32),
        "n1": n1.astype(jnp.int32),
        "c1t": c1t,
        "tid0": tids[0],
        "tid1": tids[1],
        "tid2": tids[2],
        "r0": r0.astype(jnp.int32),
        "r1": r1.astype(jnp.int32),
        "b0": b0.astype(jnp.int32),
        "b1": b1.astype(jnp.int32),
        "bits": (pair_bits + c1_bits).astype(jnp.int32),
    }


def rate_loop_precompute_strict(
    spectrum: jax.Array,
    init_gain: jax.Array,
    sample_rate: int,
    is_long: jax.Array,
    iso: bool,
    count1_coding: bool,
    region_table_select: bool,
    mag_scale: jax.Array = None,
    part2: jax.Array = None,
    block: jax.Array = None,
    iso_short: bool = False,
    linbits: bool = False,
    b0_switch: jax.Array | None = None,
) -> dict:
    """Strict-entropy sweep: candidates priced EXACTLY at every grid gain
    (lax.map over strict_layout_device; STRICT_ANCHORS = all 20).

    Round-3 history, pinned as a NEGATIVE RESULT so nobody re-tries it:
    approximate pricings (endpoint t15+delta, and 6/8/10-anchor integer
    interpolation — the code still routes through the anchor/interpolation
    scaffolding with a dense grid) lose 1.4-5.4 dB at 64 kbps because
    first-fit selection flips on tens-of-bits pricing errors. Exact
    pricing costs ~2.3x the compat sweep and is kept; part2_3_length and
    the reservoir byte accounting use the finalize-stage ACTUAL bits
    (equal to the priced bits here, since pricing is exact).

    Walk semantics (gain grid, -40 retry, evaluated rule) are the
    reference walk's, unchanged.

    mag_scale/part2 (real_scalefactors): per-coefficient 2^(0.75*sf)
    magnitude amplification, and the granule's scalefactor bits added to
    every candidate's priced bit count (part2 rides inside
    part2_3_length).

    iso_short (options.iso_short_blocks, needs block [...] int32):
    switching granules' quantizer inputs are permuted into the ISO
    2.4.3.4.8 stream order BEFORE the sweep — quantization is pointwise,
    so the entire layout/pack machinery downstream then operates on the
    conforming entropy order with no further changes."""
    absx = jnp.maximum(jnp.abs(spectrum), _F32(1e-10))
    mag = jnp.power(absx, _F32(0.75))
    if mag_scale is not None:
        mag = mag * mag_scale
    sign_neg = spectrum < 0
    if iso_short:
        # START/STOP granules are long-layout: no 2.4.3.4.8 reordering
        is_long_x = ((block == BLOCK_LONG) | (block > BLOCK_SHORT))[..., None]
        is_mixed_x = (block == BLOCK_MIXED)[..., None]

        def reorder_by_block(x):
            x_s = reorder_natural_to_stream(x, sample_rate, mixed=False)
            x_m = reorder_natural_to_stream(x, sample_rate, mixed=True)
            return jnp.where(is_long_x, x, jnp.where(is_mixed_x, x_m, x_s))

        # Ride the sign on mag's f32 sign bit so the slice/concat reorder
        # (and its block-type select) runs ONCE instead of per array. Exact:
        # mag >= 1e-10^0.75 > 0 always, so negate/abs round-trips the sign
        # and `< 0` recovers sign_neg bit-for-bit.
        signed_mag = jnp.where(sign_neg, -mag, mag)
        signed_mag = reorder_by_block(signed_mag)
        mag = jnp.abs(signed_mag)
        sign_neg = signed_mag < 0

    g0 = jnp.clip(init_gain, 0, 255)
    q0 = quantize_at_gains(mag, sign_neg, g0[..., None], iso=iso)[..., 0, :]
    allzero0 = _last_nonzero_count(q0) == 0

    gstart = jnp.where(allzero0, jnp.maximum(g0 - 40, 0), g0).astype(jnp.int32)
    k_budget = jnp.where(allzero0, N_GAIN_CANDIDATES - 1, N_GAIN_CANDIDATES)

    k = jnp.arange(N_GAIN_CANDIDATES, dtype=jnp.int32)
    gains = gstart[..., None] + 4 * k

    # Exact strict bits at STRICT_ANCHORS of the grid, piecewise-linear
    # integer interpolation between them (floor division — golden twin:
    # reference.quantize_to_fit_budget_strict uses the identical law).
    # lax.map compiles the layout body once (unrolling it multiplies the
    # compile time by the anchor count).
    qcap = QCAP_LINBITS if linbits else 15

    def _one_anchor(a):
        # unsigned quantize: bit counts are sign-invariant, so the sweep
        # skips the sign apply + abs round trip (2 VPU ops x 576 x anchors)
        g_a = jnp.minimum(gstart + 4 * a, 255)
        if iso:
            inv = inv_step34_lookup(jnp.clip(g_a, 0, 255), floor=not linbits)
        else:
            inv = inv_step_lookup(jnp.clip(g_a, 0, 255))
        q_abs = jnp.minimum(
            jnp.floor(mag * inv[..., None] + _F32(0.5)).astype(jnp.int32), qcap
        )
        lay_a = strict_layout_device(
            q_abs, sample_rate, is_long, count1_coding, region_table_select,
            assume_abs=True, linbits=linbits, b0_switch=b0_switch,
        )
        return lay_a["bits"]

    s_anchor = jax.lax.map(
        _one_anchor, jnp.asarray(STRICT_ANCHORS, dtype=jnp.int32)
    )  # [n_anchor, ...]
    anchor_bits = jnp.moveaxis(s_anchor, 0, -1)  # [..., n_anchor]
    cols = []
    for kk in range(N_GAIN_CANDIDATES):
        i = _anchor_segment(kk)
        a, b = STRICT_ANCHORS[i], STRICT_ANCHORS[i + 1]
        sa = anchor_bits[..., i]
        sb = anchor_bits[..., i + 1]
        if kk == a:
            cols.append(sa)
        elif kk == b:
            cols.append(sb)
        else:
            cols.append(sa + ((sb - sa) * (kk - a)) // (b - a))
    bits = jnp.stack(cols, axis=-1)
    if part2 is not None:
        bits = bits + part2[..., None]
    evaluated = (k == 0) | (gains < 255)
    return {
        "mag": mag,
        "sign_neg": sign_neg,
        "gstart": gstart,
        "k_budget": k_budget.astype(jnp.int32),
        "bits": bits.astype(jnp.int32),
        "evaluated": evaluated,
        "iso": iso,
        "strict": (sample_rate, count1_coding, region_table_select),
        "is_long": is_long,
        "linbits": linbits,
        **({"b0_switch": b0_switch} if b0_switch is not None else {}),
    }


def strict_finalize(
    pre: dict, k_sel: jax.Array, has_fit: jax.Array, q_fixup=None
) -> tuple[jax.Array, jax.Array, dict]:
    """Re-quantize at the selected gains and compute the final layout
    integers. Returns (gain_reported, quantized, layout).

    q_fixup: optional callable applied to the selected quantization BEFORE
    the entropy layout (intensity_q_fixup's knife-edge zeroing — the
    layout's big_values/regions/bits must see the fixed values)."""
    sample_rate, count1_coding, region_table_select = pre["strict"]
    linbits = pre.get("linbits", False)
    gains_sel = pre["gstart"] + 4 * k_sel
    q_sel = quantize_at_gains(
        pre["mag"], pre["sign_neg"], gains_sel[..., None], iso=pre["iso"],
        qcap=QCAP_LINBITS if linbits else 15, floor=not linbits,
    )[..., 0, :]
    if q_fixup is not None:
        q_sel = q_fixup(q_sel)
    lay = strict_layout_device(
        q_sel, sample_rate, pre["is_long"], count1_coding, region_table_select,
        linbits=linbits, b0_switch=pre.get("b0_switch"),
    )
    gain_out = jnp.where(has_fit, gains_sel, jnp.minimum(gains_sel + 4, 255))
    return gain_out.astype(jnp.int32), q_sel, lay


def strict_chunks_device(
    q: jax.Array, lay: dict, linbits: bool = False
) -> tuple[jax.Array, jax.Array]:
    """Per-slot (chunk, nbits) for the strict layout.

    q: [..., 576] int32; lay: strict_layout_device's output for q. Returns
    chunk/nbits [..., 432]: 288 pair slots then 144 quad slots per granule
    (write order = ascending position), nbits 0 outside [0, bv) pairs / the
    count1 quad range. Feed straight into pack_main_data.

    linbits: each pair becomes THREE interleaved slots (code | xlin+xsign |
    ylin+ysign), [..., 864] + 144 quad slots — a full ESC pair needs up to
    12+13+1 + 13+1 = 40 bits, but pack_main_data's halfword scatter caps a
    slot at 15 bits (chunk << (32-s-nbits) must fit two halfwords), so the
    pair splits at the ISO field boundaries instead (max slot 14 bits).
    """
    cap = QCAP_LINBITS if linbits else 15
    av = jnp.minimum(jnp.abs(q), cap)
    x = av[..., 0::2]
    y = av[..., 1::2]
    sx = (q[..., 0::2] < 0).astype(jnp.int32)
    sy = (q[..., 1::2] < 0).astype(jnp.int32)
    bv2 = lay["bv"] * 2
    pairpos = jnp.arange(288, dtype=jnp.int32) * 2
    region = jnp.where(
        pairpos < lay["b0"][..., None],
        0,
        jnp.where(pairpos < lay["b1"][..., None], 1, 2),
    )
    tid_pair = jnp.where(
        region == 0,
        lay["tid0"][..., None],
        jnp.where(region == 1, lay["tid1"][..., None], lay["tid2"][..., None]),
    )
    valid = (pairpos < bv2[..., None]) & (tid_pair != 0)

    if linbits:
        idx = jnp.minimum(x, 15) * 16 + jnp.minimum(y, 15)
        code = _pair_code_by_tid(tid_pair, idx, linbits=True)
        clen = _pair_len_by_tid(tid_pair, idx, linbits=True)
        lb = _linbits_of_tid(tid_pair)
        has_x = (x != 0).astype(jnp.int32)
        has_y = (y != 0).astype(jnp.int32)
        esc_x = ((x >= 15) & (lb > 0)).astype(jnp.int32)
        esc_y = ((y >= 15) & (lb > 0)).astype(jnp.int32)
        slot_a = jnp.where(valid, code, 0)
        nbits_a = jnp.where(valid, clen, 0)
        chunk_b = jnp.where(esc_x == 1, ((x - 15) << has_x) | (sx * has_x), sx * has_x)
        nbits_b = esc_x * lb + has_x
        chunk_c = jnp.where(esc_y == 1, ((y - 15) << has_y) | (sy * has_y), sy * has_y)
        nbits_c = esc_y * lb + has_y
        slot_b = jnp.where(valid, chunk_b, 0)
        nbits_b = jnp.where(valid, nbits_b, 0)
        slot_c = jnp.where(valid, chunk_c, 0)
        nbits_c = jnp.where(valid, nbits_c, 0)
        pair_chunks = jnp.stack([slot_a, slot_b, slot_c], axis=-1).reshape(
            *slot_a.shape[:-1], 864
        )
        pair_nbits = jnp.stack([nbits_a, nbits_b, nbits_c], axis=-1).reshape(
            *slot_a.shape[:-1], 864
        )
    else:
        idx = x * 16 + y
        code = _pair_code_by_tid(tid_pair, idx)
        nbits = _pair_len_by_tid(tid_pair, idx)
        has_x = x != 0
        chunk = jnp.where(has_x, (code << 1) | sx, code)
        nbits = nbits + has_x.astype(jnp.int32)
        has_y = y != 0
        chunk = jnp.where(has_y, (chunk << 1) | sy, chunk)
        nbits = nbits + has_y.astype(jnp.int32)
        pair_chunks = jnp.where(valid, chunk, 0)
        pair_nbits = jnp.where(valid, nbits, 0)

    # count1 quads: positions align + 4j, align = bv2 & 2; both alignments
    # computed statically, selected per item.
    # Select the quad/sign INPUTS between the two alignments first, then run
    # the code lookup + sign fold ONCE (the per-variant work is only the
    # cheap reshape/pad; bit-identical to computing both variants and
    # selecting the outputs, since everything downstream is elementwise in
    # the quad).
    nzs = (av > 0).astype(jnp.int32)
    sgn = (q < 0).astype(jnp.int32)
    qpos = jnp.arange(144, dtype=jnp.int32) * 4
    use2 = ((bv2 & 2) == 2)[..., None]
    pad = [(0, 0)] * (nzs.ndim - 1) + [(0, 1), (0, 0)]
    quads = jnp.where(
        use2[..., None],
        jnp.pad(nzs[..., 2:574].reshape(*nzs.shape[:-1], 143, 4), pad),
        nzs[..., :576].reshape(*nzs.shape[:-1], 144, 4),
    )
    signs = jnp.where(
        use2[..., None],
        jnp.pad(sgn[..., 2:574].reshape(*sgn.shape[:-1], 143, 4), pad),
        sgn[..., :576].reshape(*sgn.shape[:-1], 144, 4),
    )
    patt = quads[..., 0] * 8 + quads[..., 1] * 4 + quads[..., 2] * 2 + quads[..., 3]
    code_a = _nibble_lookup(_COUNT1A_CODE_WORDS, patt)
    len_a = _nibble_lookup(_COUNT1A_LEN_WORDS, patt)
    use_b = lay["c1t"][..., None] == 1
    qchunk = jnp.where(use_b, 15 - patt, code_a)
    qnbits = jnp.where(use_b, 4, len_a)
    for pos in range(4):
        has = quads[..., pos] == 1
        qchunk = jnp.where(has, (qchunk << 1) | signs[..., pos], qchunk)
        qnbits = qnbits + quads[..., pos]
    start = qpos + jnp.where(use2, 2, 0)
    vq = (start >= bv2[..., None]) & (start < (bv2 + 4 * lay["n1"])[..., None])
    quad_chunks = jnp.where(vq, qchunk, 0)
    quad_nbits = jnp.where(vq, qnbits, 0)

    return (
        jnp.concatenate([pair_chunks, quad_chunks], axis=-1),
        jnp.concatenate([pair_nbits, quad_nbits], axis=-1),
    )


# --- Spec-strict real scalefactors (device twin of reference.strict_scalefactors)

from ..ops.reference import SLEN_TABLE as _SLEN_TABLE  # noqa: E402

_SF_MULT34_NP = (2.0 ** (0.75 * np.arange(16, dtype=np.float64))).astype(np.float32)
_QUARTER_POS = (2.0 ** (np.arange(4) / 4.0)).astype(np.float32)  # 2^(r/4)


def sf_mult34_lookup(sf: jax.Array) -> jax.Array:
    """float32 2^(0.75*sf) for sf in [0, 15], gather-free (3sf/4 = q + r/4;
    exact ldexp reconstruction, validated against the float64-built table)."""
    e = 3 * sf
    qq = e >> 2
    r = e & 3
    c = _select_tree(r, _QUARTER_POS.view(np.uint32), 0, 4)
    base = jax.lax.bitcast_convert_type(c, jnp.float32)
    return jnp.ldexp(base, qq).astype(jnp.float32)


def _band_members(sample_rate: int) -> np.ndarray:
    bands = band_table(sample_rate)
    bounds = np.concatenate([[0], np.cumsum(bands)]).astype(np.int64)
    coef = np.arange(576)
    return np.stack(
        [(coef >= bounds[b]) & (coef < bounds[b + 1]) for b in range(21)]
    )  # [21, 576] bool


_BAND_MEMBERS = {
    sr: _band_members(sr)
    for sr in (44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000)
}
_SLEN1_NP = np.array([s[0] for s in _SLEN_TABLE], dtype=np.uint32)
_SLEN2_NP = np.array([s[1] for s in _SLEN_TABLE], dtype=np.uint32)


def strict_scalefactors_device(
    spectrum: jax.Array, sample_rate: int, is_long: jax.Array
) -> dict:
    """Per-granule scalefactors for real_scalefactors. spectrum [..., 576];
    is_long [...] bool. Returns dict: sf [..., 21] int32, compress, slen1,
    slen2, part2 [...] int32, mag_scale [..., 576] f32 (1.0 where not long).

    Exponent-difference law (see reference.strict_scalefactors): bit-exact
    vs the golden because jnp.frexp/np.frexp agree on float32 exactly.
    """
    members = _BAND_MEMBERS.get(sample_rate, _BAND_MEMBERS[44100])
    bounds = np.concatenate([[0], np.cumsum(band_table(sample_rate))]).astype(int)
    absx = jnp.abs(spectrum)
    gp = jnp.max(absx, axis=-1)
    _, ge = jnp.frexp(gp)

    # Band peaks as STATIC SLICE maxima (bands are contiguous), not masked
    # maxes over the full 576 — same exact f32 result, a fraction of the
    # work (as in _switching_sfd_device).
    sfs = []
    for b in range(21):
        pb = jnp.max(absx[..., int(bounds[b]) : int(bounds[b + 1])], axis=-1)
        _, pe = jnp.frexp(pb)
        cap = 15 if b < 11 else 7
        sf_b = jnp.clip((ge - pe) // 3, 0, cap)
        sf_b = jnp.where((pb > 0) & (gp > 0) & is_long, sf_b, 0)
        sfs.append(sf_b.astype(jnp.int32))
    sf = jnp.stack(sfs, axis=-1)  # [..., 21]

    return _sf_finish_device(sf, members, spectrum)


def _sf_finish_device(sf: jax.Array, members, spectrum: jax.Array) -> dict:
    """Shared tail of the scalefactor laws: smallest scalefac_compress whose
    (slen1, slen2) hold each group's max, part2 bits, and the per-
    coefficient 2^(0.75*sf) magnitude multipliers."""

    def bitlen(m):
        return jnp.where(
            m == 0, 0, jnp.where(m <= 1, 1, jnp.where(m <= 3, 2, jnp.where(m <= 7, 3, 4)))
        )

    need1 = bitlen(jnp.max(sf[..., :11], axis=-1))
    need2 = bitlen(jnp.max(sf[..., 11:], axis=-1))
    compress = jnp.full(need1.shape, 15, dtype=jnp.int32)
    for c in range(15, -1, -1):  # descending: the smallest valid index wins
        s1, s2 = _SLEN_TABLE[c]
        ok = (need1 <= s1) & (need2 <= s2)
        compress = jnp.where(ok, c, compress)
    slen1 = _select_tree(compress, _SLEN1_NP, 0, 16).astype(jnp.int32)
    slen2 = _select_tree(compress, _SLEN2_NP, 0, 16).astype(jnp.int32)
    part2 = 11 * slen1 + 10 * slen2

    mult_b = sf_mult34_lookup(sf)  # [..., 21]
    # Band->coefficient broadcast as ONE exact one-hot matmul instead of 21
    # sequential wheres over [..., 576]: members' columns are one-hot (each
    # coefficient belongs to at most one band), so the f32 HIGHEST dot
    # returns the band value bit-exactly (0/1 operand is lossless in the
    # bf16x3 decomposition) and the +tail term restores 1.0 above band 20.
    vals = jnp.where(sf > 0, mult_b, jnp.float32(1.0))  # [..., 21]
    members_f = jnp.asarray(members, jnp.float32)  # [21, 576]
    tail = jnp.asarray(1.0 - members.any(axis=0), jnp.float32)  # [576]
    mag_scale = (
        jax.lax.dot_general(
            vals,
            members_f,
            dimension_numbers=(((vals.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        + tail
    )
    return {
        "sf": sf,
        "compress": compress,
        "slen1": slen1,
        "slen2": slen2,
        "part2": part2.astype(jnp.int32),
        "mag_scale": mag_scale,
    }


# Twin constants of reference.PSY_SLOPE / PSY_ALPHA_* (tests assert they
# match): mask skirt in exponent units per band; fraction of the mask gap
# converted to scalefactor amplification.
_PSY_SLOPE = 4
_PSY_ALPHA_NUM, _PSY_ALPHA_DEN = 1, 2


def psy_scalefactors_device(
    spectrum: jax.Array, sample_rate: int, is_long: jax.Array
) -> dict:
    """Masking-driven scalefactors (options.psy_scalefactors): device twin
    of reference.psy_scalefactors. All-integer exponent arithmetic (frexp of
    band peaks + max-plus spreading scans), so golden and device agree
    bit-exactly by construction."""
    members = _BAND_MEMBERS.get(sample_rate, _BAND_MEMBERS[44100])
    absx = jnp.abs(spectrum)
    gp = jnp.max(absx, axis=-1)
    _, ge = jnp.frexp(gp)
    EMPTY = -(1 << 14)

    pes = []
    for b in range(21):
        pb = jnp.max(jnp.where(members[b], absx, 0.0), axis=-1)
        _, pe_b = jnp.frexp(pb)
        pes.append(jnp.where(pb > 0, pe_b.astype(jnp.int32), EMPTY))
    # max-plus spreading: M_b = max_b' (pe_b' - PSY_SLOPE*|b-b'|)
    Ms = list(pes)
    for b in range(1, 21):
        Ms[b] = jnp.maximum(Ms[b], Ms[b - 1] - _PSY_SLOPE)
    for b in range(19, -1, -1):
        Ms[b] = jnp.maximum(Ms[b], Ms[b + 1] - _PSY_SLOPE)
    M = jnp.stack(Ms, axis=-1)  # [..., 21]
    pe = jnp.stack(pes, axis=-1)
    m_max = jnp.max(M, axis=-1, keepdims=True)

    gap = m_max - M  # >= 0
    v = (_PSY_ALPHA_NUM * gap) // _PSY_ALPHA_DEN
    v = jnp.minimum(v, jnp.maximum(0, ge[..., None].astype(jnp.int32) - pe))
    caps = jnp.asarray([15] * 11 + [7] * 10, dtype=jnp.int32)
    sf = jnp.clip(v, 0, caps)
    sf = jnp.where(pe == EMPTY, 0, sf)
    sf = jnp.where(((gp > 0) & is_long)[..., None], sf, 0).astype(jnp.int32)
    return _sf_finish_device(sf, members, spectrum)


# Distortion control (options.distortion_control): twins of
# reference.distortion_bumps / DC_* constants. The threshold law is
# exponent-exact across backends (frexp + integer max-plus spread +
# ldexp); only the band error-energy SUMS are float reductions, so bump
# decisions can ULP-flip on knife-edge content (same cross-backend
# contract as the transient energy-ratio compare).
_DC_RATIO = 2.0
_DC_BUMP = 3
_DC_MASK_OFFSET = 6
_DC_CAPS = np.asarray([15] * 11 + [7] * 10, dtype=np.int32)


def distortion_bumps_device(
    spectrum: jax.Array, q: jax.Array, gain: jax.Array, sf: jax.Array,
    sample_rate: int, proportional: bool = False,
) -> jax.Array:
    """Per-band bump vector [..., 21] int32 (twin of
    reference.distortion_bumps): reconstruct the probe quantization per
    the ISO decode law (scalefac_scale=1), measure band error energy
    against the spread-mask target, bump violators by _DC_BUMP — or,
    proportional (options.dc_proportional), by ceil(log2(noise/mask)/2)
    clipped to 1..DC_BUMP_MAX (the f32 log2 vs the golden's float64 is a
    knife-edge flip surface, same contract as the bump compare)."""
    members = _BAND_MEMBERS.get(sample_rate, _BAND_MEMBERS[44100])
    # step = 2^((gain-210)/4), correctly rounded f32 via exact ldexp of the
    # quarter-power constants (matches the golden's float64-built value)
    e = gain - 210
    qq, r = e >> 2, e & 3
    base = jax.lax.bitcast_convert_type(
        _select_tree(r, _QUARTER_POS.view(np.uint32), 0, 4), jnp.float32
    )
    step = jnp.ldexp(base, qq).astype(jnp.float32)

    aq = jnp.abs(q).astype(jnp.float32)
    mag = jnp.power(aq, _F32(4.0 / 3.0)) * step[..., None]
    xr = jnp.where(q < 0, -mag, mag)
    # per-line 2^(-sf_band): exact powers of two
    pow2 = jnp.ldexp(_F32(1.0), -sf)  # [..., 21]
    scale_full = jnp.ones(spectrum.shape, jnp.float32)
    for b in range(21):
        scale_full = jnp.where(members[b], pow2[..., b : b + 1], scale_full)
    err = xr * scale_full - spectrum
    err2 = err * err

    EMPTY = -(1 << 14)
    pes, e2s = [], []
    absx = jnp.abs(spectrum)
    for b in range(21):
        pb = jnp.max(jnp.where(members[b], absx, 0.0), axis=-1)
        _, pe_b = jnp.frexp(pb)
        pes.append(jnp.where(pb > 0, pe_b.astype(jnp.int32), EMPTY))
        e2s.append(jnp.sum(jnp.where(members[b], err2, 0.0), axis=-1))
    Ms = list(pes)
    for b in range(1, 21):
        Ms[b] = jnp.maximum(Ms[b], Ms[b - 1] - _PSY_SLOPE)
    for b in range(19, -1, -1):
        Ms[b] = jnp.maximum(Ms[b], Ms[b + 1] - _PSY_SLOPE)
    thr_exp = jnp.stack(Ms, axis=-1) - _DC_MASK_OFFSET  # [..., 21]
    n_lines = jnp.asarray(
        np.diff(np.concatenate([[0], np.cumsum(band_table(sample_rate))])
                ).astype(np.float32)
    )
    thr2n = jnp.ldexp(n_lines, 2 * thr_exp)
    e2 = jnp.stack(e2s, axis=-1)
    violated = e2 > _F32(_DC_RATIO) * thr2n
    if proportional:
        from .reference import DC_BUMP_MAX

        # Exact twin of the golden's clip(ceil(0.5*log2(e2/thr2n)), 1,
        # cap) WITHOUT floats-on-device log2: steps >= k+1 iff the f64
        # ratio r > 4^k, and since e2/thr2n are f32 values (exact in
        # f64) and ldexp(thr2n, 2k) is an exact power-of-4 scale, the
        # f32 comparison e2 > ldexp(thr2n, 2k) decides it bit-exactly —
        # the proportional step count adds NO new flip surface beyond
        # the existing violation compare.
        steps = jnp.ones(e2.shape, jnp.int32)
        for k in range(1, DC_BUMP_MAX):
            steps = steps + (e2 > jnp.ldexp(thr2n, 2 * k)).astype(jnp.int32)
        return jnp.where(violated, steps, 0).astype(jnp.int32)
    return jnp.where(violated, _DC_BUMP, 0).astype(jnp.int32)


def distortion_sfd_device(
    sfd: dict, bumps: jax.Array, engaged: jax.Array, spectrum: jax.Array,
    sample_rate: int,
) -> dict:
    """Merged scalefactor dict after distortion-control bumps: engaged
    granules (all-LONG frames) get the rebuilt long-layout sfd from the
    bumped sf vector; everything else keeps the original fields exactly
    (twin of the golden's _long_sfd rebuild on bumped granules only)."""
    sf2 = jnp.minimum(sfd["sf"] + bumps, jnp.asarray(_DC_CAPS))
    sf2 = jnp.where(engaged[..., None], sf2, sfd["sf"]).astype(jnp.int32)
    return _rebuild_long_sfd_device(sfd, sf2, engaged, spectrum, sample_rate)


def _rebuild_long_sfd_device(
    sfd: dict, sf2: jax.Array, engaged: jax.Array, spectrum: jax.Array,
    sample_rate: int,
) -> dict:
    """Shared merge tail of distortion_sfd_device / intensity_sfd_device:
    rebuild the long-layout sfd fields from a replacement sf vector and
    keep the original fields exactly on non-engaged granules."""
    members = _BAND_MEMBERS.get(sample_rate, _BAND_MEMBERS[44100])
    fin = _sf_finish_device(sf2, members, spectrum)
    pad = jnp.zeros(sf2.shape[:-1] + (SF_SLOTS - 21,), jnp.int32)
    sf_slots2 = jnp.concatenate([sf2, pad], axis=-1)
    slot_w1 = jnp.asarray(
        np.concatenate([np.ones(11), np.zeros(SF_SLOTS - 11)]).astype(np.int32)
    )
    slot_w2 = jnp.asarray(
        np.concatenate(
            [np.zeros(11), np.ones(10), np.zeros(SF_SLOTS - 21)]
        ).astype(np.int32)
    )
    slot_nbits2 = (
        fin["slen1"][..., None] * slot_w1 + fin["slen2"][..., None] * slot_w2
    ).astype(jnp.int32)
    new = {
        "sf": sf2,
        "sf_slots": sf_slots2,
        "slot_nbits": slot_nbits2,
        "compress": fin["compress"],
        "slen1": fin["slen1"],
        "slen2": fin["slen2"],
        "part2": fin["part2"],
        "mag_scale": fin["mag_scale"],
    }

    def sel(name):
        a, b = new[name], sfd[name]
        e = engaged.reshape(engaged.shape + (1,) * (a.ndim - engaged.ndim))
        return jnp.where(e, a, b)

    return {k: sel(k) for k in new}


# --- Intensity stereo ENCODING (device twins of ops.reference's laws) --------
# Twin of reference.intensity_positions / intensity_encode and of the
# encoder.py stage-2 position fixup; MPEG-1 only (options validation).
# Every decision here is a float REDUCTION (band energies, correlations,
# position rounding), so knife-edge granules can flip across backends —
# the ULP-flip contract, same as distortion_control's bump compare.

from .reference import IS_CORR, IS_MIN_SFB, IS_NEG, IS_SFM  # noqa: E402


def _carrier_noise_flat_device(c: jax.Array) -> jax.Array:
    """Device twin of reference._carrier_noise_flat: spectral flatness of
    the would-be carrier's upper lines over the LIVE (nonzero) lines only
    (hq's adaptive lowpass zero-fills the tail; naturally-zero float MDCT
    lines do not occur, so hb2 > 0 isolates the live region). c [..., W];
    returns bool [...]. f32 reductions where golden accumulates f64 —
    knife-edge granules flip under the ULP contract like every IS gate."""
    hb2 = c * c
    live = hb2 > 0
    n_live = jnp.sum(live, axis=-1)
    denom = jnp.maximum(n_live, 1).astype(jnp.float32)
    m = jnp.sum(hb2, axis=-1) / denom
    g = jnp.exp(
        jnp.sum(jnp.where(live, jnp.log(jnp.where(live, hb2, 1.0)), 0.0), axis=-1)
        / denom
    )
    return (n_live == 0) | (g / (m + _F32(1e-20)) > _F32(IS_SFM))


def _is_members_ext(sample_rate: int) -> np.ndarray:
    """[21, 576] f32 band membership with band 20 extended to line 576:
    the intensity laws fold the sfb21 tail into band 20 (the tail rides
    slot 20's position in every validated decoder reading)."""
    bounds = np.concatenate([[0], np.cumsum(band_table(sample_rate))]).astype(int)
    coef = np.arange(576)
    return np.stack(
        [
            (coef >= bounds[b]) & (coef < (bounds[b + 1] if b < 20 else 576))
            for b in range(21)
        ]
    ).astype(np.float32)


_IS_RATES = (44100, 48000, 32000)  # intensity encoding is MPEG-1 only
_IS_MEMBERS_EXT = {sr: _is_members_ext(sr) for sr in _IS_RATES}
_IS_BOUNDS = {
    sr: np.concatenate([[0], np.cumsum(band_table(sr))]).astype(np.int32)
    for sr in _IS_RATES
}


def intensity_analyze_device(
    spec_l: jax.Array, spec_r: jax.Array, sample_rate: int
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-granule intensity analysis on long-layout spectra pairs
    [..., 576]. Returns (pos [..., 21] int32 pan positions, region
    [..., 21] bool contiguous-from-the-top qualified bands, has_region
    [...] bool, line_mask [..., 576] f32 — 1.0 on region lines).

    Qualification per band (reference.intensity_encode): effectively
    panned (quieter channel under IS_NEG of the louder) or positively
    correlated (>= IS_CORR); bands join only as a contiguous region up
    from b0 >= IS_MIN_SFB, and a region holding under IS_NEG of the right
    channel's energy is rejected (nothing saved; phantom content risk)."""
    M = jnp.asarray(_IS_MEMBERS_EXT[sample_rate])  # [21, 576]
    el = jnp.einsum("...l,bl->...b", spec_l * spec_l, M, precision=_HIGHEST)
    er = jnp.einsum("...l,bl->...b", spec_r * spec_r, M, precision=_HIGHEST)
    num = jnp.einsum("...l,bl->...b", spec_l * spec_r, M, precision=_HIGHEST)
    pos = jnp.clip(
        jnp.round(
            jnp.arctan2(jnp.sqrt(el), jnp.sqrt(er)) * _F32(12.0 / np.pi)
        ),
        0,
        6,
    ).astype(jnp.int32)
    panned = jnp.minimum(el, er) <= _F32(IS_NEG) * jnp.maximum(el, er)
    # corr is NaN only where a band energy is zero — covered by `panned`
    # (NaN >= IS_CORR is False, so the | stays exact)
    corr = num / jnp.sqrt(el * er)
    ok = (panned | (corr >= _F32(IS_CORR))) & (jnp.arange(21) >= IS_MIN_SFB)
    # contiguous-from-the-top region: band b is in iff ok[b..20] all hold
    region = jnp.flip(
        jnp.cumsum(jnp.flip(~ok, -1).astype(jnp.int32), -1), -1
    ) == 0
    er_region = jnp.sum(jnp.where(region, er, 0.0), axis=-1)
    er_total = jnp.sum(er, axis=-1)
    cut0 = int(_IS_BOUNDS[sample_rate][IS_MIN_SFB])
    noise_flat = _carrier_noise_flat_device(
        spec_l[..., cut0:] + spec_r[..., cut0:]
    )
    has_region = (
        region[..., 20]
        & (er_region > _F32(IS_NEG) * (er_total + _F32(1e-30)))
        & ~noise_flat
    )
    line_mask = jnp.einsum(
        "...b,bl->...l", region.astype(jnp.float32), M, precision=_HIGHEST
    )
    return pos, region, has_region, line_mask


def intensity_q_fixup(
    q: jax.Array, engaged: jax.Array, sample_rate: int
) -> jax.Array:
    """Knife-edge fixup on selected quantizations (twin of encoder.py's
    stage-2 zeroing): an engaged granule whose quantized extent ends
    inside (bounds[20], bounds[21]] cannot express both band 20's real
    scalefactor and the sfb21 tail's position in slot 20 — zero the
    band-20 remainder (the tail is already zero in that window). Must run
    BEFORE the entropy layout (big_values/regions/bits see the fixed q)."""
    bounds = _IS_BOUNDS[sample_rate]
    z_ext = jnp.max(
        jnp.where(q != 0, jnp.arange(1, 577, dtype=jnp.int32), 0), axis=-1
    )
    knife = engaged & (z_ext > int(bounds[20])) & (z_ext <= int(bounds[21]))
    keep = ~(knife[..., None] & (jnp.arange(576) >= int(bounds[20])))
    return jnp.where(keep, q, 0)


def intensity_sfd_device(
    sfd: dict,
    quantized: jax.Array,
    pos: jax.Array,
    summed: jax.Array,
    engaged: jax.Array,
    spectrum: jax.Array,
    sample_rate: int,
) -> dict:
    """Post-walk intensity position slots (twin of encoder.py's stage-2
    overwrite): for engaged granules (the right channel of emitted IS
    frames), every scalefactor slot at/above the band containing the
    final quantized extent is overwritten — real positions on SUMMED
    bands, the illegal marker 7 on un-summed ones (decoders keep the
    exact L/R reading there). `quantized` must already carry the
    knife-edge zeroing (intensity_q_fixup)."""
    bounds = _IS_BOUNDS[sample_rate]
    z_ext = jnp.max(
        jnp.where(quantized != 0, jnp.arange(1, 577, dtype=jnp.int32), 0),
        axis=-1,
    )
    # first band with bounds[b] >= z_ext (numpy searchsorted 'left' twin)
    b_start = jnp.sum(
        jnp.asarray(bounds[:21]) < z_ext[..., None], axis=-1
    )
    emit = jnp.where(summed, pos, 7)
    write = jnp.arange(21) >= b_start[..., None]
    sf2 = jnp.where(
        write & engaged[..., None], emit, sfd["sf"]
    ).astype(jnp.int32)
    return _rebuild_long_sfd_device(sfd, sf2, engaged, spectrum, sample_rate)


def intensity_padded_part2_device(
    sfd: dict, spectrum: jax.Array, sample_rate: int
) -> jax.Array:
    """Priced part2 bits covering max(scalefactor, 7) per slot (twin of
    encoder.py's up-front pricing): the post-walk overwrite can grow any
    slot to the illegal marker 7, and actual emitted bits must never
    exceed the priced budget (the real reservoir mirror)."""
    members = _BAND_MEMBERS.get(sample_rate, _BAND_MEMBERS[44100])
    fin = _sf_finish_device(jnp.maximum(sfd["sf"], 7), members, spectrum)
    return fin["part2"]


# --- Short-window intensity ENCODING (round 5; twins of
# reference.intensity_encode_short and the per-window stage-2 laws) ----------

from .reference import IS_MIN_SFB_SHORT  # noqa: E402


def _is_members_short(sample_rate: int) -> np.ndarray:
    """[36, 576] f32 per-(band, window) natural membership, slot-major
    (row 3*s + w); band 11 folds the per-window tail to line 192."""
    from ..tables import short_band_bounds

    bounds = short_band_bounds(sample_rate)
    line = np.arange(576) // 3
    w_of = np.arange(576) % 3
    rows = []
    for s in range(12):
        lo = int(bounds[s])
        hi = int(bounds[s + 1]) if s < 11 else 192
        for w in range(3):
            rows.append((line >= lo) & (line < hi) & (w_of == w))
    return np.stack(rows).astype(np.float32)


def _sb_bounds_for(sample_rate: int) -> np.ndarray:
    from ..tables import short_band_bounds

    return np.asarray(short_band_bounds(sample_rate)[:13], dtype=np.int32)


_IS_MEMBERS_SHORT = {sr: _is_members_short(sr) for sr in _IS_RATES}
_IS_SB_BOUNDS = {sr: _sb_bounds_for(sr) for sr in _IS_RATES}


def intensity_analyze_short_device(
    spec_l: jax.Array, spec_r: jax.Array, sample_rate: int
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-(band, window) intensity analysis on NATURAL-layout pure-short
    spectra pairs [..., 576] (twin of reference.intensity_encode_short).
    Returns (pos [..., 12, 3] int32, region [..., 12, 3] bool, has_region
    [..., 3] bool per window, line_mask [..., 576] f32)."""
    M = jnp.asarray(_IS_MEMBERS_SHORT[sample_rate])  # [36, 576]
    lead = spec_l.shape[:-1]
    el = jnp.einsum(
        "...l,bl->...b", spec_l * spec_l, M, precision=_HIGHEST
    ).reshape(*lead, 12, 3)
    er = jnp.einsum(
        "...l,bl->...b", spec_r * spec_r, M, precision=_HIGHEST
    ).reshape(*lead, 12, 3)
    num = jnp.einsum(
        "...l,bl->...b", spec_l * spec_r, M, precision=_HIGHEST
    ).reshape(*lead, 12, 3)
    pos = jnp.clip(
        jnp.round(
            jnp.arctan2(jnp.sqrt(el), jnp.sqrt(er)) * _F32(12.0 / np.pi)
        ),
        0,
        6,
    ).astype(jnp.int32)
    panned = jnp.minimum(el, er) <= _F32(IS_NEG) * jnp.maximum(el, er)
    corr = num / jnp.sqrt(el * er)
    ok = (panned | (corr >= _F32(IS_CORR))) & (
        jnp.arange(12)[:, None] >= IS_MIN_SFB_SHORT
    )
    # contiguous-from-the-top per window (along the band axis)
    region = (
        jnp.flip(
            jnp.cumsum(jnp.flip(~ok, -2).astype(jnp.int32), -2), -2
        )
        == 0
    )
    er_region = jnp.sum(jnp.where(region, er, 0.0), axis=-2)  # [..., 3]
    er_total = jnp.sum(er, axis=-2)
    # per-WINDOW flatness (granule-level would blind the gate on transient
    # granules — the quiet windows' tiny lines drag the geometric mean
    # down; see reference.intensity_encode_short)
    cut0 = int(_short_band_bounds(sample_rate)[IS_MIN_SFB_SHORT])
    c3 = (spec_l + spec_r)[..., 3 * cut0 :].reshape(
        *spec_l.shape[:-1], 192 - cut0, 3
    )
    noise_flat = _carrier_noise_flat_device(
        jnp.swapaxes(c3, -1, -2)
    )  # [..., 3]
    has_region = (
        region[..., 11, :]
        & (er_region > _F32(IS_NEG) * (er_total + _F32(1e-30)))
        & ~noise_flat
    )
    line_mask = jnp.einsum(
        "...b,bl->...l",
        (region & has_region[..., None, :]).astype(jnp.float32).reshape(
            *lead, 36
        ),
        M,
        precision=_HIGHEST,
    )
    return pos, region, has_region, line_mask


def intensity_q_fixup_short(
    q: jax.Array, engaged: jax.Array, sample_rate: int
) -> jax.Array:
    """Per-window knife-edge fixup (twin of encoder.py's short stage-2
    zeroing): an engaged pure-short granule whose window extent ends
    inside (sb[11], 192] cannot express both band 11's scalefactor and
    the per-window tail's position — zero the band-11 remainder in that
    window. NATURAL layout; runs BEFORE the reorder/entropy layout."""
    sbb = _IS_SB_BOUNDS[sample_rate]
    lead = q.shape[:-1]
    q3 = q.reshape(*lead, 192, 3)
    z_w = jnp.max(
        jnp.where(
            q3 != 0, jnp.arange(1, 193, dtype=jnp.int32)[:, None], 0
        ),
        axis=-2,
    )  # [..., 3] per-window line extents
    knife = engaged[..., None] & (z_w > int(sbb[11]))
    keep = ~(
        knife[..., None, :]
        & (jnp.arange(192)[:, None] >= int(sbb[11]))
    )
    return jnp.where(keep, q3, 0).reshape(*lead, 576)


def intensity_sfd_short_device(
    sfd: dict,
    quantized: jax.Array,
    pos: jax.Array,
    summed: jax.Array,
    engaged: jax.Array,
    sample_rate: int,
) -> dict:
    """Per-window post-walk position slots (twin of encoder.py's short
    stage-2 overwrite): for engaged pure-short granules, every
    (band, window) slot at/above the window's final quantized extent is
    overwritten — real positions on SUMMED bands, the illegal marker 7
    elsewhere; the sfd finisher fields rebuild via the MPEG-1 short
    grouping (18, 18). `quantized` must carry intensity_q_fixup_short.
    Non-engaged granules keep every field exactly."""
    sbb = _IS_SB_BOUNDS[sample_rate]
    lead = quantized.shape[:-1]
    q3 = quantized.reshape(*lead, 192, 3)
    z_w = jnp.max(
        jnp.where(
            q3 != 0, jnp.arange(1, 193, dtype=jnp.int32)[:, None], 0
        ),
        axis=-2,
    )  # [..., 3]
    b_start = jnp.sum(
        jnp.asarray(sbb[:12])[:, None] < z_w[..., None, :], axis=-2
    )  # [..., 3]
    emit = jnp.where(summed, pos, 7)  # [..., 12, 3]
    write = jnp.arange(12)[:, None] >= b_start[..., None, :]
    old = sfd["sf_slots"][..., :36].reshape(*lead, 12, 3)
    slots2 = jnp.where(write & engaged[..., None, None], emit, old)
    slots2 = slots2.reshape(*lead, 36).astype(jnp.int32)
    sf_slots2 = slots2
    if SF_SLOTS > 36:
        pad = jnp.zeros((*lead, SF_SLOTS - 36), jnp.int32)
        sf_slots2 = jnp.concatenate([slots2, pad], axis=-1)
    fin = _finish_slots_device(sf_slots2, 18, 18)
    new = {"sf_slots": sf_slots2, **fin}

    def sel(name):
        old_v, new_v = sfd[name], new[name]
        extra = new_v.ndim - engaged.ndim
        e = engaged.reshape(engaged.shape + (1,) * extra)
        return jnp.where(e, new_v, old_v)

    out = dict(sfd)
    for k in new:
        out[k] = sel(k)
    return out


def intensity_padded_part2_short_device(sfd: dict) -> jax.Array:
    """Priced part2 covering max(slot, 7) over the 36 short slots (twin
    of encoder.py's short pricing pad)."""
    padded = jnp.maximum(sfd["sf_slots"][..., :36], 7).astype(jnp.int32)
    fin = _finish_slots_device(padded, 18, 18)
    return fin["part2"]


def initial_gain_scaled(
    spectrum: jax.Array, mag_scale: jax.Array, target: float = 15.0
) -> jax.Array:
    """ISO-law initial gain from scalefactor-scaled magnitudes (twin of
    reference.compute_global_gain_scaled; target = LINBITS_Q_TARGET under
    options.linbits_tables)."""
    absv = jnp.maximum(jnp.abs(spectrum), _F32(1e-10))
    mag = jnp.power(absv, _F32(0.75)) * mag_scale
    peak_pow = jnp.max(mag, axis=-1)
    ratio = peak_pow / _F32(target)
    safe_ratio = jnp.maximum(ratio, _F32(1e-30))
    gain = 210 + jnp.trunc(_F32(16.0 / 3.0) * jnp.log2(safe_ratio)).astype(jnp.int32)
    gain = jnp.clip(gain, 0, 255)
    raw_peak = jnp.max(jnp.abs(spectrum), axis=-1)
    return jnp.where(raw_peak > 0, gain, 210).astype(jnp.int32)


SF_SLOTS = 36  # twin of reference.SF_SLOTS (transmission slot layout)


def _write_slots_device(write: jax.Array) -> jax.Array:
    """Extend a [..., 21] long-band scfsi write mask to the SF_SLOTS
    layout (twin of reference._write_slots); switching granules never
    share, their long-band mask is all-ones already."""
    pad = jnp.ones(write.shape[:-1] + (SF_SLOTS - write.shape[-1],), dtype=bool)
    return jnp.concatenate([write, pad], axis=-1)


def scalefactor_chunks_device(
    sfd: dict, write: jax.Array | None = None
) -> tuple[jax.Array, jax.Array]:
    """(chunks, nbits) for the SF_SLOTS scalefactor slots per granule (ISO
    2.4.2.7 transmission order; zero-width slots write nothing). `write`
    [..., 21] bool masks scfsi-shared long bands to zero width."""
    nbits = sfd["slot_nbits"]
    if write is not None:
        nbits = jnp.where(_write_slots_device(write), nbits, 0)
    return sfd["sf_slots"], nbits.astype(jnp.int32)


# scfsi group boundaries (ISO 2.4.2.7); twin of reference.SCFSI_GROUPS
_SCFSI_GROUPS = ((0, 6), (6, 11), (11, 16), (16, 21))


def scfsi_device(sf: jax.Array, is_long: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched twin of reference.scfsi_decide over a frame's granule pair.

    sf: [..., 2, 21] int32 (granule axis second-to-last); is_long [..., 2]
    bool. Returns (scfsi_nibble [...] int32 — the 4 side-info bits packed
    MSB-first, write [..., 2, 21] bool — granule-1 shared bands False)."""
    sf0, sf1 = sf[..., 0, :], sf[..., 1, :]
    both_long = is_long[..., 0] & is_long[..., 1]
    write1 = jnp.ones(sf1.shape, dtype=bool)
    nibble = jnp.zeros(both_long.shape, dtype=jnp.int32)
    for g, (lo, hi) in enumerate(_SCFSI_GROUPS):
        eq = jnp.all(sf0[..., lo:hi] == sf1[..., lo:hi], axis=-1)
        shared = eq & both_long
        nibble = nibble + (shared.astype(jnp.int32) << (3 - g))
        gmask = (jnp.arange(21) >= lo) & (jnp.arange(21) < hi)
        write1 = write1 & ~(shared[..., None] & gmask)
    write = jnp.stack([jnp.ones_like(write1), write1], axis=-2)  # [..., 2, 21]
    return nibble, write


def scfsi_part2_device(sfd: dict, write: jax.Array) -> jax.Array:
    """part2 bits per granule when only `write`-masked bands are emitted
    (twin of reference.scfsi_part2_bits): sum of the emitted slot widths."""
    nbits = jnp.where(_write_slots_device(write), sfd["slot_nbits"], 0)
    return jnp.sum(nbits, axis=-1).astype(jnp.int32)


# --- iso_short_blocks: short/mixed scalefactors + ISO 2.4.3.4.8 reorder ------
# Device twins of reference.short_scalefactors / granule_scalefactors and of
# the tables.short_reorder_src / mixed_reorder_src permutations. The reorder
# is implemented as static per-band slice+transpose over a [..., 192, 3]
# (line, window) view — natural coefficient sb*18 + 3m + w == 3*line + w —
# not a gather: these compile to plain relayout copies.

from ..tables import short_band_bounds as _short_band_bounds  # noqa: E402


def reorder_natural_to_stream(
    x: jax.Array, sample_rate: int, mixed: bool
) -> jax.Array:
    """x [..., 576] natural (subband-major) -> ISO stream order
    (short-sfb-major, the three windows of a band consecutive). mixed
    keeps the stream-layout long head (the first 3 short bands' worth of
    natural coefficients: 36, or 72 at 8 kHz — tables.mixed_reorder_src)
    in place and reorders the lines above."""
    bounds = [int(b) for b in _short_band_bounds(sample_rate)]
    lead = x.shape[:-1]
    x3 = x.reshape(*lead, 192, 3)
    parts = []
    if mixed:
        head_l = bounds[3]  # lines/window covered by the long head
        parts.append(x[..., : 3 * head_l])
        spans = [
            (s, e) for s, e in zip(bounds[:-1], bounds[1:]) if s >= head_l
        ]
    else:
        spans = list(zip(bounds[:-1], bounds[1:]))
    for s, e in spans:
        blk = jnp.swapaxes(x3[..., s:e, :], -1, -2)  # [..., 3, width]
        parts.append(blk.reshape(*lead, 3 * (e - s)))
    return jnp.concatenate(parts, axis=-1)


def reorder_stream_to_natural(
    x: jax.Array, sample_rate: int, mixed: bool
) -> jax.Array:
    """Inverse of reorder_natural_to_stream (same static slice/transpose
    economics, no gathers): ISO stream order -> natural subband-major."""
    bounds = [int(b) for b in _short_band_bounds(sample_rate)]
    lead = x.shape[:-1]
    parts = []
    off = 0
    if mixed:
        head_l = bounds[3]
        parts.append(x[..., : 3 * head_l].reshape(*lead, head_l, 3))
        off = 3 * head_l
        spans = [
            (s, e) for s, e in zip(bounds[:-1], bounds[1:]) if s >= head_l
        ]
    else:
        spans = list(zip(bounds[:-1], bounds[1:]))
    for s, e in spans:
        width = e - s
        blk = x[..., off : off + 3 * width].reshape(*lead, 3, width)
        parts.append(jnp.swapaxes(blk, -1, -2))  # [..., width, 3]
        off += 3 * width
    return jnp.concatenate(parts, axis=-2).reshape(*lead, 576)


def _finish_slots_device(
    sf_slots: jax.Array, n1_slots: int, n2_slots: int
) -> dict:
    """compress/slen/slot_nbits/part2 from slot values (twin of
    reference._finish_slots): group 1 = first n1_slots slots (slen1),
    group 2 = next n2_slots (slen2)."""

    def bitlen(m):
        return jnp.where(
            m == 0, 0, jnp.where(m <= 1, 1, jnp.where(m <= 3, 2, jnp.where(m <= 7, 3, 4)))
        )

    need1 = bitlen(jnp.max(sf_slots[..., :n1_slots], axis=-1))
    need2 = bitlen(jnp.max(sf_slots[..., n1_slots : n1_slots + n2_slots], axis=-1))
    compress = jnp.full(need1.shape, 15, dtype=jnp.int32)
    for c in range(15, -1, -1):  # descending: the smallest valid index wins
        s1, s2 = _SLEN_TABLE[c]
        ok = (need1 <= s1) & (need2 <= s2)
        compress = jnp.where(ok, c, compress)
    slen1 = _select_tree(compress, _SLEN1_NP, 0, 16).astype(jnp.int32)
    slen2 = _select_tree(compress, _SLEN2_NP, 0, 16).astype(jnp.int32)
    slot_w = np.zeros(SF_SLOTS, dtype=np.int32)
    slot_w[:n1_slots] = 1
    slot_w2 = np.zeros(SF_SLOTS, dtype=np.int32)
    slot_w2[n1_slots : n1_slots + n2_slots] = 1
    slot_nbits = (
        slen1[..., None] * jnp.asarray(slot_w) + slen2[..., None] * jnp.asarray(slot_w2)
    ).astype(jnp.int32)
    return {
        "compress": compress,
        "slen1": slen1,
        "slen2": slen2,
        "slot_nbits": slot_nbits,
        "part2": (n1_slots * slen1 + n2_slots * slen2).astype(jnp.int32),
    }


def _finish_slots_lsf_device(sf_slots: jax.Array, ns: tuple) -> dict:
    """LSF (ISO 13818-3 2.4.3.2) case-0 finisher (twin of
    reference._finish_slots_lsf): 4 slot groups of ns[k] slots at
    slen_k = bit_length(group max); compress = the case-0 composition
    ((s1*5+s2)*4+s3)*4+s4 (decoder reading: _lsf_sf_expand(sf, 5, 4, 4)).
    The band caps (15/15/7/7 at the group positions) bound the slens at
    (4,4,3,3), so compress < 400 always — case 0 by construction."""

    def bitlen(m):
        return jnp.where(
            m == 0, 0, jnp.where(m <= 1, 1, jnp.where(m <= 3, 2, jnp.where(m <= 7, 3, 4)))
        )

    bounds = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    slens = [
        bitlen(jnp.max(sf_slots[..., bounds[k] : bounds[k + 1]], axis=-1))
        for k in range(4)
    ]
    compress = ((slens[0] * 5 + slens[1]) * 4 + slens[2]) * 4 + slens[3]
    slot_nbits = 0
    part2 = 0
    for k in range(4):
        w = np.zeros(SF_SLOTS, dtype=np.int32)
        w[bounds[k] : bounds[k + 1]] = 1
        slot_nbits = slot_nbits + slens[k][..., None] * jnp.asarray(w)
        part2 = part2 + int(ns[k]) * slens[k]
    return {
        "compress": compress.astype(jnp.int32),
        # dict-shape compat with _finish_slots_device (scfsi is never on
        # at LSF; slot_nbits carries the emission law)
        "slen1": slens[0].astype(jnp.int32),
        "slen2": slens[1].astype(jnp.int32),
        "slot_nbits": slot_nbits.astype(jnp.int32),
        "part2": part2.astype(jnp.int32),
    }


def _switching_sfd_device(
    spectrum: jax.Array, sample_rate: int, mixed: bool, lsf: bool = False
) -> dict:
    """Short/mixed scalefactor law over every granule (selection by block
    type happens in granule_scalefactors_device). Twin of
    reference.short_scalefactors: sf = clip((ge - pe) // 3, 0, cap) per
    slot, peak exponents via frexp (bit-exact vs numpy).

    Band peaks are SLICE maxima over the [..., 192, 3] (line, window) view
    and mag_scale is built by broadcast+concat over the static band spans —
    not masked maxes / where-chains over the full 576 per slot (f32 max is
    exact either way)."""
    bounds = [int(b) for b in _short_band_bounds(sample_rate)]
    lead = spectrum.shape[:-1]
    absx = jnp.abs(spectrum)
    gp = jnp.max(absx, axis=-1)
    _, ge = jnp.frexp(gp)
    X3 = absx.reshape(*lead, 192, 3)

    def slot_sfs(pb_w, cap):
        """pb_w [..., 3] band peaks per window -> 3 slot sfs (w order)."""
        _, pe = jnp.frexp(pb_w)
        sf_b = jnp.clip((ge[..., None] - pe) // 3, 0, cap)
        return jnp.where((pb_w > 0) & (gp[..., None] > 0), sf_b, 0).astype(jnp.int32)

    # per-(short band, window) peaks; bands 0-2 are covered by the long
    # head for mixed granules
    first_sfb = 3 if mixed else 0
    short_pb = [
        jnp.max(X3[..., bounds[s] : bounds[s + 1], :], axis=-2)
        for s in range(12)
    ]  # each [..., 3]

    # mixed stream-layout long head: 8 long bands for MPEG-1, the ISO
    # 13818-3 6-band head at LSF rates (72 natural lines at 8 kHz, 36
    # elsewhere — the decoder's validated hybrid reading)
    nlong = 6 if lsf else 8
    sf_parts = []
    if mixed:
        lbounds = np.concatenate([[0], np.cumsum(band_table(sample_rate))])
        for b in range(nlong):
            pb = jnp.max(
                absx[..., int(lbounds[b]) : int(lbounds[b + 1])], axis=-1
            )
            _, pe = jnp.frexp(pb)
            sf_b = jnp.clip((ge - pe) // 3, 0, 15)
            sf_parts.append(
                jnp.where((pb > 0) & (gp > 0), sf_b, 0).astype(jnp.int32)[..., None]
            )
    for s in range(first_sfb, 12):
        cap = 15 if s < 6 else 7
        sf_parts.append(slot_sfs(short_pb[s], cap))
    n1_slots, n2_slots = (17, 18) if mixed else (18, 18)
    sf_slots = jnp.concatenate(sf_parts, axis=-1)  # [..., 33/35/36]
    n_slots = sf_slots.shape[-1]
    if n_slots < SF_SLOTS:
        pad = jnp.zeros((*lead, SF_SLOTS - n_slots), jnp.int32)
        sf_slots = jnp.concatenate([sf_slots, pad], axis=-1)
    fin = (
        _finish_slots_lsf_device(
            sf_slots, LSF_NSF_MIXED if mixed else LSF_NSF_SHORT
        )
        if lsf
        else _finish_slots_device(sf_slots, n1_slots, n2_slots)
    )

    mult = sf_mult34_lookup(sf_slots)  # [..., 36], 1.0 at sf=0 exactly
    # mag_scale by broadcast+concat over the static spans (line, window)
    head_l = bounds[3]  # lines/window under the mixed long head
    line_parts = []
    if mixed:
        # the long head (natural 0..3*head_l) handled separately below;
        # its line rows get placeholders the head concat overwrites
        line_parts.append(jnp.ones((*lead, head_l, 3), jnp.float32))
    slot = nlong if mixed else 0  # index of first short band's slots
    for s in range(first_sfb, 12):
        width = bounds[s + 1] - bounds[s]
        m3 = mult[..., slot : slot + 3]  # [..., 3] (w order)
        line_parts.append(jnp.broadcast_to(m3[..., None, :], (*lead, width, 3)))
        slot += 3
    width_tail = 192 - bounds[12]
    line_parts.append(jnp.ones((*lead, width_tail, 3), jnp.float32))
    mag_scale = jnp.concatenate(line_parts, axis=-2).reshape(*lead, 576)
    if mixed:
        lbounds = np.concatenate([[0], np.cumsum(band_table(sample_rate))])
        head_parts = []
        for b in range(nlong):
            width = int(lbounds[b + 1]) - int(lbounds[b])
            head_parts.append(
                jnp.broadcast_to(mult[..., b : b + 1], (*lead, width))
            )
        head = jnp.concatenate(head_parts, axis=-1)  # [..., 3*head_l]
        mag_scale = jnp.concatenate(
            [head, mag_scale[..., 3 * head_l :]], axis=-1
        )
    return {"sf_slots": sf_slots, "mag_scale": mag_scale, **fin}


def granule_scalefactors_device(
    spectrum: jax.Array,
    sample_rate: int,
    block: jax.Array,
    psy: bool = False,
    iso_short: bool = False,
    lsf: bool = False,
) -> dict:
    """Unified per-granule scalefactor dispatch (twin of
    reference.granule_scalefactors). spectrum [..., 576] natural order;
    block [...] int32. Returns dict with sf [..., 21] (long bands, zeros
    for switching granules — scfsi input), sf_slots [..., 36],
    slot_nbits [..., 36], compress/slen1/slen2/part2 [...],
    mag_scale [..., 576] (natural order).

    Without iso_short, switching granules emit all-zero scalefactors
    (reference behavior: scalefac_compress=0); the long laws are the
    existing strict/psy peak-exponent laws either way. lsf: the 9-bit
    case-0 scalefac_compress finisher replaces the MPEG-1 4-bit one (the
    sf LAWS are unchanged — the LSF group caps coincide with the MPEG-1
    band caps at every slot position; see reference._finish_slots_lsf)."""
    is_long = block == BLOCK_LONG
    law = psy_scalefactors_device if psy else strict_scalefactors_device
    lsfd = law(spectrum, sample_rate, is_long)
    # long layout as slots: bands 0-20 in slots 0-20
    sf = lsfd["sf"]
    pad = jnp.zeros(sf.shape[:-1] + (SF_SLOTS - 21,), jnp.int32)
    sf_slots = jnp.concatenate([sf, pad], axis=-1)
    if lsf:
        fin_l = _finish_slots_lsf_device(sf_slots, LSF_NSF_LONG)
        slot_nbits = fin_l["slot_nbits"]
        lsfd = {**lsfd, **fin_l}
    else:
        slot_w1 = jnp.asarray(
            np.concatenate([np.ones(11), np.zeros(SF_SLOTS - 11)]).astype(np.int32)
        )
        slot_w2 = jnp.asarray(
            np.concatenate([np.zeros(11), np.ones(10), np.zeros(SF_SLOTS - 21)]).astype(np.int32)
        )
        slot_nbits = lsfd["slen1"][..., None] * slot_w1 + lsfd["slen2"][..., None] * slot_w2
    out = {
        "sf": sf,
        "sf_slots": sf_slots,
        "slot_nbits": slot_nbits.astype(jnp.int32),
        "compress": lsfd["compress"],
        "slen1": lsfd["slen1"],
        "slen2": lsfd["slen2"],
        "part2": lsfd["part2"],
        "mag_scale": lsfd["mag_scale"],
    }
    if not iso_short:
        return out
    ssfd = _switching_sfd_device(spectrum, sample_rate, mixed=False, lsf=lsf)
    msfd = _switching_sfd_device(spectrum, sample_rate, mixed=True, lsf=lsf)
    is_mixed = block == BLOCK_MIXED

    def sel(name, long_v):
        v_s, v_m = ssfd[name], msfd[name]
        extra = v_s.ndim - is_long.ndim
        il = is_long.reshape(is_long.shape + (1,) * extra)
        im = is_mixed.reshape(is_mixed.shape + (1,) * extra)
        return jnp.where(il, long_v, jnp.where(im, v_m, v_s))

    out["sf_slots"] = sel("sf_slots", out["sf_slots"])
    out["slot_nbits"] = sel("slot_nbits", out["slot_nbits"])
    out["compress"] = sel("compress", out["compress"])
    out["slen1"] = sel("slen1", out["slen1"])
    out["slen2"] = sel("slen2", out["slen2"])
    out["part2"] = sel("part2", out["part2"])
    out["mag_scale"] = sel("mag_scale", out["mag_scale"])
    return out


# --- Block-sparse MDCT variant --------------------------------------------------
# The dense fold ([.., 576] @ [576, 1188]) spends ~16-33x the FLOPs of the
# per-subband block structure. This variant
# exploits the structure in pure XLA: transpose the granule to subband-major
# [.., 32, 36] (prev||cur on the minor axis), then ONE [36, 18] matmul per
# law with the aliasing butterflies folded as a block-TRIDIAGONAL law
# (neighbor subbands contribute through shifted copies), output landing
# directly in the natural (sb*18 + m) layout. Same nonzero terms as the
# dense fold, so values agree to summation-tree ULPs.


def _build_blocksparse_mats() -> dict:
    """[36, 18] f32 blocks from the same float64 pieces as the dense fold:
    unaliased long (U), short (S), and the long law's tridiagonal aliasing
    blocks (U @ A_delta for neighbor offsets -1/0/+1; interior-subband law,
    edges corrected by strip selection in the caller)."""
    W36 = np.asarray(LONG_WINDOW, dtype=np.float64)
    ML = np.asarray(LONG_MDCT_MATRIX, dtype=np.float64)
    SW = np.asarray(SHORT_WINDOW, dtype=np.float64)
    MS = np.asarray(SHORT_MDCT_MATRIX, dtype=np.float64)
    U = np.einsum("t,mt->tm", W36, ML) / 9.0  # [36, 18] combined-t x m

    Sb = np.zeros((36, 18))
    for w in range(3):
        for j in range(12):
            u = 6 * w + 6 + j
            for m in range(6):
                Sb[u, 3 * m + w] += SW[j] * MS[m, j] / 3.0

    cs = np.asarray(ALIASING_CS, dtype=np.float64)
    ca = np.asarray(ALIASING_CA, dtype=np.float64)
    # interior-subband aliasing blocks over the m-index space:
    # out[sb, m] = sum_{m'} unal[sb, m']*A0[m', m]
    #            + unal[sb-1, m']*Am1[m', m] + unal[sb+1, m']*Ap1[m', m]
    A0 = np.eye(18)
    Am1 = np.zeros((18, 18))
    Ap1 = np.zeros((18, 18))
    for j in range(8):
        A0[17 - j, 17 - j] = cs[j]  # upper strip (boundary above)
        A0[j, j] = cs[j]  # lower strip (boundary below)
        Am1[17 - j, j] = -ca[j]  # neighbor below's upper -> our lower
        Ap1[j, 17 - j] = ca[j]  # neighbor above's lower -> our upper
    f32 = lambda x: jnp.asarray(x.astype(np.float32))  # noqa: E731
    return {
        "U": f32(U),
        "S": f32(Sb),
        "T0": f32(U @ A0),
        "Tm1": f32(U @ Am1),
        "Tp1": f32(U @ Ap1),
    }


_BS_MATS = None


def mdct_chunk_blocksparse(
    S: jax.Array,
    overlap: jax.Array,
    block_type: jax.Array,
    iso_mixed_alias: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Drop-in twin of mdct_chunk computing the block-sparse formulation.
    Values equal the dense fold's to summation-tree ULPs (same nonzero
    terms, different grouping) — A/B the full step before adopting."""
    global _BS_MATS
    if _BS_MATS is None:
        _BS_MATS = _build_blocksparse_mats()
    M = _BS_MATS
    lead = S.shape[:-2]
    n_gran = S.shape[-2] // 18
    flat = S.reshape(*lead, n_gran, 576)
    signed = flat * _SIGN_FLAT
    ext = jnp.concatenate([overlap[..., None, :], signed], axis=-2)
    prev = jax.lax.slice_in_dim(ext, 0, n_gran, axis=-2)
    cur = jax.lax.slice_in_dim(ext, 1, n_gran + 1, axis=-2)

    # the explicit relayout: (t, sb) -> (sb, t); prev||cur on the minor axis
    def to_sb_major(x):  # [..., G, 576] -> [..., G, 32, 18]
        return jnp.swapaxes(x.reshape(*lead, n_gran, 18, 32), -1, -2)

    X = jnp.concatenate([to_sb_major(prev), to_sb_major(cur)], axis=-1)
    # [..., G, 32, 36]

    mm = lambda a, b: jnp.matmul(a, b, precision=_HIGHEST)  # noqa: E731
    unal = mm(X, M["U"])  # [..., G, 32, 18]
    short = mm(X, M["S"])
    tri = mm(X, M["T0"])
    # neighbor contributions through sb-shifted copies (zero-padded edges)
    zpad = jnp.zeros((*lead, n_gran, 1, 36), dtype=X.dtype)
    X_below = jnp.concatenate([zpad, X[..., :-1, :]], axis=-2)
    X_above = jnp.concatenate([X[..., 1:, :], zpad], axis=-2)
    tri = tri + mm(X_below, M["Tm1"]) + mm(X_above, M["Tp1"])

    # edge strips: sb=0's lower 8 and sb=31's upper 8 have no boundary, so
    # the interior law's cs scaling must revert to the unaliased values
    m_idx = jnp.arange(18)
    sb_idx = jnp.arange(SUBBANDS)[:, None]
    edge_low = (sb_idx == 0) & (m_idx < 8)
    edge_high = (sb_idx == SUBBANDS - 1) & (m_idx >= 10)
    aliased = jnp.where(edge_low | edge_high, unal, tri)

    bt = block_type[..., None, None]  # [..., G, 1, 1]
    out = jnp.where(bt == BLOCK_LONG, aliased, short)
    if iso_mixed_alias:
        # mixed: long head sb<2 with ONLY boundary 0 aliased = tridiagonal
        # restricted: sb0 = aliased[0] (its upper strip is boundary 0; its
        # lower edge-corrected); sb1 = boundary-0 lower strip + unaliased
        # upper strip
        sb1_mix = jnp.where((m_idx >= 10), unal[..., 1:2, :], aliased[..., 1:2, :])
        head = jnp.concatenate([aliased[..., 0:1, :], sb1_mix], axis=-2)
    else:
        head = unal[..., 0:2, :]  # reference law: no aliasing for mixed
    mixed = jnp.concatenate([head, short[..., 2:, :]], axis=-2)
    out = jnp.where(bt == BLOCK_MIXED, mixed, out)
    return out.reshape(*lead, n_gran, 576).astype(_F32), signed
