"""Hand-written GPU kernel for the compat rate sweep (Pallas, Triton route).

`rate_sweep` fuses the compat path's 20-gain quantise-and-count sweep
(twin of the jnp formulation in ops.dsp._t15_sweep). The plain form builds
[N, 20, 576] candidate tensors and reduces them twice (big_values, then the
masked table-15 bit sum); here one program handles BLOCK_ROWS granules,
reads their magnitudes once, and loops over the 20 gains with every
candidate held in registers.

Layout: the 288 (x, y) pairs of a granule load as two [rows, 512] tiles
(Triton wants power-of-two tensors; pairs >= 288 are masked). The per-gain
inverse steps come in precomputed by the same ops.dsp lookups the jnp path
uses, so both paths quantise with identical float32 factors. The table-15
length lookup is a load from a 256-entry table.

Exactness: `floor(mag * inv + 0.5)` decides the integers, and Triton may
contract a multiply feeding an add into an FMA where XLA rounds the product
first. The product is therefore issued as an explicit round-to-nearest
`mul.rn.f32`, which no compiler pass may fuse. Interpret mode (CPU tests)
uses a plain multiply, which XLA:CPU does not contract.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..tables import TABLE15_LEN
from .dsp import N_GAIN_CANDIDATES, inv_step34_lookup, inv_step_lookup

# Tuned on an H100 at N = 131,072 granules (PERF.md): rows/warps of 2/4
# beat 4/4, 4/8, 2/8 and 8/4-8/8.
BLOCK_ROWS = 2  # granules per program
NUM_WARPS = 4
NUM_STAGES = 1
_PAIRS = 288
_PAIR_TILE = 512  # _PAIRS rounded up to a power of two
_OUT_TILE = 32  # N_GAIN_CANDIDATES rounded up to a power of two
_T15_LEN = TABLE15_LEN.astype(np.int32)


def sweep_kernel_enabled() -> bool:
    """The fused sweep runs where it was compiled for: NVIDIA GPUs."""
    return jax.devices()[0].platform == "gpu"


def _exact_mul(a, b):
    (out,) = plgpu.elementwise_inline_asm(
        "mul.rn.f32 $0, $1, $2;",
        args=[a, b],
        constraints="=r,r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.float32)],
    )
    return out


def _sweep_kernel(mag_ref, inv_ref, t15_ref, bits_ref, bv_ref, *, n, rows, interpret):
    row0 = pl.program_id(0) * rows
    row = row0 + jnp.arange(rows, dtype=jnp.int32)
    live_row = row < n
    pair = jnp.arange(_PAIR_TILE, dtype=jnp.int32)
    live = live_row[:, None] & (pair < _PAIRS)[None, :]
    r_idx = jnp.where(live_row, row, 0)[:, None]
    c_idx = jnp.where(pair < _PAIRS, 2 * pair, 0)[None, :]
    mag_x = plgpu.load(mag_ref.at[r_idx, c_idx], mask=live, other=0.0)
    mag_y = plgpu.load(mag_ref.at[r_idx, c_idx + 1], mask=live, other=0.0)

    lane = jnp.arange(_OUT_TILE, dtype=jnp.int32)[None, :]
    bits_acc = jnp.zeros((rows, _OUT_TILE), jnp.int32)
    bv_acc = jnp.zeros((rows, _OUT_TILE), jnp.int32)
    for k in range(N_GAIN_CANDIDATES):
        inv = plgpu.load(
            inv_ref.at[pl.ds(row0, rows), pl.ds(k, 1)],
            mask=live_row[:, None],
            other=0.0,
        )
        inv = jnp.broadcast_to(inv, mag_x.shape)
        if interpret:
            px, py = mag_x * inv, mag_y * inv
        else:
            px, py = _exact_mul(mag_x, inv), _exact_mul(mag_y, inv)
        qx = jnp.minimum(jnp.floor(px + jnp.float32(0.5)).astype(jnp.int32), 15)
        qy = jnp.minimum(jnp.floor(py + jnp.float32(0.5)).astype(jnp.int32), 15)
        nzx = (qx != 0).astype(jnp.int32)
        nzy = (qy != 0).astype(jnp.int32)
        length = plgpu.load(t15_ref.at[qx * 16 + qy])
        bv = jnp.max(jnp.where(nzx + nzy > 0, pair[None, :] + 1, 0), axis=1, keepdims=True)
        counted = jnp.where(pair[None, :] < bv, length + nzx + nzy, 0)
        bits = jnp.sum(counted, axis=1, keepdims=True)
        bits_acc = jnp.where(lane == k, bits, bits_acc)
        bv_acc = jnp.where(lane == k, bv, bv_acc)
    out_mask = live_row[:, None] & (lane >= 0)
    plgpu.store(bits_ref.at[pl.ds(row0, rows), :], bits_acc, mask=out_mask)
    plgpu.store(bv_ref.at[pl.ds(row0, rows), :], bv_acc, mask=out_mask)


def rate_sweep(
    mag: jax.Array,
    gstart: jax.Array,
    iso: bool = False,
    *,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Candidate (bits, bv) for the 20-gain walk grid, fused.

    mag: [..., 576] f32 (max(|x|, 1e-10)^0.75); gstart: [...] int32.
    Returns (bits [..., 20], bv [..., 20]) int32, equal to
    ops.dsp._t15_sweep's jnp formulation. iso selects the unit-gain
    step^-0.75 law (options.iso_quantization).
    """
    lead = mag.shape[:-1]
    n = int(np.prod(lead)) if lead else 1
    gains = gstart.reshape(n, 1) + 4 * jnp.arange(N_GAIN_CANDIDATES, dtype=jnp.int32)
    gains = jnp.clip(gains, 0, 255)
    inv = inv_step34_lookup(gains) if iso else inv_step_lookup(gains)
    out = jax.ShapeDtypeStruct((n, _OUT_TILE), jnp.int32)
    bits, bv = pl.pallas_call(
        functools.partial(_sweep_kernel, n=n, rows=BLOCK_ROWS, interpret=interpret),
        out_shape=(out, out),
        grid=(pl.cdiv(n, BLOCK_ROWS),),
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="rate_sweep",
    )(mag.reshape(n, 576), inv.astype(jnp.float32), jnp.asarray(_T15_LEN))
    shape = (*lead, N_GAIN_CANDIDATES)
    return (
        bits[:, :N_GAIN_CANDIDATES].reshape(shape),
        bv[:, :N_GAIN_CANDIDATES].reshape(shape),
    )
