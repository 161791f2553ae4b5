"""Kernel and DSP-formulation tests (Pallas kernels in interpret mode on CPU)."""

import numpy as np
import pytest

from swiftmp3_tpu.ops import dsp


def test_device_pack_matches_host_pack():
    import jax.numpy as jnp

    from swiftmp3_tpu.io.huffman_pack import pack_frame_main_data

    rng = np.random.default_rng(1)
    F, G = 5, 4
    q = rng.integers(-15, 16, size=(F, G, 576)).astype(np.int32)
    bv = rng.integers(0, 289, size=(F, G)).astype(np.int32)
    chunks, nbits = dsp.pair_chunks_device(jnp.asarray(q), jnp.asarray(bv))
    by, total = dsp.pack_main_data(
        jnp.asarray(np.asarray(chunks).reshape(F, G * 288)),
        jnp.asarray(np.asarray(nbits).reshape(F, G * 288)),
        2160,
    )
    by = np.asarray(by)
    total = np.asarray(total)
    for f in range(F):
        host_bytes, part_bits = pack_frame_main_data(q[f], bv[f])
        assert total[f] == part_bits.sum()
        assert by[f, : len(host_bytes)].tobytes() == host_bytes


@pytest.mark.parametrize(
    "F,P,cap", [(16, 1152, 894), (5, 576, 894), (8, 1812, 1536), (3, 1152, 2160)]
)
def test_pack_main_data_matches_host_bitwriter(F, P, cap):
    """The device pack (bf16 one-hot matmuls, f32 accumulation) writes the
    same bytes as the host bit-writer across frame/slot/cap shapes,
    including slot counts that are not multiples of 128."""
    import jax

    from swiftmp3_tpu.io.huffman_pack import pack_chunks

    rng = np.random.default_rng(7)
    nb = rng.integers(0, 16, size=(F, P)).astype(np.int32)
    scale = (cap * 8 - 64) / max(nb.sum(axis=1).max(), 1)
    if scale < 1:  # thin, then cut every frame to fit the cap
        nb = np.where(rng.random((F, P)) < scale, nb, 0)
        nb = np.where(np.cumsum(nb, axis=1) <= cap * 8, nb, 0)
    ch = np.zeros((F, P), np.int32)
    nz = nb > 0
    ch[nz] = rng.integers(0, 1 << 15, size=nz.sum()) & ((1 << nb[nz]) - 1)
    by, total = jax.jit(lambda c, n: dsp.pack_main_data(c, n, cap))(ch, nb)
    by, total = np.asarray(by), np.asarray(total)
    for f in range(F):
        host, host_bits = pack_chunks(ch[f].astype(np.int64), nb[f])
        assert total[f] == host_bits
        assert by[f, : len(host)].tobytes() == host
        assert not by[f, len(host) :].any()


def test_t15_code_lookup_exact():
    import jax.numpy as jnp

    from swiftmp3_tpu.tables import TABLE15_CODE

    idx = np.arange(256, dtype=np.int32)
    got = np.asarray(dsp.t15_code_lookup(jnp.asarray(idx)))
    assert np.array_equal(got, TABLE15_CODE)


def _sweep_inputs(n=37, seed=7):
    rng = np.random.default_rng(seed)
    spec = (
        rng.standard_normal((n, 576)) * 10 ** rng.uniform(-5, 0.5, (n, 1))
    ).astype(np.float32)
    spec[3] = 0.0  # silent granule
    mag = (np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32)
    g0 = rng.integers(0, 256, n).astype(np.int32)
    return spec, mag, g0


@pytest.mark.parametrize("iso", [False, True])
def test_rate_sweep_pallas_matches_xla(iso):
    """The fused Triton-route sweep kernel (interpret mode on CPU) returns
    bit-identical (bits, bv) to the jnp formulation for both quantization
    laws, across a partial last block (37 granules)."""
    import jax.numpy as jnp

    from swiftmp3_tpu.ops import pallas_kernels as pk

    spec, mag, g0 = _sweep_inputs()
    bits_p, bv_p = pk.rate_sweep(
        jnp.asarray(mag), jnp.asarray(g0), iso=iso, interpret=True
    )
    gains = jnp.asarray(g0[:, None] + 4 * np.arange(20, dtype=np.int32))
    qk = dsp.quantize_at_gains(
        jnp.asarray(mag), jnp.asarray(spec < 0), gains, iso=iso
    )
    pair_bits = dsp._count_bits_pairs(qk)
    bv = dsp.big_values_from_quantized(qk)
    bits = jnp.sum(
        jnp.where(jnp.arange(288) < bv[..., None], pair_bits, 0), axis=-1
    )
    assert np.array_equal(np.asarray(bits_p), np.asarray(bits))
    assert np.array_equal(np.asarray(bv_p), np.asarray(bv))


@pytest.mark.chip
def test_rate_sweep_kernel_compiled_matches_jnp():
    """The compiled kernel (no interpret mode) equals the jnp sweep; runs
    only where JAX's device is a GPU (chip_smoke.py covers it at full
    width)."""
    import jax
    import jax.numpy as jnp

    from swiftmp3_tpu.ops import pallas_kernels as pk

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel has no CPU lowering")
    spec, mag, g0 = _sweep_inputs(n=4099)
    for iso in (False, True):
        got = pk.rate_sweep(jnp.asarray(mag), jnp.asarray(g0), iso=iso)
        want = dsp._t15_sweep(
            jnp.asarray(mag), jnp.asarray(spec < 0), jnp.asarray(g0), iso, False
        )
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_sweep_kernel_chosen_only_on_gpu(monkeypatch):
    """The pipeline picks the fused sweep by platform alone: never on the
    CPU, always on a GPU device."""
    import jax

    from swiftmp3_tpu.ops import pallas_kernels as pk

    assert jax.devices()[0].platform == "cpu"
    assert not pk.sweep_kernel_enabled()

    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [_Gpu()])
    assert pk.sweep_kernel_enabled()


@pytest.mark.parametrize("on_gpu", [False, True])
def test_compat_chunk_sweep_dispatch(monkeypatch, on_gpu):
    """Traced compat chunk program: no kernel off the GPU; on the GPU the
    sweep is one compiled (never interpreted) Triton pallas_call."""
    import jax

    from swiftmp3_tpu.models import pipeline
    from swiftmp3_tpu.options import MP3EncoderOptions, Mode

    monkeypatch.setattr(pipeline, "sweep_kernel_enabled", lambda: on_gpu)
    opts = MP3EncoderOptions(mode=Mode.STEREO)
    B, T = 2, 2
    jaxpr = jax.make_jaxpr(pipeline.make_chunk_fn(opts))(
        pipeline.init_carry(B, opts),
        np.zeros((B, T, 2304), np.int16),
        np.zeros((B, T), bool),
        np.ones((B, T), bool),
    )
    calls = [e for e in _walk_eqns(jaxpr.jaxpr) if e.primitive.name == "pallas_call"]
    if not on_gpu:
        assert calls == []
        return
    assert len(calls) == 1
    assert not calls[0].params["interpret"]
    assert calls[0].params["compiler_params"]["triton"] is not None


def _walk_eqns(jaxpr):
    """Every equation of a jaxpr, recursing into sub-jaxprs."""
    from jax.extend import core as jex_core

    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, jex_core.ClosedJaxpr):
                    yield from _walk_eqns(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    yield from _walk_eqns(sub)


@pytest.mark.parametrize("preset", ["compat", "hq"])
def test_chunk_f32_dots_request_highest_precision(preset):
    """Every float32 dot_general in the chunk program asks for HIGHEST
    precision (a GPU runs an unqualified f32 dot in TF32); only the pack's
    bfloat16 one-hot operands, which hold exact small integers, may not."""
    import jax

    from swiftmp3_tpu.models import pipeline
    from swiftmp3_tpu.options import MP3EncoderOptions, Mode

    if preset == "compat":
        opts = MP3EncoderOptions(mode=Mode.STEREO)
    else:
        opts = MP3EncoderOptions.hq(mode=Mode.STEREO)
    B, T = 2, 2
    args = [
        pipeline.init_carry(B, opts),
        np.zeros((B, T, 2304), np.float32),
        np.zeros((B, T), bool),
        np.ones((B, T), bool),
    ]
    if opts.window_sequencing:
        args.append(np.zeros((B, T, 1152), np.float32))
    jaxpr = jax.make_jaxpr(pipeline.make_chunk_fn(opts))(*args)
    dots = [e for e in _walk_eqns(jaxpr.jaxpr) if e.primitive.name == "dot_general"]
    assert dots
    n_f32 = 0
    for e in dots:
        dtypes = {v.aval.dtype for v in e.invars}
        if dtypes == {np.dtype(jax.numpy.bfloat16)}:
            continue
        assert dtypes == {np.dtype(np.float32)}, dtypes
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        ), (prec, e)
        n_f32 += 1
    assert n_f32 > 0


def test_polyphase_matmul_matches_stepwise():
    """The folded five-matmul filterbank (the production path) agrees with
    the stepwise formulation to float32 ULP level, and returns the same
    full-signal buffer."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    for T in (2, 6):
        hist = jnp.asarray(rng.standard_normal((3, 2, 480)).astype(np.float32))
        pcm = jnp.asarray(
            rng.standard_normal((3, 2, T * 1152)).astype(np.float32)
        )
        S_a, x_a = dsp.polyphase_chunk(hist, pcm)
        S_b, x_b = dsp.polyphase_chunk_matmul(hist, pcm)
        assert np.array_equal(np.asarray(x_a), np.asarray(x_b))
        np.testing.assert_allclose(
            np.asarray(S_a), np.asarray(S_b), rtol=0, atol=2e-4
        )
        scale = float(np.abs(np.asarray(S_a)).max())
        assert (
            float(np.abs(np.asarray(S_a) - np.asarray(S_b)).max()) <= 4e-6 * max(scale, 1.0)
        )


def test_mdct_fold_matches_stepwise():
    """The folded-matrix mdct_chunk (production) agrees with the two-step
    windowed formulation (windows x small matmuls x aliasing butterflies)
    for all block types, and the flat signed carry matches exactly."""
    import jax.numpy as jnp

    def two_step(S, overlap, block_type):
        lead = S.shape[:-2]
        n_gran = S.shape[-2] // 18
        signed = S.reshape(*lead, n_gran, 576) * dsp._SIGN_FLAT
        g = signed.reshape(*lead, n_gran, 18, 32)
        cur = jnp.swapaxes(g, -1, -2)
        ov = jnp.swapaxes(overlap.reshape(*lead, 18, 32), -1, -2)
        prev = jnp.concatenate(
            [ov[..., None, :, :], cur[..., :-1, :, :]], axis=-3
        )
        combined = jnp.concatenate([prev, cur], axis=-1)
        long_c = dsp._mdct_long_batch(combined)
        short_c = dsp._mdct_short_batch(combined)
        bt = block_type[..., None]
        sb = jnp.arange(32, dtype=jnp.int32)
        use_long = (bt == dsp.BLOCK_LONG) | ((bt == dsp.BLOCK_MIXED) & (sb < 2))
        coeffs = jnp.where(use_long[..., None], long_c, short_c)
        reduced = dsp._aliasing_reduce(coeffs)
        coeffs = jnp.where((bt == dsp.BLOCK_LONG)[..., None], reduced, coeffs)
        return coeffs.reshape(*coeffs.shape[:-2], 576), signed

    rng = np.random.default_rng(4)
    T = 3
    S = jnp.asarray(rng.standard_normal((2, 2, 36 * T, 32)).astype(np.float32))
    overlap = jnp.asarray(rng.standard_normal((2, 2, 576)).astype(np.float32))
    bt = jnp.asarray(
        rng.choice(
            [dsp.BLOCK_LONG, dsp.BLOCK_SHORT, dsp.BLOCK_MIXED], (2, 2, 2 * T)
        ).astype(np.int32)
    )
    out_a, cur_a = two_step(S, overlap, bt)
    out_b, cur_b = dsp.mdct_chunk(S, overlap, bt)
    assert np.array_equal(np.asarray(cur_a), np.asarray(cur_b))
    scale = float(np.abs(np.asarray(out_a)).max())
    assert float(np.abs(np.asarray(out_a) - np.asarray(out_b)).max()) <= 1e-5 * max(
        scale, 1.0
    )


def test_mdct_blocksparse_matches_fold():
    """The block-sparse MDCT experiment (round-3 negative result, kept as a
    tested twin — see ARCHITECTURE.md): values must match the dense fold to
    summation-tree ULPs for every block-type mix, both aliasing laws."""
    import jax.numpy as jnp
    import numpy as np

    from swiftmp3_tpu.ops import dsp

    rng = np.random.default_rng(3)
    G = 8
    S = (rng.standard_normal((2, 2, 18 * G, 32)) * 0.1).astype(np.float32)
    ov = (rng.standard_normal((2, 2, 576)) * 0.1).astype(np.float32)
    bt = rng.integers(0, 3, (2, 2, G)).astype(np.int32)
    for iso in (False, True):
        a, sa = dsp.mdct_chunk(
            jnp.asarray(S), jnp.asarray(ov), jnp.asarray(bt), iso_mixed_alias=iso
        )
        b, sb = dsp.mdct_chunk_blocksparse(
            jnp.asarray(S), jnp.asarray(ov), jnp.asarray(bt), iso_mixed_alias=iso
        )
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
