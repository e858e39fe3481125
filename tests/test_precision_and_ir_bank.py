"""Precision and IR-bank guards for the GPU port.

Precision audit: every float32 product in the render, streaming and meter
graphs asks for ``Precision.HIGHEST`` — on Hopper a default-precision f32
dot may run in TF32 (~1e-3 relative), past the parity budget.

Chirp phases: the exact filters' Bluestein chirps stay within ~1e-7 of
float64 at render lengths (a float32 angle up to 2π left a one-sample
spectral-peak image in 10-minute streaming renders).

IR bank: the jnp counter-based synthesis (``ir_synth.hash_draws`` +
``synthesize``) is the only IR source — deterministic per seed, seed
sensitive, normalized to the reference's 0.9/0.7 peaks, and exact at the
long-IR end of the presets (Cathedral, room_size 600, 48 kHz)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jex_core

from audio_raytracing_studio_tpu.models import pipeline
from audio_raytracing_studio_tpu.ops import ir_synth
from audio_raytracing_studio_tpu.params import (
    RenderParams,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
    derive_ir_geometry,
)

RATE = 16000
N_IN = RATE // 4


def _sub_jaxprs(value):
    if isinstance(value, jex_core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex_core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def equations(jaxpr):
    """Every equation, sub-jaxprs (jit, scan, cond, custom rules) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from equations(sub)


def _is_highest(precision) -> bool:
    hi = jax.lax.Precision.HIGHEST
    if isinstance(precision, tuple):
        return len(precision) > 0 and all(p == hi for p in precision)
    return precision == hi


def _batched(batch=2):
    def per_clip(tree):
        return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,)), tree)

    return per_clip


def graph_batched_internal(monkeypatch):
    from audio_raytracing_studio_tpu.parallel import sharding

    setup = pipeline.build_internal_setup(
        RenderParams(target_layout="5.1 (Standard)", bass_gain=1.5), RATE, N_IN
    )
    per_clip = _batched()
    fn = functools.partial(
        sharding._batched_internal, ir_shape=setup.ir_shape, spec=setup.spec,
        with_metrics=True, pcm16=True,
    )
    return [jax.make_jaxpr(fn)(
        jnp.zeros((2, 2, N_IN)), jnp.arange(2, dtype=jnp.int32),
        per_clip(setup.ir_scalars), per_clip(setup.mix_scalars),
    ).jaxpr]


def graph_batched_external(monkeypatch):
    from audio_raytracing_studio_tpu.parallel import sharding

    p = RenderParams(use_external_ir=True, bass_gain=1.6, target_layout="7.1 (Surround)")
    spec = pipeline.StaticSpec(
        n_in=N_IN, ir_length=400, rate=RATE, layout=p.target_layout, eq_on=True,
        air_on=False, early_on=False, late_on=False,
    )
    mix = _batched()(pipeline._mix_scalars(p, 1.0, 1.0))
    fn = functools.partial(
        sharding._batched_external, spec=spec, with_metrics=True, pcm16=False
    )
    return [jax.make_jaxpr(fn)(jnp.zeros((2, 2, N_IN)), jnp.zeros((2, 400)), mix).jaxpr]


def graph_streaming_chunk(monkeypatch):
    """One slab of the streaming conv pass, as render_streaming calls it,
    and the blockwise exact EQ that runs over the streamed buffer."""
    from audio_raytracing_studio_tpu.parallel import streaming, streaming_eq

    calls = []
    real = streaming._conv_pass_slab_mono

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(streaming, "_conv_pass_slab_mono", record)
    clip = np.zeros(N_IN, np.float32)
    clip[::97] = 0.3
    streaming.render_streaming(clip, RATE, RenderParams(), chunk_seconds=0.25)
    args, kwargs = calls[0]
    slab = jax.make_jaxpr(functools.partial(real, **kwargs))(*args).jaxpr
    d, b = 8, 64
    kernel_spectra, _eq_channel, eq_pair = streaming_eq._compiled_eq(300, RATE, d, b, 400)
    kspec = jax.make_jaxpr(kernel_spectra)().jaxpr
    kf = jnp.zeros((d, b), jnp.complex64)
    eq = jax.make_jaxpr(eq_pair)(
        jnp.zeros(400), jnp.zeros(400), kf, kf, jnp.float32(1.5), jnp.float32(0.7)
    ).jaxpr
    return [slab, kspec, eq]


def graph_meter(monkeypatch):
    from audio_raytracing_studio_tpu.metering import loudness

    x = jnp.zeros((6, RATE))
    return [
        jax.make_jaxpr(lambda d: loudness.audio_metrics(d, RATE))(x).jaxpr,
        jax.make_jaxpr(
            lambda d, v, b: loudness.audio_metrics_masked(d, RATE, v, b)
        )(x, jnp.int32(RATE // 2), jnp.int32(2)).jaxpr,
    ]


@pytest.mark.parametrize(
    "build",
    [graph_batched_internal, graph_batched_external, graph_streaming_chunk, graph_meter],
    ids=["batched_internal", "batched_external", "streaming_chunk", "meter"],
)
def test_every_product_asks_for_highest_precision(build, monkeypatch):
    eqns = [e for jaxpr in build(monkeypatch) for e in equations(jaxpr)]
    # the audit saw the real graph: its transforms are there
    assert any(e.primitive.name == "fft" for e in eqns)
    loose = [
        (e.primitive.name, e.params.get("precision")) for e in eqns
        if e.primitive.name in ("dot_general", "conv_general_dilated")
        and not _is_highest(e.params.get("precision"))
    ]
    assert not loose, f"products without Precision.HIGHEST: {loose}"


@pytest.mark.parametrize("traced", [False, True], ids=["static_n0", "traced_n0"])
@pytest.mark.parametrize("n0", [8_711_999, 28_871_999], ids=["3min", "10min"])
def test_chirp_phase_precision_at_render_lengths(n0, traced):
    from audio_raytracing_studio_tpu.ops import chirp

    j = np.random.default_rng(n0).integers(0, n0, 200_000).astype(np.int32)
    j[:3] = [0, 1, n0 - 1]
    if traced:
        got = jax.jit(lambda jj, nn: chirp._chirp(jj, nn, -1.0))(jnp.asarray(j), jnp.int32(n0))
    else:
        got = jax.jit(lambda jj: chirp._chirp(jj, n0, -1.0))(jnp.asarray(j))
    q = (j.astype(np.int64) ** 2) % (2 * n0)
    want = np.exp(-1j * np.pi * q / n0)
    # float32 round-off of cos/sin is ~6e-8; the old 2π-range angle read 8e-7
    assert np.max(np.abs(np.asarray(got) - want)) < 2e-7


def _geometry(p: RenderParams, rate: int):
    dur, refs, maxd, split = adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
    direc = compute_final_directionality_3d(
        p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet
    )
    return derive_ir_geometry(rate, dur, refs, maxd, p.material, direc, split, p.diffusion)


@pytest.fixture(scope="module")
def room_shape():
    g = _geometry(RenderParams(), RATE)
    return ir_synth.IRShape.from_geometry(g), ir_synth.IRScalars.from_geometry(g)


@functools.partial(jax.jit, static_argnames=("shape",))
def _bank(seeds, scalars, *, shape):
    def one(seed):
        return ir_synth.synthesize(shape, *ir_synth.hash_draws(seed, shape), scalars)

    return jax.vmap(one)(seeds)


def test_hash_bank_is_deterministic(room_shape):
    shape, scalars = room_shape
    e1, l1 = _bank(jnp.array([9, 9], jnp.int32), scalars, shape=shape)
    e2, l2 = _bank(jnp.array([9], jnp.int32), scalars, shape=shape)
    assert np.array_equal(np.asarray(e1[0]), np.asarray(e1[1]))
    assert np.array_equal(np.asarray(e1[0]), np.asarray(e2[0]))
    assert np.array_equal(np.asarray(l1[1]), np.asarray(l2[0]))


def test_hash_bank_seed_sensitivity_norms_structure(room_shape):
    shape, scalars = room_shape
    e, l = map(np.asarray, _bank(jnp.arange(4, dtype=jnp.int32), scalars, shape=shape))
    assert e.shape == l.shape == (4, shape.length)
    assert not np.array_equal(e[0], e[1])
    assert not np.array_equal(l[0], l[1])
    for b in range(4):
        assert np.max(np.abs(e[b])) == pytest.approx(0.9, abs=1e-4)
        assert np.max(np.abs(l[b])) == pytest.approx(0.7, abs=1e-4)
    assert not np.any(e[:, shape.split_point:])
    assert not np.any(l[:, : shape.split_point])
    assert np.all(e[:, 0] == 0.0)


def test_hash_bank_cathedral_600_at_48k_matches_oracle():
    """The long-IR end of the presets (≈7.2 s): the jnp bank against the
    float64 oracle synthesis given the same counter-stream draws."""
    from audio_raytracing_studio_tpu.oracle import dsp
    from audio_raytracing_studio_tpu.params import IRDraws

    g = _geometry(RenderParams(hall_type="Cathedral", room_size=600.0), 48000)
    shape = ir_synth.IRShape.from_geometry(g)
    scalars = ir_synth.IRScalars.from_geometry(g)
    assert shape.length == 346809
    e, l = map(np.asarray, _bank(jnp.array([42], jnp.int32), scalars, shape=shape))
    d, st, nz = map(np.asarray, ir_synth.hash_draws(42, shape))
    draws = IRDraws(
        delays=d[: g.reflection_count], strengths=st[: g.reflection_count],
        noise=nz[: g.late_length],
    )
    e_ref, l_ref = dsp.generate_impulse_response_split(g, draws)
    np.testing.assert_allclose(e[0], e_ref, atol=1e-5)
    np.testing.assert_allclose(l[0], l_ref, atol=1e-5)
    assert np.max(np.abs(l[0])) == pytest.approx(0.7, abs=1e-4)
    head = np.max(np.abs(l[0, shape.split_point: shape.split_point + 4800]))
    assert np.max(np.abs(l[0, -4800:])) < 0.1 * head  # the tail decays
