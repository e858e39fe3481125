"""The end-to-end render graphs — the framework's flagship "model".

One XLA-compiled graph per static configuration covers everything the
reference does per click across convolve_audio_split_3d /
convolve_audio_external_ir / apply_surround_panning_3d / map_channels
(/root/reference/raytracer_studio.py:338-571) — IR synthesis, batched FFT
convolution, air absorption, dry/wet mix with dry-kill, shelf EQ, conditional
normalizations, 5.1 panning and layout mapping — with zero host round-trips.

Layout inside the graph is channels-leading (C, N): FFTs run over the long
contiguous last axis, and the pan/downmix einsums contract the small channel
axis.  The host wrapper keeps the reference's (N, C) convention.

Parity notes:
- all value scalars are derived on host in float64 (params.py) and enter the
  graph as traced f32 scalars → moving a slider never recompiles unless it
  changes a shape (room size / hall type / clip length / rate / layout);
- air-absorption and shelf-EQ FFTs run at the exact output length — that
  length is part of the reference's circular-filter semantics (§ops.filters);
- static branch decisions (EQ on, air on, early/late on) replicate the
  reference's host-visible skips (:312, :360, :369, :389).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops import convolution, filters, ir_synth, spatial
from ..params import (
    IRDraws,
    RenderParams,
    adapt_early_late_levels,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
    derive_ir_geometry,
    dry_kill_factor,
    eq_enabled,
)


class MixScalars(NamedTuple):
    """Traced f32 scalars shared by both render modes."""

    early_level: jax.Array
    late_level: jax.Array
    dry_wet: jax.Array
    dry_factor: jax.Array
    bass_gain: jax.Array
    treble_gain: jax.Array
    air_absorption: jax.Array
    x_pos: jax.Array
    y_pos: jax.Array
    z_pos: jax.Array


class StaticSpec(NamedTuple):
    """Static (hashable) render configuration — one compile per value.

    ``fast_air``: apply the air-absorption gain on the convolution's
    power-of-two FFT grid instead of the reference's exact-length grid.
    Free (rides the conv spectrum, no Bluestein round trips); deviates from
    the reference only in circular-wrap terms near the signal tail, measured
    ≤ ~2e-4 max-abs — inside the 1e-3 contract.  Default off for bit-honest
    parity.
    """

    n_in: int
    ir_length: int
    rate: int
    layout: str
    eq_on: bool
    air_on: bool
    early_on: bool
    late_on: bool
    fast_air: bool = False
    # Batched renderers set this: the exact-air conv AND the exact-length
    # affine filters (air/EQ) must use power-of-two FFT grids under a
    # large vmap batch (3·2^k grids hit a pathological 8-16×-padded
    # layout on this backend — see ops.convolution / ops.filters).
    pow2_conv: bool = False

    @property
    def len_out(self) -> int:
        return max(self.n_in, self.n_in + self.ir_length - 1)


def _mix_eq_spatial(
    dry_cn: jnp.ndarray,
    wet_cn: jnp.ndarray,
    scal: MixScalars,
    spec: StaticSpec,
    eq_dyn: Optional[filters.EQDyn] = None,
) -> jnp.ndarray:
    """Shared back half: dry/wet mix → EQ → normalize → pan → map (C-leading).

    ``eq_dyn`` switches the EQ to the length-DYNAMIC exact transform (the
    clip's true output length as a traced scalar — batches of mixed-length
    EQ-on clips share one executable per padded bucket; see
    filters.apply_shelf_eq_dynamic).  It overrides ``spec.eq_on``.
    """
    mixed = scal.dry_factor * (1.0 - scal.dry_wet) * dry_cn + scal.dry_wet * wet_cn
    if eq_dyn is not None:
        mixed = filters.apply_shelf_eq_dynamic(
            mixed, scal.bass_gain, scal.treble_gain, eq_dyn
        )
    elif spec.eq_on:
        mixed = filters.apply_shelf_eq(
            mixed, spec.rate, scal.bass_gain, scal.treble_gain, pow2=spec.pow2_conv
        )
    mixed = filters.conditional_peak_normalize(mixed)

    six = spatial.apply_pan(mixed, spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos))
    six = filters.conditional_peak_normalize(six)

    out = spatial.map_layout(six, spec.layout, spec.rate, scal.z_pos)
    return filters.conditional_peak_normalize(out)


def internal_graph_with_irs(
    audio_cn: jnp.ndarray,
    early_ir: jnp.ndarray,
    late_ir: jnp.ndarray,
    scal: MixScalars,
    eq_dyn: Optional[filters.EQDyn] = None,
    *,
    spec: StaticSpec,
) -> jnp.ndarray:
    """Internal-hall render from prebuilt IRs: convolve, mix, map →
    (channels, len_out)."""
    len_out = spec.len_out
    kernels = []
    gains = []
    weights = []
    fast_air = spec.air_on and spec.fast_air
    if fast_air:
        nfft = convolution.fast_fft_length(
            max(len_out, audio_cn.shape[-1] + early_ir.shape[-1] - 1)
        )
        air_gain = filters.air_absorption_gain(nfft, spec.rate, scal.air_absorption)
    if spec.early_on:
        kernels.append(early_ir)
        weights.append(scal.early_level)
        if fast_air:
            gains.append(jnp.ones_like(air_gain))
    if spec.late_on:
        kernels.append(late_ir)
        weights.append(scal.late_level)
        if fast_air:
            gains.append(air_gain)

    exact_air = spec.air_on and not spec.fast_air
    if kernels and not exact_air:
        # No per-kernel time-domain stage → fuse the level-weighted kernel
        # sum in the frequency domain (one inverse FFT per channel, exact by
        # linearity).
        wet = convolution.convolve_combined(
            audio_cn,
            jnp.stack(kernels),
            jnp.stack(weights),
            len_out,
            kernel_gains=jnp.stack(gains) if fast_air else None,
        )
    elif kernels:
        # Exact air mode filters the late stream at the exact output length
        # before the levels combine — keep the per-kernel streams separate.
        conv = convolution.convolve_full(
            audio_cn, jnp.stack(kernels), len_out, pow2=spec.pow2_conv
        )
        early_wet = jnp.zeros((audio_cn.shape[0], len_out), dtype=jnp.float32)
        late_wet = jnp.zeros_like(early_wet)
        idx = 0
        if spec.early_on:
            early_wet = conv[idx]
            idx += 1
        if spec.late_on:
            late_wet = conv[idx]
        late_wet = filters.apply_air_absorption(
            late_wet, spec.rate, scal.air_absorption, pow2=spec.pow2_conv
        )
        wet = early_wet * scal.early_level + late_wet * scal.late_level
    else:
        wet = jnp.zeros((audio_cn.shape[0], len_out), dtype=jnp.float32)

    dry = jnp.pad(audio_cn, ((0, 0), (0, len_out - spec.n_in)))
    return _mix_eq_spatial(dry, wet, scal, spec, eq_dyn)


def internal_graph(
    audio_cn: jnp.ndarray,
    delays: jnp.ndarray,
    strengths: jnp.ndarray,
    noise: jnp.ndarray,
    ir_scalars: ir_synth.IRScalars,
    scal: MixScalars,
    eq_dyn: Optional[filters.EQDyn] = None,
    *,
    ir_shape: ir_synth.IRShape,
    spec: StaticSpec,
) -> jnp.ndarray:
    """Internal-hall render graph (pure; jit/vmap/shard-composable).

    Synthesize IRs on device, convolve, mix, map → (channels, len_out).
    """
    early_ir, late_ir = ir_synth.synthesize(
        ir_shape, delays, strengths, noise, ir_scalars
    )
    return internal_graph_with_irs(
        audio_cn, early_ir, late_ir, scal, eq_dyn, spec=spec
    )


def external_graph(
    audio_cn: jnp.ndarray,
    ir_cn: jnp.ndarray,
    scal: MixScalars,
    eq_dyn: Optional[filters.EQDyn] = None,
    *,
    spec: StaticSpec,
) -> jnp.ndarray:
    """External true-stereo IR render graph: L⊛IR_L, R⊛IR_R, mix, map."""
    len_out = spec.len_out
    wet = convolution.convolve_pairwise(audio_cn, ir_cn, len_out)
    dry = jnp.pad(audio_cn, ((0, 0), (0, len_out - spec.n_in)))
    return _mix_eq_spatial(dry, wet, scal, spec, eq_dyn)


def quantize_pcm16(x: jnp.ndarray) -> jnp.ndarray:
    """The 16-bit output contract on device (raytracer_studio.py:1082-1084 +
    libsndfile conversion semantics): clip ±OUTPUT_CLIP, ×32768 (a power-of-
    two float32 multiply — exact), round-half-even, saturate to int16.

    Bit-identical to the host path (app/api.py:154-157): clip ±OUTPUT_CLIP
    (which maps ±inf to the clip bounds), NaN → 0 (the reference's
    nan_to_num scrub, :1083), then ``wavio.encode_pcm16`` (XLA's rint is
    round-nearest-even like lrintf) — without the scrub, NaN would reach
    XLA's implementation-defined float→int16 conversion and the device
    bytes could differ from the host contract.  Callers can transfer int16
    results at half the device→host bytes and hand them straight to
    ``wavio.write``/``write_audio``."""
    x = jnp.clip(x, -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
    x = jnp.where(jnp.isnan(x), jnp.float32(0.0), x)
    scaled = jnp.rint(x * jnp.float32(32768.0))
    return jnp.clip(scaled, -32768.0, 32767.0).astype(jnp.int16)


_render_internal_core = jax.jit(internal_graph, static_argnames=("ir_shape", "spec"))
_render_external_core = jax.jit(external_graph, static_argnames=("spec",))


def _ensure_stereo_host(audio: np.ndarray) -> np.ndarray:
    """Mono → duplicated stereo; >2 ch → first two (raytracer_studio.py:1020-1022)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[:, np.newaxis]
    if audio.shape[1] == 1:
        audio = np.repeat(audio, 2, axis=1)
    elif audio.shape[1] > 2:
        audio = audio[:, :2]
    return audio


def _mix_scalars(p: RenderParams, early_lvl: float, late_lvl: float) -> MixScalars:
    f = jnp.float32
    return MixScalars(
        early_level=f(early_lvl),
        late_level=f(late_lvl),
        dry_wet=f(np.clip(p.dry_wet, 0.0, 1.0)),
        dry_factor=f(dry_kill_factor(p.dry_wet, p.dry_wet_kill_start)),
        bass_gain=f(p.bass_gain),
        treble_gain=f(p.treble_gain),
        # zeroed below the reference's skip threshold (raytracer_studio.py:312)
        # so a batch whose air_on was widened batch-wide (parallel.sharding
        # sweeps) still gives sub-threshold clips the reference's no-filter
        # semantics: factor 0 → gain curve ≡ 1.0 exactly
        air_absorption=f(
            p.air_absorption
            if p.air_absorption > config.AIR_ABSORPTION_MIN_FACTOR
            else 0.0
        ),
        x_pos=f(np.clip(p.x_pos, 0.0, 1.0)),
        y_pos=f(np.clip(p.y_pos, 0.0, 1.0)),
        z_pos=f(np.clip(p.z_pos, 0.0, 1.0)),
    )


def prepare_external_ir(
    ir: np.ndarray, ir_rate: int, target_rate: int
) -> np.ndarray:
    """Validate and (FFT-)resample an external IR to the clip's sample rate.

    Mirrors the external-IR handling at raytracer_studio.py:1034-1041:
    resample on rate mismatch (Fourier method — ops.resample.resample_fft
    replicates scipy.signal.resample's semantics on device, pinned ≤5e-6
    against scipy in test_resample), reject non-stereo.
    """
    ir = np.asarray(ir, dtype=np.float32)
    if ir.ndim != 2:
        raise ValueError("External IR must be a 2-D (samples, channels) array.")
    if ir.size == 0:
        raise ValueError("External IR is empty.")
    if ir.shape[1] != 2:
        # reject BEFORE any resample: a rate-mismatched non-stereo IR would
        # otherwise pay a fresh (shape, num) resample compile for input
        # that is always rejected
        raise ValueError("External IR must be stereo.")
    if ir_rate != target_rate:
        from ..ops.resample import resample_fft

        n_resampled = int(ir.shape[0] * target_rate / ir_rate)
        if n_resampled <= 0:
            raise ValueError("Resampling would produce an empty IR.")
        if ir.shape[0] < 2:
            raise ValueError("External IR too short to resample.")
        ir = np.asarray(resample_fft(ir, n_resampled), dtype=np.float32)
    return ir


class InternalSetup(NamedTuple):
    """Host-derived pieces of one internal-hall render."""

    ir_shape: ir_synth.IRShape
    ir_scalars: ir_synth.IRScalars
    mix_scalars: MixScalars
    spec: StaticSpec


def _internal_static(p: RenderParams, rate: int, n_in: int, fast_filters: bool):
    """Host-side static derivation (float64 param math → geometry → spec),
    shared by ``build_internal_setup`` and ``build_internal_spec``."""
    adj_duration, adj_ref_count, adj_max_delay, adj_split = adjust_parameters_for_3d(
        p.hall_type, p.room_size, p.z_pos
    )
    directionality = compute_final_directionality_3d(
        p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet
    )
    geometry = derive_ir_geometry(
        rate,
        adj_duration,
        adj_ref_count,
        adj_max_delay,
        p.material,
        directionality,
        adj_split,
        p.diffusion,
    )
    early_lvl, late_lvl = adapt_early_late_levels(p.dry_wet, p.early_level, p.late_level)

    ir_shape = ir_synth.IRShape.from_geometry(geometry)
    eq_on = eq_enabled(p.bass_gain, p.treble_gain)
    spec = StaticSpec(
        n_in=n_in,
        ir_length=geometry.length,
        rate=int(rate),
        layout=p.target_layout,
        eq_on=eq_on,
        air_on=p.air_absorption > config.AIR_ABSORPTION_MIN_FACTOR,
        early_on=ir_shape.early_taps_active and early_lvl > 1e-6,
        late_on=ir_shape.late_length > 0 and late_lvl > 1e-6,
        fast_air=fast_filters,
    )
    return geometry, early_lvl, late_lvl, ir_shape, spec


def build_internal_spec(
    p: RenderParams, rate: int, n_in: int, fast_filters: bool = False
):
    """Shape-only derivation → ``(spec, ir_shape)``.

    No device scalars are materialized — the serving batcher keys every
    submission with this on the HTTP handler thread, where eagerly
    allocating IRScalars/MixScalars device arrays per request would be
    pure waste (they are rebuilt at dispatch by render_batch anyway).
    """
    *_, ir_shape, spec = _internal_static(p, rate, n_in, fast_filters)
    return spec, ir_shape


def build_internal_setup(
    p: RenderParams, rate: int, n_in: int, fast_filters: bool = False
) -> InternalSetup:
    """Derive all host scalars / static config for an internal-hall render.

    Shared by the single-clip renderer and the batched/sharded renderers
    (parallel.sharding), which stack the traced pytrees across a batch.
    """
    geometry, early_lvl, late_lvl, ir_shape, spec = _internal_static(
        p, rate, n_in, fast_filters
    )
    return InternalSetup(
        ir_shape=ir_shape,
        ir_scalars=ir_synth.IRScalars.from_geometry(geometry),
        mix_scalars=_mix_scalars(p, early_lvl, late_lvl),
        spec=spec,
    )


def render(
    audio: np.ndarray,
    rate: int,
    p: RenderParams,
    seed: Optional[int] = None,
    draws: Optional[IRDraws] = None,
    external_ir: Optional[np.ndarray] = None,
    external_ir_rate: Optional[int] = None,
    return_metrics: bool = False,
    fast_filters: bool = False,
):
    """Render one clip through the jitted pipeline → (len_out, channels) f32.

    For the internal hall, randomness comes from ``seed`` (device PRNG,
    deterministic) or injected ``draws`` (oracle parity).  For the external
    mode, pass ``external_ir`` (+ its rate if it differs from ``rate``).
    With ``return_metrics`` the on-device meter also runs and a
    (audio, metrics-dict) tuple is returned.
    """
    audio_nc = _ensure_stereo_host(audio)
    audio_cn = jnp.asarray(audio_nc.T)
    n_in = audio_nc.shape[0]

    if p.use_external_ir:
        if external_ir is None:
            raise ValueError("use_external_ir=True requires external_ir data")
        ir = prepare_external_ir(
            external_ir, external_ir_rate if external_ir_rate else rate, rate
        )
        eq_on = eq_enabled(p.bass_gain, p.treble_gain)
        spec = StaticSpec(
            n_in=n_in,
            ir_length=ir.shape[0],
            rate=int(rate),
            layout=p.target_layout,
            eq_on=eq_on,
            air_on=False,
            early_on=False,
            late_on=False,
        )
        out_cn = _render_external_core(
            audio_cn, jnp.asarray(ir.T), _mix_scalars(p, 1.0, 1.0), spec=spec
        )
    else:
        setup = build_internal_setup(p, rate, n_in, fast_filters=fast_filters)
        if draws is not None:
            delays, strengths, noise = ir_synth.draws_to_device(draws)
        else:
            delays, strengths, noise = ir_synth.hash_draws(
                0 if seed is None else int(seed), setup.ir_shape
            )

        out_cn = _render_internal_core(
            audio_cn,
            delays,
            strengths,
            noise,
            setup.ir_scalars,
            setup.mix_scalars,
            ir_shape=setup.ir_shape,
            spec=setup.spec,
        )

    if return_metrics:
        from ..metering import loudness

        metrics = {k: float(v) for k, v in loudness.audio_metrics(out_cn, int(rate)).items()}
        return np.asarray(out_cn).T, metrics
    return np.asarray(out_cn).T
