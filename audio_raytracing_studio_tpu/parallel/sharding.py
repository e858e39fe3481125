"""Batched, mesh-sharded rendering — the production throughput path.

``render_batch`` vmaps the single-clip render graph over a batch of clips
(and, for parameter sweeps, over per-clip scalar pytrees), shards the batch
axis over the mesh's "data" axis with NamedSharding, and optionally meters
every clip on device.  XLA turns the whole thing into one SPMD program whose
only collectives are the (absent, for pure data parallel) cross-clip ones —
clip renders are embarrassingly parallel, on one device or across a mesh.

Value-parameter sweeps (diffusion, air, x/y position, mix, EQ, levels) share
one compiled executable because they only change traced scalars; shape-
changing parameters (hall type, room size, z position — it scales the early
delay window — clip length, rate, layout) bucket into
separate compiles by design (SURVEY §7 hard part 3).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..metering import loudness
from ..models import pipeline
from ..ops import ir_synth
from ..params import RenderParams, eq_enabled
from . import mesh as meshlib


def bucket_length(n: int, rate: int) -> int:
    """Quantize a clip length up to a half-second grid.

    One compiled executable per (rate, bucket) instead of per exact length —
    the shape-bucketing design of SURVEY §7 hard part 3, shared by the
    directory renderer (cli.render_dir) and the serving batcher
    (serving.batcher)."""
    step = max(1, rate // 2)
    return -(-int(n) // step) * step


def _stack_pytrees(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _metrics_and_quantize(out, spec, with_metrics, pcm16, vlen, vblocks):
    """Shared per-clip epilogue: meter (masked to the clip's true output
    length when given — zero-padded bucket tails stay out of the
    measurement) and optionally quantize to the int16 output contract on
    device (halves the device→host result transfer)."""
    metrics = None
    if with_metrics:
        # pow2: the meter's K-weighting FFT runs under the batch vmap, where
        # a 3·2^k grid mis-tiles past ~4 batch rows (same rule as the conv's
        # spec.pow2_conv — CLAUDE.md)
        metrics = (
            loudness.audio_metrics_masked(
                out, spec.rate, vlen, vblocks, pow2=spec.pow2_conv
            )
            if vlen is not None
            else loudness.audio_metrics(out, spec.rate, pow2=spec.pow2_conv)
        )
    if pcm16:
        out = pipeline.quantize_pcm16(out)
    return out, metrics


@functools.partial(
    jax.jit, static_argnames=("ir_shape", "spec", "with_metrics", "pcm16")
)
def _batched_internal(
    audio_bcn: jnp.ndarray,
    keys: jnp.ndarray,
    ir_scalars,
    mix_scalars,
    valid_lens=None,
    valid_blocks=None,
    eq_dyn=None,
    *,
    ir_shape: ir_synth.IRShape,
    spec: pipeline.StaticSpec,
    with_metrics: bool,
    pcm16: bool = False,
):
    spec = spec._replace(pow2_conv=True)  # 3·2^k grids mis-tile under vmap

    def one(audio_cn, seed, ir_sc, mix_sc, vlen, vblocks, dyn):
        delays, strengths, noise = ir_synth.hash_draws(seed, ir_shape)
        out = pipeline.internal_graph(
            audio_cn, delays, strengths, noise, ir_sc, mix_sc, dyn,
            ir_shape=ir_shape, spec=spec,
        )
        return _metrics_and_quantize(out, spec, with_metrics, pcm16, vlen, vblocks)

    return jax.vmap(one)(
        audio_bcn, keys, ir_scalars, mix_scalars, valid_lens, valid_blocks, eq_dyn
    )


@functools.partial(jax.jit, static_argnames=("spec", "with_metrics", "pcm16"))
def _batched_external(
    audio_bcn: jnp.ndarray,
    ir_cn: jnp.ndarray,
    mix_scalars,
    valid_lens=None,
    valid_blocks=None,
    eq_dyn=None,
    *,
    spec: pipeline.StaticSpec,
    with_metrics: bool,
    pcm16: bool = False,
):
    """Batched external-IR render: every clip convolved with the shared IR."""
    spec = spec._replace(pow2_conv=True)  # 3·2^k grids mis-tile under vmap

    def one(audio_cn, mix_sc, vlen, vblocks, dyn):
        out = pipeline.external_graph(audio_cn, ir_cn, mix_sc, dyn, spec=spec)
        return _metrics_and_quantize(out, spec, with_metrics, pcm16, vlen, vblocks)

    return jax.vmap(one)(
        audio_bcn, mix_scalars, valid_lens, valid_blocks, eq_dyn
    )


def render_batch(
    audio: np.ndarray,
    rate: int,
    params: RenderParams | Sequence[RenderParams],
    seeds: Optional[Sequence[int]] = None,
    device_mesh: Optional[Mesh] = None,
    with_metrics: bool = False,
    fast_filters: bool = False,
    external_ir: Optional[np.ndarray] = None,
    external_ir_rate: Optional[int] = None,
    clip_lengths: Optional[Sequence[int]] = None,
    pcm16_output: bool = False,
    async_results: bool = False,
    real_batch: Optional[int] = None,
):
    """Render a batch of clips (B, N) or (B, N, C) through one SPMD program.

    ``params`` is either one RenderParams (shared) or one per clip — all must
    agree on shape-determining fields (hall_type, room_size, rate, layout,
    clip length); value fields may sweep freely.

    ``clip_lengths``: per-clip TRUE input sample counts when the batch is
    zero-padded to one bucket length (cli.render_dir) — metrics then measure
    each clip's true output span ``clip_len + ir_len − 1`` instead of the
    padded buffer (on-device masked meter; no host re-upload).

    ``pcm16_output=True`` quantizes to the 16-bit output contract on device
    (models.pipeline.quantize_pcm16 — bit-identical to host quantization)
    and returns int16, halving the device→host result transfer.

    Returns (B, len_out, channels) float32 (int16 with ``pcm16_output``) —
    plus a list of per-clip metric dicts when ``with_metrics``.

    ``async_results=True`` returns instead a zero-argument ``fetch()``
    callable producing that same value: the SPMD computation is already
    dispatched (JAX dispatch is asynchronous) but the device→host result
    transfer happens when ``fetch()`` runs.
    The serving batcher uses this to download batch *i* on a completer
    thread while batch *i+1* stacks, uploads and computes.

    ``real_batch``: when the caller padded the batch dimension (mesh
    divisibility, or the serving batcher's batch-size buckets), the first
    ``real_batch`` rows are the real jobs — the pad rows are sliced off ON
    DEVICE before the result transfer, so padding never inflates the
    device→host download.
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio[:, :, np.newaxis]
    batch = audio.shape[0]

    param_list = (
        list(params) if isinstance(params, (list, tuple)) else [params] * batch
    )
    if len(param_list) != batch:
        raise ValueError(f"{len(param_list)} params for batch of {batch}")

    # Stereo-ize each clip, stack channels-leading.
    clips = [pipeline._ensure_stereo_host(audio[i]) for i in range(batch)]
    n_in = clips[0].shape[0]
    audio_bcn = jnp.asarray(np.stack([c.T for c in clips]))

    if clip_lengths is not None and len(clip_lengths) != batch:
        raise ValueError(f"{len(clip_lengths)} clip_lengths for batch of {batch}")

    def _eq_dyn_arrays(ir_length: int):
        """Per-clip length-DYNAMIC EQ scalars, or None for the static EQ.

        The circular shelf EQ is parity-bearing at each clip's TRUE output
        length: its brick-wall masks have sinc-like 1/j time tails, so EQ
        at the padded bucket length deviates 1.2e-2..3.8e-2 from the
        true-length EQ (fuzz-measured — past the 1e-3 contract; the smooth
        air ramp is padding-insensitive ~4e-7 and stays bucketable).
        Rather than rejecting padded EQ-on clips (round-3's first answer —
        which forced per-exact-length executables, an unbounded-compile
        surface), the EQ runs length-dynamically: chirps/gain derive on
        device from the traced true length (ops.filters.apply_shelf_eq_dynamic),
        so ONE executable per bucket serves every true length inside it.
        """
        if clip_lengths is None:
            return None
        if not any(
            int(tl) != n_in and eq_enabled(p.bass_gain, p.treble_gain)
            for tl, p in zip(clip_lengths, param_list)
        ):
            return None  # nothing padded needs EQ → keep the static path
        from ..ops import filters

        return _stack_pytrees([
            filters.eq_dyn_host(min(int(tl), n_in) + ir_length - 1, rate)
            for tl in clip_lengths
        ])

    def _mask_arrays(ir_length: int):
        """Per-clip true output lengths + gating-block counts (host ints —
        block_count's rounding is float64 host math, see audio_metrics_masked)."""
        if clip_lengths is None or not with_metrics:
            return None, None
        from ..metering import kweighting as kwm

        vlens = [min(int(c), n_in) + ir_length - 1 for c in clip_lengths]
        vblocks = [kwm.block_count(v, rate) for v in vlens]
        return (
            jnp.asarray(np.asarray(vlens, dtype=np.int32)),
            jnp.asarray(np.asarray(vblocks, dtype=np.int32)),
        )

    if any(p.use_external_ir for p in param_list):
        if not all(p.use_external_ir for p in param_list):
            raise ValueError("mixed internal/external modes in one batch")
        if external_ir is None:
            raise ValueError("use_external_ir=True requires external_ir")
        if any(p.target_layout != param_list[0].target_layout for p in param_list):
            # the internal path raises for mismatched shape-determining
            # fields; without this the batch silently renders every clip
            # with clip 0's layout
            raise ValueError(
                "external-IR batch requires one target_layout for all clips "
                "(shape-determining); bucket your batch by layout"
            )
        ir = pipeline.prepare_external_ir(
            external_ir, external_ir_rate if external_ir_rate else rate, rate
        )
        eq_on = any(eq_enabled(p.bass_gain, p.treble_gain) for p in param_list)
        spec0 = pipeline.StaticSpec(
            n_in=n_in, ir_length=ir.shape[0], rate=int(rate),
            layout=param_list[0].target_layout, eq_on=eq_on,
            air_on=False, early_on=False, late_on=False,
        )
        mix_scalars = _stack_pytrees(
            [pipeline._mix_scalars(p, 1.0, 1.0) for p in param_list]
        )
        vlens, vblocks = _mask_arrays(ir.shape[0])
        eq_dyn = _eq_dyn_arrays(ir.shape[0])
        if device_mesh is not None:
            num_devices = device_mesh.shape[meshlib.DATA_AXIS]
            if batch % num_devices:
                # same clear contract as the internal path — not a low-level
                # sharding error deep inside device_put
                raise ValueError(
                    f"batch {batch} not divisible by data axis {num_devices}"
                )
            bs = meshlib.batch_sharding(device_mesh)
            audio_bcn = jax.device_put(audio_bcn, bs)
            mix_scalars = jax.device_put(mix_scalars, bs)
            if vlens is not None:
                vlens = jax.device_put(vlens, bs)
                vblocks = jax.device_put(vblocks, bs)
            if eq_dyn is not None:
                eq_dyn = jax.device_put(eq_dyn, bs)
        out, metrics = _batched_external(
            audio_bcn, jnp.asarray(ir.T), mix_scalars, vlens, vblocks, eq_dyn,
            spec=spec0, with_metrics=with_metrics, pcm16=pcm16_output,
        )
        return _finalize_render(
            out, metrics, batch, with_metrics, async_results, real_batch
        )

    setups = [
        pipeline.build_internal_setup(p, rate, n_in, fast_filters=fast_filters)
        for p in param_list
    ]
    # The on/off stage flags are derived from sweepable VALUES (EQ gains,
    # air factor, early/late levels), so a legitimate sweep can flip them
    # per clip.  Widen them batch-wide with any(): per-clip semantics are
    # preserved by the traced scalars — zero early/late weight is an exact
    # no-op, unity EQ gain and a zeroed air factor are identity gain curves
    # (the sub-threshold air factor is zeroed in _mix_scalars).  Only
    # genuinely shape-determining mismatches (layout, rate, IR geometry)
    # reject.
    widened = dict(
        eq_on=any(s.spec.eq_on for s in setups),
        air_on=any(s.spec.air_on for s in setups),
        early_on=any(s.spec.early_on for s in setups),
        late_on=any(s.spec.late_on for s in setups),
    )
    spec0 = setups[0].spec._replace(**widened)
    shape0 = setups[0].ir_shape
    for s in setups[1:]:
        sw = s.spec._replace(**widened)
        if sw != spec0 or s.ir_shape != shape0:
            # name the ACTUAL mismatch: comparing raw (unwidened) specs here
            # used to print two identical-looking specs when the real
            # difference was IR geometry (e.g. a per-clip z_pos sweep)
            detail = (
                f"spec {sw} vs {spec0}" if sw != spec0
                else f"IR geometry {s.ir_shape} vs {shape0} — z_pos, "
                     "room_size and hall_type set the IR length"
            )
            raise ValueError(
                "shape-determining parameters must match across a batch "
                f"({detail}); bucket your sweep by shape"
            )

    ir_scalars = _stack_pytrees([s.ir_scalars for s in setups])
    mix_scalars = _stack_pytrees([s.mix_scalars for s in setups])

    if seeds is None:
        seeds = range(batch)
    # IR draws come from the counter-based stream (ops.rng): a pure function
    # of (seed, stream, index), so a seed renders the same audio anywhere.
    keys = jnp.asarray(
        np.asarray([int(s) & 0xFFFFFFFF for s in seeds], dtype=np.uint32).view(np.int32)
    )
    vlens, vblocks = _mask_arrays(spec0.ir_length)
    eq_dyn = _eq_dyn_arrays(spec0.ir_length)

    if device_mesh is not None:
        num_devices = device_mesh.shape[meshlib.DATA_AXIS]
        if batch % num_devices:
            raise ValueError(f"batch {batch} not divisible by data axis {num_devices}")
        bs = meshlib.batch_sharding(device_mesh)
        audio_bcn = jax.device_put(audio_bcn, bs)
        keys = jax.device_put(keys, bs)
        ir_scalars = jax.device_put(ir_scalars, bs)
        mix_scalars = jax.device_put(mix_scalars, bs)
        if vlens is not None:
            vlens = jax.device_put(vlens, bs)
            vblocks = jax.device_put(vblocks, bs)
        if eq_dyn is not None:
            eq_dyn = jax.device_put(eq_dyn, bs)

    out, metrics = _batched_internal(
        audio_bcn,
        keys,
        ir_scalars,
        mix_scalars,
        vlens,
        vblocks,
        eq_dyn,
        ir_shape=shape0,
        spec=spec0,
        with_metrics=with_metrics,
        pcm16=pcm16_output,
    )
    return _finalize_render(
        out, metrics, batch, with_metrics, async_results, real_batch
    )


def _finalize_render(
    out,
    metrics,
    batch: int,
    with_metrics: bool,
    async_results: bool,
    real_batch: Optional[int] = None,
):
    """Device→host completion of a dispatched batch render.

    ``fetch()`` blocks on the result transfer and converts metrics to
    per-clip host dicts; with ``async_results`` the caller decides WHEN to
    pay that (pipelined serving), otherwise it is paid inline.

    ``real_batch`` (< batch when the caller padded): pad rows are dropped
    by a device-side slice BEFORE ``np.asarray`` forces the transfer, so
    only real jobs are downloaded.
    """
    if real_batch is not None and not 1 <= real_batch <= batch:
        raise ValueError(f"real_batch {real_batch} outside [1, {batch}]")
    if real_batch is not None and real_batch < batch:
        out = out[:real_batch]
        if with_metrics:
            metrics = jax.tree.map(lambda v: v[:real_batch], metrics)
        batch = real_batch

    def fetch():
        result = np.asarray(out).transpose(0, 2, 1)
        if with_metrics:
            metrics_np = jax.tree.map(np.asarray, metrics)
            return result, [
                {k: float(v[i]) for k, v in metrics_np.items()}
                for i in range(batch)
            ]
        return result

    return fetch if async_results else fetch()


def executable_cache_size() -> int:
    """Compiled-executable count across the render path's jit entry points.

    Serving memory accounting (serving.batcher.memory_stats): each cached
    XLA executable retains host-side buffers (program, literal constants,
    transfer staging) that per-allocation profilers attribute to nobody —
    counting them is how a soak distinguishes "N new executables compiled"
    from an actual leak.  Covers the batched SPMD wrappers here, the
    single-clip pipeline cores, and the streaming renderer's slab kernels.
    """
    from ..metering import loudness
    from . import streaming

    fns = [
        _batched_internal,
        _batched_external,
        pipeline._render_internal_core,
        pipeline._render_external_core,
        streaming._conv_pass_slab_mono,
        streaming._conv_pass_slab_stereo,
        streaming._quantize_pcm16,
        loudness._k_weight_jit,
    ]
    total = 0
    for f in fns:
        try:
            total += f._cache_size()
        except Exception:  # noqa: BLE001 — accounting only
            pass
    return total
