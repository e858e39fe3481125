"""Single-device streaming render for arbitrarily long clips.

``parallel.long_render`` shards one clip's sample axis over a multi-device
mesh; this module is the one-chip counterpart: the same overlap-add block
decomposition, but blocks advance **in time** through one compiled chunk
step with a carried convolution tail, so HBM stays bounded by the chunk
size no matter how long the clip is.  The reference takes one whole-signal
FFT (raytracer_studio.py:362) and cannot render hour-scale clips at all;
the exact single-shot path here (models.pipeline.render) holds the whole
conv grid and tops out around ~10 minutes on a 16 GB chip.

Stage plan (mirrors the single-device graph, pipeline._mix_eq_spatial).
Every chunked stage is a ``lax.scan`` executable over chunk indices
slicing a device-resident buffer — a handful of dispatches regardless of
clip length (not one host round-trip per chunk):
  1. conv pass, SLAB-PIPELINED: chunks are grouped into fixed-size slabs
     (one compiled scan per slab shape, reused for ANY clip length); all
     slab host→device transfers are initiated asynchronously up front, so
     slab i+1's upload rides under slab i's device work instead of one
     bulk upload serializing ahead of the first dispatch.
     Mono sources upload ONE channel and broadcast on device (halves the
     dominant transfer).  Each slab scan does overlap-add conv (air gain
     on the chunk's conv grid, StaticSpec.fast_air semantics) → dry/wet
     mix, with the conv tail, running |max|, and chunk offset carried
     across slabs.
  2. whole-buffer elementwise (one jit): normalize → pan → normalize →
     layout map (the 12/18 ms delays are plain shifts) → normalize.
  3. optional BS.1770 meter scan: K-weighting FIR with a carried tail;
     gating-block energies read from per-chunk energy cumsums at
     host-static block boundaries (same prefix-energy scheme as
     long_render._sharded_metrics, sequential instead of psum).

Non-unity EQ gains run the exact-length circular EQ between stages 1 and 2
via the blockwise single-chip Bluestein transform (parallel.streaming_eq —
bounded FFT workspace, n0 < 2^30); fast_air conv mode (same ≤1e-3 envelope
as long mode).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..metering import kweighting as kwc
from ..metering.loudness import gated_loudness_from_blocks, k_weighting_fir
from ..models import pipeline
from ..ops import convolution, filters, ir_synth, spatial
from ..params import RenderParams, eq_enabled

DEFAULT_CHUNK_SECONDS = 30.0


# ---------------------------------------------------------------------------
# module-level jitted passes (the models.pipeline idiom): static shape/mode
# config via static_argnames, kernels and MixScalars as ARGUMENTS.  Closure
# jits re-traced every render and baked the parameter scalars as literals,
# so even the persistent compile cache missed whenever a parameter changed;
# at streaming scale the re-trace + cache lookup cost seconds of pure host
# time per render.
# ---------------------------------------------------------------------------


def _conv_pass_slab_body(
    audio_slab, carry_tail, gmax, kers, gains, scal,
    *, chunk, c_in, pairwise, early_on, late_on, slab_chunks, out_len_local,
):
    """One slab's overlap-add hops in one executable: a lax.scan over the
    slab's chunks (no host round-trip per chunk).  The donated slab input is recycled into the slab output where
    shapes allow; conv tail and running |max| carry across slabs on
    device."""
    l = out_len_local - chunk + 1

    def step(carry, i):
        buf, tail_c, gmax_c = carry
        start = i * chunk
        audio_chunk = jax.lax.dynamic_slice(audio_slab, (0, start), (c_in, chunk))
        if c_in == 1:  # mono source: broadcast on device, not on host
            audio_chunk = jnp.broadcast_to(audio_chunk, (2, chunk))
        if pairwise:
            conv = convolution.convolve_pairwise(audio_chunk, kers, out_len_local)
            wet = conv[..., :chunk]
            tail = conv[..., chunk:]
        else:
            if early_on or late_on:
                conv = convolution.convolve_full(
                    audio_chunk, kers, out_len_local, kernel_gains=gains
                )
                if early_on and late_on:
                    wet_full = (
                        conv[0] * scal.early_level + conv[1] * scal.late_level
                    )
                else:
                    wet_full = conv[0] * (
                        scal.early_level if early_on else scal.late_level
                    )
            else:
                # dry-only: no FFT work at all — convolving every chunk
                # against the all-zero placeholder kernel just to discard
                # it would waste an rfft+irfft per chunk of the whole clip
                wet_full = jnp.zeros((2, out_len_local), jnp.float32)
            wet = wet_full[..., :chunk]
            tail = wet_full[..., chunk:]
        wet = wet.at[..., : l - 1].add(tail_c)
        mixed = (
            scal.dry_factor * (1.0 - scal.dry_wet) * audio_chunk
            + scal.dry_wet * wet
        )
        buf = jax.lax.dynamic_update_slice(buf, mixed, (0, start))
        return (buf, tail, jnp.maximum(gmax_c, jnp.max(jnp.abs(mixed)))), None

    init = (
        jnp.zeros((2, slab_chunks * chunk), dtype=jnp.float32),
        carry_tail,
        gmax,
    )
    (buf, tail, gmax), _ = jax.lax.scan(
        step, init, jnp.arange(slab_chunks, dtype=jnp.int32)
    )
    return buf, tail, gmax


_CONV_STATICS = (
    "chunk", "c_in", "pairwise", "early_on", "late_on",
    "slab_chunks", "out_len_local",
)
_conv_pass_slab_mono = jax.jit(_conv_pass_slab_body, static_argnames=_CONV_STATICS)
# donation only helps when the slab input can alias the (2, slab_len)
# output — i.e. stereo input; mono slabs are half the size (and would warn)
_conv_pass_slab_stereo = jax.jit(
    _conv_pass_slab_body, static_argnames=_CONV_STATICS, donate_argnums=(0,)
)


def _conv_pass_slab_split_body(
    audio_slab, tail_rest, tail_late, kers, scal,
    *, chunk, c_in, early_on, slab_chunks, out_len_local,
):
    """Exact-air variant of the slab conv pass (fast_filters=False): the
    LATE stream stays separate — unweighted and un-aired — so the
    exact-length circular air filter (parallel.streaming_eq.
    air_absorption_streaming) can run over the whole late buffer between
    pass 1 and the mix, exactly where the single-shot exact graph applies
    it (models.pipeline.internal_graph_with_irs exact-air branch /
    raytracer_studio.py:310-336).  The REST stream carries the dry mix
    plus the level-weighted early wet.  kers rows: [early?, late]."""
    l = out_len_local - chunk + 1

    def step(carry, i):
        rest_buf, late_buf, t_rest, t_late = carry
        start = i * chunk
        audio_chunk = jax.lax.dynamic_slice(audio_slab, (0, start), (c_in, chunk))
        if c_in == 1:
            audio_chunk = jnp.broadcast_to(audio_chunk, (2, chunk))
        conv = convolution.convolve_full(audio_chunk, kers, out_len_local)
        if early_on:
            early_full = conv[0] * scal.early_level
            late_full = conv[1]
        else:
            early_full = jnp.zeros((2, out_len_local), jnp.float32)
            late_full = conv[0]
        early_wet = early_full[..., :chunk].at[..., : l - 1].add(t_rest)
        late_wet = late_full[..., :chunk].at[..., : l - 1].add(t_late)
        rest = (
            scal.dry_factor * (1.0 - scal.dry_wet) * audio_chunk
            + scal.dry_wet * early_wet
        )
        rest_buf = jax.lax.dynamic_update_slice(rest_buf, rest, (0, start))
        late_buf = jax.lax.dynamic_update_slice(late_buf, late_wet, (0, start))
        carry_out = (
            rest_buf, late_buf, early_full[..., chunk:], late_full[..., chunk:]
        )
        return carry_out, None

    init = (
        jnp.zeros((2, slab_chunks * chunk), dtype=jnp.float32),
        jnp.zeros((2, slab_chunks * chunk), dtype=jnp.float32),
        tail_rest,
        tail_late,
    )
    (rest_buf, late_buf, t_rest, t_late), _ = jax.lax.scan(
        step, init, jnp.arange(slab_chunks, dtype=jnp.int32)
    )
    return rest_buf, late_buf, t_rest, t_late


_SPLIT_STATICS = ("chunk", "c_in", "early_on", "slab_chunks", "out_len_local")
_conv_split_mono = jax.jit(_conv_pass_slab_split_body, static_argnames=_SPLIT_STATICS)
_conv_split_stereo = jax.jit(
    _conv_pass_slab_split_body, static_argnames=_SPLIT_STATICS, donate_argnums=(0,)
)


@jax.jit
def _combine_late(rest_buf, late_air, dry_wet, late_level):
    """mixed = rest + dry_wet·late_level·air(late); post-mix running max
    (the normalization keys on the post-mix peak, like the exact graph)."""
    mixed = rest_buf + dry_wet * late_level * late_air
    return mixed, jnp.max(jnp.abs(mixed))


@functools.partial(
    jax.jit, static_argnames=("layout", "rate", "len_out")
)
def _finish_pass(buf, gmax, scal, *, layout, rate, len_out):
    """Pass 2: normalize → pan → map, whole buffer, one executable."""
    scale = jnp.where(gmax > 1.0, 1.0 / gmax, 1.0)
    mixed = jnp.where(gmax < 1e-9, jnp.zeros_like(buf), buf * scale)
    six = spatial.apply_pan(
        mixed, spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos)
    )
    six = filters.conditional_peak_normalize(six)
    out = spatial.map_layout(six, layout, rate, scal.z_pos)
    # The exact pipeline works on (C, len_out) buffers, so map_layout's
    # 12/18 ms delays trim at len_out; in this oversized buffer they
    # spill into [len_out, len_out+delay).  Zero the spill so the final
    # data-dependent normalize (and the meter) see identical samples.
    out = out * (jnp.arange(buf.shape[-1]) < len_out)
    return filters.conditional_peak_normalize(out)


@functools.partial(jax.jit, static_argnames=("slab_len", "n_ch"))
def _slab_slice(buf, s, *, slab_len, n_ch):
    return jax.lax.dynamic_slice(buf, (0, s * slab_len), (n_ch, slab_len))


# device-side PCM16 quantization (models.pipeline.quantize_pcm16): halves
# the dominant device→host result transfer of a long streaming render
_quantize_pcm16 = jax.jit(pipeline.quantize_pcm16)


@functools.partial(
    jax.jit, static_argnames=("chunk", "n_ch", "slab_chunks")
)
def _meter_slab(
    out_slab, bpos_scan, bvalid_scan, kw_carry, peak_c, sq_c, mpk_c, fir,
    *, chunk, n_ch, slab_chunks,
):
    """One slab of meter hops in one lax.scan executable (round-3 VERDICT
    item 4 — no host round-trip per chunk): K-weighting FIR with a
    carried tail, per-chunk boundary energies RELATIVE to the chunk start,
    device-side scalar accumulators carried across slab dispatches.
    Slab-shaped like the conv pass, so the compile is independent of the
    clip length.

    The unbounded running energy carry stays on host in float64 (a float32
    carry loses ~ulp-of-total per block at hour scale, drifting the gated
    LUFS — cf. the CLAUDE.md cumsum note)."""
    fir_len = fir.shape[0]

    def step(carry, xs):
        kw_c, pk, sq, mpk = carry
        bpos, bvalid, i = xs
        out_chunk = jax.lax.dynamic_slice(out_slab, (0, i * chunk), (n_ch, chunk))
        mono = 0.5 * (out_chunk[0] + out_chunk[1])
        conv = convolution.convolve_pairwise(
            mono[None, :], fir[None, :], chunk + fir_len - 1
        )[0]
        kw = conv[:chunk].at[: fir_len - 1].add(kw_c)
        new_carry = conv[chunk:]
        cums = jnp.concatenate(
            [jnp.zeros(1, jnp.float32), jnp.cumsum(jnp.square(kw))]
        )
        vals = jnp.where(bvalid, cums[bpos], 0.0)
        pk = jnp.maximum(pk, jnp.max(jnp.abs(out_chunk)))
        sq = sq + jnp.sum(jnp.square(out_chunk))
        mpk = jnp.maximum(mpk, jnp.max(jnp.abs(mono)))
        return (new_carry, pk, sq, mpk), (vals, cums[-1])

    xs = (bpos_scan, bvalid_scan, jnp.arange(slab_chunks, dtype=jnp.int32))
    (kw_carry, peak_c, sq_c, mpk_c), (vals_all, totals) = jax.lax.scan(
        step, (kw_carry, peak_c, sq_c, mpk_c), xs
    )
    return kw_carry, peak_c, sq_c, mpk_c, vals_all, totals


def _build_kernels(p: RenderParams, rate: int, n_in: int, seed: int,
                   external_ir, external_ir_rate, fast_filters: bool = True):
    """IRs + spec + scalars, identical to long_render's preparation."""
    if p.use_external_ir:
        if external_ir is None:
            raise ValueError("use_external_ir=True requires external_ir")
        ir = pipeline.prepare_external_ir(
            external_ir, external_ir_rate if external_ir_rate else rate, rate
        )
        eq_on = eq_enabled(p.bass_gain, p.treble_gain)
        spec = pipeline.StaticSpec(
            n_in=n_in, ir_length=ir.shape[0], rate=int(rate),
            layout=p.target_layout, eq_on=eq_on,
            air_on=False, early_on=False, late_on=False,
        )
        return jnp.asarray(ir.T), [], True, spec, pipeline._mix_scalars(p, 1.0, 1.0)

    setup = pipeline.build_internal_setup(p, rate, n_in, fast_filters=fast_filters)
    spec = setup.spec
    delays, strengths, noise = ir_synth.hash_draws(int(seed), setup.ir_shape)
    early_ir, late_ir = ir_synth.synthesize(
        setup.ir_shape, delays, strengths, noise, setup.ir_scalars
    )
    kernels, kernel_is_late = [], []
    if spec.early_on:
        kernels.append(early_ir)
        kernel_is_late.append(False)
    if spec.late_on:
        kernels.append(late_ir)
        kernel_is_late.append(True)
    kers = (
        jnp.stack(kernels) if kernels else jnp.zeros((1, spec.ir_length), jnp.float32)
    )
    return kers, kernel_is_late, False, spec, setup.mix_scalars


def render_streaming(
    audio: np.ndarray,
    rate: int,
    p: RenderParams,
    seed: int = 0,
    chunk_seconds: float = DEFAULT_CHUNK_SECONDS,
    with_metrics: bool = False,
    external_ir: Optional[np.ndarray] = None,
    external_ir_rate: Optional[int] = None,
    return_output: bool = True,
    pcm16_output: bool = False,
    fast_filters: bool = True,
):
    """Render one long clip in bounded memory → (len_out, channels) float32.

    Any EQ gains (exact-length circular EQ via parallel.streaming_eq); any
    layout; internal hall or external IR.  ``chunk_seconds`` bounds per-step
    FFT size and HBM; results are chunk-size-invariant (overlap-add is
    exact, tested).

    ``fast_filters=False`` runs the reference's EXACT-length air-absorption
    transform (raytracer_studio.py:310-336) instead of the conv-grid
    approximation: the late stream is kept separate through the chunked
    conv pass and the exact circular air filter runs blockwise over the
    whole late buffer (air_absorption_streaming — same traced-n0 Bluestein
    machinery as the streaming EQ) before the levels combine, matching the
    single-shot exact path to float32 round-off.  Costs one extra
    buffer-sized stream through pass 1 plus one blockwise transform pair;
    the default stays the fast conv-grid gain (≤~2e-4 deviation, inside
    the 1e-3 contract).

    ``return_output=False`` (requires ``with_metrics``) skips the bulk
    device→host result transfer and returns ``(None, metrics)`` — the
    metrics readbacks still force the full render on device.  Use when the
    host only needs the measurement (or when benchmarking compute without
    the host link's bandwidth).

    ``pcm16_output=True`` quantizes to the 16-bit output contract ON DEVICE
    (clip ±OUTPUT_CLIP → ×32768 round-half-even → saturate) and returns
    int16 — bit-identical to quantizing the float32 return on host, at half
    the device→host transfer.  Metrics are measured on the float signal as
    always.  ``utils.wavio.write``/``write_audio`` accept int16 directly.
    """
    if not return_output and not with_metrics:
        raise ValueError("return_output=False requires with_metrics=True")
    chunk_seconds = float(chunk_seconds)
    if not math.isfinite(chunk_seconds) or chunk_seconds <= 0:
        # int(inf·rate) is an OverflowError traceback, not the clean
        # ValueError the CLI error contract maps to exit 2 (fuzz-found,
        # tools/fuzz_campaign.py cli mode seed 1210271)
        raise ValueError(
            f"chunk_seconds must be a positive finite number (got {chunk_seconds})"
        )
    audio_np = np.asarray(audio, dtype=np.float32)
    mono_in = audio_np.ndim == 1 or audio_np.shape[1] == 1
    audio_nc = pipeline._ensure_stereo_host(audio)
    n_in = audio_nc.shape[0]
    kers, kernel_is_late, pairwise, spec, scal = _build_kernels(
        p, rate, n_in, seed, external_ir, external_ir_rate, fast_filters
    )
    # exact air (fast_filters=False) needs the late stream separate through
    # pass 1; with no late kernel the air filter is a no-op either way
    exact_air = (
        not fast_filters
        and not pairwise
        and spec.air_on
        and True in kernel_is_late
    )
    # non-unity EQ runs the blockwise exact-length transform on the device
    # buffer between pass 1 and pass 2 (parallel.streaming_eq) — no gate
    l = int(kers.shape[-1])
    len_out = spec.len_out
    chunk = max(int(chunk_seconds * rate), 2 * l)
    if with_metrics:
        # the chunked meter carries fir_len−1 samples of K-weighting tail
        # into the next chunk — a chunk shorter than the FIR cannot absorb it
        from ..metering.loudness import K_FIR_LENGTH

        chunk = max(chunk, K_FIR_LENGTH)
    n_chunks = math.ceil(len_out / chunk)
    # slab pipelining: fixed chunks-per-slab so ONE slab executable serves
    # any clip length; n_chunks rounds up to a slab multiple (zero chunks)
    slab_chunks = min(n_chunks, 8)
    n_slabs = math.ceil(n_chunks / slab_chunks)
    n_chunks_padded = n_slabs * slab_chunks
    n_total = n_chunks_padded * chunk
    slab_len = slab_chunks * chunk

    c_in = 1 if mono_in else 2
    audio_cn = np.zeros((c_in, n_total), dtype=np.float32)
    audio_cn[:, :n_in] = audio_nc.T[:c_in]

    out_len_local = chunk + l - 1
    gains = None
    if not pairwise and not exact_air:
        nfft = convolution.fast_fft_length(out_len_local)
        if spec.air_on and kernel_is_late:
            air_gain = filters.air_absorption_gain(nfft, spec.rate, scal.air_absorption)
            gains = jnp.stack(
                [air_gain if is_late else jnp.ones_like(air_gain)
                 for is_late in kernel_is_late]
            )

    # --- pass 1: initiate ALL slab uploads asynchronously, then dispatch
    # slab scans in order — slab i+1's host→device transfer overlaps slab
    # i's device work ---
    slabs = [
        jax.device_put(audio_cn[:, s * slab_len : (s + 1) * slab_len])
        for s in range(n_slabs)
    ]
    if exact_air:
        split_jit = _conv_split_mono if c_in == 1 else _conv_split_stereo
        t_rest = jnp.zeros((2, l - 1), dtype=jnp.float32)
        t_late = jnp.zeros((2, l - 1), dtype=jnp.float32)
        rest_slabs, late_slabs = [], []
        for s in range(n_slabs):
            rest_s, late_s, t_rest, t_late = split_jit(
                slabs[s], t_rest, t_late, kers, scal,
                chunk=chunk, c_in=c_in, early_on=spec.early_on,
                slab_chunks=slab_chunks, out_len_local=out_len_local,
            )
            slabs[s] = None
            rest_slabs.append(rest_s)
            late_slabs.append(late_s)
        rest_buf = (
            jnp.concatenate(rest_slabs, axis=1)
            if n_slabs > 1 else rest_slabs[0]
        )
        late_buf = (
            jnp.concatenate(late_slabs, axis=1)
            if n_slabs > 1 else late_slabs[0]
        )
        rest_slabs = late_slabs = None
        # the reference's exact-length air transform over the whole late
        # stream (blockwise traced-n0 Bluestein), then the levels combine
        from .streaming_eq import air_absorption_streaming

        late_buf = air_absorption_streaming(
            late_buf, len_out, int(rate), scal.air_absorption
        )
        mixed_buf, global_max = _combine_late(
            rest_buf, late_buf, scal.dry_wet, scal.late_level
        )
        rest_buf = late_buf = None
    else:
        conv_jit = _conv_pass_slab_mono if c_in == 1 else _conv_pass_slab_stereo
        carry_tail = jnp.zeros((2, l - 1), dtype=jnp.float32)
        global_max = jnp.float32(0.0)
        mixed_slabs = []
        for s in range(n_slabs):
            mixed_s, carry_tail, global_max = conv_jit(
                slabs[s], carry_tail, global_max, kers, gains, scal,
                chunk=chunk, c_in=c_in, pairwise=pairwise,
                early_on=spec.early_on, late_on=spec.late_on,
                slab_chunks=slab_chunks, out_len_local=out_len_local,
            )
            # the dispatched execution holds the input slab until it
            # completes; dropping our reference lets HBM reclaim it then,
            # instead of keeping ALL input slabs live through the concat
            # (an extra ~1× clip size)
            slabs[s] = None
            mixed_slabs.append(mixed_s)
        mixed_buf = (
            jnp.concatenate(mixed_slabs, axis=1)
            if n_slabs > 1 else mixed_slabs[0]
        )
        mixed_slabs = None  # per-slab buffers die once the concat consumed them
    # the conv tail past len_out is zero by construction (input zero-padded)

    if spec.eq_on:
        # exact-length circular shelf EQ over [0, len_out) of the device
        # buffer (blockwise Bluestein — bounded FFT workspace); the
        # conditional normalization then keys on the POST-EQ peak, exactly
        # like pipeline._mix_eq_spatial's ordering (mix → EQ → normalize)
        from .streaming_eq import shelf_eq_streaming

        # no sync barrier before the EQ dispatch: back-to-back enqueueing
        # lets the device run the EQ right behind pass 1
        mixed_buf = shelf_eq_streaming(
            mixed_buf, len_out, int(rate), scal.bass_gain, scal.treble_gain,
            # DEFAULT: traced-n0 executables keyed on the padded slab grid —
            # varying-length long jobs stop paying a per-length compile,
            # and the compile surface stays bounded. ARS_STREAM_EQ_DYNAMIC=0
            # forces the old per-length exact executables (an A/B knob
            # still to settle on the GPU, ROADMAP D6).
            dynamic=os.environ.get("ARS_STREAM_EQ_DYNAMIC", "1") == "1",
        )
        global_max = jnp.max(jnp.abs(mixed_buf))

    out_cn = _finish_pass(
        mixed_buf, global_max, scal,
        layout=spec.layout, rate=spec.rate, len_out=len_out,
    )

    def fetch_output():
        buf = _quantize_pcm16(out_cn) if pcm16_output else out_cn
        return np.asarray(buf[:, :len_out]).T

    if not with_metrics:
        return fetch_output()

    metrics = _streaming_metrics(
        out_cn, rate, len_out, chunk, n_chunks, slab_chunks
    )
    if not return_output:
        return None, metrics
    return fetch_output(), metrics


def _streaming_metrics(
    out_cn, rate: int, len_out: int, chunk: int, n_chunks: int, slab_chunks: int = 8
):
    """Chunked on-device BS.1770 meter over the (C, n_total) output buffer.

    Like the conv pass, the scan is dispatched per fixed-size slab of
    chunks (meter state carried across dispatches) so the executable's
    shape — and its compile — is independent of the clip length."""
    fir = jnp.asarray(k_weighting_fir(rate).astype(np.float32))
    fir_len = int(fir.shape[0])

    # gating-block boundaries (host-static), grouped per chunk with padding
    from ..metering.loudness import _block_bounds

    lo, hi, jblocks = _block_bounds(len_out, rate)
    step = 1.0 - kwc.BLOCK_OVERLAP
    bounds = (
        np.concatenate([lo[:jblocks], hi[:jblocks]])
        if jblocks > 0
        else np.zeros(0, np.int64)
    )
    max_per_chunk = int(np.ceil(chunk / (kwc.BLOCK_SECONDS * step * rate)) + 4) * 2

    n_ch = int(out_cn.shape[0])

    # gating-block boundaries grouped per chunk (host-static index tables)
    idx_per_chunk = []
    bpos_all = np.zeros((n_chunks, max_per_chunk), np.int32)
    bvalid_all = np.zeros((n_chunks, max_per_chunk), bool)
    for i in range(n_chunks):
        offset = i * chunk
        inside = (bounds > offset) & (bounds <= offset + chunk)
        idx = np.nonzero(inside)[0]
        idx_per_chunk.append(idx)
        bpos_all[i, : idx.size] = (bounds[idx] - offset).astype(np.int32)
        bvalid_all[i, : idx.size] = True
        # positions past len_out are zero in the buffer → contribute nothing

    slab_chunks = min(slab_chunks, n_chunks)
    n_slabs = math.ceil(n_chunks / slab_chunks)
    slab_len = slab_chunks * chunk
    # pad the per-chunk boundary tables to a slab multiple (invalid rows)
    pad_rows = n_slabs * slab_chunks - n_chunks
    if pad_rows:
        bpos_all = np.concatenate(
            [bpos_all, np.zeros((pad_rows, max_per_chunk), np.int32)]
        )
        bvalid_all = np.concatenate(
            [bvalid_all, np.zeros((pad_rows, max_per_chunk), bool)]
        )

    kw_carry = jnp.zeros(fir_len - 1, dtype=jnp.float32)
    peak_c = sq_c = mpk_c = jnp.float32(0.0)
    vals_slabs, totals_slabs = [], []
    bpos_dev = jnp.asarray(bpos_all)
    bvalid_dev = jnp.asarray(bvalid_all)
    for s in range(n_slabs):
        r0, r1 = s * slab_chunks, (s + 1) * slab_chunks
        kw_carry, peak_c, sq_c, mpk_c, vals_s, totals_s = _meter_slab(
            _slab_slice(out_cn, jnp.int32(s), slab_len=slab_len, n_ch=n_ch),
            bpos_dev[r0:r1],
            bvalid_dev[r0:r1],
            kw_carry,
            peak_c,
            sq_c,
            mpk_c,
            fir,
            chunk=chunk,
            n_ch=n_ch,
            slab_chunks=slab_chunks,
        )
        vals_slabs.append(vals_s)
        totals_slabs.append(totals_s)

    energies = np.zeros(bounds.shape[0], dtype=np.float64)
    vals_np = np.concatenate(
        [np.asarray(v, dtype=np.float64) for v in vals_slabs]
    )[: n_chunks]
    totals_np = np.concatenate(
        [np.asarray(t, dtype=np.float64) for t in totals_slabs]
    )[: n_chunks]
    prefix = np.concatenate([[0.0], np.cumsum(totals_np)[:-1]])
    for i, idx in enumerate(idx_per_chunk):
        if idx.size:
            energies[idx] = prefix[i] + vals_np[i, : idx.size]
    peak = float(peak_c)
    sq_sum = float(sq_c)
    mono_peak = float(mpk_c)

    if jblocks > 0:
        z = (energies[jblocks:] - energies[:jblocks]) / (kwc.BLOCK_SECONDS * rate)
        lufs = float(
            gated_loudness_from_blocks(
                jnp.asarray(z[None, :], dtype=jnp.float32),
                jnp.ones(1, jnp.float32),
            )
        )
    else:
        lufs = float("-inf")
    if mono_peak < 1e-6:
        lufs = float("-inf")
    peak_db = 20.0 * math.log10(peak) if peak > 1e-15 else float("-inf")
    rms = math.sqrt(sq_sum / (len_out * out_cn.shape[0])) if len_out else 0.0
    rms_db = 20.0 * math.log10(rms) if rms > 1e-15 else float("-inf")
    return {"lufs": lufs, "true_peak_dbfs": peak_db, "rms_dbfs": rms_db}
