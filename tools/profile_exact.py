"""Per-stage device-time roofline for the EXACT render mode (PERF.md data).

The bit-honest exact mode (the reference's own filter semantics,
raytracer_studio.py:310-336, 387-398) runs the costliest filters.  This
tool times each stage of the batched exact render in isolation on the GPU —
IR synth / conv / exact-air / mix / pan-map / meter — plus the raw batched
FFT "speed-of-light" units each FFT-bound stage should be compared against:

  * unit_rfft_pair:  rfft+irfft roundtrip of (B, 2, p2)   — the conv grid
  * unit_cfft_pair:  complex fft+ifft of (B, m_air)       — the exact-air
                     wrap grid (m_air = fast_fft_length(2·len_out); the
                     exact circular filter packs stereo into one complex
                     stream, ops/filters._apply_affine_circular)

Timing per utils/profiling.time_jitted (every call ends in
block_until_ready), warmup first, mean of N iterations.  Stage inputs are
materialized device arrays produced by the previous stage, so each timing
is one executable's steady state (the full fused graph is timed too — the
sum of isolated stages exceeds it by the un-fused materialization cost).

Writes one JSON object to stdout, with the device and the card's power
limit; PERF.md interprets it.  Needs a GPU.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DURATION_S = 60.0
RATE = 48000


def main() -> int:
    from audio_raytracing_studio_tpu.utils.profiling import time_jitted
    from audio_raytracing_studio_tpu.utils.runtime import gpu_device_record

    device = gpu_device_record()
    print(json.dumps({"device": device}), file=sys.stderr)

    import jax
    import jax.numpy as jnp

    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.ops import convolution, fftops, filters, ir_synth, spatial
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams

    batch = int(os.environ.get("BENCH_BATCH", "48"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))

    t = np.arange(int(DURATION_S * RATE)) / RATE
    rng = np.random.default_rng(0xBE7C)
    clips = np.stack(
        [
            (
                0.3 * np.sin(2 * np.pi * (180.0 + 9.0 * i) * t)
                + 0.05 * np.sin(2 * np.pi * (1000.0 + 37.0 * i) * t)
            ).astype(np.float32)
            + (0.02 * rng.standard_normal(t.shape)).astype(np.float32)
            for i in range(batch)
        ]
    )
    p = RenderParams(target_layout="Stereo")
    setup = pipeline.build_internal_setup(
        p, RATE, clips.shape[1], fast_filters=False
    )
    spec = setup.spec._replace(pow2_conv=True)  # the batched exact spec
    ir_shape = setup.ir_shape
    len_out = spec.len_out
    n_in = spec.n_in

    audio_bcn = jnp.asarray(
        np.stack([pipeline._ensure_stereo_host(c).T for c in clips])
    )
    keys = jnp.arange(batch, dtype=jnp.int32)
    ir_scalars = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (batch,)), setup.ir_scalars
    )
    mix_scalars = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (batch,)), setup.mix_scalars
    )

    # --- stage executables (vmapped, static config bound) ---
    @functools.partial(jax.jit, static_argnames=("shape",))
    def stage_ir(keys, sc, *, shape):
        def one(seed, s):
            d, st, nz = ir_synth.hash_draws(seed, shape)
            return ir_synth.synthesize(shape, d, st, nz, s)

        return jax.vmap(one)(keys, sc)

    @functools.partial(jax.jit, static_argnames=("n_out",))
    def stage_conv(audio, early, late, *, n_out):
        def one(a, e, l):
            return convolution.convolve_full(
                a, jnp.stack([e, l]), n_out, pow2=True
            )

        return jax.vmap(one)(audio, early, late)

    @functools.partial(jax.jit, static_argnames=("rate",))
    def stage_air(late_wet, air, *, rate):
        def one(w, f):
            return filters.apply_air_absorption(w, rate, f, pow2=True)

        return jax.vmap(one)(late_wet, air)

    @jax.jit
    def stage_mix(dry, early_wet, late_aired, scal):
        def one(d, e, l, s):
            wet = e * s.early_level + l * s.late_level
            mixed = s.dry_factor * (1.0 - s.dry_wet) * d + s.dry_wet * wet
            return filters.conditional_peak_normalize(mixed)

        return jax.vmap(one)(dry, early_wet, late_aired, scal)

    @functools.partial(jax.jit, static_argnames=("layout", "rate"))
    def stage_pan(mixed, scal, *, layout, rate):
        def one(m, s):
            six = spatial.apply_pan(
                m, spatial.pan_matrix(s.x_pos, s.y_pos, s.z_pos)
            )
            six = filters.conditional_peak_normalize(six)
            out = spatial.map_layout(six, layout, rate, s.z_pos)
            return filters.conditional_peak_normalize(out)

        return jax.vmap(one)(mixed, scal)

    @functools.partial(jax.jit, static_argnames=("rate",))
    def stage_meter(out, *, rate):
        from audio_raytracing_studio_tpu.metering import loudness

        def one(o):
            return loudness.audio_metrics(o, rate, pow2=True)

        return jax.vmap(one)(out)

    # --- FFT speed-of-light units ---
    p2 = fftops.next_power_of_two(n_in + spec.ir_length - 1)
    m_air = convolution.fast_fft_length(2 * len_out)

    @functools.partial(jax.jit, static_argnames=("n",))
    def unit_rfft_pair(x, *, n):
        return jnp.fft.irfft(jnp.fft.rfft(x, n=n, axis=-1), n=n, axis=-1)

    @functools.partial(jax.jit, static_argnames=("n",))
    def unit_cfft_pair(re, im, *, n):
        # the production transform pair (ops/fftops radix-3 over pow2 FFTs,
        # the path _apply_affine_circular runs)
        z = jax.lax.complex(re, im)
        w = fftops.ifft_fast(fftops.fft_fast(z, n))
        return jnp.real(w) + jnp.imag(w)

    # --- materialize stage inputs (device-resident) ---
    def bench(name, fn, *args, **kwargs):
        r = time_jitted(fn, *args, name=name, iterations=iters, **kwargs)
        print(str(r), file=sys.stderr)
        return r.seconds_per_call, fn(*args, **kwargs)

    results = {}

    # full fused graph, the honest total (same executable as bench.py exact)
    def full():
        out, _ = sharding._batched_internal(
            audio_bcn, keys, ir_scalars, mix_scalars,
            ir_shape=ir_shape, spec=setup.spec, with_metrics=False,
        )
        return out

    t_full, _ = bench("full_exact_graph", full)
    results["full_exact_graph_s"] = t_full
    del full, _  # the closure cell pins audio_bcn; drop it before staging

    t_ir, (early, late) = bench(
        "ir_synth", stage_ir, keys, ir_scalars, shape=ir_shape
    )
    results["ir_synth_s"] = t_ir

    t_conv, conv = bench(
        "conv_pow2", stage_conv, audio_bcn, early, late, n_out=len_out
    )
    results["conv_s"] = t_conv
    # Free consumed intermediates between stages: the chip has 16 GB HBM and
    # the full set of (B, 2, len_out) float32 stage products (~1.1 GB each,
    # plus the 6-channel pan temps) does not fit at once — the first hardware
    # run RESOURCE_EXHAUSTED at the pan stage with everything held live.
    early_wet = jnp.copy(conv[:, 0])
    late_wet = jnp.copy(conv[:, 1])
    del conv, early, late

    t_air, late_aired = bench(
        "exact_air", stage_air, late_wet, mix_scalars.air_absorption, rate=RATE
    )
    results["exact_air_s"] = t_air
    del late_wet

    dry = jnp.pad(audio_bcn, ((0, 0), (0, 0), (0, len_out - n_in)))
    del audio_bcn
    t_mix, mixed = bench(
        "mix_normalize", stage_mix, dry, early_wet, late_aired, mix_scalars
    )
    results["mix_s"] = t_mix
    del dry, early_wet, late_aired

    t_pan, out = bench(
        "pan_map", stage_pan, mixed, mix_scalars,
        layout=spec.layout, rate=RATE,
    )
    results["pan_map_s"] = t_pan
    del mixed

    t_meter, _ = bench("meter", stage_meter, out, rate=RATE)
    results["meter_s"] = t_meter
    del out, _

    # FFT units at the two grids
    x = jnp.asarray(rng.standard_normal((batch, 2, p2)).astype(np.float32))
    t_r, _ = bench("unit_rfft_pair", unit_rfft_pair, x, n=p2)
    results["unit_rfft_pair_s"] = t_r
    # free the rfft unit's 1.6 GB input and retained output before the
    # complex unit allocates its ~7 GB working set (first run OOM'd here)
    del x, _
    re = jnp.asarray(rng.standard_normal((batch, m_air)).astype(np.float32))
    im = jnp.asarray(rng.standard_normal((batch, m_air)).astype(np.float32))
    t_c, _ = bench("unit_cfft_pair", unit_cfft_pair, re, im, n=m_air)
    results["unit_cfft_pair_s"] = t_c

    results.update(
        batch=batch, iters=iters, rate=RATE, n_in=n_in,
        ir_length=spec.ir_length, len_out=len_out, p2=p2, m_air=m_air,
        device=device,
        realtime_factor_exact=batch * DURATION_S / t_full,
        stage_sum_s=t_ir + t_conv + t_air + t_mix + t_pan,
    )
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
