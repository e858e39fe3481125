"""Micro-breakdown of the batched exact conv stage (PERF.md "conv attempt").

The packed-stereo conv is the largest stage of the exact graph in
profile_exact.  This tool times the pieces of
``ops/convolution._convolve_full_packed_stereo`` in isolation on the GPU to
locate where its time goes against the transform unit:

  fwd_z        fft_fast of the packed signal         (48, m)        1 row
  fwd_kernels  fft_fast of the zero-padded IR pair   (48, 2, m)     2 rows
  prod_ifft    broadcast product + ifft_fast         (48, 2, m)     2 rows
  emit         real/imag stack + crop + astype       (48, 2, 2, n0)
  whole        the production function end to end
  fwd_kernels_flat  same 96 rows as fwd_kernels but rank-2 (96, m) —
               isolates the rank-3 tiling question

Same shapes as bench.py / profile_exact: B=48, 60 s 48 kHz, ir 72 000,
m = 3·2^20.  Timing per utils/profiling.time_jitted (block_until_ready).
Writes one JSON object to stdout, with the device and the card's power
limit.  Needs a GPU.
"""

from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RATE = 48000
DURATION_S = 60.0
IR_LEN = 72000


def main() -> int:
    from audio_raytracing_studio_tpu.utils.profiling import time_jitted
    from audio_raytracing_studio_tpu.utils.runtime import gpu_device_record

    device = gpu_device_record()
    print(json.dumps({"device": device}), file=sys.stderr)

    import jax
    import jax.numpy as jnp

    from audio_raytracing_studio_tpu.ops import convolution, fftops

    batch = int(os.environ.get("BENCH_BATCH", "48"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    n_in = int(DURATION_S * RATE)
    n0 = n_in + IR_LEN - 1
    m = convolution.fast_fft_length(n0)

    rng = np.random.default_rng(0xC04F)
    sig = jnp.asarray(rng.standard_normal((batch, 2, n_in)).astype(np.float32))
    kernels = jnp.asarray(
        rng.standard_normal((batch, 2, IR_LEN)).astype(np.float32)
    )

    def bench(name, fn, *args, **kwargs):
        r = time_jitted(fn, *args, name=name, iterations=iters, **kwargs)
        print(str(r), file=sys.stderr)
        return r.seconds_per_call, fn(*args, **kwargs)

    results = {"batch": batch, "iters": iters, "n_in": n_in, "n0": n0, "m": m}

    # the production executable, exactly as the pipeline traces it
    @functools.partial(jax.jit, static_argnames=("n_out",))
    def whole(s, k, *, n_out):
        def one(a, kk):
            return convolution.convolve_full(a, kk, n_out, pow2=True)

        return jax.vmap(one)(s, k)

    t, _ = bench("whole_conv", whole, sig, kernels, n_out=n0)
    results["whole_conv_s"] = t
    del _

    # pieces (device shapes match what the vmapped trace produces)
    @functools.partial(jax.jit, static_argnames=("m",))
    def fwd_z(s, *, m):
        z = jax.lax.complex(s[..., 0, :], s[..., 1, :])
        return fftops.fft_fast(z, m)

    t, zf = bench("fwd_z", fwd_z, sig, m=m)
    results["fwd_z_s"] = t

    @functools.partial(jax.jit, static_argnames=("m",))
    def fwd_kernels(k, *, m):
        return fftops.fft_fast(k, m)

    t, ker_f = bench("fwd_kernels", fwd_kernels, kernels, m=m)
    results["fwd_kernels_s"] = t

    @functools.partial(jax.jit, static_argnames=("m",))
    def fwd_kernels_flat(k, *, m):
        return fftops.fft_fast(k.reshape(-1, k.shape[-1]), m)

    t, _ = bench("fwd_kernels_flat", fwd_kernels_flat, kernels, m=m)
    results["fwd_kernels_flat_s"] = t
    del _

    @jax.jit
    def prod_ifft(zf, ker_f):
        return fftops.ifft_fast(zf[..., None, :] * ker_f)

    t, conv = bench("prod_ifft", prod_ifft, zf, ker_f)
    results["prod_ifft_s"] = t
    del zf, ker_f

    @functools.partial(jax.jit, static_argnames=("n_out",))
    def emit(conv, *, n_out):
        out = jnp.stack([jnp.real(conv), jnp.imag(conv)], axis=-2)
        return out[..., :n_out].astype(jnp.float32)

    t, _ = bench("emit", emit, conv, n_out=n0)
    results["emit_s"] = t
    del conv, _

    results["pieces_sum_s"] = (
        results["fwd_z_s"]
        + results["fwd_kernels_s"]
        + results["prod_ifft_s"]
        + results["emit_s"]
    )
    results["device"] = device
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
