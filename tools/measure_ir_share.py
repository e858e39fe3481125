"""IR-synthesis share of the batched render step, on the GPU.

Times the jitted, vmapped IR-bank synthesis alone (``ir_synth.hash_draws``
+ ``ir_synth.synthesize``, the code inside ``sharding._batched_internal``)
beside the full batched render step at the same shapes:

  * B=48 × Room (72,000-sample IRs), 60 s 48 kHz mono → Stereo;
  * B=16 × Cathedral room_size=600 (346,809-sample IRs), same clips.

The step runs on device-resident inputs in both filter modes.  Timing per
``utils.profiling.time_jitted`` (block_until_ready, warm-up first): the
median of ``--iters`` calls.  Prints one JSON line per shape,
naming the device and the card's power limit.  Needs a GPU.

Usage: python tools/measure_ir_share.py [--iters N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RATE = 48000
SECONDS = 60.0


def measure(name: str, p, batch: int, iters: int, n_in: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.ops import ir_synth
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.utils.profiling import time_jitted

    keys = jnp.arange(batch, dtype=jnp.int32)
    rng = np.random.default_rng(0)
    audio = jnp.asarray(
        (0.3 * rng.standard_normal((batch, 2, n_in))).astype(np.float32)
    )
    row = {"shape": name, "batch": batch}
    for fast in (True, False):
        setup = pipeline.build_internal_setup(p, RATE, n_in, fast_filters=fast)
        shape = setup.ir_shape
        row["ir_length"] = shape.length
        ir_sc = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,)), setup.ir_scalars)
        mix_sc = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,)), setup.mix_scalars)

        @jax.jit
        def bank(k, sc):
            def one(seed, s):
                return ir_synth.synthesize(shape, *ir_synth.hash_draws(seed, shape), s)

            return jax.vmap(one)(k, sc)

        def step():
            return sharding._batched_internal(
                audio, keys, ir_sc, mix_sc,
                ir_shape=shape, spec=setup.spec, with_metrics=False,
            )

        ir_s = time_jitted(bank, keys, ir_sc, name="ir_bank",
                           iterations=iters).seconds_median
        step_s = time_jitted(step, name="step", iterations=iters).seconds_median
        mode = "fast" if fast else "exact"
        row[mode] = {
            "ir_bank_s": ir_s,
            "step_s": step_s,
            "ir_share": ir_s / step_s,
        }
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=SECONDS)
    args = ap.parse_args(argv)

    from audio_raytracing_studio_tpu.params import RenderParams
    from audio_raytracing_studio_tpu.utils.runtime import gpu_device_record

    device = gpu_device_record()
    n_in = int(args.seconds * RATE)
    for name, p, batch in (
        ("room", RenderParams(target_layout="Stereo"), 48),
        ("cathedral_600",
         RenderParams(hall_type="Cathedral", room_size=600.0, target_layout="Stereo"), 16),
    ):
        row = measure(name, p, batch, args.iters, n_in)
        print(json.dumps({**row, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
