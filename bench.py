"""Headline benchmark: batched realtime factor on one GPU.

BASELINE.json metric: "Realtime factor (audio-sec rendered/sec/chip), 60 s
48 kHz clip, IR synth + convolve" — rendered through the full internal-hall
graph (BASELINE config 1: Room hall, default material, mono → stereo,
including the air-absorption filter and all normalizations) batched over B
clips in one SPMD program.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"value_exact", "vs_baseline_exact"} — "value" is the fast filter mode
(≤~2e-4 deviation, inside the 1e-3 parity contract), "value_exact" the
bit-honest exact-length filter path (the reference's semantics), both
measured in one process on the warm cache.  vs_baseline is the ratio
against the measured CPU oracle realtime factor (BASELINE_CPU.json — the
reference-equivalent NumPy/SciPy pipeline; the reference itself publishes
no numbers).  The JSON also names the device and the card's power limit.
Needs a GPU: on any other platform it exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

DURATION_S = 60.0
RATE = 48000


def _cpu_baseline_rtf() -> float:
    path = os.path.join(REPO, "BASELINE_CPU.json")
    try:
        with open(path) as f:
            return float(json.load(f)["realtime_factor"])
    except Exception:
        return 8.53  # BASELINE_CPU.json's value (tools/measure_cpu_baseline.py)


def main() -> None:
    import jax

    from audio_raytracing_studio_tpu.utils.runtime import gpu_device_record

    device = gpu_device_record()  # exits non-zero on any other platform
    print(json.dumps({"device": device}), file=sys.stderr)

    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams

    batch = int(os.environ.get("BENCH_BATCH", "48"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))

    t = np.arange(int(DURATION_S * RATE)) / RATE
    # varied content per clip (distinct tones + deterministic noise):
    # throughput here is content-independent, but the headline shouldn't
    # rest on 48 copies of one sine.
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

    # Build the batched program pieces once (host setup + device inputs).
    clips_cn = np.stack([pipeline._ensure_stereo_host(c).T for c in clips])
    import jax.numpy as jnp

    audio_bcn = jnp.asarray(clips_cn)
    keys = jnp.arange(batch, dtype=jnp.int32)  # counter-based seeds (ops.rng)

    def measure(fast: bool) -> float:
        """Warm up + time one filter mode → realtime factor."""
        setup = pipeline.build_internal_setup(
            p, RATE, clips.shape[1], fast_filters=fast
        )
        ir_scalars = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,)), setup.ir_scalars
        )
        mix_scalars = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (batch,)), setup.mix_scalars
        )

        def run():
            out, _ = sharding._batched_internal(
                audio_bcn,
                keys,
                ir_scalars,
                mix_scalars,
                ir_shape=setup.ir_shape,
                spec=setup.spec,
                with_metrics=False,
            )
            return jax.block_until_ready(out)

        run()  # compile + warmup
        # Settle before opening the timed window: the first executions
        # after a big compile can still run slow.  Run until two
        # consecutive samples agree within 20%, bounded by
        # BENCH_SETTLE_MAX; on a warm cache this costs two fast calls.
        settle: list[float] = []
        for _ in range(int(os.environ.get("BENCH_SETTLE_MAX", "12"))):
            t0 = time.perf_counter()
            run()
            settle.append(time.perf_counter() - t0)
            if len(settle) >= 2 and abs(settle[-1] - settle[-2]) <= 0.2 * min(
                settle[-2:]
            ):
                break
        if len(settle) > 2:
            print(
                f"settle({'fast' if fast else 'exact'}): "
                f"{[round(s, 3) for s in settle]}",
                file=sys.stderr,
            )
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            run()
            samples.append(time.perf_counter() - t0)
        samples.sort()
        wall = samples[len(samples) // 2]  # median: robust to one straggler
        return batch * DURATION_S / wall

    # BOTH modes in one process on the warm cache (round-4 VERDICT item 2):
    # "value" is the fast mode (conv-grid air + fused wet spectrum, ≤~2e-4
    # deviation — parity-tested vs the oracle, inside the 1e-3 contract);
    # "value_exact" is the bit-honest exact-length filter path — the
    # reference's own semantics (raytracer_studio.py:310-336, 387-398) —
    # carried in the SAME driver-recorded line so it cannot silently
    # regress.  BENCH_FAST=0 skips the fast arm (exact becomes the
    # headline), BENCH_EXACT=0 skips the exact arm — iteration knobs only;
    # the driver runs both.
    baseline = _cpu_baseline_rtf()
    record = {
        "metric": "realtime_factor_60s48k_batched_per_chip",
        "value": 0.0,
        "unit": "audio_seconds_per_second",
        "vs_baseline": 0.0,
        "device": device,
    }
    if os.environ.get("BENCH_FAST", "1") == "1":
        rtf = measure(fast=True)
        record["value"] = round(rtf, 2)
        record["vs_baseline"] = round(rtf / baseline, 2)
    if os.environ.get("BENCH_EXACT", "1") == "1":
        rtf_exact = measure(fast=False)
        record["value_exact"] = round(rtf_exact, 2)
        record["vs_baseline_exact"] = round(rtf_exact / baseline, 2)
        if record["value"] == 0.0:  # fast arm skipped: exact IS the headline
            record["value"] = record["value_exact"]
            record["vs_baseline"] = record["vs_baseline_exact"]
    print(json.dumps(record))


if __name__ == "__main__":
    main()
