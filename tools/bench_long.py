"""Long-form benchmark on one GPU (not the driver's line):

Streaming render of a genuinely long clip (default 30 min @ 48 kHz) through
``render_streaming``.  Reports three realtime factors: ``compute`` (output
stays on device; the metrics readbacks force the full render),
``end_to_end`` (including the float32 result download) and
``end_to_end_pcm16`` (device-quantized int16 download).  Prints the device
and the card's power limit first; needs a GPU.

Usage: python tools/bench_long.py [--minutes N] [--bass B] [--treble T] [--exact]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _make_long_clip(minutes: float, rate: int):
    import numpy as np

    n = int(minutes * 60.0 * rate)
    t0 = np.arange(n, dtype=np.float64) / rate
    x = (0.25 * np.sin(2 * np.pi * 220.0 * t0)
         + 0.1 * np.sin(2 * np.pi * 3.1 * t0) * np.sin(2 * np.pi * 880.0 * t0)
         ).astype(np.float32)
    return x


def bench_long(minutes: float, bass: float = 1.0, treble: float = 1.0,
               exact: bool = False) -> dict:
    """30-min streaming render timings.  ``exact`` runs fast_filters=False:
    the reference's exact-length air transform via the blockwise traced-n0
    Bluestein over the separated late stream (round-5) — the on-chip cost
    of bit-honest streaming semantics vs the conv-grid default."""
    from audio_raytracing_studio_tpu.parallel.streaming import render_streaming
    from audio_raytracing_studio_tpu.params import RenderParams

    rate = 48000
    seconds = minutes * 60.0
    x = _make_long_clip(minutes, rate)
    p = RenderParams(target_layout="5.1 (Standard)", room_size=200.0,
                     bass_gain=bass, treble_gain=treble)
    ff = not exact

    # warm at FULL shape: finish/meter executables depend on the total
    # buffer length, so a short warm run would leave compiles in the timing
    render_streaming(x, rate, p, seed=1, chunk_seconds=30.0,
                     with_metrics=True, return_output=False, fast_filters=ff)

    start = time.perf_counter()
    _none, metrics = render_streaming(
        x, rate, p, seed=1, chunk_seconds=30.0,
        with_metrics=True, return_output=False, fast_filters=ff,
    )
    compute_wall = time.perf_counter() - start

    start = time.perf_counter()
    out, _m = render_streaming(
        x, rate, p, seed=1, chunk_seconds=30.0, with_metrics=True,
        fast_filters=ff,
    )
    e2e_wall = time.perf_counter() - start

    # device-side PCM16 quantization: int16 result at half the transfer
    # (bit-identical to host-quantizing `out` — asserted below)
    start = time.perf_counter()
    out16, _m = render_streaming(
        x, rate, p, seed=1, chunk_seconds=30.0, with_metrics=True,
        pcm16_output=True, fast_filters=ff,
    )
    e2e16_wall = time.perf_counter() - start
    import numpy as np

    from audio_raytracing_studio_tpu import config
    from audio_raytracing_studio_tpu.utils import wavio

    host16 = wavio.encode_pcm16(
        np.clip(out, -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
    )
    pcm16_exact = bool(np.array_equal(out16, host16))
    return {
        "metric": "streaming_long_render_realtime_factor",
        "filters": "exact" if exact else "fast",
        "minutes": minutes,
        "rate": rate,
        "layout": "5.1 (Standard)",
        "compute": round(seconds / compute_wall, 2),
        "compute_wall_s": round(compute_wall, 2),
        "end_to_end": round(seconds / e2e_wall, 2),
        "end_to_end_wall_s": round(e2e_wall, 2),
        "end_to_end_pcm16": round(seconds / e2e16_wall, 2),
        "end_to_end_pcm16_wall_s": round(e2e16_wall, 2),
        "pcm16_bit_identical": pcm16_exact,
        "out_shape": list(out.shape),
        "result_mb": round(out.nbytes / 1e6, 1),
        "result_pcm16_mb": round(out16.nbytes / 1e6, 1),
        "metrics": metrics,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--bass", type=float, default=1.0)
    ap.add_argument("--treble", type=float, default=1.0)
    ap.add_argument("--exact", action="store_true",
                    help="fast_filters=False: exact-length streaming air")
    args = ap.parse_args()

    from audio_raytracing_studio_tpu.utils.runtime import gpu_device_record

    print(json.dumps({"device": gpu_device_record()}), flush=True)
    print(json.dumps(
        bench_long(args.minutes, args.bass, args.treble, args.exact)
    ), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
