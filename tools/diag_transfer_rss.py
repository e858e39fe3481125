"""Minimal RSS diagnostic for host-memory growth under device transfers.

When a serving soak's RSS grows while the serving accounting shows inputs
and results bounded, the device path itself is the suspect.  This loop
isolates it: a fixed-shape host→device
upload, one jitted op, and a device→host download, repeated for --seconds,
with an RSS sample per iteration.  Linear growth here indicts the
backend's host-side transfer buffers (nothing in this loop retains
anything); a flat curve clears them and points back at serving-layer
allocation churn (fragmentation), which --malloc-trim tests directly.

Usage (GPU):    python tools/diag_transfer_rss.py --seconds 120
                python tools/diag_transfer_rss.py --seconds 120 --malloc-trim 10
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument(
        "--mb", type=float, default=16.0,
        help="payload size per direction per iteration (float32 MB)",
    )
    ap.add_argument(
        "--vary-shapes", type=int, default=0,
        help="cycle through N distinct payload shapes instead of one "
             "(distinguishes per-shape buffer pools from a plain leak)",
    )
    ap.add_argument(
        "--malloc-trim", type=float, default=0.0,
        help="call libc malloc_trim(0) every this many seconds",
    )
    args = ap.parse_args()

    from audio_raytracing_studio_tpu.utils.runtime import gpu_device_record

    device = gpu_device_record()
    import jax
    import jax.numpy as jnp

    print(json.dumps({"device": device}), file=sys.stderr)

    trim = None
    if args.malloc_trim > 0:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        trim = libc.malloc_trim

    n = int(args.mb * (1 << 20) / 4)
    shapes = max(1, int(args.vary_shapes))
    f = jax.jit(lambda x: x * 1.000001 + 0.5)
    rng = np.random.default_rng(0xD1A6)
    host = [
        rng.standard_normal(n + 1024 * k).astype(np.float32)
        for k in range(shapes)
    ]
    # one warm pass per shape so compiles don't sit inside the trace
    for k in range(shapes):
        np.asarray(f(jnp.asarray(host[k])))

    samples = []
    t0 = time.monotonic()
    last_trim = t0
    i = 0
    while time.monotonic() - t0 < args.seconds:
        k = i % shapes
        dev = jnp.asarray(host[k])          # host→device upload
        out = np.asarray(f(dev))            # execute + device→host download
        del dev
        if out.shape != host[k].shape:
            raise AssertionError("shape mismatch")
        now = time.monotonic()
        if trim is not None and now - last_trim >= args.malloc_trim:
            trim(0)
            last_trim = now
        samples.append((round(now - t0, 1), round(_rss_mb(), 1)))
        i += 1

    wall = time.monotonic() - t0
    rss = [s for _, s in samples]
    moved_mb = i * args.mb * 2
    half = rss[len(rss) // 2 :]
    x = np.arange(len(half), dtype=np.float64)
    slope = 0.0
    if len(half) >= 3:
        per_iter = np.polyfit(x, np.asarray(half, np.float64), 1)[0]
        slope = per_iter * (len(rss) / wall) * 60.0  # MB/min
    print(
        json.dumps(
            {
                "metric": "transfer-loop RSS diagnostic",
                "device": device,
                "seconds": round(wall, 1),
                "iterations": i,
                "payload_mb": args.mb,
                "shapes": shapes,
                "malloc_trim_s": args.malloc_trim,
                "moved_mb_total": round(moved_mb, 1),
                "rss_start_mb": rss[0],
                "rss_peak_mb": max(rss),
                "rss_end_mb": rss[-1],
                "rss_slope_last_half_mb_per_min": round(float(slope), 2),
                "rss_curve_mb": rss[:: max(1, len(rss) // 24)],
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
