"""Measure the CPU (NumPy/SciPy oracle) realtime factor — the baseline.

The reference publishes no numbers (BASELINE.md), so the baseline the
accelerator build is compared against is the vendored-equivalent oracle rendering the
headline config (BASELINE.json config 1: internal Room hall, mono 48 kHz
60 s clip → stereo) single-threaded on this machine's CPU.

Writes BASELINE_CPU.json at the repo root; bench.py reads it for the
``vs_baseline`` ratio.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_raytracing_studio_tpu.oracle import dsp
from audio_raytracing_studio_tpu.params import RenderParams

DURATION_S = 60.0
RATE = 48000


def main() -> None:
    t = np.arange(int(DURATION_S * RATE)) / RATE
    clip = (0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    p = RenderParams(target_layout="Stereo")

    # one warmup + timed repeats
    rng = np.random.default_rng(0)
    dsp.render(clip, RATE, p, rng=rng)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        dsp.render(clip, RATE, p, rng=np.random.default_rng(i))
        times.append(time.perf_counter() - t0)

    wall = float(np.median(times))
    rtf = DURATION_S / wall
    result = {
        "config": "internal Room hall, mono 48kHz 60s clip -> stereo (BASELINE.json config 1)",
        "implementation": "NumPy/SciPy oracle (reference-equivalent), single-threaded CPU",
        "wall_seconds_per_clip": wall,
        "realtime_factor": rtf,
        "repeats": times,
    }
    out_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "BASELINE_CPU.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
