"""Host codec throughput bench: encode/decode realtime factors per format.

VERDICT r4 item 2: uploads decode at POST time on the HTTP thread of a
1-core host (serving/service.py), so codec speed is part of the serving
story — a slow decoder starves the device dispatch loop (the CLAUDE.md
15x-corruption failure mode).  The reference pays the same cost inside
libsndfile/ffmpeg (raytracer_studio.py:1013); here the decoders are
in-repo, so the numbers are ours to own.

Measures wall-clock encode and decode for each writable/readable format
at the given clip lengths and prints one JSON line per (codec, length)
plus a markdown table.  Pure host work: jax is never imported.

Usage:
    python tools/bench_codecs.py [--lengths 60 600] [--codecs wav flac ogg mp3 m4a]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_raytracing_studio_tpu.utils import wavio  # noqa: E402

RATE = 44100
CODEC_EXT = {"wav": ".wav", "flac": ".flac", "ogg": ".ogg", "mp3": ".mp3", "m4a": ".m4a"}


def music_like(seconds: float, rate: int = RATE, channels: int = 2) -> np.ndarray:
    """Deterministic music-like test signal: AM'd harmonic stack + noise.

    Lossy encoders' speed depends on content (residue/psychoacoustic work
    scales with spectral complexity), so a bare sine would flatter them.
    """
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    rng = np.random.default_rng(0xC0DEC)
    sig = np.zeros((n, channels), dtype=np.float64)
    for ch in range(channels):
        for k, f0 in enumerate((110.0, 220.0, 330.0, 554.37, 880.0)):
            am = 0.5 + 0.5 * np.sin(2 * np.pi * (0.3 + 0.13 * k) * t + ch)
            sig[:, ch] += am * np.sin(2 * np.pi * f0 * (1 + 0.001 * ch) * t) / (k + 1)
        sig[:, ch] += 0.05 * rng.standard_normal(n)
    sig *= 0.5 / np.max(np.abs(sig))
    return sig.astype(np.float32)


def available(codec: str) -> bool:
    if codec in ("wav", "flac", "ogg"):
        return True  # in-repo native paths, always present
    if codec == "mp3":
        from audio_raytracing_studio_tpu.utils import mp3io

        return mp3io.encode_available() and mp3io.decode_available()
    if codec == "m4a":
        from audio_raytracing_studio_tpu.utils import lavcio

        return lavcio.encode_available() and lavcio.decode_available()
    return False


def bench_one(codec: str, seconds: float, workdir: str) -> dict:
    data = music_like(seconds)
    path = os.path.join(workdir, f"bench_{codec}_{int(seconds)}s{CODEC_EXT[codec]}")

    t0 = time.perf_counter()
    wavio.write_audio(path, data, RATE)
    enc_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out, rate = wavio.read(path)
    dec_s = time.perf_counter() - t0

    assert rate == RATE, f"{codec}: rate {rate} != {RATE}"
    drift = abs(out.shape[0] - data.shape[0])
    assert drift <= RATE // 10, f"{codec}: length drift {drift} samples"

    size = os.path.getsize(path)
    os.remove(path)
    return {
        "codec": codec,
        "clip_s": seconds,
        "encode_s": round(enc_s, 3),
        "decode_s": round(dec_s, 3),
        "encode_x_rt": round(seconds / enc_s, 1),
        "decode_x_rt": round(seconds / dec_s, 1),
        "mb": round(size / 1e6, 2),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", type=float, nargs="+", default=[60.0, 600.0])
    ap.add_argument("--codecs", nargs="+", default=list(CODEC_EXT))
    args = ap.parse_args()

    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        for codec in args.codecs:
            if not available(codec):
                print(f"# {codec}: unavailable on this image, skipped", flush=True)
                continue
            for seconds in args.lengths:
                row = bench_one(codec, seconds, workdir)
                rows.append(row)
                print(json.dumps(row), flush=True)

    print("\n| codec | clip | encode ×rt | decode ×rt | size MB |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['codec']} | {int(r['clip_s'])}s | {r['encode_x_rt']}× "
            f"| {r['decode_x_rt']}× | {r['mb']} |"
        )
    worst = min(rows, key=lambda r: r["decode_x_rt"])
    print(
        f"\nworst decode: {worst['codec']} at {worst['decode_x_rt']}x realtime "
        f"({worst['clip_s']}s clip)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
