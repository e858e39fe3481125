"""Audio analyzer CLI — the sidecar tool's capabilities, on the device.

Covers /root/reference/analyser.py (a standalone Streamlit app shelling out
to ffmpeg/pydub): file analysis (rate/channels/duration/LUFS), normalization
to a target LUFS, and format conversion.  LUFS measurement and gain-based
normalization run through the framework's own BS.1770 meter — no external
binaries needed.  WAV/FLAC/OGG convert natively, MP3 through the in-image
codec libraries (ctypes, utils/mp3io), AAC/M4A through the FFmpeg
libraries compiled in-process (utils/lavcio) — every target the reference
converts to, with no external binary; the ffmpeg-on-PATH tier remains
only as the last fallback on stripped images.

Usage:
  python -m audio_raytracing_studio_tpu.cli.analyzer analyze in.wav
  python -m audio_raytracing_studio_tpu.cli.analyzer normalize in.wav out.wav --target -16
  python -m audio_raytracing_studio_tpu.cli.analyzer convert in.wav out.mp3 --bitrate 256
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys

import numpy as np

from ..analysis.metrics import calculate_audio_metrics
from ..utils import wavio


def analyze(path: str, backend: str = "jax", true_peak: bool = False) -> dict:
    """Rate / channels / duration / LUFS — analyser.py:50-70 equivalents.

    ``true_peak=True`` additionally reports the 4× oversampled inter-sample
    true peak (BS.1770 Annex 2, metering.loudness.oversampled_true_peak_dbfs)
    — a rebuild extension: the reference's "Peak" is the plain sample peak
    despite its label (raytracer_studio.py:695-697), kept as-is for parity.
    """
    data, rate = wavio.read(path)  # one decode: meta derives from the data
    meta = {
        "samplerate": rate,
        "channels": data.shape[1],
        "duration": data.shape[0] / rate if rate > 0 else 0.0,
    }
    metrics = calculate_audio_metrics(data, rate, backend=backend)
    lufs = metrics["lufs"]
    peak = metrics["true_peak_dbfs"]
    result = {
        "Pfad": str(path),
        "Abtastrate": meta["samplerate"],
        "Kanäle": meta["channels"],
        "Dauer (Sekunden)": round(meta["duration"], 2),
        "LUFS": round(lufs, 2) if lufs is not None and np.isfinite(lufs) else "Nicht messbar",
        "Peak (dBFS)": round(peak, 2)
        if peak is not None and np.isfinite(peak) else "-inf",
    }
    if true_peak:
        import jax
        import jax.numpy as jnp

        from ..metering.loudness import oversampled_true_peak_dbfs

        tp = float(jax.jit(oversampled_true_peak_dbfs)(jnp.asarray(data.T)))
        result["True Peak 4x (dBTP)"] = round(tp, 2) if np.isfinite(tp) else "-inf"
    return result


def normalize_to_lufs(
    input_path: str, output_path: str, target_lufs: float = -16.0, backend: str = "jax"
) -> dict:
    """Static-gain normalization to the target integrated loudness.

    analyser.py:86-105 runs ffmpeg loudnorm; for integrated-loudness
    targeting a constant gain is exact (loudness is gain-equivariant), keeps
    dynamics untouched, and needs no external binary.
    """
    data, rate = wavio.read(input_path)
    metrics = calculate_audio_metrics(data, rate, backend=backend)
    lufs = metrics["lufs"]
    if lufs is None or not np.isfinite(lufs):
        raise ValueError("LUFS nicht messbar (Stille oder zu kurz)")
    gain_db = target_lufs - lufs
    gain = 10.0 ** (gain_db / 20.0)
    scaled = data * gain
    clipped = bool(np.any(np.abs(scaled) > 1.0))
    out = np.clip(scaled, -1.0, 1.0)
    wavio.write_audio(output_path, out, rate, subtype="PCM_16")
    # constant gain is exact for integrated loudness, so re-metering only
    # adds information when the clip stage engaged (a second full meter
    # pass would otherwise double the runtime on hour-scale files)
    if clipped:
        output_lufs = calculate_audio_metrics(out, rate, backend=backend)["lufs"]
    else:
        output_lufs = target_lufs
    return {
        "input_lufs": round(lufs, 2),
        "gain_db": round(gain_db, 2),
        "output_lufs": round(output_lufs, 2),
        "clipped": clipped,
        "output": output_path,
    }


def convert(input_path: str, output_path: str, bitrate: str = "256",
            samplerate: int | None = None) -> str:
    """Format conversion (analyser.py:73-83).  WAV, FLAC and Ogg/Vorbis
    natively (both directions, via utils.wavio / flacio / vorbisio +
    vorbisenc); MP3 through the in-image codec libraries bound via ctypes
    (utils.mp3io: libmp3lame out, libmpg123 in — no subprocess); AAC/M4A
    through the FFmpeg *libraries* compiled in-process (utils.lavcio —
    the reference needs the ffmpeg BINARY via pydub for ALL lossy
    targets).  ``samplerate`` additionally rate-converts through the
    on-device polyphase resampler (ops.resample) — a rebuild extension;
    the reference's converter can only change containers, not rates."""

    def _maybe_resample(data: np.ndarray, rate: int) -> tuple[np.ndarray, int]:
        if samplerate is None or int(samplerate) == rate:
            return data, rate
        from ..ops.resample import resample_poly

        return np.asarray(resample_poly(data, int(samplerate), rate)), int(samplerate)

    if output_path.lower().endswith(".wav"):
        data, rate = wavio.read(input_path)  # reads WAV or FLAC natively
        data, rate = _maybe_resample(data, rate)
        wavio.write(output_path, data, rate, subtype="PCM_16")
        return output_path
    if output_path.lower().endswith(".flac"):
        from ..utils import flacio

        data, rate = wavio.read(input_path)
        data, rate = _maybe_resample(data, rate)
        flacio.write(output_path, data, rate, bits_per_sample=16)
        return output_path
    if output_path.lower().endswith(".ogg"):
        from ..utils import vorbisenc

        data, rate = wavio.read(input_path)
        data, rate = _maybe_resample(data, rate)
        # the encoder is quality-mode (like libvorbis -q); honor the bitrate
        # request through the measured kbps→quality mapping instead of
        # silently ignoring it
        vorbisenc.write(
            output_path, data, rate,
            quality=vorbisenc.quality_for_bitrate(int(bitrate)),
        )
        return output_path
    if output_path.lower().endswith(".mp3"):
        from ..utils import mp3io

        if mp3io.encode_available():
            data, rate = wavio.read(input_path)
            data, rate = _maybe_resample(data, rate)
            mp3io.write(output_path, data, rate, bitrate_kbps=int(bitrate))
            return output_path
        # libmp3lame absent → the ffmpeg tier below keeps the old contract
    if output_path.lower().endswith((".aac", ".m4a", ".mp4")):
        from ..utils import lavcio

        if lavcio.encode_available():
            data, rate = wavio.read(input_path)
            data, rate = _maybe_resample(data, rate)
            lavcio.encode_aac(output_path, data, rate, bitrate_kbps=int(bitrate))
            return output_path
        # FFmpeg libraries absent → the binary tier below keeps the contract
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not found — non-WAV conversion needs ffmpeg on PATH"
        )
    cmd = ["ffmpeg", "-y", "-i", str(input_path), "-b:a", f"{bitrate}k"]
    if samplerate is not None:
        cmd += ["-ar", str(int(samplerate))]
    proc = subprocess.run(
        cmd + [str(output_path)], capture_output=True, timeout=600
    )
    if proc.returncode != 0:
        # surface ffmpeg's actual diagnostic — CalledProcessError's str()
        # hides the captured stderr that explains the failure
        raise ValueError(
            "ffmpeg-Konvertierung fehlgeschlagen: "
            f"{proc.stderr.decode('utf-8', 'replace').strip()[:300]}"
        )
    return output_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ars-analyze", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="rate/channels/duration/LUFS")
    a.add_argument("input")
    a.add_argument("--backend", default="jax", choices=["jax", "oracle"])
    a.add_argument(
        "--true-peak", action="store_true",
        help="also report the 4x oversampled inter-sample true peak (dBTP)",
    )

    n = sub.add_parser("normalize", help="normalize to target LUFS")
    n.add_argument("input")
    n.add_argument("output")
    n.add_argument("--target", type=float, default=-16.0)
    n.add_argument("--backend", default="jax", choices=["jax", "oracle"])

    c = sub.add_parser(
        "convert", help="convert format (wav/flac/ogg/mp3/aac/m4a, no ffmpeg)"
    )
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--bitrate", default="256")
    c.add_argument("--samplerate", type=int, default=None,
                   help="also rate-convert (on-device polyphase resampler)")

    args = ap.parse_args(argv)  # parse first: --help shouldn't init JAX
    from ..utils.runtime import ensure_backend

    ensure_backend()
    try:
        if args.cmd == "analyze":
            print(json.dumps(
                analyze(args.input, args.backend, true_peak=args.true_peak),
                ensure_ascii=False, indent=2,
            ))
        elif args.cmd == "normalize":
            print(json.dumps(normalize_to_lufs(args.input, args.output, args.target, args.backend), indent=2))
        elif args.cmd == "convert":
            print(convert(args.input, args.output, args.bitrate,
                          samplerate=args.samplerate))
    except Exception as e:  # noqa: BLE001 — CLI error surface
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
