"""Directory batch renderer — production serving loop with I/O prefetch.

Renders every audio file in a directory (WAV/FLAC/AIFF/OGG/MP3/M4A —
anything the native codecs or the FFmpeg-library tier read, as long as
the header declares a frame count) through the batched SPMD pipeline, keeping
the device busy: clips are bucketed by (rate, length quantized to a
half-second grid) using header-only probes, each bucket reuses one compiled
executable, and while the device renders micro-batch *i* a thread pool reads
micro-batch *i+1* and writes the finished outputs.  Metrics are computed on
the trimmed per-clip output (not the bucket padding).

Shelf EQ buckets like everything else: render_batch runs the exact
circular EQ length-DYNAMICALLY for padded clips (chirps from each clip's
true decoded length as traced scalars — ops.filters.apply_shelf_eq_dynamic,
≤1e-6 vs the unpadded solo render), so mixed-length EQ-on directories share
one compiled executable per (rate, bucket) too.

Usage:
  python -m audio_raytracing_studio_tpu.cli.render_dir in_dir/ out_dir/ \
      --hall Cathedral --room-size 400 --layout "5.1 (Standard)" \
      --batch 8 --seed 7 --metrics
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import time
from typing import List

import numpy as np

from .. import config
from ..analysis.metrics import calculate_audio_metrics, metrics_string
from ..utils import wavio
from .render import params_from_args


def _bucket_length(n: int, rate: int) -> int:
    """Quantize clip length up to a half-second grid to bound compile count
    (one definition, shared with the serving batcher: parallel.sharding)."""
    from ..parallel.sharding import bucket_length

    return bucket_length(n, rate)


# raw .aac (ADTS) is excluded: it carries no frame count, so the header-only
# probe cannot bucket it — convert to m4a first (cli/analyzer convert)
AUDIO_EXTENSIONS = (
    ".wav", ".flac", ".aiff", ".aifc", ".aif", ".ogg", ".mp3", ".m4a", ".mp4"
)


def discover(in_dir: str) -> List[str]:
    return sorted(
        f for f in os.listdir(in_dir) if f.lower().endswith(AUDIO_EXTENSIONS)
    )


def main(argv=None) -> int:
    from .render import add_param_flags

    ap = argparse.ArgumentParser(
        prog="ars-render-dir", description="directory batch renderer"
    )
    ap.add_argument(
        "input",
        help="input directory of audio files (WAV/FLAC/AIFF/OGG/MP3/M4A)",
    )
    ap.add_argument("output", help="output directory")
    ap.add_argument("--batch", type=int, default=8, help="micro-batch size")
    add_param_flags(ap)
    args = ap.parse_args(argv)

    from ..utils.runtime import ensure_backend

    ensure_backend()
    from ..parallel.sharding import render_batch

    try:
        names = discover(args.input)
    except OSError as e:
        # a file where a directory belongs, a missing path, a permission
        # wall: the CLI contract is "error: ..." + exit 1, not a traceback
        # (fuzz-found, tools/fuzz_campaign.py cli mode seed 1200004)
        print(f"error: cannot list {args.input!r}: {e}", file=sys.stderr)
        return 1
    if not names:
        print("no audio files found", file=sys.stderr)
        return 1
    try:
        os.makedirs(args.output, exist_ok=True)
    except OSError as e:
        print(f"error: cannot create {args.output!r}: {e}", file=sys.stderr)
        return 1
    try:
        p = params_from_args(args)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if p.use_external_ir:
        print("error: render_dir covers the internal hall path", file=sys.stderr)
        return 2

    # --- bucket by (rate, quantized length) from header-only probes ---
    buckets: dict = {}
    for name in names:
        try:
            meta = wavio.probe(os.path.join(args.input, name))
        except (OSError, ValueError) as e:
            print(f"skipping {name}: {e}", file=sys.stderr)
            continue
        if meta["frames"] <= 0:
            # an unknown length (Ogg with no EOS granule, unscannable MP3 …)
            # would bucket to length 0 and render as pure silence — skip loud
            print(f"skipping {name}: could not determine length", file=sys.stderr)
            continue
        key = (meta["samplerate"], _bucket_length(meta["frames"], meta["samplerate"]))
        buckets.setdefault(key, []).append((name, meta["frames"]))
    if not buckets:
        print("no readable audio files", file=sys.stderr)
        return 1

    # unique OUTPUT name per input, decided up front: song.wav and song.mp3
    # both map to song.wav otherwise, and concurrent post_chunk threads
    # would silently overwrite each other's results
    used_out: set = set()

    def _out_name(name: str) -> str:
        base, ext = os.path.splitext(name)
        # keep .wav/.flac/.ogg (write_audio dispatches on extension);
        # other input formats (AIFF, MP3, M4A …) come back as WAV
        out = name if ext.lower() in (".wav", ".flac", ".ogg") else base + ".wav"
        stem, oext = os.path.splitext(out)
        k = 1
        while out in used_out:
            out = f"{stem}_{k}{oext}"
            k += 1
        used_out.add(out)
        return out

    out_names = {
        name: _out_name(name) for items in buckets.values() for name, _ in items
    }
    # the meter is a full extra device pass (host pass for binaural) — only
    # pay for it when the numbers are reported (cli/render's rule)
    want_metrics = args.metrics or args.json

    io_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)

    def load_chunk(chunk):
        return [
            wavio.read(os.path.join(args.input, name))[0] for name, _frames in chunk
        ]

    # flatten micro-batches so batch i+1 prefetches while i renders
    schedule = []
    clip_base = 0  # global clip index: per-clip seeds must not collide
    for (rate, n_bucket), items in sorted(buckets.items()):  # across buckets
        for lo in range(0, len(items), args.batch):
            chunk_items = items[lo : lo + args.batch]
            schedule.append((rate, n_bucket, chunk_items, clip_base))
            clip_base += len(chunk_items)

    def post_chunk(outs, batch_metrics, chunk, rate, n_bucket):
        """Trim and write one rendered chunk (binaural additionally
        post-processes + meters on host).

        Runs on a pool thread so the host work of batch *i* overlaps the
        device step of batch *i+1* (the driver thread only blocks on
        render_batch's device→host transfer).  On the non-binaural path
        the device already quantized to int16 (half the transfer) and
        metered each clip's true output span, so the host only trims the
        bucket padding and writes bytes.
        """
        chunk_results = []
        for i, (name, frames) in enumerate(chunk):
            out_path = os.path.join(args.output, out_names[name])
            # trim the bucket padding: real output = clip len + IR − 1
            real_len = frames + (outs.shape[1] - n_bucket)
            trimmed = outs[i, :real_len]
            if args.binaural:
                # same order as cli/render._finalize_and_write: binauralize
                # the raw render, clip the STEREO that hits disk to the
                # output contract, meter what was written
                from ..ops.binaural import binauralize

                trimmed = binauralize(
                    np.asarray(trimmed, dtype=np.float32), rate, p.target_layout
                )
                trimmed = np.clip(
                    trimmed, -config.OUTPUT_CLIP, config.OUTPUT_CLIP
                )
                metrics = (
                    calculate_audio_metrics(trimmed, rate) if want_metrics else None
                )
            else:
                metrics = batch_metrics[i] if batch_metrics is not None else None
            wavio.write_audio(out_path, trimmed, rate)
            chunk_results.append({"output": out_path, "metrics": metrics})
        return chunk_results

    t_start = time.perf_counter()
    audio_seconds = 0.0
    post_futures = []

    pending = io_pool.submit(load_chunk, schedule[0][2]) if schedule else None
    for step, (rate, n_bucket, chunk, base) in enumerate(schedule):
        datas = pending.result()
        pending = (
            io_pool.submit(load_chunk, schedule[step + 1][2])
            if step + 1 < len(schedule)
            else None
        )

        from ..models.pipeline import _ensure_stereo_host

        # lossy probes can mis-declare by a codec frame in EITHER direction
        # (MP4 padding): never let a decoded clip overrun its bucket, and
        # always hand render_batch the DECODED lengths — they drive the
        # masked meter AND the length-dynamic exact EQ of padded clips
        # (a short decode zero-padding a header-length EQ run was a review
        # finding; the dynamic EQ keys on the true length, so header
        # over-declares are harmless now)
        decoded = [_ensure_stereo_host(d)[:n_bucket] for d in datas]
        clips = np.zeros((len(chunk), n_bucket, 2), dtype=np.float32)
        for i, st in enumerate(decoded):
            clips[i, : st.shape[0], :] = st
        # post_chunk trims with these lengths too — the written output must
        # match the EQ'd true span, not the header's declared frame count
        chunk = [(name, st.shape[0]) for (name, _f), st in zip(chunk, decoded)]
        true_lens = [st.shape[0] for st in decoded]
        seeds = [args.seed + base + i for i in range(len(chunk))]

        if args.binaural:
            # binaural post-processing runs on host floats and re-meters
            outs = render_batch(
                clips, rate, p, seeds=seeds, fast_filters=True,
                clip_lengths=true_lens,
            )
            batch_metrics = None
        elif want_metrics:
            outs, batch_metrics = render_batch(
                clips, rate, p, seeds=seeds,
                fast_filters=True, with_metrics=True, pcm16_output=True,
                clip_lengths=true_lens,
            )
        else:
            # no metrics requested → skip the whole on-device meter pass
            outs = render_batch(
                clips, rate, p, seeds=seeds,
                fast_filters=True, pcm16_output=True,
                clip_lengths=true_lens,
            )
            batch_metrics = None
        post_futures.append(
            io_pool.submit(post_chunk, outs, batch_metrics, chunk, rate, n_bucket)
        )
        audio_seconds += sum(frames for _, frames in chunk) / rate

    results = [r for f in post_futures for r in f.result()]
    wall = time.perf_counter() - t_start
    io_pool.shutdown()

    if args.json:
        print(json.dumps({"clips": results, "audio_seconds": audio_seconds,
                          "wall_seconds": wall,
                          "realtime_factor": audio_seconds / wall if wall else None}))
    else:
        for r in results:
            line = r["output"]
            if args.metrics:
                line += "  " + metrics_string(r["metrics"])
            print(line)
        print(f"# {len(results)} clips, {audio_seconds:.1f} audio-s in {wall:.2f} s "
              f"({audio_seconds / wall:.1f}x realtime)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
