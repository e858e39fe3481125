"""Serving-layer throughput bench: N concurrent jobs through RenderService.

Measures what a production client actually sees — end-to-end job latency
including queueing, micro-batching, the SPMD render, device→host result
transfer and per-job trimming — and how well the batcher coalesced the
burst (one dispatch per static signature is the design claim).

Protocol: results are forced all the way to host numpy (the trimmed
arrays ARE host data), one warmup burst pays the compile before the
measured burst.

``--soak S`` switches to a sustained-load soak (round-4 VERDICT item 3):
Poisson arrivals of mixed-length, mixed-metrics jobs for S seconds, with a
warmup pass per static signature first.  Reports p50/p95/p99 end-to-end job
latency, the dispatch-size histogram, rejection count (backpressure), and
RSS at start/peak/end — the evidence that queueing, memory and latency stay
bounded under minutes of production-shaped load.

Usage:
  python tools/bench_serving.py                 # 48× 60 s 48 kHz jobs
  python tools/bench_serving.py --soak 600 --arrival-rate 2.0

Needs a GPU; the device and the card's power limit go to stderr first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
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


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _watchdog(svc, args, metric: str):
    """No-progress abort for a run that stops moving (utils.watchdog).

    Progress = the batcher's own counters; the watchdog adds process-I/O
    movement on top, so a long in-flight transfer never trips it.  A COLD
    first compile at a new shape can sit quiet longer than the default —
    pass a larger --stall-timeout (or 0 to disable) on cold-cache runs.
    """
    from audio_raytracing_studio_tpu.utils.watchdog import StallWatchdog

    def progress():
        st = svc.stats()
        return (st["jobs_done"], st["jobs_failed"], st["batches"])

    return StallWatchdog(
        progress,
        timeout_s=args.stall_timeout,
        stall_json={"metric": metric},
        name="bench-serving-watchdog",
    )


def soak(args) -> int:
    """Poisson-arrival sustained-load soak through RenderService."""
    out = run_soak(args, extir_every=args.extir_every)
    print(json.dumps(out))
    return 1 if out["failed"] else 0


def matrix(args) -> int:
    """Soak-matrix mode (round-4 VERDICT item 5): run --soak seconds per
    arm over the service-config matrix — external-IR jobs in the mix and
    device-mesh SPMD — reporting one JSON line per arm plus a summary."""
    import jax

    arms = [("internal+extir", {}, args.extir_every or 5)]
    ndev = len(jax.devices())
    if ndev >= 2:
        from audio_raytracing_studio_tpu.parallel import mesh as meshlib

        m = meshlib.make_mesh(data=ndev, block=1)
        arms.append(("mesh", {"device_mesh": m}, 0))
    else:
        print(
            f"matrix: {ndev} device(s) — skipping mesh arms", file=sys.stderr
        )
    rc = 0
    summary = []
    for label, kw, extir in arms:
        print(f"--- arm: {label} ---", file=sys.stderr)
        out = run_soak(args, svc_kwargs=kw, label=label, extir_every=extir)
        out["arm"] = label
        print(json.dumps(out), flush=True)
        rc |= 1 if out["failed"] else 0
        summary.append(
            {
                "arm": label,
                "completed": out["completed"],
                "failed": out["failed"],
                "x_realtime": out["throughput_x_realtime"],
                "p95_s": out["latency_p95_s"],
                "rss_end_mb": out["rss_end_mb"],
            }
        )
    print(json.dumps({"metric": "serving soak matrix", "arms": summary}))
    return rc


def http_soak(args) -> int:
    """Sustained load THROUGH the HTTP layer (round-4 VERDICT item 3).

    Poisson arrivals where each job is a full client lifecycle over real
    HTTP on this host: POST /v1/upload with pre-encoded wav/flac/ogg bytes
    (host decode happens on the request thread at job-POST time — the
    decode-starvation surface), POST /v1/jobs (mixed metrics/EQ/external-IR
    mix, mixed result formats), poll GET status, download the result.
    Proves request-thread decode doesn't starve the dispatch loop and that
    upload/result temp files are reclaimed under minutes of concurrent
    load.
    """
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from http.client import HTTPConnection

    from audio_raytracing_studio_tpu.serving import RenderService
    from audio_raytracing_studio_tpu.serving.service import RenderHTTPService
    from audio_raytracing_studio_tpu.utils import wavio

    rate = args.rate
    rng = np.random.default_rng(0x177E)
    durations = [float(d) for d in args.soak_durations.split(",")]
    codecs = ["wav", "flac", "ogg"]
    result_formats = ["wav", "flac", "ogg"]

    # pre-encode one blob per (duration, codec): the job mix cycles through
    # them so every decode path carries sustained request-thread load
    tmpd = tempfile.mkdtemp(prefix="ars_httpsoak_")
    blobs = {}
    try:
        for d in durations:
            n = int(d * rate)
            t = np.arange(n) / rate
            x = (
                0.35 * np.sin(2 * np.pi * 220.0 * t)
                + 0.05 * rng.standard_normal(n)
            ).astype(np.float32)
            xs = np.stack([x, 0.9 * x], axis=1)
            for c in codecs:
                path = os.path.join(tmpd, f"clip_{d}.{c}")
                wavio.write_audio(path, xs, rate)
                with open(path, "rb") as f:
                    blobs[(d, c)] = f.read()
        n_ir = int(0.4 * rate)
        env = np.exp(-np.arange(n_ir) / (0.1 * rate)).astype(np.float32)
        ir = (
            0.4 * rng.standard_normal((n_ir, 2)).astype(np.float32)
            * env[:, None]
        )
        ir_local = os.path.join(tmpd, "ir.wav")
        wavio.write(ir_local, ir, rate)
        with open(ir_local, "rb") as f:
            ir_blob = f.read()
    except BaseException:
        shutil.rmtree(tmpd, ignore_errors=True)
        raise

    svc = RenderService(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        fast_filters=args.fast_filters,
        pcm16_output=True,
        max_queued=args.max_queued,
        pipeline_depth=args.pipeline_depth,
    )
    metric = "serving soak over HTTP (mixed-codec uploads, full job lifecycle)"
    wd = _watchdog(svc, args, metric).start()
    hsvc = RenderHTTPService(service=svc, host="127.0.0.1", port=0).start()

    def _req(method, path, body=None, headers=None):
        conn = HTTPConnection("127.0.0.1", hsvc.port, timeout=600)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def _params(i, eq, extir):
        p = {
            "target_layout": "Stereo",
            "diffusion": 0.2 + 0.6 * ((i * 37) % 100) / 100.0,
            "x_pos": 0.1 + 0.8 * ((i * 53) % 100) / 100.0,
        }
        if eq:
            p["bass_gain"] = 1.5
        if extir:
            p["use_external_ir"] = True
        return p

    # the shared external IR is uploaded once; job uploads rotate per job
    st, data = _req(
        "POST", "/v1/upload", ir_blob, {"X-Filename": "ir.wav"}
    )
    assert st == 200, (st, data)
    ir_remote = json.loads(data)["path"]

    def run_job(i, t_arrival):
        d = durations[i % len(durations)]
        c = codecs[i % len(codecs)]
        eq = i % 3 == 0
        extir = i % 5 == 4
        fmt = result_formats[i % len(result_formats)]
        st, data = _req(
            "POST", "/v1/upload", blobs[(d, c)],
            {"X-Filename": f"clip{i}.{c}"},
        )
        if st != 200:
            return ("fail_upload", f"{st}: {data[:120]!r}", d)
        path = json.loads(data)["path"]
        payload = {
            "input": path,
            "seed": i,
            "metrics": i % 2 == 0,
            "format": fmt,
            "params": _params(i, eq, extir),
        }
        if extir:
            payload["external_ir"] = ir_remote
        st, data = _req("POST", "/v1/jobs", json.dumps(payload).encode())
        if st == 503:
            return ("rejected", None, d)
        if st != 202:
            return ("fail_submit", f"{st}: {data[:160]!r}", d)
        jid = json.loads(data)["job_id"]
        while True:
            st, data = _req("GET", f"/v1/jobs/{jid}")
            s = json.loads(data).get("status")
            if s == "done":
                break
            if s in ("error", "cancelled"):
                return ("fail_job", data[:160].decode("utf-8", "replace"), d)
            time.sleep(0.25)
        st, data = _req("GET", f"/v1/jobs/{jid}/result")
        if st != 200 or len(data) < 1000:
            return ("fail_result", f"{st}: {len(data)} bytes", d)
        return ("ok", time.monotonic() - t_arrival, d)

    # --- warmup: one serialized job per signature, straight through HTTP ---
    t_warm = time.monotonic()
    warm_jobs = 0
    for i in range(2 * len(durations) * len(codecs)):
        outcome = run_job(i, time.monotonic())
        if outcome[0] != "ok":
            print(f"warmup job {i} failed: {outcome}", file=sys.stderr)
            wd.stop()
            hsvc.stop()
            shutil.rmtree(tmpd, ignore_errors=True)
            return 1
        warm_jobs += 1
    print(
        f"warmup ({warm_jobs} jobs over HTTP): "
        f"{time.monotonic() - t_warm:.1f} s",
        file=sys.stderr,
    )
    if args.warm_buckets:
        from audio_raytracing_studio_tpu.params import RenderParams
        from audio_raytracing_studio_tpu.serving import RenderJob

        t_warm = time.monotonic()
        bucket_list = [int(b) for b in args.warm_buckets.split(",")]
        for di, d in enumerate(durations):
            n = int(d * rate)
            clip = np.zeros(n, np.float32)
            for wm in (False, True):
                job = RenderJob(
                    clip, rate,
                    RenderParams(**{
                        k: v for k, v in _params(di, di % 3 == 0, False).items()
                    }),
                    with_metrics=wm,
                )
                svc.warm(job, sizes=bucket_list)
        print(
            f"warm buckets {bucket_list}: {time.monotonic() - t_warm:.1f} s",
            file=sys.stderr,
        )

    lock = threading.Lock()
    latencies: list[float] = []
    failures: list[tuple] = []
    rejected = 0
    audio_ok = 0.0
    rss_samples = [_rss_mb()]
    dir_samples: list[tuple] = []
    stop_sampler = threading.Event()

    def sampler():
        while not stop_sampler.wait(5.0):
            st_ = svc.stats()
            with lock:
                rss_samples.append(st_.get("rss_mb", _rss_mb()))
                try:
                    dir_samples.append((
                        len(os.listdir(hsvc._uploads.dir)),
                        len(os.listdir(hsvc._result_dir)),
                    ))
                except OSError:
                    pass

    smp = threading.Thread(target=sampler, daemon=True)
    smp.start()

    pool = ThreadPoolExecutor(max_workers=args.http_workers)
    outstanding = []
    t0 = time.monotonic()
    deadline = t0 + args.soak
    i = warm_jobs
    submitted = 0
    while time.monotonic() < deadline:
        time.sleep(float(rng.exponential(1.0 / args.arrival_rate)))
        if time.monotonic() >= deadline:
            break
        outstanding.append(pool.submit(run_job, i, time.monotonic()))
        i += 1
        submitted += 1
    for fut in outstanding:
        kind, info, d = fut.result(timeout=3600)
        if kind == "ok":
            latencies.append(info)
            audio_ok += d
        elif kind == "rejected":
            rejected += 1
        else:
            failures.append((kind, info))
    wall = time.monotonic() - t0
    pool.shutdown()
    stop_sampler.set()
    smp.join(timeout=10)
    stats = svc.stats()
    wd.stop()
    upload_files_end = len(os.listdir(hsvc._uploads.dir))
    result_files_end = len(os.listdir(hsvc._result_dir))
    hsvc.stop()
    shutil.rmtree(tmpd, ignore_errors=True)
    rss_samples.append(_rss_mb())

    lat = sorted(latencies)
    tail = rss_samples[len(rss_samples) // 2:]
    slope = 0.0
    if len(tail) >= 3:
        x = np.arange(len(tail)) * (5.0 / 60.0)
        slope = float(np.polyfit(x, np.asarray(tail, np.float64), 1)[0])
    out = {
        "metric": metric,
        "soak_seconds": round(wall, 1),
        "arrival_rate_hz": args.arrival_rate,
        "http_workers": args.http_workers,
        "submitted": submitted,
        "completed": len(lat),
        "failed": len(failures),
        "rejected_503": rejected,
        "audio_seconds": round(audio_ok, 1),
        "throughput_x_realtime": round(audio_ok / wall, 1) if wall else 0,
        "latency_p50_s": round(_pct(lat, 0.50), 3),
        "latency_p95_s": round(_pct(lat, 0.95), 3),
        "latency_p99_s": round(_pct(lat, 0.99), 3),
        "jobs_done_service": stats["jobs_done"],
        "dispatch_s": stats["dispatch_s"],
        "fetch_s": stats["fetch_s"],
        "rss_start_mb": round(rss_samples[0], 1),
        "rss_peak_mb": round(max(rss_samples), 1),
        "rss_end_mb": round(rss_samples[-1], 1),
        "rss_slope_last_half_mb_per_min": round(slope, 2),
        "upload_files_peak": max((u for u, _ in dir_samples), default=0),
        "upload_files_end": upload_files_end,
        "result_files_peak": max((r for _, r in dir_samples), default=0),
        "result_files_end": result_files_end,
        "executables_end": stats.get("executables"),
        "failures_sample": [f"{k}: {v}" for k, v in failures[:3]],
    }
    print(json.dumps(out))
    return 1 if failures else 0


def run_soak(args, svc_kwargs=None, label="", extir_every=0) -> dict:
    """One soak arm: Poisson arrivals through a fresh RenderService.

    svc_kwargs overrides the service config (the --matrix arms pass
    device_mesh here); extir_every mixes one external-IR job
    per that many arrivals (they share one IR so they micro-batch).
    Returns the result dict — callers emit the JSON.
    """
    from audio_raytracing_studio_tpu.params import RenderParams
    from audio_raytracing_studio_tpu.serving import RenderJob, RenderService

    rate = args.rate
    rng = np.random.default_rng(0x50AC)
    durations = [float(d) for d in args.soak_durations.split(",")]
    # pre-generate one clip per duration; per-job variation comes from the
    # value-parameter sweep (content doesn't change serving behavior)
    clips = {}
    for d in durations:
        n = int(d * rate)
        t = np.arange(n) / rate
        clips[d] = (
            0.35 * np.sin(2 * np.pi * 200.0 * t)
            + 0.05 * rng.standard_normal(n)
        ).astype(np.float32)
    # one shared external IR (0.5 s stereo decaying noise): external-mode
    # jobs sharing the same IR bytes coalesce into one batch key
    n_ir = int(0.5 * rate)
    env = np.exp(-np.arange(n_ir) / (0.12 * rate)).astype(np.float32)
    ext_ir = (
        0.5 * rng.standard_normal((n_ir, 2)).astype(np.float32) * env[:, None]
    )

    kwargs = dict(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        fast_filters=args.fast_filters,
        pcm16_output=True,
        max_queued=args.max_queued,
        pipeline_depth=args.pipeline_depth,
    )
    kwargs.update(svc_kwargs or {})
    metric = "serving soak (Poisson arrivals, mixed lengths/metrics)"
    if label:
        metric += f" [{label}]"
    svc = RenderService(**kwargs)
    wd = _watchdog(svc, args, metric).start()

    def make_job(i: int, with_metrics=None, eq=None, extir=None) -> RenderJob:
        d = durations[i % len(durations)]
        if eq is None:
            eq = i % 3 == 0
        if with_metrics is None:
            with_metrics = i % 2 == 0
        if extir is None:
            extir = bool(extir_every) and i % extir_every == extir_every - 1
        p = RenderParams(
            target_layout="Stereo",
            diffusion=0.2 + 0.6 * ((i * 37) % 100) / 100.0,
            x_pos=0.1 + 0.8 * ((i * 53) % 100) / 100.0,
            # EQ flips per job: widened batch-wide inside one batch key; a
            # padded EQ-on job adds the eq_dyn leg to the executable
            bass_gain=1.5 if eq else 1.0,
            use_external_ir=extir,
        )
        return RenderJob(
            clips[d], rate, p, seed=i, with_metrics=with_metrics,
            external_ir=ext_ir if extir else None,
            external_ir_rate=rate if extir else None,
        )

    # --- warmup: one job per compiled-executable signature (duration ×
    # metrics × EQ/eq_dyn), serialized, so the soak measures serving, not
    # compiles ---
    t_warm = time.monotonic()
    warm_jobs = 0
    extir_arms = (False, True) if extir_every else (False,)
    for di in range(len(durations)):
        for wm in (False, True):
            for eq in (False, True):
                for xi in extir_arms:
                    svc.render(
                        make_job(di, with_metrics=wm, eq=eq, extir=xi),
                        timeout=3600,
                    )
                    warm_jobs += 1
    warmup_s = time.monotonic() - t_warm
    print(f"warmup ({warm_jobs} signatures): {warmup_s:.1f} s", file=sys.stderr)

    # warm the batch-size buckets traffic will actually form (the compiled
    # program is keyed on the padded batch dim too): one warm() per
    # traffic-shaped signature — make_job ties EQ to the duration index, so
    # (duration, metrics) with eq=None reproduces exactly the executables
    # the Poisson mix dispatches.  Without this the soak's first minutes
    # measure compiles, not serving.
    if args.warm_buckets:
        t_warm = time.monotonic()
        bucket_list = [int(b) for b in args.warm_buckets.split(",")]
        for di in range(len(durations)):
            for wm in (False, True):
                for xi in extir_arms:
                    warmed = svc.warm(
                        make_job(di, with_metrics=wm, extir=xi),
                        sizes=bucket_list,
                    )
        print(
            f"warm buckets {warmed} x "
            f"{2 * len(durations) * len(extir_arms)} signatures: "
            f"{time.monotonic() - t_warm:.1f} s",
            file=sys.stderr,
        )

    lock = threading.Lock()
    latencies: list[float] = []
    failures: list[str] = []
    rejected = 0
    rss_samples = [_rss_mb()]
    queue_depths: list[int] = []
    mem_samples: list[dict] = []  # full stats() snapshots (memory accounting)
    stop_sampler = threading.Event()

    def sampler():
        while not stop_sampler.wait(5.0):
            st = svc.stats()
            with lock:
                rss_samples.append(st.get("rss_mb", _rss_mb()))
                queue_depths.append(st["queued"])
                mem_samples.append(st)

    smp = threading.Thread(target=sampler, daemon=True)
    smp.start()
    n_warm_batches = len(svc.stats()["batch_sizes"])

    # --- Poisson arrivals for --soak seconds ---
    t0 = time.monotonic()
    deadline = t0 + args.soak
    submitted = 0
    audio_seconds = 0.0
    outstanding = 0
    drained = threading.Condition(lock)
    i = 0
    while time.monotonic() < deadline:
        # exponential inter-arrival gap at the target rate
        time.sleep(float(rng.exponential(1.0 / args.arrival_rate)))
        if time.monotonic() >= deadline:
            break
        job = make_job(i)
        i += 1
        t_sub = time.monotonic()

        def done(fut, t_sub=t_sub):
            nonlocal outstanding
            with lock:
                err = fut.exception()
                if err is not None:
                    failures.append(repr(err))
                else:
                    latencies.append(time.monotonic() - t_sub)
                outstanding -= 1
                drained.notify_all()

        try:
            fut = svc.submit(job)
        except RuntimeError:  # backpressure (503)
            rejected += 1
            continue
        with lock:
            outstanding += 1
        fut.add_done_callback(done)
        # drop the future reference NOW: a retained future pins its result
        # (~4 MB of rendered audio per job), which would make the harness
        # itself look like a service-side leak in the RSS numbers
        del fut
        submitted += 1
        audio_seconds += len(job.audio) / rate
    with drained:  # drain without retaining any result
        drained.wait_for(lambda: outstanding == 0, timeout=3600)
    wall = time.monotonic() - t0
    stop_sampler.set()
    smp.join(timeout=10)
    stats = svc.stats()
    wd.stop()
    svc.stop()
    import gc

    gc.collect()  # big numpy results are mmap'd; RSS reflects real frees
    rss_samples.append(_rss_mb())

    lat = sorted(latencies)
    sizes = stats["batch_sizes"]
    hist: dict[str, int] = {}
    for s in sizes[n_warm_batches:]:  # skip warmup + bucket-warm dispatches
        hist[str(s)] = hist.get(str(s), 0) + 1

    # --- memory trajectory (VERDICT r4 item 1: prove the plateau) ---
    # downsample the 5 s RSS samples to <=24 curve points and fit a line
    # over the last half (mb per minute) — a flat tail is the plateau proof
    curve = rss_samples
    if len(curve) > 24:
        step = (len(curve) - 1) / 23.0
        curve = [curve[int(round(k * step))] for k in range(24)]
    tail = rss_samples[len(rss_samples) // 2:]
    slope = 0.0
    if len(tail) >= 3:
        x = np.arange(len(tail)) * (5.0 / 60.0)  # sample period in minutes
        slope = float(np.polyfit(x, np.asarray(tail, np.float64), 1)[0])
    mem_last = mem_samples[-1] if mem_samples else {}
    out = {
        "metric": metric,
        "soak_seconds": round(wall, 1),
        "arrival_rate_hz": args.arrival_rate,
        "submitted": submitted,
        "completed": len(lat),
        "failed": len(failures),
        "rejected_503": rejected,
        "audio_seconds": round(audio_seconds, 1),
        "throughput_x_realtime": round(audio_seconds / wall, 1) if wall else 0,
        "latency_p50_s": round(_pct(lat, 0.50), 3),
        "latency_p95_s": round(_pct(lat, 0.95), 3),
        "latency_p99_s": round(_pct(lat, 0.99), 3),
        "latency_max_s": round(lat[-1], 3) if lat else 0.0,
        "dispatch_size_hist": hist,
        "queue_depth_max": max(queue_depths, default=0),
        "pipeline_depth": stats["pipeline_depth"],
        "dispatch_s": stats["dispatch_s"],  # host-stack+upload+launch total
        "fetch_s": stats["fetch_s"],  # result download+trim total

        "rss_start_mb": round(rss_samples[0], 1),
        "rss_mid_mb": round(rss_samples[len(rss_samples) // 2], 1),
        "rss_peak_mb": round(max(rss_samples), 1),
        "rss_end_mb": round(rss_samples[-1], 1),
        "rss_curve_mb": [round(v, 1) for v in curve],
        "rss_slope_last_half_mb_per_min": round(slope, 2),
        "executables_end": mem_last.get("executables"),
        "device_buffer_end_mb": mem_last.get("device_buffer_mb"),
        "inflight_input_peak_mb": round(
            max((s.get("inflight_input_bytes", 0) for s in mem_samples),
                default=0) / 1e6, 1),
        "retained_result_peak_mb": round(
            max((s.get("retained_result_bytes", 0) for s in mem_samples),
                default=0) / 1e6, 1),
        "failures_sample": failures[:3],
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_serving")
    ap.add_argument("--jobs", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--rate", type=int, default=48000)
    ap.add_argument("--max-batch", type=int, default=48)
    ap.add_argument("--max-wait-ms", type=float, default=200.0)
    ap.add_argument("--metrics", action="store_true")
    ap.add_argument(
        "--exact-filters", dest="fast_filters", action="store_false",
        default=True, help="bit-honest exact-length filters (default: fast)",
    )
    ap.add_argument(
        "--soak", type=float, default=0.0, metavar="SECONDS",
        help="sustained-load soak: Poisson arrivals for this many seconds",
    )
    ap.add_argument(
        "--arrival-rate", type=float, default=2.0,
        help="soak mean arrival rate, jobs/s (Poisson)",
    )
    ap.add_argument(
        # off the half-second bucket grid on purpose: padded EQ-on jobs
        # must exercise the length-dynamic exact EQ under sustained load
        "--soak-durations", default="5.3,14.7,44.9",
        help="comma-separated clip durations (s) cycled through in the soak",
    )
    ap.add_argument("--max-queued", type=int, default=64)
    ap.add_argument(
        "--http", action="store_true",
        help="soak THROUGH the HTTP layer: per-job upload (wav/flac/ogg "
             "bytes) → job POST → status polling → result download",
    )
    ap.add_argument(
        "--http-workers", type=int, default=16,
        help="HTTP soak: concurrent client lifecycles",
    )
    ap.add_argument(
        "--matrix", action="store_true",
        help="run --soak seconds per arm over the service-config matrix "
             "(external-IR mix, device mesh)",
    )
    ap.add_argument(
        "--extir-every", type=int, default=0,
        help="soak: every Nth job renders through a shared external IR "
             "(0 disables; the matrix's first arm defaults to 5)",
    )
    ap.add_argument(
        "--warm-buckets", default="2,4,8,16",
        help="soak: comma-separated batch-size buckets to pre-compile per "
             "traffic signature ('' skips; singles are always warmed)",
    )
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="dispatched groups in flight (1 = the pre-round-4 serial worker)",
    )
    ap.add_argument(
        "--stall-timeout", type=float, default=600.0,
        help="abort (exit 3, thread dump, error JSON) when neither the "
             "batcher's counters nor process I/O move for this many "
             "seconds.  Raise it (or 0 to disable) for cold-cache first "
             "compiles at a new shape",
    )
    args = ap.parse_args(argv)

    from audio_raytracing_studio_tpu.utils.runtime import gpu_device_record

    device = gpu_device_record()
    print(json.dumps({"device": device}), file=sys.stderr)

    if args.matrix:
        if args.soak <= 0:
            ap.error("--matrix needs --soak SECONDS (per-arm duration)")
        return matrix(args)
    if args.http:
        if args.soak <= 0:
            ap.error("--http needs --soak SECONDS")
        return http_soak(args)
    if args.soak > 0:
        return soak(args)

    from audio_raytracing_studio_tpu.params import RenderParams
    from audio_raytracing_studio_tpu.serving import RenderJob, RenderService

    rate = args.rate
    n = int(args.seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.default_rng(0)
    clips = [
        (0.4 * np.sin(2 * np.pi * (180 + 20 * i) * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
        for i in range(args.jobs)
    ]
    # a value sweep across the burst — all jobs share one static signature
    params = [
        RenderParams(
            target_layout="Stereo",
            diffusion=0.2 + 0.6 * (i / max(1, args.jobs - 1)),
            x_pos=0.1 + 0.8 * (i / max(1, args.jobs)),
        )
        for i in range(args.jobs)
    ]

    svc = RenderService(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        fast_filters=args.fast_filters,
        pcm16_output=True,
        pipeline_depth=args.pipeline_depth,
    )
    wd = _watchdog(
        svc, args, "serving realtime factor (audio-sec/sec, end-to-end jobs)"
    ).start()

    def burst(tag: str) -> float:
        t0 = time.perf_counter()
        futs = [
            svc.submit(
                RenderJob(c, rate, p, seed=i, with_metrics=args.metrics)
            )
            for i, (c, p) in enumerate(zip(clips, params))
        ]
        results = [f.result() for f in futs]
        dt = time.perf_counter() - t0
        # results are int16 (pcm16_output) so NaNs were clipped on device;
        # the honest sanity check is true-span length + audible signal
        for i, r in enumerate(results):
            assert r.audio.shape[0] > n, f"job {i}: no reverb tail"
            assert np.abs(np.asarray(r.audio, np.float32)).max() > 0, f"job {i} silent"
        print(f"{tag}: {dt:.3f} s for {args.jobs} jobs", file=sys.stderr)
        return dt

    # pre-compile EVERY batch-size bucket of the signature: which bucket a
    # group lands in depends on arrival timing, so without this the
    # measured pass can hit a fresh bucket and pay its compile
    t0 = time.perf_counter()
    warmed = svc.warm(
        RenderJob(clips[0], rate, params[0], with_metrics=args.metrics)
    )
    print(
        f"warm buckets {warmed}: {time.perf_counter() - t0:.1f} s",
        file=sys.stderr,
    )
    burst("warmup (download path)")
    stats0 = svc.stats()
    dt = burst("measured")

    audio_seconds = args.jobs * args.seconds
    stats = svc.stats()
    wd.stop()
    svc.stop()
    out = {
        "metric": "serving realtime factor (audio-sec/sec, end-to-end jobs)",
        "value": round(audio_seconds / dt, 1),
        "unit": "x realtime",
        "jobs": args.jobs,
        "job_latency_s": round(dt, 3),
        "batch_sizes": stats["batch_sizes"][-8:],
        "pipeline_depth": args.pipeline_depth,
        # measured-pass phase totals (worker dispatch vs completer fetch;
        # they overlap under pipelining, so the sum can exceed job_latency_s)
        "dispatch_s": round(stats["dispatch_s"] - stats0["dispatch_s"], 3),
        "fetch_s": round(stats["fetch_s"] - stats0["fetch_s"], 3),
        "device": device,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
