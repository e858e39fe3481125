"""Smoke test of the system's main paths on the GPU, checked against the oracle.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --chips 4    # four GPUs: the sharded paths only

Phases (one card), each printing one JSON line of findings:

0. device — platform, device kind, count, the card's name and power limit
   (nvidia-smi), the compile-cache directory;
1. farm — ``sharding.render_batch`` on B=48 mono 60 s 48 kHz clips, Room
   hall → Stereo, PCM16 output and metrics, in both filter modes;
2. external + multichannel — BASELINE config 2 (external stereo IR,
   dry/wet, dry-kill, shelf EQ, clips of mixed true length) and configs
   4-5 (a 3D-positioned source → 7.1 and 5.1.2, metered);
3. service — the HTTP JSON API (``serving.service``) answering WAV and FLAC
   uploads of 10-60 s, with an external-IR job, an EQ job and metrics;
4. long form — ``streaming.render_streaming`` of 10 minutes mono → 5.1,
   exact filters, shelf EQ, metrics;
5. kernel checks — pair-packed exact gain, device PCM16 quantize, masked
   metering, the length-dynamic exact EQ (as an op and in a padded batch).

With ``--chips 4`` it runs only the sharded paths: ``render_batch`` over a
("data"=4) mesh against the same seeds on one card, and ``render_long``
over ("block"=4) against the one-card streaming render.

Every rendered result is held to the contract of BASELINE.json against the
float64 NumPy oracle fed the same counter-based seed draws.  Every phase
runs; if any fails the script exits 1 and prints no result line.  It needs
a GPU: on any other platform it exits non-zero before rendering anything.
The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Each phase is a function with its sizes as arguments, so the CPU tests run
them at tiny sizes.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import sys
import time
import traceback
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

RATE = 48000

# --- limits, each with its reason ---------------------------------------
# BASELINE.json contract: max-abs deviation of a float render from the
# float64 oracle given the same random draws.
TOL_FLOAT = 1e-3
# BASELINE.json contract: 16-bit PCM within 1 LSB of the quantized oracle.
# Holds for the exact filter mode (float deviation ~1e-6).  The fast filter
# mode's conv-grid air filter deviates up to ~2e-4 by design (≈7 LSB), so
# it is held to the float contract's LSB equivalent, ceil(1e-3·32768) = 33,
# the limit tests/test_parity.py applies to every render.
TOL_LSB_EXACT = 1
TOL_LSB_FAST = 33
# Meter on the device vs the float64 oracle meter on the same signal, the
# tolerances of tests/test_loudness_jax.py::test_audio_metrics_matches_oracle.
TOL_METER = {"lufs": 0.01, "true_peak_dbfs": 1e-3, "rms_dbfs": 1e-3}
# A served result is a PCM16 file: half an LSB of quantization on top of
# the render (tests/test_serving.py::test_result_matches_direct_render).
TOL_SERVED = 1.0 / 32768 + 2e-5
# Component checks at n ≈ 3·10⁶: two float32 transform chains of that length
# agree to a few ulps of log2(n) butterflies (~1e-6 of peak); 1e-4 keeps
# them 10× inside the whole-render contract.
TOL_COMPONENT = 1e-4


# --- helpers ---------------------------------------------------------------

def make_clips(batch: int, seconds: float, rate: int, seed: int) -> np.ndarray:
    """(batch, n) float32 mono clips: distinct tones plus seeded noise."""
    n = int(round(seconds * rate))
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    return np.stack([
        (0.3 * np.sin(2 * np.pi * (180.0 + 9.0 * i) * t)
         + 0.05 * np.sin(2 * np.pi * (1000.0 + 37.0 * i) * t)
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
        for i in range(batch)
    ])


def oracle_render(x, rate, p, seed, external_ir=None) -> np.ndarray:
    """The float64 NumPy oracle, fed the draws ``seed`` gives the device."""
    from audio_raytracing_studio_tpu.ops import ir_synth
    from audio_raytracing_studio_tpu.oracle import dsp
    from audio_raytracing_studio_tpu.params import (
        IRDraws,
        adjust_parameters_for_3d,
        compute_final_directionality_3d,
        derive_ir_geometry,
    )

    if p.use_external_ir:
        return dsp.render(x, rate, p, external_ir=external_ir)
    dur, refs, maxd, split = adjust_parameters_for_3d(p.hall_type, p.room_size, p.z_pos)
    direc = compute_final_directionality_3d(
        p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet
    )
    g = derive_ir_geometry(rate, dur, refs, maxd, p.material, direc, split, p.diffusion)
    d, st, nz = map(
        np.asarray, ir_synth.hash_draws(int(seed), ir_synth.IRShape.from_geometry(g))
    )
    draws = IRDraws(
        delays=d[: g.reflection_count],
        strengths=st[: g.reflection_count],
        noise=nz[: g.late_length],
    )
    return dsp.render(x, rate, p, draws=draws)


def _lsb(a_int16, b_int16) -> int:
    return int(np.max(np.abs(a_int16.astype(np.int32) - b_int16.astype(np.int32))))


def check_audio(name: str, ours, ref, lsb_limit: int = TOL_LSB_EXACT) -> dict:
    """Float render vs oracle: max-abs and PCM16 LSB limits."""
    from audio_raytracing_studio_tpu.oracle import dsp

    ours = np.asarray(ours, np.float32)
    if ours.shape != ref.shape:
        raise AssertionError(f"{name}: shape {ours.shape} vs oracle {ref.shape}")
    if not np.isfinite(ours).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float(np.max(np.abs(ours - ref)))
    lsb = _lsb(dsp.quantize_pcm16(ours), dsp.quantize_pcm16(ref))
    if err > TOL_FLOAT or lsb > lsb_limit:
        raise AssertionError(
            f"{name}: max-abs {err:.3e} (limit {TOL_FLOAT}), "
            f"PCM16 {lsb} LSB (limit {lsb_limit})"
        )
    return {"max_abs": err, "lsb": lsb}


def check_pcm16(name: str, q, ref, lsb_limit: int) -> dict:
    """Device-quantized int16 render vs the quantized oracle."""
    from audio_raytracing_studio_tpu.oracle import dsp

    q = np.asarray(q)
    if q.dtype != np.int16 or q.shape != ref.shape:
        raise AssertionError(f"{name}: {q.dtype}{q.shape} vs oracle {ref.shape}")
    lsb = _lsb(q, dsp.quantize_pcm16(ref))
    if lsb > lsb_limit:
        raise AssertionError(f"{name}: PCM16 {lsb} LSB (limit {lsb_limit})")
    return {"lsb": lsb}


def check_metrics(name: str, metrics: dict, signal, rate: int) -> dict:
    """Device meter vs the oracle meter of the same (len, C) signal."""
    from audio_raytracing_studio_tpu.oracle.loudness import calculate_audio_metrics

    ref = calculate_audio_metrics(np.asarray(signal, np.float64), rate)
    diffs = {k: abs(float(metrics[k]) - float(ref[k])) for k in TOL_METER}
    bad = {k: v for k, v in diffs.items() if not v <= TOL_METER[k]}
    if bad:
        raise AssertionError(f"{name}: meter off the oracle by {bad} (limits {TOL_METER})")
    return {f"d_{k}": v for k, v in diffs.items()}


def _timed(fn, repeats: int = 3):
    """First call (compile + run) and the median of ``repeats`` more."""
    t0 = time.perf_counter()
    result = fn()
    first = time.perf_counter() - t0
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    steady = statistics.median(samples) if samples else first
    return result, {
        "first_call_s": first,
        "compile_s_est": max(0.0, first - steady),
        "steady_s": steady,
        "steady_samples_s": samples,
    }


def peak_bytes_in_use(device) -> int | str:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not available"
    return int(stats["peak_bytes_in_use"])


def batched_step_memory(batch, n_in, rate, p, fast, with_metrics, pcm16,
                        in_sharding=None) -> dict:
    """``compiled.memory_analysis()`` of the batched internal render step
    (per device when ``in_sharding`` spreads the batch over a mesh)."""
    import jax
    import jax.numpy as jnp

    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.parallel import sharding

    setup = pipeline.build_internal_setup(p, rate, n_in, fast_filters=fast)

    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=in_sharding)

    def per_clip(tree):
        return jax.tree.map(lambda x: sds((batch,), jnp.asarray(x).dtype), tree)

    compiled = sharding._batched_internal.lower(
        sds((batch, 2, n_in), jnp.float32), sds((batch,), jnp.int32),
        per_clip(setup.ir_scalars), per_clip(setup.mix_scalars),
        ir_shape=setup.ir_shape, spec=setup.spec,
        with_metrics=with_metrics, pcm16=pcm16,
    ).compile()
    ma = compiled.memory_analysis()
    if ma is None:
        return {"memory_analysis": "not available"}
    return {
        k: int(getattr(ma, k))
        for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes",
        )
        if hasattr(ma, k)
    }


# --- phases ----------------------------------------------------------------

def phase_device(devices, card: str) -> dict:
    from audio_raytracing_studio_tpu.utils.profiling import compilation_cache_dir

    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
        "card": card,
        "compile_cache": compilation_cache_dir(),
    }


def phase_farm(batch: int = 48, seconds: float = 60.0, rate: int = RATE,
               seed: int = 0, repeats: int = 3) -> dict:
    """Render farm: B mono clips → Stereo (Room hall) in both filter modes."""
    import jax

    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams

    p = RenderParams(target_layout="Stereo")
    clips = make_clips(batch, seconds, rate, seed)
    seeds = [1000 + seed + i for i in range(batch)]
    check = sorted({0, batch - 1})
    refs = {i: oracle_render(clips[i], rate, p, seeds[i]) for i in check}
    findings: dict = {"batch": batch, "seconds": seconds, "rate": rate}
    for fast in (True, False):
        mode = "fast" if fast else "exact"
        lsb_limit = TOL_LSB_FAST if fast else TOL_LSB_EXACT

        def served():
            return sharding.render_batch(
                clips, rate, p, seeds=seeds, with_metrics=True,
                pcm16_output=True, fast_filters=fast,
            )

        (q, metrics_q), timing = _timed(served, repeats)
        out, metrics = sharding.render_batch(
            clips, rate, p, seeds=seeds, with_metrics=True, fast_filters=fast,
        )
        m = {"timing": timing,
             "audio_s_per_s": batch * seconds / timing["steady_s"]}
        for i in check:
            m[f"clip{i}"] = {
                **check_audio(f"farm {mode} clip {i}", out[i], refs[i], lsb_limit),
                **check_pcm16(f"farm {mode} pcm16 clip {i}", q[i], refs[i], lsb_limit),
                **check_metrics(f"farm {mode} clip {i}", metrics[i], out[i], rate),
            }
            if metrics_q[i] != metrics[i]:
                raise AssertionError(f"farm {mode}: pcm16 run metered differently")
        m["memory_analysis"] = batched_step_memory(
            batch, clips.shape[1], rate, p, fast, True, True
        )
        findings[mode] = m
    findings["peak_bytes_in_use"] = peak_bytes_in_use(jax.devices()[0])
    return findings


def synthetic_stereo_ir(seconds: float, rate: int, seed: int) -> np.ndarray:
    """(L, 2) decaying-noise stereo IR with a direct-path spike."""
    n = max(2, int(seconds * rate))
    rng = np.random.default_rng(seed)
    env = np.exp(-np.arange(n) / (0.25 * rate))[:, None]
    ir = (rng.standard_normal((n, 2)) * env * 0.3).astype(np.float32)
    ir[0] = 1.0
    return ir


def phase_external_multichannel(batch: int = 8, seconds: float = 60.0,
                                rate: int = RATE, seed: int = 0) -> dict:
    """BASELINE config 2 on clips of mixed true length, and configs 4-5."""
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams

    clips = make_clips(batch, seconds, rate, seed + 1)
    n = clips.shape[1]
    findings: dict = {"batch": batch, "seconds": seconds}

    # config 2: external IR + dry/wet + dry-kill + shelf EQ, mixed lengths
    ir = synthetic_stereo_ir(1.5, rate, seed)
    p_ext = RenderParams(
        use_external_ir=True, dry_wet=0.7, dry_wet_kill_start=0.4,
        bass_gain=1.6, treble_gain=0.6, target_layout="Stereo",
    )
    rng = np.random.default_rng(seed + 2)
    true_lens = [n] + [int(n * f) for f in rng.uniform(0.5, 1.0, batch - 1)]
    padded = clips.copy()
    for i, tl in enumerate(true_lens):
        padded[i, tl:] = 0.0
    (out, metrics), timing = _timed(lambda: sharding.render_batch(
        padded, rate, p_ext, external_ir=ir, external_ir_rate=rate,
        clip_lengths=true_lens, with_metrics=True,
    ), repeats=1)
    cfg2 = {"timing": timing, "true_lens": true_lens}
    for i in sorted({0, int(np.argmin(true_lens))}):
        ref = oracle_render(clips[i, : true_lens[i]], rate, p_ext, 0, external_ir=ir)
        ours = out[i, : ref.shape[0]]
        cfg2[f"clip{i}"] = {
            **check_audio(f"config 2 clip {i}", ours, ref),
            **check_metrics(f"config 2 clip {i}", metrics[i], ours, rate),
        }
    findings["config2_external_eq"] = cfg2

    # configs 4-5: 3D-positioned source → 7.1 and 5.1.2, metered
    for layout in ("7.1 (Surround)", "5.1.2 (Atmos Light)"):
        p = RenderParams(x_pos=0.2, y_pos=0.8, z_pos=0.7, target_layout=layout)
        seeds = [2000 + seed + i for i in range(batch)]
        (out, metrics), timing = _timed(lambda: sharding.render_batch(
            clips, rate, p, seeds=seeds, with_metrics=True,
        ), repeats=1)
        ref = oracle_render(clips[0], rate, p, seeds[0])
        findings[layout] = {
            "timing": timing,
            "channels": int(out.shape[2]),
            **check_audio(f"{layout} clip 0", out[0], ref),
            **check_metrics(f"{layout} clip 0", metrics[0], out[0], rate),
        }
    return findings


# the service's job mix: (upload format, result format, metrics, EQ, external
# IR).  Consecutive pairs share a compiled batch signature.
SERVICE_JOBS = (
    ("wav", "wav", True, False, False),
    ("flac", "wav", True, False, False),
    ("wav", "wav", False, True, False),
    ("flac", "flac", False, False, False),
    ("wav", "wav", True, False, False),
    ("flac", "flac", True, False, False),
    ("wav", "wav", True, True, True),
    ("flac", "wav", True, True, True),
)
SERVICE_SECONDS = (10.2, 10.4, 30.1, 30.3, 59.6, 59.8, 20.1, 20.4)


def _http(port: int, path: str, body: bytes | None = None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, headers=headers or {}
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _encode(audio: np.ndarray, rate: int, fmt: str) -> bytes:
    from audio_raytracing_studio_tpu.utils import flacio, wavio

    buf = io.BytesIO()
    if fmt == "flac":
        flacio.write(buf, audio, rate)
    else:
        wavio.write(buf, audio, rate, subtype="PCM_16")
    return buf.getvalue()


def _decode(raw: bytes) -> np.ndarray:
    from audio_raytracing_studio_tpu.utils import flacio, wavio

    reader = flacio.read if raw[:4] == b"fLaC" else wavio.read
    audio, _rate = reader(io.BytesIO(raw))
    return audio


def phase_service(seconds=SERVICE_SECONDS, rate: int = RATE, seed: int = 0,
                  max_wait_ms: float = 2000.0, oracle_job: int = 4) -> dict:
    """The HTTP JSON API in-process: 8 jobs of mixed length and format.

    Each served file is held to ``render_batch`` of the same group (same
    seeds, same padding — the executable the service ran), and one job to
    the oracle."""
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams
    from audio_raytracing_studio_tpu.serving.batcher import RenderService, memory_stats
    from audio_raytracing_studio_tpu.serving.service import RenderHTTPService

    assert len(seconds) == len(SERVICE_JOBS)
    rss_before = memory_stats().get("rss_mb", "not available")
    svc = RenderService(max_batch=8, max_wait_ms=max_wait_ms)
    http = RenderHTTPService(svc, host="127.0.0.1", port=0).start()
    try:
        ir = synthetic_stereo_ir(1.0, rate, seed + 3)
        ir_path = json.loads(_http(http.port, "/v1/upload", _encode(ir, rate, "wav"),
                                   {"X-Filename": "ir.wav"}))["path"]
        ir_decoded = _decode(_encode(ir, rate, "wav"))
        jobs = []
        for i, (sec, (fin, fout, metered, eq, ext)) in enumerate(
            zip(seconds, SERVICE_JOBS)
        ):
            clip = make_clips(1, sec, rate, seed + 10 + i)[0]
            raw = _encode(clip, rate, fin)
            path = json.loads(_http(http.port, "/v1/upload", raw,
                                    {"X-Filename": f"job{i}.{fin}"}))["path"]
            p = RenderParams(
                target_layout="Stereo", room_size=80.0,
                bass_gain=1.6 if eq else 1.0, treble_gain=0.7 if eq else 1.0,
                use_external_ir=ext, dry_wet=0.6 if ext else 0.5,
            )
            payload = {"input": path, "params": p.to_preset_dict(),
                       "seed": 300 + i, "metrics": metered, "format": fout}
            if ext:
                payload["external_ir"] = ir_path
            jobs.append({"p": p, "payload": payload, "decoded": _decode(raw)[:, 0]})
        for job in jobs:  # post back to back so pairs share a batch
            job["t0"] = time.perf_counter()
            job["id"] = json.loads(_http(
                http.port, "/v1/jobs", json.dumps(job["payload"]).encode()
            ))["job_id"]
        deadline = time.monotonic() + 900
        pending = list(jobs)
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(pending)} jobs still queued")
            for job in list(pending):
                status = json.loads(_http(http.port, f"/v1/jobs/{job['id']}"))
                if status["status"] != "queued":
                    job["latency_s"] = time.perf_counter() - job["t0"]
                    job["status"] = status
                    pending.remove(job)
            time.sleep(0.05)
        for job in jobs:
            if job["status"]["status"] != "done":
                raise AssertionError(f"job failed: {job['status']}")
            job["served"] = _decode(_http(http.port, f"/v1/jobs/{job['id']}/result"))
        stats = json.loads(_http(http.port, "/v1/stats"))
    finally:
        http.stop()

    report: dict = {"batch_sizes": stats["batch_sizes"], "jobs": []}
    for a in range(0, len(jobs), 2):  # reference: each pair as one render_batch
        pair = jobs[a: a + 2]
        n_bucket = sharding.bucket_length(max(len(j["decoded"]) for j in pair), rate)
        padded = np.zeros((len(pair), n_bucket), np.float32)
        for k, j in enumerate(pair):
            padded[k, : len(j["decoded"])] = j["decoded"]
        metered = pair[0]["payload"]["metrics"]
        ext = pair[0]["p"].use_external_ir
        ref = sharding.render_batch(
            padded, rate, [j["p"] for j in pair],
            seeds=[j["payload"]["seed"] for j in pair], with_metrics=metered,
            clip_lengths=[len(j["decoded"]) for j in pair],
            external_ir=ir_decoded if ext else None,
            external_ir_rate=rate if ext else None,
        )
        ref_audio, ref_metrics = ref if metered else (ref, [None] * len(pair))
        ir_len = ref_audio.shape[1] - n_bucket + 1
        for k, j in enumerate(pair):
            want = np.clip(ref_audio[k, : len(j["decoded"]) + ir_len - 1],
                           -0.9999, 0.9999)
            got = j["served"]
            if got.shape != want.shape:
                raise AssertionError(f"job {a + k}: served {got.shape} vs {want.shape}")
            err = float(np.max(np.abs(got - want)))
            if err > TOL_SERVED:
                raise AssertionError(f"job {a + k}: served vs render_batch {err:.3e}")
            entry = {"seconds": len(j["decoded"]) / rate,
                     "format": j["payload"]["format"],
                     "latency_s": j["latency_s"], "vs_render_batch": err}
            if metered:
                served_m = j["status"]["metrics"]
                dm = max(abs(served_m[m] - ref_metrics[k][m]) for m in TOL_METER)
                if dm > 1e-4:
                    raise AssertionError(f"job {a + k}: metrics differ by {dm}")
                entry["d_metrics_vs_render_batch"] = dm
            report["jobs"].append(entry)

    j = jobs[oracle_job]
    ref = oracle_render(j["decoded"], rate, j["p"], j["payload"]["seed"])
    served_q = np.rint(j["served"] * 32768.0).astype(np.int16)
    report["oracle_job"] = {
        "job": oracle_job,
        **check_pcm16("service vs oracle", served_q, ref, TOL_LSB_EXACT),
        "max_abs": float(np.max(np.abs(j["served"] - ref))),
    }
    if report["oracle_job"]["max_abs"] > TOL_FLOAT + 0.5 / 32768:
        raise AssertionError(f"service vs oracle: {report['oracle_job']}")
    report["rss_mb_before"] = rss_before
    report["rss_mb_after"] = memory_stats().get("rss_mb", "not available")
    return report


def phase_long_form(minutes: float = 10.0, rate: int = RATE, seed: int = 0,
                    chunk_seconds: float = 30.0) -> dict:
    """Streaming render of a long mono clip → 5.1, exact filters, EQ."""
    from audio_raytracing_studio_tpu.parallel import streaming
    from audio_raytracing_studio_tpu.params import RenderParams

    p = RenderParams(
        target_layout="5.1 (Standard)", x_pos=0.3, y_pos=0.7, z_pos=0.4,
        bass_gain=1.6, treble_gain=0.7,
    )
    clip = make_clips(1, minutes * 60.0, rate, seed + 4)[0]
    s = 4000 + seed
    t0 = time.perf_counter()
    out, metrics = streaming.render_streaming(
        clip, rate, p, seed=s, chunk_seconds=chunk_seconds,
        with_metrics=True, fast_filters=False,
    )
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = oracle_render(clip, rate, p, s)
    oracle_s = time.perf_counter() - t0
    return {
        "minutes": minutes,
        "render_s_incl_compile": render_s,
        "oracle_host_s": oracle_s,
        "compared_with": "oracle",
        **check_audio("long form", out, ref),
        **check_metrics("long form", metrics, out, rate),
    }


def phase_kernel_checks(seconds: float = 60.0, rate: int = RATE,
                        seed: int = 0) -> dict:
    """Component checks at render widths: pair-packed gain, device PCM16,
    masked metering, length-dynamic exact EQ (op and padded batch)."""
    import jax
    import jax.numpy as jnp

    from audio_raytracing_studio_tpu import config
    from audio_raytracing_studio_tpu.metering import kweighting as kw
    from audio_raytracing_studio_tpu.metering import loudness as jl
    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.ops import fftops, filters
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams
    from audio_raytracing_studio_tpu.utils import wavio

    rng = np.random.default_rng(seed + 5)
    n = int(seconds * rate) + 71999  # a render's output length: odd, not pow2
    out: dict = {"n": n}

    # pair-packed exact circular gain vs the unpacked reference form
    x = (rng.standard_normal((2, n)) * 0.4).astype(np.float32)
    g = (0.3 + rng.random(n // 2 + 1)).astype(np.float32)
    y = np.asarray(jax.jit(fftops.apply_circular_gain)(jnp.asarray(x), jnp.asarray(g)))
    unpacked = jax.jit(lambda xx, gg: fftops.irfft_exact(fftops.rfft_exact(xx, n) * gg, n))
    err = float(np.abs(y - np.asarray(unpacked(jnp.asarray(x), jnp.asarray(g)))).max())
    if err > TOL_COMPONENT:
        raise AssertionError(f"pair-packed gain off by {err:.3e}")
    out["pair_packed_gain_max_abs"] = err

    # device PCM16 quantization + int16 readback == the host contract
    xq = (rng.standard_normal((8, n)) * 0.7).astype(np.float32)
    xq[0, :3] = [1.5, -1.5, 0.99995]  # saturation and the clip edge
    got = np.asarray(jax.jit(pipeline.quantize_pcm16)(jnp.asarray(xq)))
    want = wavio.encode_pcm16(np.clip(xq, -config.OUTPUT_CLIP, config.OUTPUT_CLIP))
    mismatches = int((got != want).sum())
    if got.dtype != np.int16 or mismatches:
        raise AssertionError(f"device pcm16: {got.dtype}, {mismatches} mismatches")
    out["pcm16_mismatches"] = mismatches

    # masked metering of a zero-padded buffer == metering the trimmed signal
    valid = int(n * 0.83)
    sig = (0.4 * np.sin(2 * np.pi * 330 * np.arange(valid) / rate)
           + 0.05 * rng.standard_normal(valid)).astype(np.float32)[None, :]
    padded = np.concatenate([sig, np.zeros((1, n - valid), np.float32)], axis=1)
    masked = jax.jit(lambda d, vl, vb: jl.audio_metrics_masked(d, rate, vl, vb))(
        jnp.asarray(padded), jnp.int32(valid), jnp.int32(kw.block_count(valid, rate))
    )
    trimmed = jl.audio_metrics(jnp.asarray(sig), rate)
    d_meter = {k: abs(float(masked[k]) - float(trimmed[k])) for k in TOL_METER}
    if any(v > 1e-3 for v in d_meter.values()):  # same signal: 1e-3 dB
        raise AssertionError(f"masked vs trimmed meter: {d_meter}")
    out["masked_meter_d"] = d_meter

    # length-dynamic exact EQ: traced-n0 op vs the static EQ at n0
    n0 = int(n * 0.87) + 1
    xe = (0.4 * rng.standard_normal((2, n))).astype(np.float32)
    xe[:, n0:] = 0.0
    got_dyn = np.asarray(jax.jit(filters.apply_shelf_eq_dynamic)(
        jnp.asarray(xe), jnp.float32(1.7), jnp.float32(0.4),
        filters.eq_dyn_host(n0, rate),
    ))
    ref_static = np.asarray(jax.jit(
        lambda s, b, t: filters.apply_shelf_eq(s, rate, b, t)
    )(jnp.asarray(xe[:, :n0]), jnp.float32(1.7), jnp.float32(0.4)))
    err_op = float(np.abs(got_dyn[:, :n0] - ref_static).max())
    tail = float(np.abs(got_dyn[:, n0:]).max())
    if err_op > TOL_COMPONENT or tail != 0.0:
        raise AssertionError(f"dynamic EQ op: {err_op:.3e} vs static, tail {tail}")
    out["dynamic_eq_op_max_abs"] = err_op

    # ... and in a padded batch, against the unpadded solo render
    n_bucket = sharding.bucket_length(int(seconds * rate), rate)
    n_clip = int(n_bucket * 0.84) + 7
    clip = make_clips(1, n_clip / rate, rate, seed + 6)[0][:n_clip]
    padded_e = np.zeros((1, n_bucket), np.float32)
    padded_e[0, :n_clip] = clip
    p_eq = RenderParams(target_layout="Stereo", bass_gain=1.7, treble_gain=0.5)
    out_b = sharding.render_batch(padded_e, rate, [p_eq], seeds=[11],
                                  clip_lengths=[n_clip])[0]
    solo = np.asarray(pipeline.render(clip, rate, p_eq, seed=11))
    err_b = float(np.abs(out_b[: solo.shape[0]] - solo).max())
    if err_b > TOL_COMPONENT:
        raise AssertionError(f"dynamic EQ padded batch vs solo: {err_b:.3e}")
    out["dynamic_eq_batch_max_abs"] = err_b
    return out


def phase_four_chips(devices, batch: int = 48, seconds: float = 60.0,
                     long_minutes: float = 10.0, rate: int = RATE,
                     seed: int = 0) -> dict:
    """The sharded paths over four devices, each against one device."""
    import jax

    from audio_raytracing_studio_tpu.parallel import long_render, streaming
    from audio_raytracing_studio_tpu.parallel import mesh as meshlib
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams

    devices = list(devices)[:4]
    if len(devices) != 4:
        raise AssertionError(f"needs 4 devices, got {len(devices)}")
    out: dict = {"devices": len(devices)}

    # data parallel: the batch over ("data"=4) vs the same seeds on one card
    p = RenderParams(target_layout="Stereo")
    clips = make_clips(batch, seconds, rate, seed)
    seeds = [1000 + seed + i for i in range(batch)]
    data_mesh = meshlib.make_mesh(data=4, block=1, devices=devices)
    (sharded, m_sh), timing = _timed(lambda: sharding.render_batch(
        clips, rate, p, seeds=seeds, device_mesh=data_mesh, with_metrics=True,
    ), repeats=2)
    with jax.default_device(devices[0]):
        single, m_one = sharding.render_batch(clips, rate, p, seeds=seeds,
                                              with_metrics=True)
    err = float(np.max(np.abs(sharded - single)))
    dm = max(abs(a[k] - b[k]) for a, b in zip(m_sh, m_one) for k in TOL_METER)
    if err > TOL_FLOAT or dm > TOL_METER["lufs"]:
        raise AssertionError(f"data=4 vs one card: {err:.3e}, metrics {dm}")
    out["data4"] = {
        "timing": timing,
        "audio_s_per_s": batch * seconds / timing["steady_s"],
        "max_abs_vs_one_card": err,
        "d_metrics_vs_one_card": dm,
        **check_audio("data=4 clip 0", sharded[0], oracle_render(clips[0], rate, p, seeds[0]),
                      TOL_LSB_EXACT),
        "memory_analysis_per_device": batched_step_memory(
            batch, clips.shape[1], rate, p, False, True, False,
            in_sharding=meshlib.batch_sharding(data_mesh),
        ),
    }

    # sequence parallel: one long 7.1 clip over ("block"=4), shelf EQ on
    # (the distributed exact DFT), vs the one-card streaming render
    p_long = RenderParams(target_layout="7.1 (Surround)", z_pos=0.7,
                          bass_gain=1.5, treble_gain=0.7)
    clip = make_clips(1, long_minutes * 60.0, rate, seed + 7)[0]
    block_mesh = meshlib.make_mesh(data=1, block=4, devices=devices)
    t0 = time.perf_counter()
    long_out, long_m = long_render.render_long(
        clip, rate, p_long, block_mesh, seed=5, with_metrics=True
    )
    long_s = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        ref, ref_m = streaming.render_streaming(
            clip, rate, p_long, seed=5, with_metrics=True
        )
    if long_out.shape != ref.shape:
        raise AssertionError(f"render_long {long_out.shape} vs streaming {ref.shape}")
    err = float(np.max(np.abs(long_out - ref)))
    dm = {k: abs(long_m[k] - ref_m[k]) for k in TOL_METER}
    if err > TOL_FLOAT or any(dm[k] > TOL_METER[k] for k in TOL_METER):
        raise AssertionError(f"block=4 vs streaming: {err:.3e}, metrics {dm}")
    out["block4"] = {
        "minutes": long_minutes,
        "render_s_incl_compile": long_s,
        "compared_with": "one-card render_streaming",
        "max_abs": err,
        "d_metrics": dm,
    }
    out["peak_bytes_in_use"] = [peak_bytes_in_use(d) for d in devices]
    return out


# --- driver ----------------------------------------------------------------

def check_device(devices, chips: int = 1) -> None:
    """The GPU gate: no other platform, and enough cards for the run."""
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}; "
            "no CPU fallback"
        )
    if len(devices) < chips:
        raise SystemExit(f"chip_smoke: --chips {chips} but {len(devices)} GPUs")


def final_line(devices) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def run_phases(phases) -> list:
    """Run every phase, print one JSON line each; return the failed names."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            findings = fn()
            line = {"phase": name, "ok": True, **findings}
        except Exception as e:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            failed.append(name)
            line = {"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"}
        line["phase_s"] = time.perf_counter() - t0
        print(json.dumps(line, default=str), flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: only the sharded paths, over four GPUs")
    ap.add_argument("--seed", type=int, default=0, help="data seed")
    args = ap.parse_args(argv)

    import jax

    from audio_raytracing_studio_tpu.utils.runtime import ensure_backend, gpu_card_info

    ensure_backend()
    devices = jax.devices()
    check_device(devices, args.chips)
    card = gpu_card_info()
    print(json.dumps({"phase": "device", "ok": True,
                      **phase_device(devices, card)}), flush=True)
    s = args.seed
    if args.chips == 4:
        phases = [("four_chips", lambda: phase_four_chips(devices, seed=s))]
    else:
        phases = [
            ("farm", lambda: phase_farm(seed=s)),
            ("external_multichannel", lambda: phase_external_multichannel(seed=s)),
            ("service", lambda: phase_service(seed=s)),
            ("long_form", lambda: phase_long_form(seed=s)),
            ("kernel_checks", lambda: phase_kernel_checks(seed=s)),
        ]
    failed = run_phases(phases)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(final_line(devices))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
