"""Offline fuzz campaigns for idle-CPU hours: parity and codec robustness.

Two modes, both designed to find bugs the bounded CI suite cannot afford
to search for:

  python tools/fuzz_campaign.py parity [N] [--start-seed S]
      N random render configurations (wider than tests/test_parity.py's
      TestFuzzParity: the full UI parameter ranges incl. degenerate corners,
      every rate the UI can see, mono/stereo inputs, external-IR cases,
      silent and near-empty clips) rendered by BOTH the jitted pipeline and
      the float64 oracle with identical injected draws.  Any max-abs
      deviation > 1e-3 (reference contract, BASELINE.json) or shape/PCM16
      mismatch is logged and the campaign exits nonzero at the end.

  python tools/fuzz_campaign.py codec [N] [--start-seed S]
      N random mutations (truncations, bit flips, splices, magic-prefixed
      garbage) of real encoded files across every supported container,
      pushed through the sniff-and-dispatch layer untrusted uploads hit
      (utils/wavio.read).  Contract: decode OR clean ValueError; any other
      exception type is a bug (the HTTP studio's error contract, app/api.py).

Findings print as one JSON line each to stderr and collect into
/tmp/fuzz_campaign_findings.jsonl so a campaign interrupted by the driver
still leaves its evidence on disk.  Progress goes to stdout every 25 cases.

Runs on the CPU backend (forced before jax initializes).  Not a pytest module on purpose: campaigns are
open-ended and would blow the suite budget — regressions that campaigns
find get minimized into tests/ with a fixed seed.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

os.chdir(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.getcwd())

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

FINDINGS_PATH = "/tmp/fuzz_campaign_findings.jsonl"


def _record(kind: str, payload: dict) -> None:
    rec = {"kind": kind, "ts": time.time(), **payload}
    line = json.dumps(rec, default=str)
    print(line, file=sys.stderr)
    with open(FINDINGS_PATH, "a") as f:
        f.write(line + "\n")


# ---------------------------------------------------------------- parity ---


def _random_params(rng: np.random.Generator):
    from audio_raytracing_studio_tpu import config
    from audio_raytracing_studio_tpu.params import RenderParams

    # full UI ranges (reference slider bounds), including the endpoints,
    # hit endpoints with elevated probability to probe clip boundaries
    def u(lo, hi, edge_p=0.15):
        r = rng.uniform()
        if r < edge_p / 2:
            return float(lo)
        if r < edge_p:
            return float(hi)
        return float(rng.uniform(lo, hi))

    return RenderParams(
        hall_type=str(rng.choice(["Plate", "Room", "Cathedral"])),
        material=str(rng.choice(list(config.MATERIAL_ABSORPTION))),
        room_size=u(10.0, 1000.0),
        diffusion=u(0.0, 1.0),
        air_absorption=u(0.0, 1.0),
        early_level=u(0.0, 2.0),
        late_level=u(0.0, 2.0),
        dry_wet=u(0.0, 1.0),
        dry_wet_kill_start=u(0.0, 1.0),
        bass_gain=u(0.1, 5.0),
        treble_gain=u(0.1, 5.0),
        x_pos=u(0.0, 1.0),
        y_pos=u(0.0, 1.0),
        z_pos=u(0.0, 1.0),
        target_layout=str(rng.choice(list(config.CHANNEL_LAYOUTS))),
    )


def _random_clip(rng: np.random.Generator, rate: int) -> np.ndarray:
    kind = rng.choice(["tone", "noise", "silence", "impulse", "loud"])
    n = int(rng.integers(max(64, rate // 16), rate))  # up to 1 s — CPU budget
    t = np.arange(n) / rate
    if kind == "tone":
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(30, rate / 2.5) * t)
    elif kind == "noise":
        x = 0.2 * rng.standard_normal(n)
    elif kind == "silence":
        x = np.zeros(n)
    elif kind == "impulse":
        x = np.zeros(n)
        x[int(rng.integers(0, n))] = rng.choice([-1.0, 1.0])
    else:  # loud — exercises the conditional peak normalizations
        x = 1.4 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * rng.standard_normal(n)
    x = x.astype(np.float32)
    if rng.uniform() < 0.4:  # stereo input path
        x = np.stack([x, np.roll(x, n // 7) * 0.8], axis=0)
    return x


def run_parity(n_cases: int, start_seed: int) -> int:
    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.oracle import dsp
    from audio_raytracing_studio_tpu.params import IRDraws

    sys.path.insert(0, "tests")
    from test_parity import geometry_for  # reuse the single-source helper

    failures = 0
    worst = 0.0
    rates = [8000, 16000, 22050, 24000, 32000, 44100, 48000]
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        rate = int(rng.choice(rates))
        p = _random_params(rng)
        x = _random_clip(rng, rate)
        external_ir = None
        if rng.uniform() < 0.2:
            import dataclasses

            p = dataclasses.replace(p, use_external_ir=True)
            ir_n = int(rng.integers(16, rate // 2))
            ir = 0.3 * rng.standard_normal((ir_n, 2)).astype(np.float32)
            ir_rate = int(rng.choice(rates))
            if ir_rate != rate:
                # resample ONCE on the pipeline's device resampler and feed
                # the result to both sides (the oracle has no resampler —
                # same convention as test_parity.test_external_ir_resampled)
                ir = np.asarray(pipeline.prepare_external_ir(ir, ir_rate, rate))
            external_ir = ir
        try:
            # fast_filters (conv-grid air absorption) shares the 1e-3
            # contract (tests/test_parity.py TestFastAir); on-device
            # metrics must match the float64 oracle meter to 0.02
            # (tests/test_loudness_jax.py bounds)
            fast = bool(rng.uniform() < 0.3)
            with_metrics = bool(rng.uniform() < 0.25)
            metrics = None
            if p.use_external_ir:
                ours = pipeline.render(
                    x, rate, p, external_ir=external_ir,
                    fast_filters=fast, return_metrics=with_metrics,
                )
                ref = dsp.render(x, rate, p, external_ir=external_ir)
            else:
                d = IRDraws.sample(np.random.default_rng(seed), geometry_for(p, rate))
                ours = pipeline.render(
                    x, rate, p, draws=d,
                    fast_filters=fast, return_metrics=with_metrics,
                )
                ref = dsp.render(x, rate, p, draws=d)
            if with_metrics:
                ours, metrics = ours
            if ours.shape != ref.shape:
                raise AssertionError(f"shape {ours.shape} vs {ref.shape}")
            err = float(np.max(np.abs(np.asarray(ours) - ref)))
            worst = max(worst, err)
            if metrics is not None:
                from audio_raytracing_studio_tpu.oracle import loudness as oracle_loud

                ref_m = oracle_loud.calculate_audio_metrics(ref, rate)
                for key, tol in (("lufs", 0.02), ("rms_dbfs", 0.02)):
                    a, b = float(metrics[key]), float(ref_m[key])
                    finite = np.isfinite(a) and np.isfinite(b)
                    if (finite and abs(a - b) > tol) or (np.isfinite(a) != np.isfinite(b)):
                        raise AssertionError(
                            f"metrics {key}: device {a} vs oracle {b}"
                        )
            q_ours = dsp.quantize_pcm16(np.asarray(ours))
            q_ref = dsp.quantize_pcm16(ref)
            lsb = int(np.max(np.abs(q_ours.astype(np.int32) - q_ref.astype(np.int32))))
            if err > 1e-3 or lsb > 33:  # 33 = ceil(1e-3 * 32768) + 1 LSB
                failures += 1
                _record(
                    "parity_violation",
                    {
                        "seed": seed,
                        "err": err,
                        "lsb": lsb,
                        "rate": rate,
                        "params": p.to_preset_dict(),
                        "clip_shape": list(np.shape(x)),
                        "external": bool(p.use_external_ir),
                        "fast_filters": fast,
                        "with_metrics": with_metrics,
                    },
                )
        except Exception as e:  # noqa: BLE001 — campaign must keep going
            failures += 1
            _record(
                "parity_crash",
                {
                    "seed": seed,
                    "rate": rate,
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:],
                    "params": p.to_preset_dict(),
                    "external": bool(p.use_external_ir),
                    "fast_filters": locals().get("fast"),
                },
            )
        if (i + 1) % 25 == 0:
            dt = time.time() - t0
            print(
                f"[parity] {i + 1}/{n_cases} cases, {failures} failures, "
                f"worst {worst:.2e}, {dt / (i + 1):.1f} s/case",
                flush=True,
            )
        if (i + 1) % 40 == 0:
            jax.clear_caches()  # random shapes — bound retained executables
    print(f"[parity] DONE: {n_cases} cases, {failures} failures, worst {worst:.2e}")
    return failures


# ----------------------------------------------------------------- codec ---


def _encode_corpus(tmpdir: str) -> list:
    """One real file per supported container (skip what this image lacks)."""
    from audio_raytracing_studio_tpu.utils import lavcio, mp3io, wavio

    rate = 8000
    t = np.arange(rate // 2, dtype=np.float32) / rate
    sig = 0.4 * np.sin(2 * np.pi * 220.0 * t)
    tone = np.stack([sig, 0.8 * sig], axis=1).astype(np.float32)
    out = []
    for fmt in ["wav", "flac", "ogg"]:
        path = os.path.join(tmpdir, f"seed.{fmt}")
        wavio.write_audio(path, tone, rate)
        out.append(path)
    if mp3io.encode_available() and mp3io.decode_available():
        path = os.path.join(tmpdir, "seed.mp3")
        wavio.write_audio(path, tone, rate)
        out.append(path)
    if lavcio.encode_available() and lavcio.decode_available():
        path = os.path.join(tmpdir, "seed.m4a")
        wavio.write_audio(path, tone, rate)
        out.append(path)
    return out


def _mutate(rng: np.random.Generator, blob: bytes) -> bytes:
    buf = bytearray(blob)
    op = rng.choice(["truncate", "bitflip", "byteset", "splice", "extend"])
    if op == "truncate" and len(buf) > 4:
        return bytes(buf[: int(rng.integers(1, len(buf)))])
    if op == "bitflip":
        for _ in range(int(rng.integers(1, 32))):
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= 1 << int(rng.integers(0, 8))
        return bytes(buf)
    if op == "byteset":
        i = int(rng.integers(0, len(buf)))
        j = min(len(buf), i + int(rng.integers(1, 64)))
        buf[i:j] = bytes([int(rng.integers(0, 256))]) * (j - i)
        return bytes(buf)
    if op == "splice" and len(buf) > 16:
        i = int(rng.integers(0, len(buf) - 8))
        j = int(rng.integers(0, len(buf) - 8))
        n = int(rng.integers(4, min(512, len(buf) - max(i, j))))
        buf[i : i + n] = buf[j : j + n]
        return bytes(buf)
    # extend: append garbage
    return bytes(buf) + rng.bytes(int(rng.integers(1, 4096)))


def run_codec(n_cases: int, start_seed: int) -> int:
    import tempfile

    from audio_raytracing_studio_tpu.utils import wavio

    failures = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmpdir:
        corpus = [(p, open(p, "rb").read()) for p in _encode_corpus(tmpdir)]
        print(f"[codec] corpus: {[os.path.basename(p) for p, _ in corpus]}")
        work = os.path.join(tmpdir, "mut.bin")
        for i in range(n_cases):
            seed = start_seed + i
            rng = np.random.default_rng(seed)
            src_path, blob = corpus[int(rng.integers(0, len(corpus)))]
            mutated = _mutate(rng, blob)
            # keep the original extension ~half the time (dispatch by sniff
            # vs by extension are different code paths)
            ext = os.path.splitext(src_path)[1] if rng.uniform() < 0.5 else ".bin"
            path = work + ext
            with open(path, "wb") as f:
                f.write(mutated)
            try:
                data, rate = wavio.read(path)
                assert np.all(np.isfinite(data)), "non-finite samples returned"
                assert 0 < rate < 10_000_000, f"absurd rate {rate}"
            except ValueError:
                pass  # clean rejection — the contract
            except AssertionError as e:
                failures += 1
                _record(
                    "codec_bad_output",
                    {"seed": seed, "src": os.path.basename(src_path), "error": str(e)},
                )
            except Exception as e:  # noqa: BLE001
                failures += 1
                _record(
                    "codec_bad_exception",
                    {
                        "seed": seed,
                        "src": os.path.basename(src_path),
                        "ext": ext,
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    },
                )
            finally:
                if os.path.exists(path):
                    os.unlink(path)
            if (i + 1) % 200 == 0:
                dt = time.time() - t0
                print(
                    f"[codec] {i + 1}/{n_cases} cases, {failures} failures, "
                    f"{1000 * dt / (i + 1):.0f} ms/case",
                    flush=True,
                )
    print(f"[codec] DONE: {n_cases} cases, {failures} failures")
    return failures


# ---------------------------------------------------------------- encode ---


def run_encode(n_cases: int, start_seed: int) -> int:
    """write_audio across every format with hostile inputs; decode back.

    Contract: clean ValueError OR a file that decodes to the right shape
    with finite samples (bit-exact for lossless formats).  Hostile inputs:
    NaN/Inf samples, empty and 1-sample clips, >2 channels, extreme rates,
    int16 arrays, non-contiguous views.
    """
    import tempfile

    from audio_raytracing_studio_tpu.utils import lavcio, mp3io, wavio

    fmts = ["wav", "flac", "ogg"]
    if mp3io.encode_available() and mp3io.decode_available():
        fmts.append("mp3")
    if lavcio.encode_available() and lavcio.decode_available():
        fmts.append("m4a")
    lossless = {"wav", "flac"}
    failures = 0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmpdir:
        for i in range(n_cases):
            seed = start_seed + i
            rng = np.random.default_rng(seed)
            fmt = fmts[int(rng.integers(0, len(fmts)))]
            rate = int(rng.choice([1, 7, 8000, 22050, 44100, 48000, 192000, 2_822_400]))
            n = int(rng.choice([0, 1, 2, 63, 1024, int(rng.integers(1, 30000))]))
            ch = int(rng.choice([1, 2, 2, 6, 8, 16]))
            data = (0.5 * rng.standard_normal((n, ch))).astype(np.float32)
            hostile = rng.uniform()
            if hostile < 0.1 and n:
                data[rng.integers(0, n), rng.integers(0, ch)] = np.nan
            elif hostile < 0.2 and n:
                data[rng.integers(0, n), rng.integers(0, ch)] = np.inf
            elif hostile < 0.3:
                data = np.rint(data * 32767).astype(np.int16)
            elif hostile < 0.4:
                data = data[::2]  # non-contiguous view
            path = os.path.join(tmpdir, f"enc_{i}.{fmt}")
            try:
                wavio.write_audio(path, data, rate)
                back, back_rate = wavio.read(path)
                if np.issubdtype(np.asarray(data).dtype, np.floating) and not np.all(
                    np.isfinite(data)
                ):
                    pass  # NaN/Inf input: only require decode not to crash
                else:
                    assert np.all(np.isfinite(back)), "non-finite decode"
                if fmt in lossless and np.asarray(data).size:
                    assert back.shape[0] == np.asarray(data).shape[0], (
                        f"frame count {back.shape} vs {np.asarray(data).shape}"
                    )
                    assert back_rate == rate, f"rate {back_rate} vs {rate}"
            except ValueError:
                pass  # clean rejection
            except Exception as e:  # noqa: BLE001
                failures += 1
                _record(
                    "encode_bad_exception",
                    {
                        "seed": seed,
                        "fmt": fmt,
                        "rate": rate,
                        "shape": list(np.asarray(data).shape),
                        "dtype": str(np.asarray(data).dtype),
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    },
                )
            finally:
                if os.path.exists(path):
                    os.unlink(path)
            if (i + 1) % 50 == 0:
                dt = time.time() - t0
                print(
                    f"[encode] {i + 1}/{n_cases} cases, {failures} failures, "
                    f"{dt / (i + 1):.2f} s/case",
                    flush=True,
                )
    print(f"[encode] DONE: {n_cases} cases, {failures} failures")
    return failures


# ------------------------------------------------------------- streaming ---


def run_streaming(n_cases: int, start_seed: int) -> int:
    """render_streaming vs the single-shot pipeline at random configs.

    Random chunk sizes that do NOT divide the clip, EQ on/off, every
    layout, external IR sometimes, pcm16 output sometimes.  Contract:
    ≤2e-4 max-abs vs pipeline.render (the bound test_streaming pins) and
    bit-identical PCM16 when quantizing on device.
    """
    import dataclasses

    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.oracle import dsp
    from audio_raytracing_studio_tpu.parallel import streaming

    failures = 0
    worst = 0.0
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        rate = int(rng.choice([8000, 16000, 22050]))  # CPU budget
        p = _random_params(rng)
        x = _random_clip(rng, rate)
        chunk_seconds = float(rng.uniform(0.15, 1.3))
        external_ir = None
        if rng.uniform() < 0.15:
            p = dataclasses.replace(p, use_external_ir=True)
            ir_n = int(rng.integers(16, rate // 2))
            external_ir = 0.3 * rng.standard_normal((ir_n, 2)).astype(np.float32)
        try:
            kw = dict(chunk_seconds=chunk_seconds)
            if p.use_external_ir:
                kw["external_ir"] = external_ir
            out = streaming.render_streaming(x, rate, p, seed=seed, **kw)
            single = pipeline.render(
                x, rate, p, seed=seed, external_ir=external_ir
            )
            if out.shape != single.shape:
                raise AssertionError(f"shape {out.shape} vs {single.shape}")
            err = float(np.max(np.abs(out - single)))
            worst = max(worst, err)
            if err > 2e-4:
                raise AssertionError(f"streaming deviation {err:.2e} > 2e-4")
            if rng.uniform() < 0.3:  # device-side PCM16 contract
                q_dev = streaming.render_streaming(
                    x, rate, p, seed=seed, pcm16_output=True, **kw
                )
                q_host = dsp.quantize_pcm16(out)
                if not np.array_equal(np.asarray(q_dev), q_host):
                    nbad = int(np.sum(np.asarray(q_dev) != q_host))
                    raise AssertionError(f"pcm16 mismatch on {nbad} samples")
            if rng.uniform() < 0.3 and not p.use_external_ir:
                # round-5 exact-air arm: fast_filters=False must match the
                # EXACT single-shot pipeline to float32 round-off (the
                # tests/test_streaming.py::TestExactAirStreaming bound)
                out_x = streaming.render_streaming(
                    x, rate, p, seed=seed, fast_filters=False, **kw
                )
                exact = pipeline.render(
                    x, rate, p, seed=seed, fast_filters=False
                )
                err_x = float(np.max(np.abs(out_x - exact)))
                worst = max(worst, err_x)
                if err_x > 1e-4:
                    raise AssertionError(
                        f"exact-air streaming deviation {err_x:.2e} > 1e-4"
                    )
        except AssertionError as e:
            failures += 1
            _record(
                "streaming_violation",
                {
                    "seed": seed,
                    "rate": rate,
                    "chunk_seconds": chunk_seconds,
                    "error": str(e),
                    "params": p.to_preset_dict(),
                    "clip_shape": list(np.shape(x)),
                },
            )
        except Exception as e:  # noqa: BLE001
            failures += 1
            _record(
                "streaming_crash",
                {
                    "seed": seed,
                    "rate": rate,
                    "chunk_seconds": chunk_seconds,
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:],
                    "params": p.to_preset_dict(),
                },
            )
        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            print(
                f"[streaming] {i + 1}/{n_cases} cases, {failures} failures, "
                f"worst {worst:.2e}, {dt / (i + 1):.1f} s/case",
                flush=True,
            )
        if (i + 1) % 20 == 0:
            jax.clear_caches()  # random shapes — bound retained executables
    print(f"[streaming] DONE: {n_cases} cases, {failures} failures, worst {worst:.2e}")
    return failures


MODES = {
    "parity": run_parity,
    "codec": run_codec,
    "encode": run_encode,
    "streaming": run_streaming,
}


# ------------------------------------------------------------------ http ---


def _raw_request(port: int, payload: bytes, timeout: float = 20.0) -> bytes:
    """One raw TCP exchange: send ``payload``, read until close/timeout.
    Returns whatever the server sent (b'' if it closed without a byte)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.settimeout(timeout)
        try:
            s.sendall(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # server already rejected — whatever it wrote still counts
        chunks = []
        try:
            while True:
                b = s.recv(65536)
                if not b:
                    break
                chunks.append(b)
                if len(chunks) > 64:  # don't buffer a result download
                    break
        except (socket.timeout, ConnectionResetError):
            pass
        return b"".join(chunks)


def _status_of(raw: bytes) -> int:
    """HTTP status code of the FIRST response in a raw byte exchange
    (0 = no parseable status line — the server just closed)."""
    try:
        line = raw.split(b"\r\n", 1)[0].decode("latin-1")
        parts = line.split()
        if len(parts) >= 2 and parts[0].startswith("HTTP/"):
            return int(parts[1])
    except (ValueError, IndexError):
        pass
    return 0


def _http_alive(port: int, path: str) -> bool:
    import urllib.request

    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=60
        ) as r:
            return r.status == 200
    except Exception:  # noqa: BLE001
        return False


def run_http(n_cases: int, start_seed: int) -> int:
    """Hostile HTTP traffic against BOTH product servers.

    Spins up the studio server (app/server.py over the headless runtime)
    and the serving job API (serving/service.py over a small CPU
    RenderService) on ephemeral ports, then throws malformed requests:
    non-HTTP bytes, hostile Content-Length (negative/huge/non-numeric),
    truncated bodies, traversal filenames and upload paths, deep/huge/
    wrong-typed JSON, random methods and paths, pipelined pairs.

    Contract per case: the server answers with a PARSEABLE status that is
    never 5xx (500 = an exception type the error contract missed; the
    stdlib's own 501 for unknown methods is allowed), or closes the
    connection; after every case both servers still answer a liveness GET
    within 60 s.  Any 5xx, hang, or dead server is a finding.
    """
    import tempfile

    tmpdir = tempfile.mkdtemp(prefix="ars_httpfuzz_")
    os.chdir(tmpdir)

    from audio_raytracing_studio_tpu.app import marker, studio
    from audio_raytracing_studio_tpu.app.server import StudioHTTPServer
    from audio_raytracing_studio_tpu.serving.batcher import RenderService
    from audio_raytracing_studio_tpu.serving.service import RenderHTTPService
    from audio_raytracing_studio_tpu.utils import wavio
    from audio_raytracing_studio_tpu.utils.presets import PresetStore

    marker.ensure_map_asset()
    demo = studio.build_demo(PresetStore(tmpdir))
    studio_srv = StudioHTTPServer(demo, host="127.0.0.1", port=0).start()
    api_srv = RenderHTTPService(
        RenderService(max_batch=2, max_wait_ms=20.0),
        host="127.0.0.1",
        port=0,
        preset_dir=tmpdir,
    ).start()

    # one real uploaded clip so job payloads can reference a valid path
    rng0 = np.random.default_rng(0)
    clip = (0.2 * rng0.standard_normal(1600)).astype(np.float32)
    wav_path = os.path.join(tmpdir, "seed.wav")
    wavio.write(wav_path, clip, 8000)
    wav_bytes = open(wav_path, "rb").read()
    uploaded = api_srv.save_upload("seed.wav", wav_bytes)

    def _body_json(rng) -> bytes:
        kind = rng.integers(0, 8)
        if kind == 0:
            return b"{"  # truncated JSON
        if kind == 1:
            return b"[" * 2000 + b"]" * 2000  # deep nesting → RecursionError?
        if kind == 2:
            return json.dumps({"input": uploaded, "seed": "NaN"}).encode()
        if kind == 3:
            return json.dumps(
                {"input": uploaded, "params": "not-a-dict", "seed": [1, 2]}
            ).encode()
        if kind == 4:
            return json.dumps(
                {"input": "/etc/passwd", "preset": "../../escape_v4.json"}
            ).encode()
        if kind == 5:
            return json.dumps(
                {"id": int(rng.integers(-5, 200)), "value": ["x"] * 5,
                 "event": "click", "set": {str(rng.integers(0, 99)): None}}
            ).encode()
        if kind == 6:
            return os.urandom(int(rng.integers(1, 4096)))
        return json.dumps({"input": uploaded, "format": "exe"}).encode()

    def _attack(rng) -> bytes:
        target_api = bool(rng.integers(0, 2))
        port = api_srv.port if target_api else studio_srv.port
        method = str(rng.choice(["GET", "POST", "PUT", "DELETE", "BREW", "P" * 40]))
        paths_api = ["/v1/upload", "/v1/jobs", "/v1/jobs/" + "0" * 32,
                     "/v1/jobs/../../x", "/v1/stats", "/v1/presets", "/" + "a" * 3000]
        paths_studio = ["/", "/state", "/set", "/event", "/upload",
                        "/file?path=/etc/passwd", "/file?path=..%2F..%2Fetc%2Fpasswd",
                        "/%00", "/" + "b" * 3000]
        path = str(rng.choice(paths_api if target_api else paths_studio))
        body = _body_json(rng)
        mode = rng.integers(0, 7)
        if mode == 0:  # not HTTP at all
            return port, os.urandom(int(rng.integers(1, 512)))
        if mode == 1:  # hostile Content-Length
            cl = str(rng.choice(["-5", "99999999999999999999", "abc",
                                 str(513 * 1024 * 1024)]))  # just past _MAX_UPLOAD
            return port, (
                f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                f"Content-Length: {cl}\r\nConnection: close\r\n\r\n"
            ).encode() + body[:64]
        if mode == 2:  # truncated body (claims more than it sends), close
            claimed = len(body) + int(rng.integers(1, 100000))
            return port, (
                f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                f"Content-Length: {claimed}\r\nConnection: close\r\n\r\n"
            ).encode() + body
        if mode == 3:  # header flood / huge header line
            hdrs = "".join(f"X-H{i}: v\r\n" for i in range(int(rng.integers(1, 150))))
            hdrs += "X-Filename: " + "%2e%2e%2f" * 200 + "\r\n"
            return port, (
                f"{method} {path} HTTP/1.1\r\nHost: x\r\n{hdrs}"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            ).encode() + body
        if mode == 4:  # pipelined pair on one connection
            one = (
                f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                f"Content-Length: {len(body)}\r\n\r\n"
            ).encode() + body
            return port, one + b"GET /v1/stats HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        if mode == 5:  # well-formed hostile request
            return port, (
                f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                f"X-Filename: {str(rng.choice(['../../evil.wav', 'a' * 500, '%00x', 'ok.wav']))}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            ).encode() + body
        # mode 6: no Content-Length at all, but a body
        return port, (
            f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
        ).encode() + body

    failures = 0
    t0 = time.time()
    try:
        for i in range(n_cases):
            seed = start_seed + i
            rng = np.random.default_rng(seed)
            port, payload = _attack(rng)
            try:
                raw = _raw_request(port, payload)
                status = _status_of(raw)
            except Exception as e:  # noqa: BLE001
                failures += 1
                _record("http_client_error", {
                    "seed": seed, "error": f"{type(e).__name__}: {e}",
                    "payload_head": payload[:200].decode("latin-1", "replace"),
                })
                continue
            if status >= 500 and status != 501:
                failures += 1
                _record("http_5xx", {
                    "seed": seed, "status": status, "port": port,
                    "api": port == api_srv.port,
                    "payload_head": payload[:300].decode("latin-1", "replace"),
                    "response_head": raw[:300].decode("latin-1", "replace"),
                })
            if not (_http_alive(api_srv.port, "/v1/stats")
                    and _http_alive(studio_srv.port, "/state")):
                failures += 1
                _record("http_server_dead", {
                    "seed": seed,
                    "payload_head": payload[:300].decode("latin-1", "replace"),
                })
                break
            if (i + 1) % 25 == 0:
                dt = time.time() - t0
                print(
                    f"[http] {i + 1}/{n_cases} cases, {failures} failures, "
                    f"{dt / (i + 1):.2f} s/case",
                    flush=True,
                )
    finally:
        studio_srv.stop()
        api_srv.stop()
    print(f"[http] DONE: {n_cases} cases, {failures} failures")
    return failures


MODES["http"] = run_http


# ------------------------------------------------------------------ soak ---


def _rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def _open_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def run_soak(n_cases: int, start_seed: int) -> int:
    """Sustained job load against the serving API: boundedness, not speed.

    ``n_cases`` waves of concurrent jobs (mixed small signatures, result
    downloads for half, deliberate client abandonment for the rest — the
    eviction paths) through an in-process ``RenderHTTPService`` with small
    caps (max_jobs=24, max_uploads=8).  After every wave: job registry
    ≤ cap + in-flight, upload dir ≤ cap, and at the end RSS and open-fd
    growth over the middle half of the run stay under loose ceilings
    (leaks show up as monotone growth; jit warmup is excluded by measuring
    from the first quarter).
    """
    import tempfile
    import urllib.request

    tmpdir = tempfile.mkdtemp(prefix="ars_soak_")
    os.chdir(tmpdir)

    from audio_raytracing_studio_tpu.serving.batcher import RenderService
    from audio_raytracing_studio_tpu.serving.service import RenderHTTPService
    from audio_raytracing_studio_tpu.utils import wavio

    max_jobs, max_uploads = 24, 8
    srv = RenderHTTPService(
        RenderService(max_batch=4, max_wait_ms=10.0),
        host="127.0.0.1", port=0,
        max_jobs=max_jobs, max_uploads=max_uploads, preset_dir=tmpdir,
    ).start()
    base = f"http://127.0.0.1:{srv.port}"

    def _post(path, body, headers=None):
        req = urllib.request.Request(
            base + path, data=body, method="POST", headers=headers or {}
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def _get(path, raw=False):
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.read() if raw else json.loads(r.read())

    failures = 0
    rss_samples, fd_samples = [], []
    t0 = time.time()
    try:
        for i in range(n_cases):
            seed = start_seed + i
            rng = np.random.default_rng(seed)
            # fresh upload most waves (exercises upload eviction), varying
            # length buckets → a few distinct static signatures
            n = int(rng.choice([800, 800, 1600, 3200]))
            clip = (0.2 * rng.standard_normal(n)).astype(np.float32)
            p = os.path.join(tmpdir, "u.wav")
            wavio.write(p, clip, 8000)
            up = _post("/v1/upload", open(p, "rb").read(),
                       {"X-Filename": f"u{seed}.wav"})["path"]
            jobs = []
            for _ in range(int(rng.integers(2, 6))):
                jobs.append(_post("/v1/jobs", json.dumps({
                    "input": up,
                    "seed": int(rng.integers(0, 99)),
                    "metrics": bool(rng.uniform() < 0.5),
                    "format": str(rng.choice(["wav", "flac"])),
                }).encode())["job_id"])
            # poll to done; download results for half, abandon the rest
            deadline = time.time() + 300
            for j, jid in enumerate(jobs):
                while time.time() < deadline:
                    st = _get(f"/v1/jobs/{jid}")
                    if st["status"] != "queued":
                        break
                    time.sleep(0.2)
                if st["status"] != "done":
                    failures += 1
                    _record("soak_job_failed", {"seed": seed, "status": st})
                    continue
                if j % 2 == 0:
                    _get(f"/v1/jobs/{jid}/result", raw=True)
            stats = _get("/v1/stats")
            known = stats.get("jobs_known", 0)
            if known > max_jobs + 8:  # + generous in-flight slack
                failures += 1
                _record("soak_unbounded_jobs", {"seed": seed, "jobs_known": known})
            n_uploads = len(os.listdir(srv._uploads.dir)) if hasattr(
                srv._uploads, "dir") else None
            if n_uploads is not None and n_uploads > max_uploads:
                failures += 1
                _record("soak_unbounded_uploads", {"seed": seed, "files": n_uploads})
            rss_samples.append(_rss_kb())
            fd_samples.append(_open_fds())
            if (i + 1) % 10 == 0:
                dt = time.time() - t0
                print(
                    f"[soak] {i + 1}/{n_cases} waves, {failures} failures, "
                    f"RSS {rss_samples[-1] // 1024} MB, fds {fd_samples[-1]}, "
                    f"{dt / (i + 1):.1f} s/wave",
                    flush=True,
                )
    finally:
        srv.stop()
    # leak check over the steady-state region (skip jit warmup quarter)
    q = max(1, len(rss_samples) // 4)
    if len(rss_samples) >= 8:
        rss_growth = rss_samples[-1] - rss_samples[q]
        fd_growth = fd_samples[-1] - fd_samples[q]
        if rss_growth > 200_000:  # >200 MB steady-state growth
            failures += 1
            _record("soak_rss_growth", {
                "kb_growth": rss_growth, "samples": rss_samples[::q]})
        if fd_growth > 32:
            failures += 1
            _record("soak_fd_growth", {
                "fd_growth": fd_growth, "samples": fd_samples[::q]})
    print(
        f"[soak] DONE: {n_cases} waves, {failures} failures, "
        f"RSS {rss_samples[0] // 1024}→{rss_samples[-1] // 1024} MB, "
        f"fds {fd_samples[0]}→{fd_samples[-1]}"
    )
    return failures


MODES["soak"] = run_soak


# ----------------------------------------------------------------- batch ---


def run_batch(n_cases: int, start_seed: int) -> int:
    """render_batch (one SPMD program, value params sweeping per clip) vs
    per-clip pipeline.render.

    Stresses the widened batch-wide stage flags (air/eq/early/late can
    differ per clip inside one batch — zero-weight/identity-gain clips
    must keep exact solo semantics), masked metrics over true clip spans
    (clip_lengths buckets), the device PCM16 contract, and fast_filters.
    Contract: ≤2e-4 max-abs vs the solo render (tests pin 2e-5 value
    sweeps / 1e-4 flag widening), metrics ≤0.03, PCM16 bit-identical to
    host quantization of the batch floats.
    """
    import dataclasses

    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.oracle import dsp
    from audio_raytracing_studio_tpu.parallel import sharding

    failures = 0
    worst = 0.0
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        rate = int(rng.choice([8000, 16000]))
        bsz = int(rng.choice([2, 3, 4]))
        shared = _random_params(rng)  # statics come from this draw
        n = int(rng.integers(rate // 8, rate // 2))
        use_buckets = bool(rng.uniform() < 0.3)
        params = []
        for _ in range(bsz):
            v = _random_params(rng)  # value fields come from these draws
            # padded EQ-on clips run the length-DYNAMIC exact EQ (chirps
            # from the traced true length) — same ≤2e-4 contract vs solo
            params.append(dataclasses.replace(
                v,
                hall_type=shared.hall_type,
                room_size=shared.room_size,
                # z_pos and diffusion drive the IR geometry
                # (duration/smooth width), so they are shape-determining
                # like hall/room/layout
                z_pos=shared.z_pos,
                diffusion=shared.diffusion,
                target_layout=shared.target_layout,
                use_external_ir=False,
            ))
        true_lens = (
            [int(rng.integers(max(64, n // 3), n + 1)) for _ in range(bsz)]
            if use_buckets else [n] * bsz
        )
        clips = np.zeros((bsz, n), dtype=np.float32)
        for b in range(bsz):
            clips[b, : true_lens[b]] = (
                0.3 * rng.standard_normal(true_lens[b])
            ).astype(np.float32)
        seeds = [int(rng.integers(0, 1000)) for _ in range(bsz)]
        fast = bool(rng.uniform() < 0.3)
        with_metrics = bool(rng.uniform() < 0.4)
        pcm16 = bool(rng.uniform() < 0.3)
        try:
            kw = dict(seeds=seeds, fast_filters=fast, with_metrics=with_metrics)
            if use_buckets:
                kw["clip_lengths"] = true_lens
            out = sharding.render_batch(clips, rate, params, **kw)
            metrics = None
            if with_metrics:
                out, metrics = out
            out = np.asarray(out)
            if pcm16:
                kw2 = {k: v for k, v in kw.items() if k != "with_metrics"}
                q = np.asarray(sharding.render_batch(
                    clips, rate, params, pcm16_output=True, **kw2
                ))
                q_host = dsp.quantize_pcm16(out)
                if not np.array_equal(q, q_host):
                    raise AssertionError(
                        f"pcm16 mismatch on "
                        f"{int(np.sum(q != q_host))} samples"
                    )
            for b in range(bsz):
                solo = pipeline.render(
                    clips[b, : true_lens[b]], rate, params[b],
                    seed=seeds[b], fast_filters=fast,
                    return_metrics=with_metrics,
                )
                solo_m = None
                if with_metrics:
                    solo, solo_m = solo
                solo = np.asarray(solo)
                span = solo.shape[0]
                err = float(np.max(np.abs(out[b, :span] - solo)))
                worst = max(worst, err)
                if err > 2e-4:
                    raise AssertionError(f"clip {b}: batch vs solo {err:.2e}")
                if metrics is not None:
                    for key in ("lufs", "rms_dbfs"):
                        a = float(metrics[b][key])
                        c = float(solo_m[key])
                        if (np.isfinite(a) != np.isfinite(c)) or (
                            np.isfinite(a) and abs(a - c) > 0.03
                        ):
                            raise AssertionError(
                                f"clip {b} metrics {key}: batch {a} vs solo {c}"
                            )
        except AssertionError as e:
            failures += 1
            _record("batch_violation", {
                "seed": seed, "rate": rate, "batch": bsz, "error": str(e),
                "fast_filters": fast, "buckets": use_buckets,
                "shared": shared.to_preset_dict(),
            })
        except Exception as e:  # noqa: BLE001
            failures += 1
            _record("batch_crash", {
                "seed": seed, "rate": rate, "batch": bsz,
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            })
        if (i + 1) % 5 == 0:
            dt = time.time() - t0
            print(
                f"[batch] {i + 1}/{n_cases} cases, {failures} failures, "
                f"worst {worst:.2e}, {dt / (i + 1):.1f} s/case",
                flush=True,
            )
        if (i + 1) % 40 == 0:
            # every case compiles fresh random shapes; past ~150 retained
            # executables the 1-core box dies with 'LLVM compilation error:
            # Cannot allocate memory' (observed at batch case ~170)
            jax.clear_caches()
    print(f"[batch] DONE: {n_cases} cases, {failures} failures, worst {worst:.2e}")
    return failures


MODES["batch"] = run_batch


# ---------------------------------------------------------------- preset ---


def _hostile_name(rng: np.random.Generator) -> str:
    """Preset names a hostile or confused client might send."""
    pools = [
        lambda: "Mein Preset " + str(rng.integers(100)),
        lambda: rng.choice(["", " ", ".", "..", "...", "_", "-", "_v4.json"]),
        lambda: "../" * int(rng.integers(1, 4)) + "etc/passwd",
        lambda: "..\\" * int(rng.integers(1, 4)) + "windows",
        lambda: "a/b/" + str(rng.integers(10)),
        lambda: "x\x00y" + str(rng.integers(10)),
        lambda: "".join(chr(int(c)) for c in rng.integers(1, 32, size=6)),
        lambda: "名前🎵" + str(rng.integers(10)),
        lambda: "A" * int(rng.integers(200, 500)),
        lambda: str(rng.choice(["CON", "NUL", "aux", "last_preset_v4"])),
        lambda: "".join(
            chr(int(c)) for c in rng.integers(32, 0x2FF, size=int(rng.integers(1, 20)))
        ),
    ]
    return pools[int(rng.integers(len(pools)))]()


def _hostile_preset_value(rng: np.random.Generator):
    """A random JSON value for one preset key."""
    r = rng.uniform()
    if r < 0.25:
        return float(rng.uniform(-1e3, 1e3))
    if r < 0.35:
        return float(rng.choice([np.inf, -np.inf, np.nan, 1e308, -0.0, 5e-324]))
    if r < 0.5:
        return str(rng.choice(["Plate", "xxx", "1.5", "inf", "nan", "", "1e999"]))
    if r < 0.6:
        return bool(rng.integers(2))
    if r < 0.7:
        return None
    if r < 0.8:
        return [1, 2, 3]
    if r < 0.9:
        return {"a": 1}
    return int(rng.integers(-(2**40), 2**40))


def run_preset(n_cases: int, start_seed: int) -> int:
    """PresetStore CRUD + RenderParams coercion under hostile names, values
    and file contents.

    Contract per case (the studio/HTTP 400 error contract, plus filesystem
    containment):
    - every store operation either returns or raises ValueError (incl.
      JSONDecodeError/UnicodeDecodeError) / FileNotFoundError — any other
      exception type is a bug;
    - nothing outside ``<base>/presets_v4`` (plus an explicitly-directed
      zip path) is ever created, modified or deleted — traversal-shaped
      names must not escape;
    - a SUCCESSFUL save round-trips: load(filename) reproduces every field
      of the saved params exactly (NaN-aware), and the last-used pointer
      points at the new file;
    - from_preset_dict is total over arbitrary JSON values per key and
      raises ValueError on non-object payloads.
    """
    import dataclasses
    import shutil
    import tempfile

    from audio_raytracing_studio_tpu import config
    from audio_raytracing_studio_tpu.params import RenderParams
    from audio_raytracing_studio_tpu.utils.presets import PresetStore

    CLEAN = (ValueError, FileNotFoundError)  # JSONDecodeError ⊂ ValueError

    def snapshot(root: str) -> dict:
        out = {}
        for dp, _, fns in os.walk(root):
            for fn in fns:
                p = os.path.join(dp, fn)
                try:
                    out[p] = os.path.getsize(p)
                except OSError:
                    out[p] = -1
        return out

    def fields_equal(a: RenderParams, b: RenderParams) -> bool:
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, float) and isinstance(vb, float):
                if not (va == vb or (np.isnan(va) and np.isnan(vb))):
                    return False
            elif va != vb:
                return False
        return True

    failures = 0
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        case_dir = tempfile.mkdtemp(prefix="ars_presetfuzz_")
        decoy = os.path.join(case_dir, "decoy", "secret.txt")
        os.makedirs(os.path.dirname(decoy))
        with open(decoy, "w") as f:
            f.write("canary")
        base = os.path.join(case_dir, "store")
        os.makedirs(base)
        store = PresetStore(base)
        preset_dir = os.path.realpath(store.preset_dir)
        zip_target = os.path.join(case_dir, "export.zip")
        op_log = []
        try:
            for _ in range(int(rng.integers(8, 25))):
                before = snapshot(case_dir)
                op = rng.choice(
                    ["save", "load", "delete", "list", "zip", "corrupt",
                     "last", "raw_dict"]
                )
                name = _hostile_name(rng)
                op_log.append((str(op), name[:40]))
                try:
                    if op == "save":
                        p = _random_params(rng)
                        if rng.uniform() < 0.3:
                            p = dataclasses.replace(
                                p,
                                room_size=float(
                                    rng.choice([np.nan, np.inf, -np.inf, 1e308])
                                ),
                            )
                        _, filename = store.save(name, p)
                        loaded = store.load(filename)
                        if not fields_equal(p, RenderParams.from_preset_dict(
                            p.to_preset_dict()
                        )) or not fields_equal(
                            RenderParams.from_preset_dict(p.to_preset_dict()),
                            loaded,
                        ):
                            raise AssertionError(
                                f"save/load round-trip mismatch for {name!r}"
                            )
                        if store.load_last() != filename:
                            raise AssertionError("last-used pointer not updated")
                    elif op == "load":
                        existing = store.list_presets()
                        target = (
                            str(rng.choice(existing))
                            if existing and rng.uniform() < 0.5
                            else name
                        )
                        out = store.load(target)
                        if not isinstance(out, RenderParams):
                            raise AssertionError("load returned non-params")
                    elif op == "delete":
                        res = store.delete(name)
                        if not isinstance(res, bool):
                            raise AssertionError("delete returned non-bool")
                    elif op == "list":
                        store.list_presets()
                    elif op == "zip":
                        store.export_zip(zip_target)
                    elif op == "corrupt":
                        store.ensure_dir()
                        fn = os.path.join(
                            preset_dir, f"c{int(rng.integers(5))}_v4.json"
                        )
                        kind = rng.uniform()
                        if kind < 0.3:
                            body = rng.bytes(int(rng.integers(0, 200)))
                        elif kind < 0.6:
                            body = json.dumps(
                                [_hostile_preset_value(rng) for _ in range(3)]
                            ).encode()
                        else:
                            body = json.dumps({
                                k: _hostile_preset_value(rng)
                                for k in list(config.PRESET_KEYS)[
                                    : int(rng.integers(0, 17))
                                ]
                            }).encode()
                        with open(fn, "wb") as f:
                            f.write(body)
                        out = store.load(os.path.basename(fn))
                        if not isinstance(out, RenderParams):
                            raise AssertionError("load returned non-params")
                    elif op == "last":
                        store.ensure_dir()
                        with open(store.last_preset_file, "wb") as f:
                            f.write(rng.bytes(int(rng.integers(0, 40))))
                        last = store.load_last()
                        if last is not None and not isinstance(last, str):
                            raise AssertionError("load_last returned non-str")
                    else:  # raw_dict — from_preset_dict totality
                        val = _hostile_preset_value(rng)
                        if isinstance(val, dict) or rng.uniform() < 0.5:
                            RenderParams.from_preset_dict({
                                k: _hostile_preset_value(rng)
                                for k in list(config.PRESET_KEYS)
                            })
                        else:
                            try:
                                RenderParams.from_preset_dict(val)
                                raise AssertionError(
                                    f"from_preset_dict accepted {type(val)}"
                                )
                            except ValueError:
                                pass
                except CLEAN:
                    pass
                after = snapshot(case_dir)
                for path in set(before) | set(after):
                    inside = os.path.realpath(path).startswith(
                        preset_dir + os.sep
                    ) or os.path.realpath(path) == os.path.realpath(zip_target)
                    if not inside and before.get(path) != after.get(path):
                        raise AssertionError(
                            f"op {op}({name!r}) touched {path} outside the store"
                        )
                if open(decoy).read() != "canary":
                    raise AssertionError("decoy file modified")
        except AssertionError as e:
            failures += 1
            _record("preset_violation", {
                "seed": seed, "error": str(e), "ops": op_log[-5:],
            })
        except Exception as e:  # noqa: BLE001
            failures += 1
            _record("preset_bad_exception", {
                "seed": seed, "error": f"{type(e).__name__}: {e}",
                "ops": op_log[-5:],
                "trace": traceback.format_exc()[-2000:],
            })
        finally:
            shutil.rmtree(case_dir, ignore_errors=True)
        if (i + 1) % 25 == 0:
            dt = time.time() - t0
            print(
                f"[preset] {i + 1}/{n_cases} cases, {failures} failures, "
                f"{dt / (i + 1):.2f} s/case",
                flush=True,
            )
    print(f"[preset] DONE: {n_cases} cases, {failures} failures")
    return failures


MODES["preset"] = run_preset


# -------------------------------------------------------------------- ui ---


def run_ui(n_cases: int, start_seed: int) -> int:
    """Type-VALID adversarial traffic through the real studio event graph.

    Complements http mode (protocol hostility) and the typed /set vetting
    (wrong-typed values are 400s at the boundary): every value sent here is
    one the real gradio frontend could produce — member dropdown choices,
    finite in-range sliders, booleans, arbitrary unicode text, real file
    uploads, map clicks at arbitrary pixels — driven through random event
    sequences.  Any 5xx is therefore a HANDLER bug, and a dead server or
    unparseable /state is a runtime bug.  One case = one fresh studio
    server + 10-30 seeded ops (the render cache persists in-process, so
    later cases reuse compiled executables).
    """
    import io
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    from audio_raytracing_studio_tpu.app import marker, studio
    from audio_raytracing_studio_tpu.app.server import StudioHTTPServer
    from audio_raytracing_studio_tpu.utils import wavio
    from audio_raytracing_studio_tpu.utils.presets import PresetStore

    def post(port, path, payload: dict):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(payload).encode(),
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=180) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    def upload(port, name, body: bytes):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/upload",
            data=body,
            headers={"X-Filename": name},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())["path"]

    def valid_value(rng, comp):
        t = comp["type"]
        if t == "Slider":
            lo = float(comp.get("minimum", 0.0))
            hi = float(comp.get("maximum", 1.0))
            r = rng.uniform()
            if r < 0.15:
                return lo
            if r < 0.3:
                return hi
            return float(rng.uniform(lo, hi))
        if t == "Checkbox":
            return bool(rng.integers(2))
        if t == "Dropdown":
            choices = comp.get("choices") or []
            if not choices or rng.uniform() < 0.1:
                return None
            return str(rng.choice(choices))
        if t == "Number":
            return float(rng.uniform(-1e6, 1e6))
        # Textbox and friends: arbitrary unicode incl. hostile names
        return _hostile_name(rng).replace("\x00", "")[:250]

    failures = 0
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        case_dir = tempfile.mkdtemp(prefix="ars_uifuzz_")
        cwd = os.getcwd()
        os.chdir(case_dir)
        srv = None
        op_log = []
        try:
            marker.ensure_map_asset()
            if rng.uniform() < 0.3:
                # the sidecar analyzer UI runs on the same server/runtime —
                # its two-mode handlers (analyze / normalize+convert) get
                # the same type-valid adversarial traffic
                from audio_raytracing_studio_tpu.app import analyzer_ui

                demo = analyzer_ui.build_demo()
            else:
                demo = studio.build_demo(PresetStore(case_dir))
            srv = StudioHTTPServer(demo, host="127.0.0.1", port=0).start()
            # a couple of real uploads for Audio/File components
            paths = []
            for u in range(2):
                rate = int(rng.choice([8000, 16000, 44100]))
                n = int(rng.integers(200, rate // 2))
                x = (0.4 * rng.standard_normal(n)).astype(np.float32)
                if rng.uniform() < 0.4:
                    x = np.stack([x, x * 0.5], axis=1)
                buf = io.BytesIO()
                wavio.write(buf, x, rate)
                paths.append(upload(srv.port, f"clip{u}.wav", buf.getvalue()))
            renders_left = 2
            for _ in range(int(rng.integers(10, 30))):
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/state", timeout=60
                ) as r:
                    comps = json.loads(r.read())["components"]
                op = rng.choice(["set", "set", "event", "upload_set", "select"])
                if op == "set":
                    comp = comps[int(rng.integers(len(comps)))]
                    value = valid_value(rng, comp)
                    op_log.append(("set", comp["type"], str(value)[:30]))
                    code, _ = post(srv.port, "/set", {
                        "id": comp["id"], "value": value,
                        "fire_change": bool(rng.integers(2)),
                    })
                elif op == "upload_set":
                    targets = [c for c in comps if c["type"] in ("Audio", "File")]
                    if not targets:
                        continue
                    comp = targets[int(rng.integers(len(targets)))]
                    op_log.append(("upload_set", comp.get("label")))
                    code, _ = post(srv.port, "/set", {
                        "id": comp["id"],
                        "value": str(rng.choice(paths)),
                    })
                elif op == "select":
                    sel = [c for c in comps if "select" in c.get("events", ())]
                    if not sel:
                        continue
                    comp = sel[int(rng.integers(len(sel)))]
                    index = [
                        int(rng.integers(-50, 2000)),
                        int(rng.integers(-50, 2000)),
                    ]
                    op_log.append(("select", comp.get("label"), index))
                    code, _ = post(srv.port, "/event", {
                        "id": comp["id"], "event": "select", "index": index,
                    })
                else:
                    evented = [
                        (c, e) for c in comps for e in c.get("events", ())
                    ]
                    comp, event = evented[int(rng.integers(len(evented)))]
                    label = str(comp.get("label") or comp.get("value"))
                    if "Verarbeiten" in label or "Bearbeiten" in label:
                        if renders_left <= 0:
                            continue
                        renders_left -= 1
                    op_log.append(("event", label[:30], event))
                    payload = {"id": comp["id"], "event": event}
                    if event == "select":
                        payload["index"] = [
                            int(rng.integers(0, 900)),
                            int(rng.integers(0, 900)),
                        ]
                    code, _ = post(srv.port, "/event", payload)
                if code >= 500:
                    raise AssertionError(
                        f"5xx ({code}) on {op_log[-1]!r} with UI-shaped input"
                    )
            # the server must still answer with a parseable state
            with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/state", timeout=60
            ) as r:
                json.loads(r.read())
        except AssertionError as e:
            failures += 1
            _record("ui_violation", {
                "seed": seed, "error": str(e), "ops": op_log[-6:],
            })
        except Exception as e:  # noqa: BLE001
            failures += 1
            _record("ui_crash", {
                "seed": seed, "error": f"{type(e).__name__}: {e}",
                "ops": op_log[-6:],
                "trace": traceback.format_exc()[-2000:],
            })
        finally:
            if srv is not None:
                try:
                    srv.stop()
                except Exception:  # noqa: BLE001
                    pass
            os.chdir(cwd)
            shutil.rmtree(case_dir, ignore_errors=True)
        if (i + 1) % 5 == 0:
            dt = time.time() - t0
            print(
                f"[ui] {i + 1}/{n_cases} cases, {failures} failures, "
                f"{dt / (i + 1):.1f} s/case",
                flush=True,
            )
    print(f"[ui] DONE: {n_cases} cases, {failures} failures")
    return failures


MODES["ui"] = run_ui


# ------------------------------------------------------------------- cli ---


def run_cli(n_cases: int, start_seed: int) -> int:
    """Hostile argv through the three CLI entry points, in-process.

    Contract (the CLIs' documented error discipline): ``main(argv)``
    returns an int exit code or raises SystemExit — never any other
    exception — and stderr carries ``error: ...`` messages, never a
    traceback.  Inputs may be hostile (missing files, directories, raw
    bytes with audio magics, empty files); generated OUTPUT paths are
    confined to the case dir.  A fraction of cases use a valid tiny clip
    with sane flags so the deep paths (render, sweep, stream, metrics,
    binaural, json, convert, normalize) actually execute.
    """
    import contextlib
    import io
    import shutil
    import tempfile

    from audio_raytracing_studio_tpu.cli import analyzer as cli_analyzer
    from audio_raytracing_studio_tpu.cli import render as cli_render
    from audio_raytracing_studio_tpu.cli import render_dir as cli_render_dir
    from audio_raytracing_studio_tpu.utils import wavio

    HALLS = ["Plate", "Room", "Cathedral"]
    LAYOUTS = ["Stereo", "5.1 (Standard)", "7.1 (Surround)"]
    VALUE_FLAGS = [
        "--room-size", "--diffusion", "--air-absorption", "--early-level",
        "--late-level", "--dry-wet", "--kill-start", "--bass-gain",
        "--treble-gain", "--x", "--y", "--z", "--seed", "--chunk-seconds",
        "--batch", "--target", "--bitrate", "--samplerate",
    ]

    def num_str(rng) -> str:
        return str(rng.choice([
            "0.5", "1", "-3", "0", "1e9", "-1e9", "inf", "-inf", "nan",
            "abc", "", "0.0001", "99999", "--", "0x10", "1_000",
        ]))

    def make_inputs(rng, case_dir: str) -> list:
        paths = []
        ok = os.path.join(case_dir, "ok.wav")
        rate = int(rng.choice([8000, 16000]))
        n = int(rng.integers(400, rate))
        x = (0.4 * rng.standard_normal(n)).astype(np.float32)
        if rng.uniform() < 0.3:
            x = np.stack([x, 0.5 * x], axis=1)
        wavio.write(ok, x, rate)
        paths.append(ok)
        bad = os.path.join(case_dir, "bad.wav")
        with open(bad, "wb") as f:
            f.write(b"RIFF" + rng.bytes(int(rng.integers(0, 64))))
        paths.append(bad)
        empty = os.path.join(case_dir, "empty.flac")
        open(empty, "wb").close()
        paths.append(empty)
        paths.append(os.path.join(case_dir, "missing.wav"))
        paths.append(case_dir)  # a directory where a file is expected
        return paths

    def random_argv(rng, case_dir: str, inputs: list) -> tuple:
        sane = rng.uniform() < 0.35
        out = os.path.join(
            case_dir,
            str(rng.choice(["out.wav", "out.flac", "out.ogg", "out.mp3",
                            "o{i}.wav", "out.xyz", "out"])),
        )
        tool = rng.choice(["render", "render_dir", "analyzer"])
        if tool == "analyzer":
            sub = str(rng.choice(["analyze", "normalize", "convert", "bogus"]))
            argv = [sub]
            argv.append(str(rng.choice(inputs)) if not sane else inputs[0])
            if sub in ("normalize", "convert") or rng.uniform() < 0.3:
                argv.append(out)
            for _ in range(int(rng.integers(0, 3))):
                flag = str(rng.choice(["--target", "--bitrate", "--samplerate"]))
                argv += [flag, "8000" if sane and flag == "--samplerate"
                         else ("-16" if sane else num_str(rng))]
            return cli_analyzer.main, argv
        if tool == "render_dir":
            indir = os.path.join(case_dir, "in")
            os.makedirs(indir, exist_ok=True)
            if rng.uniform() < 0.7:
                shutil.copy(inputs[0], os.path.join(indir, "a.wav"))
            if rng.uniform() < 0.3:
                shutil.copy(inputs[1], os.path.join(indir, "b.wav"))
            argv = [
                str(rng.choice([indir, inputs[3], inputs[0]])) if not sane
                else indir,
                os.path.join(case_dir, "outdir"),
            ]
            fn = cli_render_dir.main
        else:
            argv = [str(rng.choice(inputs)) if not sane else inputs[0], out]
            fn = cli_render.main
            if rng.uniform() < 0.2:
                argv += ["--sweep", str(rng.choice([
                    "diffusion=0.2,0.8", "z=0.1,0.9", "bogus=1,2",
                    "diffusion=", "diffusion=a,b", "=1,2",
                ]))]
            if rng.uniform() < 0.15:
                argv += ["--stream", "--chunk-seconds",
                         "1" if sane else num_str(rng)]
            if rng.uniform() < 0.15:
                argv += ["--binaural"]
        for _ in range(int(rng.integers(0, 5))):
            r = rng.uniform()
            if r < 0.3:
                argv += ["--hall", str(rng.choice(HALLS if sane
                                                  else HALLS + ["Dome", ""]))]
            elif r < 0.5:
                argv += ["--layout", str(rng.choice(LAYOUTS))]
            elif r < 0.9:
                flag = str(rng.choice(VALUE_FLAGS[:13]))
                argv += [flag, str(rng.uniform(0, 2))[:6] if sane
                         else num_str(rng)]
            else:
                argv += [str(rng.choice(["--metrics", "--json", "--preset",
                                         "--bogus-flag"]))]
        return fn, argv

    failures = 0
    t0 = time.time()
    for i in range(n_cases):
        seed = start_seed + i
        rng = np.random.default_rng(seed)
        case_dir = tempfile.mkdtemp(prefix="ars_clifuzz_")
        inputs = make_inputs(rng, case_dir)
        fn, argv = random_argv(rng, case_dir, inputs)
        out_buf, err_buf = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out_buf), \
                    contextlib.redirect_stderr(err_buf):
                try:
                    rc = fn(argv)
                except SystemExit:
                    rc = 0  # argparse exit — clean by contract
            if not isinstance(rc, int) and rc is not None:
                raise AssertionError(f"main returned {type(rc).__name__}")
            err = err_buf.getvalue()
            if "Traceback (most recent call last)" in err:
                raise AssertionError("traceback printed to stderr")
        except AssertionError as e:
            failures += 1
            _record("cli_violation", {
                "seed": seed, "error": str(e), "argv": argv[:20],
                "stderr_tail": err_buf.getvalue()[-500:],
            })
        except Exception as e:  # noqa: BLE001
            failures += 1
            _record("cli_bad_exception", {
                "seed": seed, "error": f"{type(e).__name__}: {e}",
                "argv": argv[:20],
                "trace": traceback.format_exc()[-2000:],
            })
        finally:
            shutil.rmtree(case_dir, ignore_errors=True)
        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            print(
                f"[cli] {i + 1}/{n_cases} cases, {failures} failures, "
                f"{dt / (i + 1):.1f} s/case",
                flush=True,
            )
    print(f"[cli] DONE: {n_cases} cases, {failures} failures")
    return failures


MODES["cli"] = run_cli


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in MODES:
        print(__doc__)
        print(f"modes: {', '.join(MODES)}")
        return 2
    n = int(args[1]) if len(args) > 1 and args[1].isdigit() else 100
    start_seed = 1000
    if "--start-seed" in args:
        start_seed = int(args[args.index("--start-seed") + 1])
    failures = MODES[args[0]](n, start_seed)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
