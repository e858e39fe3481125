"""Zero-dependency HTTP JSON job API over the micro-batching render service.

The studio server (app/server.py) is the interactive single-user surface;
this is the production one: clients POST render jobs and the service
batches concurrent jobs into single SPMD device programs
(serving.batcher.RenderService).  stdlib ``http.server`` only — same
zero-dependency posture as the studio server.

Endpoints
---------
POST /v1/upload        raw audio bytes + X-Filename header → {"path": …}
POST /v1/jobs          {"input": <uploaded path>, "params": {16 preset keys}?,
                        "preset": "<name>_v4.json"?, "seed": int?,
                        "metrics": bool?, "external_ir": <uploaded path>?}
                        → {"job_id": …} — "preset" loads a saved studio
                        preset (v4 JSON) as the base; "params" keys
                        override it
GET  /v1/presets       {"presets": [...]} — the studio's preset files
GET  /v1/jobs/<id>     {"status": "queued"|"done"|"error"|"cancelled",
                        "metrics"?: …, "metrics_string"?: …, "error"?: …}
GET  /v1/jobs/<id>/result    the rendered audio (WAV PCM_16; .flac/.ogg by
                             "format" in the job request)
DELETE /v1/jobs/<id>   cancel a queued job (races the batcher: a job the
                       worker already picked up completes normally)
GET  /v1/stats         batcher statistics (batch sizes, jobs done/failed)

Finished jobs are retained up to ``max_jobs`` (default 256): the oldest
*completed* entries and their result files are evicted first, so a
long-running service is bounded in memory and disk whatever the client
polling discipline.

Run:  python -m audio_raytracing_studio_tpu.serving.service --port 8871
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import threading
import urllib.parse
import uuid
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler

from ..utils.httpbase import _CLIENT_GONE, QuietDisconnectHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from ..params import RenderParams
from .batcher import RenderJob, RenderService

log = logging.getLogger("ars_tpu.serving.http")

_MAX_UPLOAD = 512 * 1024 * 1024
_FORMATS = {"wav": ".wav", "flac": ".flac", "ogg": ".ogg"}


class _JobEntry:
    def __init__(self, future: "Future", fmt: str):
        self.future = future
        self.fmt = fmt
        self.result_path: Optional[str] = None
        self.lock = threading.Lock()


class RenderHTTPService:
    """HTTP front end over a ``RenderService``."""

    def __init__(
        self,
        service: Optional[RenderService] = None,
        host: str = "0.0.0.0",
        port: int = 0,
        max_jobs: int = 256,
        max_uploads: int = 64,
        preset_dir: str = ".",
    ):
        from ..utils.presets import PresetStore
        from ..utils.uploads import UploadStore

        if max_jobs < 1:
            raise ValueError(f"max_jobs must be >= 1 (got {max_jobs})")
        self.service = service or RenderService()
        self.max_jobs = int(max_jobs)
        # uploads are decoded into the job at POST /v1/jobs time, so
        # evicting old upload FILES never breaks a queued render — the cap
        # only bounds how long an upload stays referencable for new jobs
        self._uploads = UploadStore(
            prefix="ars_serving_uploads_", max_files=max_uploads
        )
        self._result_dir = tempfile.mkdtemp(prefix="ars_serving_results_")
        self._presets = PresetStore(preset_dir)
        self._jobs: Dict[str, _JobEntry] = {}  # insertion-ordered
        self._jobs_lock = threading.Lock()
        self.httpd = QuietDisconnectHTTPServer((host, port), self._make_handler())
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ---
    def start(self) -> "RenderHTTPService":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        log.info("render service on http://%s:%d", self.host, self.port)
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
        self.service.stop()
        self._uploads.cleanup()
        import shutil

        shutil.rmtree(self._result_dir, ignore_errors=True)

    # --- job handling ---
    def save_upload(self, filename: str, body: bytes) -> str:
        # single shared definition of the sanitize/claim/allowlist logic
        # (utils.uploads — also used by the studio server)
        return self._uploads.save(filename, body)

    def _read_upload(self, path: str) -> tuple:
        """Only previously-uploaded files are readable — the same
        no-arbitrary-filesystem-reads posture as the studio server."""
        if not self._uploads.allowed(os.path.realpath(path)):
            raise PermissionError(f"input is not an uploaded file: {path!r}")
        from ..utils import wavio

        return wavio.read(path)

    def create_job(self, payload: Dict[str, Any]) -> str:
        if not isinstance(payload, dict):
            # json.loads happily returns lists/numbers/strings — every
            # .get() below assumes an object (a bare-list body was a
            # fuzz-found AttributeError 500, tools/fuzz_campaign.py http)
            raise ValueError("job payload must be a JSON object")
        input_path = payload.get("input")
        if not isinstance(input_path, str) or not input_path:
            raise ValueError("missing 'input' (uploaded file path)")
        fmt = str(payload.get("format", "wav")).lower()
        if fmt not in _FORMATS:
            raise ValueError(f"unknown format {fmt!r} (use wav/flac/ogg)")
        base: Dict[str, Any] = {}
        preset = payload.get("preset")
        if preset:
            try:
                # remember=False: a service render must not move the
                # studio's last-used pointer
                base = self._presets.load(str(preset), remember=False).to_preset_dict()
            except FileNotFoundError:
                raise ValueError(f"no such preset: {preset!r}") from None
        overrides = payload.get("params") or {}
        if not isinstance(overrides, dict):
            raise ValueError("'params' must be a JSON object")
        base.update(overrides)
        params = RenderParams.from_preset_dict(base)
        audio, rate = self._read_upload(input_path)

        external_ir = None
        external_ir_rate = None
        if params.use_external_ir:
            ir_path = payload.get("external_ir")
            if not isinstance(ir_path, str) or not ir_path:
                raise ValueError("use_external_ir requires 'external_ir' upload path")
            external_ir, external_ir_rate = self._read_upload(ir_path)

        try:
            seed = int(payload.get("seed", 0))
        except (TypeError, ValueError):
            # int() of a JSON list/object raises TypeError, which the HTTP
            # layer maps to 500 — payload-shape problems are the client's
            raise ValueError("'seed' must be an integer") from None
        job = RenderJob(
            audio=audio,
            rate=rate,
            params=params,
            seed=seed,
            with_metrics=bool(payload.get("metrics", True)),
            external_ir=external_ir,
            external_ir_rate=external_ir_rate,
        )
        future = self.service.submit(job)  # fail-fast ValueErrors surface as 400
        job_id = uuid.uuid4().hex
        with self._jobs_lock:
            self._jobs[job_id] = _JobEntry(future, fmt)
            self._evict_locked()
        return job_id

    def _evict_locked(self):
        """Bound the registry: evict oldest COMPLETED jobs (and their result
        files) past ``max_jobs``.  Pending jobs are never evicted — the
        registry can transiently exceed the cap under a flood of in-flight
        work, but completed state is strictly bounded.

        Entries whose result file is being materialized right now
        (``job_result_path`` holds ``entry.lock``) are skipped this round —
        evicting mid-write would orphan the file it is about to create."""
        if len(self._jobs) <= self.max_jobs:
            return
        excess = len(self._jobs) - self.max_jobs
        for job_id in [k for k, e in self._jobs.items() if e.future.done()]:
            if excess <= 0:
                break
            entry = self._jobs[job_id]
            if not entry.lock.acquire(blocking=False):
                continue
            try:
                del self._jobs[job_id]
                excess -= 1
                if entry.result_path:
                    try:
                        os.unlink(entry.result_path)
                    except OSError:
                        pass
            finally:
                entry.lock.release()

    def cancel_job(self, job_id: str) -> Dict[str, Any]:
        entry = self._entry(job_id)
        cancelled = entry.future.cancel()  # False once the batcher took it
        return {
            "job_id": job_id,
            "status": "cancelled" if cancelled else self.job_status(job_id)["status"],
            "cancelled": cancelled,
        }

    def job_status(self, job_id: str) -> Dict[str, Any]:
        entry = self._entry(job_id)
        fut = entry.future
        if fut.cancelled():
            return {"job_id": job_id, "status": "cancelled"}
        if not fut.done():
            return {"job_id": job_id, "status": "queued"}
        exc = fut.exception()
        if exc is not None:
            return {
                "job_id": job_id,
                "status": "error",
                "error": f"{type(exc).__name__}: {exc}",
            }
        result = fut.result()
        out: Dict[str, Any] = {
            "job_id": job_id,
            "status": "done",
            "rate": result.rate,
            "samples": int(result.audio.shape[0]),
            "channels": int(result.audio.shape[1]),
        }
        if result.metrics is not None:
            from ..analysis.metrics import metrics_string

            out["metrics"] = {k: float(v) for k, v in result.metrics.items()}
            out["metrics_string"] = metrics_string(result.metrics)
        return out

    def job_result_path(self, job_id: str) -> str:
        """Render the result to a file once (WAV PCM_16 contract, or the
        requested codec via write_audio's extension dispatch)."""
        entry = self._entry(job_id)
        result = entry.future.result(timeout=0)  # raises if pending/errored
        with entry.lock:
            if entry.result_path is None:
                from .. import config
                from ..utils import wavio

                path = os.path.join(
                    self._result_dir, f"{job_id}{_FORMATS[entry.fmt]}"
                )
                audio = result.audio
                if audio.dtype != np.int16:
                    # the product output contract (app/api.py): clip + PCM_16
                    audio = np.clip(
                        np.nan_to_num(audio), -config.OUTPUT_CLIP, config.OUTPUT_CLIP
                    )
                wavio.write_audio(path, audio, result.rate)
                entry.result_path = path
        return entry.result_path

    def _entry(self, job_id: str) -> _JobEntry:
        with self._jobs_lock:
            entry = self._jobs.get(job_id)
        if entry is None:
            raise KeyError(job_id)
        return entry

    # --- HTTP plumbing ---
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s %s", self.address_string(), fmt % args)

            def _send_json(self, obj: Any, code: int = 200):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    if length < 0:
                        # rfile.read(-1) would read until the CLIENT
                        # closes — a hostile keep-alive socket that never
                        # sends pins this handler thread forever
                        self.close_connection = True
                        self._send_json(
                            {"error": f"invalid Content-Length {length}"}, 400
                        )
                        return
                    if length > _MAX_UPLOAD:
                        # the unread body would desync this keep-alive
                        # connection — drop it instead of letting the next
                        # "request line" be parsed out of raw audio bytes
                        self.close_connection = True
                        self._send_json({"error": "body too large"}, 413)
                        return
                    body = self.rfile.read(length)
                    if parsed.path == "/v1/upload":
                        filename = urllib.parse.unquote(
                            self.headers.get("X-Filename", "upload.bin")
                        )
                        self._send_json({"path": server.save_upload(filename, body)})
                    elif parsed.path == "/v1/jobs":
                        payload = json.loads(body or b"{}")
                        job_id = server.create_job(payload)
                        self._send_json({"job_id": job_id, "status": "queued"}, 202)
                    else:
                        self._send_json({"error": "not found"}, 404)
                except PermissionError as e:
                    self._send_json({"error": str(e)}, 403)
                except RuntimeError as e:
                    # queue backpressure / stopped service → retryable 503
                    self._send_json({"error": str(e)}, 503)
                except (ValueError, json.JSONDecodeError) as e:
                    self._send_json({"error": str(e)}, 400)
                except _CLIENT_GONE:
                    # client hung up mid-response — nothing to answer on,
                    # and not a server error worth a stack trace
                    self.close_connection = True
                except Exception as e:  # noqa: BLE001
                    log.exception("request failed")
                    self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

            def do_DELETE(self):
                parsed = urllib.parse.urlparse(self.path)
                try:
                    m = re.fullmatch(r"/v1/jobs/([0-9a-f]{32})", parsed.path)
                    if m:
                        self._send_json(server.cancel_job(m.group(1)))
                        return
                    self._send_json({"error": "not found"}, 404)
                except KeyError:
                    self._send_json({"error": "no such job"}, 404)
                except _CLIENT_GONE:
                    # client hung up mid-response — nothing to answer on,
                    # and not a server error worth a stack trace
                    self.close_connection = True
                except Exception as e:  # noqa: BLE001
                    log.exception("request failed")
                    self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                try:
                    m = re.fullmatch(r"/v1/jobs/([0-9a-f]{32})", parsed.path)
                    if m:
                        self._send_json(server.job_status(m.group(1)))
                        return
                    m = re.fullmatch(r"/v1/jobs/([0-9a-f]{32})/result", parsed.path)
                    if m:
                        entry = server._entry(m.group(1))
                        if entry.future.cancelled():
                            self._send_json({"error": "job was cancelled"}, 410)
                            return
                        if not entry.future.done():
                            self._send_json({"error": "job still queued"}, 409)
                            return
                        if entry.future.exception() is not None:
                            self._send_json(
                                {"error": str(entry.future.exception())}, 410
                            )
                            return
                        path = server.job_result_path(m.group(1))
                        try:
                            fh = open(path, "rb")
                        except FileNotFoundError:
                            # evicted between path resolution and open
                            self._send_json({"error": "result evicted"}, 410)
                            return
                        with fh:
                            size = os.fstat(fh.fileno()).st_size
                            self.send_response(200)
                            self.send_header(
                                "Content-Type",
                                {
                                    ".wav": "audio/wav",
                                    ".flac": "audio/flac",
                                    ".ogg": "audio/ogg",
                                }[os.path.splitext(path)[1]],
                            )
                            self.send_header("Content-Length", str(size))
                            self.end_headers()
                            import shutil

                            shutil.copyfileobj(fh, self.wfile, length=1 << 20)
                        return
                    if parsed.path == "/v1/presets":
                        self._send_json(
                            {"presets": server._presets.list_presets()}
                        )
                        return
                    if parsed.path == "/v1/stats":
                        stats = server.service.stats()
                        with server._jobs_lock:
                            stats["jobs_known"] = len(server._jobs)
                        self._send_json(stats)
                        return
                    self._send_json({"error": "not found"}, 404)
                except KeyError:
                    self._send_json({"error": "no such job"}, 404)
                except _CLIENT_GONE:
                    # client hung up mid-response — nothing to answer on,
                    # and not a server error worth a stack trace
                    self.close_connection = True
                except Exception as e:  # noqa: BLE001
                    log.exception("request failed")
                    self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

        return Handler


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="ars-serve", description="micro-batching render service"
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8871)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=100.0)
    ap.add_argument(
        "--fast-filters", action="store_true",
        help="conv-grid air absorption (≤2e-4 deviation, fastest path)",
    )
    ap.add_argument(
        "--streaming-threshold-s", type=float, default=600.0,
        help="clips longer than this render via the bounded-memory "
             "streaming path instead of one whole-signal batch",
    )
    ap.add_argument(
        "--chunk-seconds", type=float, default=30.0,
        help="streaming chunk size for routed long jobs",
    )
    ap.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="dispatched groups in flight at once (2 overlaps one group's "
             "result download with the next group's upload+compute; 1 = "
             "fully serial worker)",
    )
    ap.add_argument(
        "--preset-dir", default=".",
        help="directory containing the studio's presets_v4/ (for "
             '\'{"preset": "<name>_v4.json"}\' job payloads)',
    )
    args = ap.parse_args(argv)

    from ..utils.runtime import ensure_backend

    ensure_backend()
    service = RenderService(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        fast_filters=args.fast_filters,
        streaming_threshold_s=args.streaming_threshold_s,
        chunk_seconds=args.chunk_seconds,
        pipeline_depth=args.pipeline_depth,
    )
    http = RenderHTTPService(service, args.host, args.port, preset_dir=args.preset_dir)
    print(f"* Render service on http://{args.host}:{http.port}")
    try:
        http.serve_forever()
    except KeyboardInterrupt:
        http.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
