"""Serving layer: dynamic micro-batching RenderService + HTTP job API.

The design claim under test: concurrent jobs that share an XLA static
signature dispatch as ONE ``render_batch`` SPMD program (value parameters
sweeping freely inside the batch), and every job's output is identical to
what it would have rendered alone — trimmed to its true span, metered on
the true span.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from audio_raytracing_studio_tpu.models import pipeline
from audio_raytracing_studio_tpu.params import RenderParams
from audio_raytracing_studio_tpu.parallel import sharding
from audio_raytracing_studio_tpu.serving import RenderJob, RenderService
from audio_raytracing_studio_tpu.serving.service import RenderHTTPService
from audio_raytracing_studio_tpu.utils import wavio

RATE = 16000


def make_clip(i, seconds=0.3, rate=RATE):
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)).astype(np.float32)


def padded_reference(clip, p, seed, *, external_ir=None):
    """What a bucketed job must produce: the clip rendered at its padded
    bucket length, trimmed back to the true span clip_len + ir_len − 1."""
    n_bucket = sharding.bucket_length(len(clip), RATE)
    padded = np.pad(clip, (0, n_bucket - len(clip)))
    out = pipeline.render(padded, RATE, p, seed=seed, external_ir=external_ir)
    real_len = len(clip) + (out.shape[0] - n_bucket)
    return np.asarray(out)[:real_len]


def wait_all(futures, timeout=300):
    return [f.result(timeout=timeout) for f in futures]


class TestBucketLength:
    def test_half_second_grid(self):
        assert sharding.bucket_length(1, 16000) == 8000
        assert sharding.bucket_length(8000, 16000) == 8000
        assert sharding.bucket_length(8001, 16000) == 16000
        assert sharding.bucket_length(4800, 16000) == 8000


class TestBatcher:
    def test_single_job_roundtrip(self):
        svc = RenderService(max_batch=4, max_wait_ms=20)
        try:
            clip = make_clip(0)
            p = RenderParams(target_layout="Stereo", room_size=50.0)
            res = svc.render(RenderJob(clip, RATE, p, seed=3), timeout=300)
            assert res.rate == RATE
            expect = padded_reference(clip, p, seed=3)
            assert res.audio.shape == expect.shape
            np.testing.assert_allclose(res.audio, expect, atol=2e-5)
        finally:
            svc.stop()

    def test_value_sweep_batches_into_one_dispatch(self):
        """Different material/diffusion/position/EQ/seed jobs share ONE
        compiled batch — the whole point of the serving layer.  Padded
        EQ-on jobs ride the length-DYNAMIC exact EQ (batcher.py padding
        semantics), so they coalesce with everything else AND match their
        unpadded solo renders."""
        svc = RenderService(max_batch=8, max_wait_ms=50, start=False)
        p_base = dict(target_layout="Stereo", room_size=50.0)
        jobs = [
            RenderParams(material="Stein", diffusion=0.2, **p_base),
            RenderParams(material="Teppich", diffusion=0.8, x_pos=0.9, **p_base),
            RenderParams(dry_wet=0.9, **p_base),
            RenderParams(bass_gain=1.7, treble_gain=0.6, **p_base),  # EQ on
            RenderParams(bass_gain=0.4, **p_base),                   # EQ on
        ]
        clips = [make_clip(i) for i in range(5)]
        futs = [
            svc.submit(RenderJob(c, RATE, p, seed=i))
            for i, (c, p) in enumerate(zip(clips, jobs))
        ]
        svc.start()
        results = wait_all(futs)
        assert svc.stats()["batch_sizes"] == [5]
        for i, (c, p) in enumerate(zip(clips, jobs)):
            # every job equals its UNPADDED solo render: the widened batch
            # runs the dynamic EQ at each clip's true length, and the
            # linear stages are padding-exact
            solo = np.asarray(pipeline.render(c, RATE, p, seed=i))
            np.testing.assert_allclose(results[i].audio, solo, atol=2e-5)
        svc.stop()

    def test_batch_size_buckets(self):
        """Group sizes round up to pow2-capped-at-max_batch executables:
        arrival timing must not mint fresh batch-dimension compiles (a
        48-burst warmed as 3+45 can dispatch as 4+44 and recompile
        BOTH)."""
        svc = RenderService(max_batch=48, start=False)
        try:
            for b, padded in [
                (1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 32),
                (33, 48), (44, 48), (45, 48), (48, 48),
            ]:
                assert b + svc._batch_pad(b) == padded, b
        finally:
            svc.stop()
        # a non-pow2 max_batch below the pow2 ceiling is itself the cap
        svc = RenderService(max_batch=6, start=False)
        try:
            assert [b + svc._batch_pad(b) for b in (1, 2, 3, 5, 6)] == [
                1, 2, 4, 6, 6,
            ]
        finally:
            svc.stop()

    def test_bucket_sizes_enumerates_the_executable_set(self):
        svc = RenderService(max_batch=48, start=False)
        try:
            assert svc.bucket_sizes() == [1, 2, 4, 8, 16, 32, 48]
        finally:
            svc.stop()
        svc = RenderService(max_batch=6, start=False)
        try:
            assert svc.bucket_sizes() == [1, 2, 4, 6]
        finally:
            svc.stop()

    def test_buckets_are_fixed_points_with_non_pow2_data_axis(self):
        """Every bucket must pad to ITSELF even when the mesh data axis is
        not a power of two (d=3: bucket 3 previously re-padded to 6, so
        warm() compiled executables production never dispatched)."""
        import jax

        from audio_raytracing_studio_tpu.parallel import mesh as meshlib

        if len(jax.devices()) < 3:
            pytest.skip("needs 3 devices")
        m = meshlib.make_mesh(data=3, block=1, devices=jax.devices()[:3])
        svc = RenderService(max_batch=8, device_mesh=m, start=False)
        try:
            buckets = svc.bucket_sizes()
            assert buckets == [3, 6, 9]  # pow2 {1,2,4,8} rounded up to 3k
            for b in buckets:
                assert svc._batch_pad(b) == 0, b  # fixed point
            # arbitrary sizes land on the smallest bucket >= batch
            assert [b + svc._batch_pad(b) for b in (1, 2, 3, 4, 6, 7, 8)] == [
                3, 3, 3, 6, 6, 9, 9,
            ]
        finally:
            svc.stop()

    def test_warm_precompiles_every_bucket(self, monkeypatch):
        """warm() must dispatch exactly one batch per size bucket BEFORE
        traffic (a fresh bucket discovered mid-burst costs a full compile
        at request latency), and a subsequent real job must still
        render correctly."""
        from audio_raytracing_studio_tpu.parallel import sharding

        dispatched = []
        real_render_batch = sharding.render_batch

        def spy(clips, rate, params, **kwargs):
            dispatched.append((clips.shape[0], kwargs.get("real_batch")))
            return real_render_batch(clips, rate, params, **kwargs)

        monkeypatch.setattr(
            "audio_raytracing_studio_tpu.parallel.sharding.render_batch", spy
        )
        svc = RenderService(max_batch=8, max_wait_ms=50, start=False)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        clip = make_clip(0)
        warmed = svc.warm(RenderJob(clip, RATE, p))
        assert warmed == [1, 2, 4, 8]
        # one dispatch per bucket, at exactly the bucket size (pad = 0)
        assert dispatched == [(1, 1), (2, 2), (4, 4), (8, 8)]
        # warm dispatches are not production stats
        assert svc.stats()["batch_sizes"] == []
        # a real job after warming renders through the same path
        fut = svc.submit(RenderJob(clip, RATE, p, seed=3))
        svc.start()
        result = fut.result(timeout=120)
        svc.stop()
        expect = padded_reference(clip, p, seed=3)
        np.testing.assert_allclose(result.audio, expect, atol=2e-5)
        # explicit sizes normalize to their buckets
        svc2 = RenderService(max_batch=8, start=False)
        try:
            dispatched.clear()
            assert svc2.warm(RenderJob(clip, RATE, p), sizes=[3, 8]) == [4, 8]
            assert dispatched == [(4, 4), (8, 8)]
        finally:
            svc2.stop()

    def test_warm_rejects_streaming_jobs(self):
        svc = RenderService(
            max_batch=4, streaming_threshold_s=0.5, start=False
        )
        try:
            clip = np.zeros(RATE, np.float32)  # 1 s > 0.5 s threshold
            with pytest.raises(ValueError, match="streaming"):
                svc.warm(RenderJob(clip, RATE, RenderParams()))
        finally:
            svc.stop()

    def test_dispatch_pads_batch_and_slices_download(self, monkeypatch):
        """The dispatched render sees the BUCKETED batch with real_batch
        marking the true jobs (pad rows must not ride the download), and
        each real job still matches its reference."""
        from audio_raytracing_studio_tpu.parallel import sharding

        seen = {}
        real_render_batch = sharding.render_batch

        def spy(clips, rate, params, **kwargs):
            seen["batch"] = clips.shape[0]
            seen["real_batch"] = kwargs.get("real_batch")
            return real_render_batch(clips, rate, params, **kwargs)

        monkeypatch.setattr(
            "audio_raytracing_studio_tpu.parallel.sharding.render_batch", spy
        )
        svc = RenderService(max_batch=8, max_wait_ms=50, start=False)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        clips = [make_clip(i) for i in range(3)]
        futs = [
            svc.submit(RenderJob(c, RATE, p, seed=i))
            for i, c in enumerate(clips)
        ]
        svc.start()
        results = wait_all(futs)
        svc.stop()
        assert seen == {"batch": 4, "real_batch": 3}
        assert svc.stats()["batch_sizes"] == [3]  # stats report TRUE sizes
        for i, c in enumerate(clips):
            expect = padded_reference(c, p, seed=i)
            np.testing.assert_allclose(results[i].audio, expect, atol=2e-5)

    def test_padding_is_exact_on_the_linear_path(self):
        """With no exact-length circular stage (air off, EQ unity) the
        bucket padding is mathematically invisible: the trimmed output
        equals the UNPADDED single render."""
        svc = RenderService(max_batch=2, max_wait_ms=20)
        try:
            clip = make_clip(2)  # 4800 samples → bucket 8000: real padding
            p = RenderParams(
                target_layout="Stereo", room_size=50.0, air_absorption=0.0
            )
            res = svc.render(RenderJob(clip, RATE, p, seed=5), timeout=300)
            unpadded = np.asarray(pipeline.render(clip, RATE, p, seed=5))
            assert res.audio.shape == unpadded.shape
            np.testing.assert_allclose(res.audio, unpadded, atol=2e-5)
        finally:
            svc.stop()

    def test_eq_job_matches_unpadded_solo_exactly(self):
        """A padded EQ-on job must equal the unpadded single render, not
        the padded_reference — padded-length circular EQ deviates ~1e-2;
        the batcher's render_batch call runs the length-DYNAMIC exact EQ
        at the clip's true length (batcher.py padding semantics)."""
        svc = RenderService(max_batch=2, max_wait_ms=20)
        try:
            clip = make_clip(2)  # NOT a half-second multiple → real padding
            p = RenderParams(
                target_layout="Stereo", room_size=50.0,
                bass_gain=4.0, treble_gain=0.3,
            )
            res = svc.render(RenderJob(clip, RATE, p, seed=5), timeout=300)
            unpadded = np.asarray(pipeline.render(clip, RATE, p, seed=5))
            assert res.audio.shape == unpadded.shape
            np.testing.assert_allclose(res.audio, unpadded, atol=2e-5)
        finally:
            svc.stop()

    def test_distinct_specs_split_batches(self):
        svc = RenderService(max_batch=8, max_wait_ms=50, start=False)
        room = RenderParams(target_layout="Stereo", room_size=50.0)
        plate = RenderParams(
            target_layout="Stereo", room_size=50.0, hall_type="Plate"
        )
        futs = [
            svc.submit(RenderJob(make_clip(i), RATE, p, seed=i))
            for i, p in enumerate([room, plate, room, plate])
        ]
        svc.start()
        wait_all(futs)
        assert sorted(svc.stats()["batch_sizes"]) == [2, 2]
        assert svc.stats()["jobs_done"] == 4
        svc.stop()

    def test_partial_batch_dispatches_on_deadline(self):
        svc = RenderService(max_batch=8, max_wait_ms=80)
        try:
            p = RenderParams(target_layout="Stereo", room_size=50.0)
            futs = [
                svc.submit(RenderJob(make_clip(i), RATE, p, seed=i))
                for i in range(2)
            ]
            wait_all(futs)
            assert svc.stats()["batch_sizes"] == [2]
        finally:
            svc.stop()

    def test_metrics_measured_on_true_span(self):
        """Metrics must match a direct masked render_batch of the same
        padded bucket — i.e. the device meter saw the true span, not the
        zero padding."""
        clip = make_clip(1, seconds=1.0)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        svc = RenderService(max_batch=2, max_wait_ms=20)
        try:
            res = svc.render(
                RenderJob(clip, RATE, p, seed=7, with_metrics=True), timeout=300
            )
        finally:
            svc.stop()
        n_bucket = sharding.bucket_length(len(clip), RATE)
        padded = np.zeros((1, n_bucket), np.float32)
        padded[0, : len(clip)] = clip
        _, expect = sharding.render_batch(
            padded, RATE, p, seeds=[7], with_metrics=True,
            clip_lengths=[len(clip)],
        )
        assert res.metrics is not None
        for k, v in expect[0].items():
            assert res.metrics[k] == pytest.approx(float(v), abs=1e-6), k

    def test_failed_batch_is_isolated(self, monkeypatch):
        svc = RenderService(max_batch=2, max_wait_ms=20, start=False)
        p = RenderParams(target_layout="Stereo", room_size=50.0)

        def boom(*a, **k):
            raise RuntimeError("injected device failure")

        monkeypatch.setattr(sharding, "render_batch", boom)
        futs = [
            svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(2)
        ]
        svc.start()
        for f in futs:
            with pytest.raises(RuntimeError, match="injected device failure"):
                f.result(timeout=60)
        assert svc.stats()["jobs_failed"] == 2
        monkeypatch.undo()
        # the worker survived: a fresh job renders fine
        res = svc.render(RenderJob(make_clip(9), RATE, p, seed=9), timeout=300)
        assert np.isfinite(res.audio).all()
        svc.stop()

    def test_external_ir_jobs_batch_by_ir_digest(self, rng):
        ir = (0.3 * rng.standard_normal((400, 2))).astype(np.float32)
        p = RenderParams(use_external_ir=True, target_layout="Stereo")
        svc = RenderService(max_batch=8, max_wait_ms=50, start=False)
        clips = [make_clip(i) for i in range(2)]
        futs = [
            svc.submit(RenderJob(c, RATE, p, seed=i, external_ir=ir))
            for i, c in enumerate(clips)
        ]
        svc.start()
        results = wait_all(futs)
        assert svc.stats()["batch_sizes"] == [2]
        for i, c in enumerate(clips):
            expect = padded_reference(c, p, seed=i, external_ir=ir)
            np.testing.assert_allclose(results[i].audio, expect, atol=2e-5)
        svc.stop()

    def test_invalid_jobs_fail_fast_at_submit(self, rng):
        svc = RenderService(max_batch=2, max_wait_ms=20, start=False)
        p_ext = RenderParams(use_external_ir=True)
        with pytest.raises(ValueError, match="external_ir"):
            svc.submit(RenderJob(make_clip(0), RATE, p_ext))
        mono_ir = rng.standard_normal((400, 1)).astype(np.float32)
        with pytest.raises(ValueError, match="stereo"):
            svc.submit(RenderJob(make_clip(0), RATE, p_ext, external_ir=mono_ir))
        with pytest.raises(ValueError, match="rate"):
            svc.submit(RenderJob(make_clip(0), 0, RenderParams()))
        with pytest.raises(ValueError, match="audio"):
            svc.submit(RenderJob(np.zeros((0,), np.float32), RATE, RenderParams()))
        svc.start()
        svc.stop()

    def test_long_jobs_route_to_streaming(self):
        """Clips past streaming_threshold_s render via the bounded-memory
        streaming path as singleton jobs — identical output and metrics to
        calling parallel.streaming.render_streaming directly."""
        from audio_raytracing_studio_tpu.parallel.streaming import (
            render_streaming,
        )

        clip = make_clip(4, seconds=0.8)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        svc = RenderService(
            max_batch=4, max_wait_ms=20,
            streaming_threshold_s=0.5, chunk_seconds=0.25,
        )
        try:
            res = svc.render(
                RenderJob(clip, RATE, p, seed=6, with_metrics=True), timeout=600
            )
        finally:
            svc.stop()
        assert svc.stats()["batch_sizes"] == [1]
        expect, expect_metrics = render_streaming(
            clip, RATE, p, seed=6, chunk_seconds=0.25, with_metrics=True,
            fast_filters=False,  # the service default, honored end to end
        )
        assert res.audio.shape == np.asarray(expect).shape
        np.testing.assert_allclose(res.audio, np.asarray(expect), atol=0)
        assert res.metrics == pytest.approx(expect_metrics)

    def test_streaming_routed_job_honors_exact_filters(self):
        """Round-4 VERDICT item 4: a service configured fast_filters=False
        routes long jobs through the streaming renderer's EXACT air path —
        the result matches the exact single-shot pipeline to float32
        round-off, not just the ≤1e-3 fast envelope."""
        from audio_raytracing_studio_tpu.models import pipeline

        clip = make_clip(7, seconds=0.8)
        p = RenderParams(
            target_layout="Stereo", room_size=50.0, air_absorption=0.7
        )
        svc = RenderService(
            max_batch=4, max_wait_ms=20, fast_filters=False,
            streaming_threshold_s=0.5, chunk_seconds=0.25,
        )
        try:
            res = svc.render(RenderJob(clip, RATE, p, seed=9), timeout=600)
        finally:
            svc.stop()
        exact = pipeline.render(clip, RATE, p, seed=9, fast_filters=False)
        assert res.audio.shape == np.asarray(exact).shape
        assert np.max(np.abs(res.audio - np.asarray(exact))) < 1e-4

    def test_backpressure_and_stopped_service(self):
        svc = RenderService(max_batch=2, max_wait_ms=20, max_queued=2, start=False)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        svc.submit(RenderJob(make_clip(0), RATE, p))
        svc.submit(RenderJob(make_clip(1), RATE, p))
        with pytest.raises(RuntimeError, match="overloaded"):
            svc.submit(RenderJob(make_clip(2), RATE, p))
        # stop() without ever starting: queued futures fail, not hang
        f1 = svc._q.queue[0].future  # peek — both items still queued
        svc.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            f1.result(timeout=5)
        with pytest.raises(RuntimeError, match="stopped"):
            svc.submit(RenderJob(make_clip(3), RATE, p))

    def test_pipelined_matches_serial_bit_exactly(self):
        """pipeline_depth=2 (default: completer thread downloads group i
        while the worker launches group i+1) must produce byte-identical
        results to the fully serial pipeline_depth=1 worker."""
        p = RenderParams(target_layout="Stereo", room_size=50.0, bass_gain=1.4)
        jobs = [
            (make_clip(i, seconds=0.2 + 0.15 * (i % 3)), i % 2 == 0, i)
            for i in range(6)
        ]

        def run(depth):
            svc = RenderService(
                max_batch=2, max_wait_ms=20, pipeline_depth=depth
            )
            try:
                futs = [
                    svc.submit(
                        RenderJob(c, RATE, p, seed=s, with_metrics=wm)
                    )
                    for c, wm, s in jobs
                ]
                return wait_all(futs), svc.stats()
            finally:
                svc.stop()

        serial, st1 = run(1)
        piped, st2 = run(2)
        assert st1["pipeline_depth"] == 1 and st2["pipeline_depth"] == 2
        # phase split is accounted in both modes (dispatch covers the
        # host-stack + launch; on CPU the fetch can round to 0.000)
        assert st2["dispatch_s"] > 0.0 and st2["fetch_s"] >= 0.0
        for a, b in zip(serial, piped):
            np.testing.assert_array_equal(a.audio, b.audio)
            assert a.metrics == b.metrics

    def test_fetch_failure_is_isolated_to_its_group(self, monkeypatch):
        """A failure during the RESULT DOWNLOAD (completer thread) must fail
        only that group's futures; the service keeps serving."""
        svc = RenderService(max_batch=2, max_wait_ms=20, start=False)
        p = RenderParams(target_layout="Stereo", room_size=50.0)

        def bad_dispatch(*a, **k):
            assert k.get("async_results"), "batcher must dispatch async"

            def bad_fetch():
                raise RuntimeError("injected download failure")

            return bad_fetch

        monkeypatch.setattr(sharding, "render_batch", bad_dispatch)
        futs = [
            svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(2)
        ]
        svc.start()
        for f in futs:
            with pytest.raises(RuntimeError, match="injected download failure"):
                f.result(timeout=60)
        assert svc.stats()["jobs_failed"] == 2
        monkeypatch.undo()
        # both threads survived: a fresh job renders fine
        res = svc.render(RenderJob(make_clip(9), RATE, p, seed=9), timeout=300)
        assert np.isfinite(res.audio).all()
        svc.stop()

    def test_stop_drains_inflight_downloads(self):
        """stop() must resolve every dispatched-but-undownloaded future
        (the completer drains before exiting)."""
        svc = RenderService(max_batch=1, max_wait_ms=5, pipeline_depth=3)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        futs = [
            svc.submit(RenderJob(make_clip(i), RATE, p, seed=i)) for i in range(3)
        ]
        svc.stop(timeout=300)
        for f in futs:
            assert np.isfinite(f.result(timeout=5).audio).all()

    def test_mesh_full_option_matrix(self):
        """The mesh-sharded service supports the FULL option matrix —
        pcm16_output, with_metrics (masked to each clip's true span) and EQ
        on off-grid clip lengths (the length-dynamic exact EQ)."""
        import jax

        from audio_raytracing_studio_tpu import config
        from audio_raytracing_studio_tpu.parallel import mesh as meshlib

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        m = meshlib.make_mesh(data=8, block=1)
        svc = RenderService(
            device_mesh=m, pcm16_output=True,
            max_batch=8, max_wait_ms=50, start=False,
        )
        p_eq = RenderParams(
            target_layout="Stereo", room_size=50.0,
            bass_gain=1.7, treble_gain=0.6,
        )
        p_flat = RenderParams(target_layout="Stereo", room_size=50.0)
        # 0.21 s is off the half-second bucket grid: the EQ job exercises
        # the length-dynamic exact EQ under the mesh
        clips = [make_clip(0, seconds=0.21), make_clip(1, seconds=0.3)]
        jobs = [p_eq, p_flat]
        futs = [
            svc.submit(RenderJob(c, RATE, p, seed=i, with_metrics=True))
            for i, (c, p) in enumerate(zip(clips, jobs))
        ]
        svc.start()
        results = wait_all(futs)
        svc.stop()
        assert svc.stats()["batch_sizes"] == [2]
        for i, (c, p) in enumerate(zip(clips, jobs)):
            # the length-dynamic exact EQ matches the UNPADDED solo render
            # (not the padded-length EQ — that deviates 1e-2-class, which is
            # exactly why the dynamic EQ exists)
            expect, sm = pipeline.render(c, RATE, p, seed=i, return_metrics=True)
            want = wavio.encode_pcm16(
                np.clip(
                    np.asarray(expect), -config.OUTPUT_CLIP, config.OUTPUT_CLIP
                )
            )
            r = results[i]
            assert r.audio.dtype == np.int16
            assert r.audio.shape == want.shape
            # float agreement ~2e-5 (sharded vs solo graph) → ±2 int16 LSBs
            assert np.max(
                np.abs(r.audio.astype(np.int32) - want.astype(np.int32))
            ) <= 2
            # metrics masked to the true span, against the unpadded solo
            assert r.metrics["rms_dbfs"] == pytest.approx(
                float(sm["rms_dbfs"]), abs=0.05
            )
            assert r.metrics["lufs"] == pytest.approx(float(sm["lufs"]), abs=0.05)

    def test_mesh_batch_pads_to_data_axis(self):
        import jax

        from audio_raytracing_studio_tpu.parallel import mesh as meshlib

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        m = meshlib.make_mesh(data=8, block=1)
        svc = RenderService(max_batch=8, max_wait_ms=50, device_mesh=m, start=False)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        clips = [make_clip(i) for i in range(3)]  # 3 jobs → padded to 8
        futs = [
            svc.submit(RenderJob(c, RATE, p, seed=i)) for i, c in enumerate(clips)
        ]
        svc.start()
        results = wait_all(futs)
        assert svc.stats()["batch_sizes"] == [3]
        for i, c in enumerate(clips):
            np.testing.assert_allclose(
                results[i].audio, padded_reference(c, p, seed=i), atol=2e-5
            )
        svc.stop()


@pytest.fixture(scope="module")
def http_service():
    svc = RenderService(max_batch=4, max_wait_ms=30)
    http = RenderHTTPService(svc, host="127.0.0.1", port=0).start()
    yield http
    http.stop()


def _get(http, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{http.port}{path}") as r:
        return json.loads(r.read())


def _post(http, path, body: bytes, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{http.port}{path}", data=body, headers=headers or {}
    )
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _poll_done(http, job_id, timeout=300):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = _get(http, f"/v1/jobs/{job_id}")
        if status["status"] != "queued":
            return status
        time.sleep(0.1)
    raise TimeoutError(job_id)


class TestHTTPService:
    def _upload_clip(self, http, i=0):
        import io

        clip = make_clip(i, seconds=0.4)
        buf = io.BytesIO()
        wavio.write(buf, clip[:, None], RATE, subtype="PCM_16")
        return _post(
            http, "/v1/upload", buf.getvalue(), {"X-Filename": f"clip{i}.wav"}
        )["path"], clip

    def test_job_lifecycle(self, http_service):
        http = http_service
        path, clip = self._upload_clip(http, 0)
        payload = {
            "input": path,
            "params": {"target_layout": "Stereo", "room_size": 50.0},
            "seed": 4,
            "metrics": True,
        }
        job = _post(http, "/v1/jobs", json.dumps(payload).encode())
        assert job["status"] == "queued"
        status = _poll_done(http, job["job_id"])
        assert status["status"] == "done", status
        assert "LUFS" in status["metrics_string"]
        assert status["rate"] == RATE
        with urllib.request.urlopen(
            f"http://127.0.0.1:{http.port}/v1/jobs/{job['job_id']}/result"
        ) as r:
            raw = r.read()
        assert raw[:4] == b"RIFF"
        import io

        rendered, rate = wavio.read(io.BytesIO(raw))
        assert rate == RATE
        assert rendered.shape[0] == status["samples"]
        assert rendered.shape[1] == status["channels"] == 2
        assert np.isfinite(rendered).all()
        stats = _get(http, "/v1/stats")
        assert stats["jobs_done"] >= 1

    def test_result_matches_direct_render(self, http_service):
        """End-to-end numeric check: serve a clip, re-render the decoded
        upload directly, compare within the PCM_16 write quantization."""
        http = http_service
        path, _ = self._upload_clip(http, 1)
        decoded, rate = wavio.read(path)
        p = RenderParams(target_layout="Stereo", room_size=50.0)
        payload = {
            "input": path,
            "params": p.to_preset_dict(),
            "seed": 11,
            "metrics": False,
        }
        job = _post(http, "/v1/jobs", json.dumps(payload).encode())
        status = _poll_done(http, job["job_id"])
        assert status["status"] == "done", status
        import io

        with urllib.request.urlopen(
            f"http://127.0.0.1:{http.port}/v1/jobs/{job['job_id']}/result"
        ) as r:
            rendered, _ = wavio.read(io.BytesIO(r.read()))
        expect = padded_reference(decoded[:, 0], p, seed=11)
        # the served file passed the product output contract: ±0.9999 clip
        # then PCM_16 quantization (app/api.py semantics)
        expect = np.clip(expect, -0.9999, 0.9999)
        np.testing.assert_allclose(rendered, expect, atol=1.0 / 32768 + 2e-5)

    def test_flac_result_format(self, http_service):
        http = http_service
        path, _ = self._upload_clip(http, 2)
        payload = {
            "input": path,
            "params": {"target_layout": "Stereo", "room_size": 50.0},
            "format": "flac",
            "metrics": False,
        }
        job = _post(http, "/v1/jobs", json.dumps(payload).encode())
        status = _poll_done(http, job["job_id"])
        assert status["status"] == "done", status
        with urllib.request.urlopen(
            f"http://127.0.0.1:{http.port}/v1/jobs/{job['job_id']}/result"
        ) as r:
            raw = r.read()
        assert raw[:4] == b"fLaC"

    def test_error_contracts(self, http_service):
        http = http_service
        # non-upload input path → 403
        err = self._expect_code(
            http, "/v1/jobs",
            {"input": "/etc/passwd", "params": {}}, 403,
        )
        assert "upload" in err["error"]
        # bad format → 400
        path, _ = self._upload_clip(http, 3)
        self._expect_code(
            http, "/v1/jobs", {"input": path, "format": "mp9"}, 400
        )
        # missing input → 400
        self._expect_code(http, "/v1/jobs", {"params": {}}, 400)
        # unknown job → 404
        import urllib.error

        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(http, "/v1/jobs/" + "0" * 32)
        assert exc.value.code == 404

    def test_non_object_payloads_are_clean_400(self, http_service):
        """json.loads returns lists/numbers/strings too; every payload
        field access assumes an object.  A bare-list body was a fuzz-found
        AttributeError 500 (tools/fuzz_campaign.py http, seed 700054);
        wrong-typed fields (list seed, list params) raised TypeError into
        the catch-all 500 path."""
        http = http_service
        for bad in ([[1, 2]], 5, "input", None, True):
            err = self._expect_code(http, "/v1/jobs", bad, 400)
            assert "JSON object" in err["error"]
        path, _ = self._upload_clip(http, 4)
        err = self._expect_code(
            http, "/v1/jobs", {"input": path, "seed": [3]}, 400
        )
        assert "seed" in err["error"]
        err = self._expect_code(
            http, "/v1/jobs", {"input": path, "params": ["x"]}, 400
        )
        assert "params" in err["error"]

    def test_negative_content_length_is_clean_400(self, http_service):
        """A negative Content-Length must never reach rfile.read(-1) —
        that read blocks until the CLIENT closes, pinning a handler
        thread forever on a hostile keep-alive socket."""
        import socket

        with socket.create_connection(
            ("127.0.0.1", http_service.port), timeout=30
        ) as s:
            s.sendall(
                b"POST /v1/jobs HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: -7\r\nConnection: close\r\n\r\n"
            )
            status = s.recv(64).split(b"\r\n", 1)[0]
        assert b"400" in status
        # the server is still alive
        assert "jobs_known" in _get(http_service, "/v1/stats")

    @staticmethod
    def _expect_code(http, path, payload, code):
        import urllib.error

        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(http, path, json.dumps(payload).encode())
        assert exc.value.code == code
        return json.loads(exc.value.read())

    def test_preset_job(self, tmp_path):
        """A job can reference a saved studio preset by filename; 'params'
        keys override it; the studio's last-used pointer is untouched."""
        from audio_raytracing_studio_tpu.utils.presets import PresetStore

        store = PresetStore(str(tmp_path))
        p_saved = RenderParams(
            target_layout="Stereo", room_size=50.0, diffusion=0.77
        )
        _, fname = store.save("ServePreset", p_saved)
        store.save_last("")  # known state
        svc = RenderService(max_batch=2, max_wait_ms=20)
        http = RenderHTTPService(
            svc, host="127.0.0.1", port=0, preset_dir=str(tmp_path)
        ).start()
        try:
            path, clip = self._upload_clip(http, 7)
            payload = {
                "input": path,
                "preset": fname,
                "params": {"x_pos": 0.9},  # override on top of the preset
                "seed": 2,
                "metrics": False,
            }
            job = _post(http, "/v1/jobs", json.dumps(payload).encode())
            status = _poll_done(http, job["job_id"])
            assert status["status"] == "done", status
            import dataclasses
            import io

            decoded, _ = wavio.read(path)
            with urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/v1/jobs/{job['job_id']}/result"
            ) as r:
                rendered, _ = wavio.read(io.BytesIO(r.read()))
            # numeric check: preset + override == the merged RenderParams
            merged = dataclasses.replace(p_saved, x_pos=0.9)
            expect = np.clip(
                padded_reference(decoded[:, 0], merged, seed=2), -0.9999, 0.9999
            )
            np.testing.assert_allclose(rendered, expect, atol=1.0 / 32768 + 2e-5)
            # listed over HTTP
            assert fname in _get(http, "/v1/presets")["presets"]
            # unknown preset → 400
            err = self._expect_code(
                http, "/v1/jobs", {"input": path, "preset": "nope_v4.json"}, 400
            )
            assert "preset" in err["error"]
            # the service did NOT move the studio's last-used pointer
            assert store.load_last() in (None, "")
        finally:
            http.stop()

    def test_upload_retention_bounded(self):
        """max_uploads evicts the oldest upload files — disk stays bounded."""
        import os

        svc = RenderService(max_batch=2, max_wait_ms=20, start=False)
        http = RenderHTTPService(svc, host="127.0.0.1", port=0, max_uploads=2)
        http.start()
        try:
            paths = [self._upload_clip(http, i)[0] for i in range(3)]
            assert not os.path.exists(paths[0])  # evicted
            assert os.path.exists(paths[1]) and os.path.exists(paths[2])
            # an evicted upload is no longer referencable for new jobs
            err = self._expect_code(
                http, "/v1/jobs", {"input": paths[0], "params": {}}, 403
            )
            assert "upload" in err["error"]
        finally:
            http.stop()
        assert not os.path.exists(paths[1])  # stop() removed the dirs

    def test_upload_eviction_is_lru_not_insertion_age(self):
        """A shared upload that jobs keep referencing survives a stream of
        newer one-shot uploads (upload-one-IR, submit-many-jobs pattern —
        insertion-age eviction 403'd every external-IR job after the cap's
        worth of clip uploads in the round-5 HTTP soak)."""
        import os

        svc = RenderService(max_batch=2, max_wait_ms=20, start=False)
        http = RenderHTTPService(svc, host="127.0.0.1", port=0, max_uploads=2)
        http.start()
        try:
            shared, _ = self._upload_clip(http, 0)
            for i in range(1, 5):
                # each reference touches the shared upload → it stays MRU
                assert http._uploads.allowed(os.path.realpath(shared))
                p, _ = self._upload_clip(http, i)
            assert os.path.exists(shared)
            assert http._uploads.allowed(os.path.realpath(shared))
            # the shared upload is still referencable for new jobs
            job = _post(
                http,
                "/v1/jobs",
                json.dumps({"input": shared, "params": {}}).encode(),
            )
            assert "job_id" in job
        finally:
            http.stop()

    def test_cancel_queued_job(self):
        """A queued job cancels cleanly: the batcher skips it, status reads
        'cancelled', the result endpoint answers 410."""
        import urllib.error

        svc = RenderService(max_batch=2, max_wait_ms=20, start=False)
        http = RenderHTTPService(svc, host="127.0.0.1", port=0).start()
        try:
            path, _ = self._upload_clip(http, 5)
            payload = {"input": path, "params": {"target_layout": "Stereo"}}
            job = _post(http, "/v1/jobs", json.dumps(payload).encode())
            req = urllib.request.Request(
                f"http://127.0.0.1:{http.port}/v1/jobs/{job['job_id']}",
                method="DELETE",
            )
            res = json.loads(urllib.request.urlopen(req).read())
            assert res["cancelled"] is True and res["status"] == "cancelled"
            assert _get(http, f"/v1/jobs/{job['job_id']}")["status"] == "cancelled"
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(http, f"/v1/jobs/{job['job_id']}/result")
            assert exc.value.code == 410
            # the worker drains past the cancelled item without dispatching
            svc.start()
            svc.stop()
            assert svc.stats()["batches"] == 0
        finally:
            http.stop()

    def test_completed_job_retention_is_bounded(self):
        """max_jobs evicts the oldest COMPLETED entries and deletes their
        result files — a long-running service is memory/disk bounded."""
        import os
        import urllib.error

        svc = RenderService(max_batch=2, max_wait_ms=20)
        http = RenderHTTPService(svc, host="127.0.0.1", port=0, max_jobs=2)
        http.start()
        try:
            path, _ = self._upload_clip(http, 6)
            payload = {"input": path, "params": {"target_layout": "Stereo"}}
            first = _post(http, "/v1/jobs", json.dumps(payload).encode())
            _poll_done(http, first["job_id"])
            # materialize the first job's result file so eviction must unlink it
            urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/v1/jobs/{first['job_id']}/result"
            ).read()
            first_path = http._entry(first["job_id"]).result_path
            assert first_path and os.path.exists(first_path)
            later = [
                _post(http, "/v1/jobs", json.dumps(payload).encode())
                for _ in range(2)
            ]
            for j in later:
                _poll_done(http, j["job_id"])
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(http, f"/v1/jobs/{first['job_id']}")
            assert exc.value.code == 404
            assert not os.path.exists(first_path)
        finally:
            http.stop()


class TestMemoryAccounting:
    """VERDICT r4 item 1: the serving layer must say where its bytes are —
    and results must own exactly their trimmed bytes (a contiguous slice of
    the batch download buffer is a VIEW that pins the whole batch)."""

    def test_result_owns_its_bytes(self):
        svc = RenderService(max_batch=2, max_wait_ms=20)
        try:
            p = RenderParams(target_layout="Stereo")
            futs = [
                svc.submit(RenderJob(make_clip(i), RATE, p, seed=i))
                for i in range(2)
            ]
            for r in wait_all(futs):
                assert r.audio.base is None and r.audio.flags.owndata
        finally:
            svc.stop()

    def test_inflight_and_retained_accounting(self):
        import gc

        svc = RenderService(max_batch=2, max_wait_ms=20, start=False)
        try:
            p = RenderParams(target_layout="Stereo")
            futs = [
                svc.submit(RenderJob(make_clip(i), RATE, p, seed=i))
                for i in range(2)
            ]
            st = svc.stats()
            # two stereo-ized clips queued, nothing resolved yet
            assert st["inflight_input_bytes"] == sum(
                make_clip(i).nbytes * 2 for i in range(2)
            )
            assert st["retained_results"] == 0
            svc.start()
            results = wait_all(futs)
            st = svc.stats()
            assert st["inflight_input_bytes"] == 0
            assert st["retained_results"] == 2
            assert st["retained_result_bytes"] == sum(
                r.audio.nbytes for r in results
            )
            # memory_stats merge: process + runtime context for soak diffing
            assert st["rss_mb"] > 0 and st["executables"] >= 1
            assert "device_buffer_mb" in st
            # cumulative transfer counters (RSS attribution in soaks):
            # inputs = both clips' stereo-ized bytes, results = at least
            # the trimmed result bytes (the download buffer is bucket-padded)
            assert st["dispatched_input_bytes_total"] == sum(
                make_clip(i).nbytes * 2 for i in range(2)
            )
            assert st["fetched_result_bytes_total"] >= sum(
                r.audio.nbytes for r in results
            )
            del results, futs
            gc.collect()
            st = svc.stats()
            assert st["retained_results"] == 0
            assert st["retained_result_bytes"] == 0
        finally:
            svc.stop()

    def test_cancelled_and_failed_jobs_release_inputs(self):
        svc = RenderService(max_batch=8, max_wait_ms=50, start=False)
        try:
            p = RenderParams(target_layout="Stereo")
            fut = svc.submit(RenderJob(make_clip(0), RATE, p))
            assert svc.stats()["inflight_input_bytes"] > 0
            assert fut.cancel()
            svc.start()
            # worker drops the cancelled item at dispatch time
            deadline = time.monotonic() + 30
            while svc.stats()["inflight_input_bytes"] and time.monotonic() < deadline:
                time.sleep(0.05)
            assert svc.stats()["inflight_input_bytes"] == 0
        finally:
            svc.stop()
        # a stopped service flushing orphans also releases their bytes
        svc2 = RenderService(max_batch=2, start=False)
        fut = svc2.submit(RenderJob(make_clip(1), RATE, p))
        assert svc2.stats()["inflight_input_bytes"] > 0
        svc2.stop()
        with pytest.raises(RuntimeError):
            fut.result(timeout=5)
        assert svc2.stats()["inflight_input_bytes"] == 0
