"""Binaural downmix extension: ITD/ILD structure and energy sanity."""

import numpy as np
import pytest

from audio_raytracing_studio_tpu.ops.binaural import binauralize


def click_in_channel(ch, channels=6, n=4800, rate=48000):
    x = np.zeros((n, channels), np.float32)
    x[n // 2, ch] = 1.0
    return x, rate


def test_hard_left_source_itd_and_ild():
    """RL (-110°) source: left ear earlier and louder than right."""
    x, rate = click_in_channel(4)  # RL
    out = binauralize(x, rate, "5.1 (Standard)")
    left, right = out[:, 0], out[:, 1]
    # ILD: left ear carries more energy
    assert np.sum(left**2) > 2.0 * np.sum(right**2)
    # ITD: right-ear arrival later (centroid of |x|)
    t_l = np.argmax(np.abs(left))
    t_r = np.argmax(np.abs(right))
    expected_itd = int(0.0875 / 343.0 * (np.deg2rad(110) + np.sin(np.deg2rad(110))) * rate)
    assert t_r - t_l == pytest.approx(expected_itd, abs=2)


def test_center_source_symmetric():
    x, rate = click_in_channel(2)  # C
    out = binauralize(x, rate, "5.1 (Standard)")
    np.testing.assert_allclose(out[:, 0], out[:, 1], atol=1e-6)


def test_energy_reasonable():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((9600, 6)) * 0.1).astype(np.float32)
    out = binauralize(x, 48000, "5.1 (Standard)")
    e_in = np.sum(x**2)
    e_out = np.sum(out**2)
    assert 0.2 * e_in < e_out < 1.5 * e_in


def test_all_layouts():
    from audio_raytracing_studio_tpu import config

    for name, info in config.CHANNEL_LAYOUTS.items():
        x = np.zeros((2400, info["channels"]), np.float32)
        x[100, 0] = 0.5
        out = binauralize(x, 48000, name)
        assert out.shape == (2400, 2)


def test_high_rate_itd_does_not_wrap():
    """The ITD headroom must scale with the sample rate: at 384 kHz a fully
    lateral source's far-ear delay (~280 samples) exceeds the old fixed
    256-sample pad, and the delayed tail would wrap circularly into the
    clip start as a pre-echo."""
    rate = 384000
    n = 2048
    x = np.zeros((n, 6), np.float32)
    x[n - 1, 4] = 1.0  # RL (-110°): near-maximal ITD, click at the very end
    out = binauralize(x, rate, "5.1 (Standard)")
    # nothing may arrive before the click minus the (noncausal) shadow-filter
    # smear — a circular wrap would land delayed far-ear energy near t=0
    head = out[: n // 2]
    assert np.max(np.abs(head)) < 1e-4, np.max(np.abs(head))
    assert np.max(np.abs(out)) > 0.05  # the click itself survived


def test_lengths_share_one_compile_bucket():
    """Clip lengths quantize to the half-second grid before the jitted mix:
    every distinct length would otherwise be a fresh trace + compile
    (render_dir processes directories of odd-length clips) — and results must be identical to the unbucketed
    linear convolution (zero-padding is exact)."""
    from audio_raytracing_studio_tpu.ops.binaural import _binaural_mix

    rate = 48000
    before = _binaural_mix._cache_size()
    outs = []
    for n in (4700, 4800, 4850):  # all bucket to 24000 @ 48 kHz
        x = np.zeros((n, 6), np.float32)
        x[n // 2, 0] = 1.0
        outs.append(binauralize(x, rate, "5.1 (Standard)"))
    assert _binaural_mix._cache_size() - before <= 1
    for n, out in zip((4700, 4800, 4850), outs):
        assert out.shape == (n, 2)
        assert np.max(np.abs(out)) > 0.1


def test_layout_mismatch_rejected():
    with pytest.raises(ValueError, match="does not match"):
        binauralize(np.zeros((100, 6), np.float32), 48000, "Stereo")


def test_cli_binaural_flag(tmp_path):
    from audio_raytracing_studio_tpu.cli.render import main
    from audio_raytracing_studio_tpu.utils import wavio

    rate = 16000
    t = np.arange(rate // 4) / rate
    src = tmp_path / "in.wav"
    wavio.write(src, (0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), rate)
    out = tmp_path / "bin.wav"
    rc = main([str(src), str(out), "--layout", "5.1 (Standard)",
               "--room-size", "50", "--binaural", "--seed", "1"])
    assert rc == 0
    data, r = wavio.read(out)
    assert data.shape[1] == 2  # surround render downmixed to binaural stereo


def test_render_dir_binaural_and_trimmed_metrics(tmp_path):
    """Directory mode: --binaural applied; metrics measured on trimmed clip."""
    import json as _json

    from audio_raytracing_studio_tpu.cli.render_dir import main
    from audio_raytracing_studio_tpu.utils import wavio

    in_dir = tmp_path / "i"; in_dir.mkdir()
    rate = 16000
    t = np.arange(rate // 8) / rate  # short clip → heavy bucket padding
    wavio.write(in_dir / "a.wav", (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), rate)
    out_dir = tmp_path / "o"

    import subprocess, sys
    rc = main([str(in_dir), str(out_dir), "--layout", "5.1 (Standard)",
               "--room-size", "50", "--binaural", "--json"])
    assert rc == 0
    data, r = wavio.read(out_dir / "a.wav")
    assert data.shape[1] == 2  # binauralized

    # trimmed metrics: RMS should reflect the real clip, not 0.5s of padding
    from audio_raytracing_studio_tpu.analysis.metrics import calculate_audio_metrics
    m = calculate_audio_metrics(data, r)
    assert m["rms_dbfs"] > -30  # a padded-length measurement would be much lower
