"""MP3 I/O tests (utils/mp3io.py — ctypes bindings to the in-image
libmp3lame encoder and libmpg123 decoder).

The two libraries are independent codebases, so every encode→decode
round trip here cross-validates one against the other — the same interop
discipline as the FLAC (test_flacio) and Vorbis (test_vorbisenc) suites.
Tests skip cleanly on images without the shared libraries; in THIS image
both are present and everything runs.

Reference surface: analyser.py:73-83 converts to mp3 via pydub+ffmpeg;
raytracer_studio.py:1013 reads mp3 via soundfile→ffmpeg.  Here both
directions run with no external binary and no subprocess.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from audio_raytracing_studio_tpu.utils import mp3io, wavio

needs_decoder = pytest.mark.skipif(
    not mp3io.decode_available(), reason="libmpg123 not present in this image"
)
needs_encoder = pytest.mark.skipif(
    not mp3io.encode_available(), reason="libmp3lame not present in this image"
)
needs_both = pytest.mark.skipif(
    not (mp3io.decode_available() and mp3io.encode_available()),
    reason="mp3 codec libraries not present in this image",
)


def _test_signal(seconds=2.0, rate=44100, channels=2, seed=11):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    chans = []
    for c in range(channels):
        chans.append(
            0.5 * np.sin(2 * np.pi * (220 * (c + 1)) * t)
            + 0.1 * np.sin(2 * np.pi * (1800 + 500 * c) * t)
            + 0.01 * rng.standard_normal(len(t))
        )
    return np.stack(chans, axis=1).astype(np.float32), rate


def _snr_db(ref, got):
    err = got.astype(np.float64) - ref.astype(np.float64)
    return 10 * np.log10(
        np.sum(ref.astype(np.float64) ** 2) / max(np.sum(err**2), 1e-30)
    )


@needs_both
class TestRoundTrip:
    def test_stereo_gapless_roundtrip(self, tmp_path):
        """Encode→decode restores the exact frame count (Xing/LAME tag) and
        the audio at ≥25 dB SNR (256 kbps joint stereo)."""
        x, rate = _test_signal()
        p = tmp_path / "rt.mp3"
        mp3io.write(p, x, rate, bitrate_kbps=256)
        y, got_rate = mp3io.decode(p)
        assert got_rate == rate
        assert y.shape == x.shape, f"{y.shape} vs {x.shape}"
        assert _snr_db(x, y) > 25.0

    def test_mono_roundtrip(self, tmp_path):
        x, rate = _test_signal(channels=1, rate=48000)
        p = tmp_path / "mono.mp3"
        mp3io.write(p, x, rate, bitrate_kbps=192)
        y, got_rate = mp3io.decode(p)
        assert got_rate == rate
        assert y.shape == x.shape
        assert _snr_db(x, y) > 25.0

    def test_low_rate_mpeg2(self, tmp_path):
        """16 kHz rides MPEG-2 framing; the binding must not assume MPEG-1."""
        x, rate = _test_signal(rate=16000, channels=2)
        p = tmp_path / "lsf.mp3"
        mp3io.write(p, x, rate, bitrate_kbps=96)
        y, got_rate = mp3io.decode(p)
        assert got_rate == rate
        assert y.shape == x.shape
        assert _snr_db(x, y) > 20.0

    def test_bitrate_scales_size_and_quality(self, tmp_path):
        x, rate = _test_signal(seconds=3.0)
        small = mp3io.encode(x, rate, bitrate_kbps=64)
        big = mp3io.encode(x, rate, bitrate_kbps=320)
        assert len(big) > len(small) * 2.5
        y_small, _ = _decode_bytes(tmp_path, small)
        y_big, _ = _decode_bytes(tmp_path, big)
        assert _snr_db(x, y_big) > _snr_db(x, y_small)

    def test_id3v2_prefix_is_skipped(self, tmp_path):
        """mpg123 skips ID3v2; the sniff chain still classifies it as MP3."""
        x, rate = _test_signal(seconds=0.5)
        raw = mp3io.encode(x, rate)
        pad = 64
        # ID3v2.3 header: "ID3", version 3.0, flags 0, syncsafe size
        id3 = b"ID3\x03\x00\x00" + bytes(
            [(pad >> 21) & 0x7F, (pad >> 14) & 0x7F, (pad >> 7) & 0x7F, pad & 0x7F]
        ) + b"\x00" * pad
        p = tmp_path / "tagged.mp3"
        p.write_bytes(id3 + raw)
        assert wavio.sniff_container(p.read_bytes()[:12]) == "MP3"
        y, got_rate = mp3io.decode(p)
        assert got_rate == rate
        assert y.shape == x.shape


def _decode_bytes(tmp_path, payload: bytes):
    p = tmp_path / f"b{abs(hash(payload)) % 10**8}.mp3"
    p.write_bytes(payload)
    return mp3io.decode(p)


@needs_both
class TestErrorContract:
    def test_garbage_behind_sync_word_raises(self, tmp_path):
        """Sync word + invalid bitrate nibble, then zeros: no frame can ever
        be resynced, so the decoder must report an empty/undecodable stream
        (deterministic — random garbage can contain pseudo-valid frames)."""
        p = tmp_path / "junk.mp3"
        p.write_bytes(b"\xff\xfb\xf0\x00" + b"\x00" * 4096)
        with pytest.raises(ValueError):
            mp3io.decode(p)

    def test_tag_only_stream_raises(self, tmp_path):
        """A 50-byte prefix holds at most the (silent) tag frame header."""
        x, rate = _test_signal(seconds=0.5)
        raw = mp3io.encode(x, rate)
        p = tmp_path / "cut.mp3"
        p.write_bytes(raw[:50])
        with pytest.raises(ValueError):
            mp3io.decode(p)

    def test_midstream_truncation_decodes_prefix(self, tmp_path):
        """Lossy transport semantics: resync and return the intact frames."""
        x, rate = _test_signal(seconds=2.0)
        raw = mp3io.encode(x, rate)
        p = tmp_path / "half.mp3"
        p.write_bytes(raw[: len(raw) // 2])
        y, got_rate = mp3io.decode(p)
        assert got_rate == rate
        assert 0 < y.shape[0] < x.shape[0]

    def test_more_than_two_channels_rejected(self):
        x = np.zeros((1000, 6), dtype=np.float32)
        with pytest.raises(ValueError, match="maximal 2 Kanäle"):
            mp3io.encode(x, 48000)

    def test_empty_signal_rejected(self):
        with pytest.raises(ValueError, match="empty"):
            mp3io.encode(np.zeros((0, 2), dtype=np.float32), 48000)

    def test_non_finite_samples_rejected(self):
        """libmp3lame ABORTS the process (psymodel.c assertion) on NaN/Inf
        samples — must be a clean ValueError before any sample reaches the
        native encoder (found by tools/fuzz_campaign.py encode mode)."""
        for bad in (np.nan, np.inf, -np.inf):
            x = np.zeros((4096, 2), dtype=np.float32)
            x[100, 0] = bad
            with pytest.raises(ValueError, match="non-finite"):
                mp3io.encode(x, 44100)


@needs_both
class TestProductSurface:
    def test_wavio_read_dispatches_mp3(self, tmp_path):
        x, rate = _test_signal()
        p = tmp_path / "in.mp3"
        mp3io.write(p, x, rate)
        y, got_rate = wavio.read(p)
        assert got_rate == rate and y.shape == x.shape

    def test_write_audio_mp3_target(self, tmp_path):
        x, rate = _test_signal(channels=1)
        p = tmp_path / "out.mp3"
        wavio.write_audio(p, x, rate)
        y, got_rate = wavio.read(p)
        assert got_rate == rate and y.shape == x.shape

    def test_probe(self, tmp_path):
        x, rate = _test_signal(seconds=1.5)
        p = tmp_path / "probe.mp3"
        mp3io.write(p, x, rate)
        meta = wavio.probe(p)
        assert meta["samplerate"] == rate
        assert meta["channels"] == 2
        assert meta["bits"] == 0
        assert abs(meta["duration"] - 1.5) < 0.1

    def test_analyzer_convert_wav_to_mp3_and_back(self, tmp_path):
        from audio_raytracing_studio_tpu.cli import analyzer

        x, rate = _test_signal()
        src = tmp_path / "src.wav"
        wavio.write(src, x, rate)
        mp3 = tmp_path / "conv.mp3"
        analyzer.convert(str(src), str(mp3), bitrate="192")
        back = tmp_path / "back.flac"
        analyzer.convert(str(mp3), str(back))
        y, got_rate = wavio.read(back)
        assert got_rate == rate
        assert y.shape[0] == x.shape[0]
        assert _snr_db(x, y) > 20.0

    def test_analyzer_analyze_mp3(self, tmp_path):
        from audio_raytracing_studio_tpu.cli import analyzer

        x, rate = _test_signal()
        wav = tmp_path / "a.wav"
        mp3 = tmp_path / "a.mp3"
        wavio.write(wav, x, rate)
        mp3io.write(mp3, x, rate)
        ref = analyzer.analyze(str(wav), backend="oracle")
        got = analyzer.analyze(str(mp3), backend="oracle")
        assert got["Abtastrate"] == rate and got["Kanäle"] == 2
        assert abs(got["LUFS"] - ref["LUFS"]) < 0.5

    def test_render_cli_accepts_mp3_input(self, tmp_path):
        """The flagship render path eats .mp3 directly (reference needs
        soundfile/ffmpeg for this, raytracer_studio.py:1013)."""
        x, rate = _test_signal(seconds=0.4, rate=16000, channels=1)
        src = tmp_path / "clip.mp3"
        mp3io.write(src, x, rate)
        out = tmp_path / "out.wav"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="/root/repo")
        proc = subprocess.run(
            [
                sys.executable,
                "-m",
                "audio_raytracing_studio_tpu.cli.render",
                str(src),
                str(out),
                "--hall",
                "Room",
                "--layout",
                "Stereo",
                "--seed",
                "5",
            ],
            capture_output=True,
            text=True,
            cwd="/root/repo",
            timeout=600,  # a hung child must fail this test, not hang the suite
        )
        assert proc.returncode == 0, proc.stderr
        y, got_rate = wavio.read(out)
        assert got_rate == rate
        assert y.shape[1] == 2
        assert y.shape[0] > x.shape[0]  # reverb tail past the dry length
