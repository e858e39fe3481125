"""Seeded NumPy/SciPy reference oracle for the full DSP pipeline.

This is an independent, vectorized reimplementation of the reference's
behavior (/root/reference/raytracer_studio.py) used as (a) the golden test
oracle for the JAX pipeline (≤1e-3 max-abs contract from BASELINE.json)
and (b) the CPU baseline timing harness.  Unlike the reference it is fully
deterministic: all random draws come from an explicit ``IRDraws`` bundle or a
seeded Generator (the reference uses the unseeded global ``np.random`` at
:262, :264, :285, making itself non-reproducible).

dtype flow matches the reference exactly: float32 signal arrays, float64
scalar math, float64 FFTs for EQ/air filters (np.fft promotes), float32
FFT convolution (scipy.signal.fftconvolve preserves dtype).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from scipy.signal import fftconvolve

from .. import config
from ..params import (
    IRDraws,
    IRGeometry,
    RenderParams,
    adapt_early_late_levels,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
    derive_ir_geometry,
    dry_kill_factor,
)


# ---------------------------------------------------------------------------
# IR synthesis
# ---------------------------------------------------------------------------

def generate_impulse_response_split(
    geometry: IRGeometry, draws: IRDraws
) -> tuple[np.ndarray, np.ndarray]:
    """Split (early, late) impulse responses from explicit random draws.

    Semantics of generate_impulse_response_split_3d
    (raytracer_studio.py:238-308): early = scattered random taps scaled by
    absorption/directionality/delay falloff; late = smoothed uniform noise
    under an exponential −50 dB decay envelope; early normalized to 0.9 peak
    (excluding sample 0), late to 0.7 peak.
    """
    g = geometry
    if g.rate <= 0 or g.ir_duration <= 0:
        return np.array([1.0], dtype=np.float32), np.zeros(1, dtype=np.float32)

    early_ir = np.zeros(g.length, dtype=np.float32)
    late_ir = np.zeros(g.length, dtype=np.float32)

    # --- Early reflections (:258-268) ---
    if g.early_taps_active and len(draws.delays) > 0:
        delays = np.asarray(draws.delays, dtype=np.int64)
        base_strengths = np.asarray(draws.strengths, dtype=np.float64)
        valid = (delays > 0) & (delays < g.split_point)
        strengths = base_strengths * (1.0 - g.absorption)
        strengths = strengths * np.clip(g.directionality, 0.1, 1.0)
        strengths = strengths * (
            1.0
            - (delays / g.actual_max_early_delay) ** config.EARLY_DELAY_DECAY_EXP
        )
        # Unbuffered in-order accumulation matches the reference's += loop.
        np.add.at(early_ir, delays[valid], strengths[valid].astype(np.float32))

    # --- Late tail (:270-296) ---
    if g.late_length > 0:
        noise_raw = np.asarray(draws.noise, dtype=np.float64)
        w = g.noise_smooth_width
        if w > 1 and g.late_length >= w:
            kernel = np.ones(w) / w
            noise_smoothed = np.convolve(noise_raw, kernel, mode="same")
            std_raw = np.std(noise_raw)
            std_smooth = np.std(noise_smoothed)
            if std_smooth > 1e-6:
                noise_smoothed = noise_smoothed / std_smooth * std_raw
            else:
                noise_smoothed = noise_raw
        else:
            noise_smoothed = noise_raw

        decay_envelope = np.power(g.decay_factor, np.arange(g.late_length))
        late_ir[g.split_point :] = noise_smoothed * g.initial_late_amp * decay_envelope

    # --- Normalization (:299-303) ---
    if g.length > 1:
        early_max = np.max(np.abs(early_ir[1:]))
        if early_max > 1e-6:
            early_ir[1:] = (early_ir[1:] / early_max) * config.EARLY_NORM_PEAK
    late_max = np.max(np.abs(late_ir))
    if late_max > 1e-6:
        late_ir = (late_ir / late_max) * config.LATE_NORM_PEAK

    return early_ir, late_ir


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

def apply_air_absorption(signal: np.ndarray, rate: int, factor: float) -> np.ndarray:
    """FFT-domain tilt: unity below 2 kHz, ramping to 1−0.8·factor at Nyquist.

    Semantics of apply_simple_lp_filter (raytracer_studio.py:310-336).
    """
    if factor < config.AIR_ABSORPTION_MIN_FACTOR:
        return signal
    if signal.ndim != 2 or signal.size == 0:
        return signal
    n_fft = signal.shape[0]
    if n_fft < 2:
        return signal

    fft_data = np.fft.rfft(signal, axis=0)
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / rate)
    start = config.AIR_ABSORPTION_START_HZ
    mask = freqs >= start
    gain = np.ones_like(freqs)
    max_freq = freqs[-1] if len(freqs) > 0 else start + 1
    if np.any(mask) and max_freq > start:
        max_damping = np.clip(factor, 0.0, 1.0) * config.AIR_ABSORPTION_MAX_DAMPING
        ramp = np.clip((freqs[mask] - start) / (max_freq - start), 0, 1)
        gain[mask] = 1.0 - ramp * max_damping
    fft_data *= gain[:, np.newaxis]
    return np.fft.irfft(fft_data, n=n_fft, axis=0).astype(np.float32)


def apply_shelf_eq(
    signal: np.ndarray, rate: int, bass_gain: float, treble_gain: float
) -> np.ndarray:
    """FFT-domain shelf EQ: bins ≤250 Hz × bass, bins ≥4 kHz × treble.

    Semantics of the inline EQ duplicated at raytracer_studio.py:387-398 and
    :441-452, including the skip when both gains are ≈1.
    """
    if signal is None or signal.size == 0:
        return signal
    if np.isclose(bass_gain, 1.0) and np.isclose(treble_gain, 1.0):
        return signal
    n_fft = signal.shape[0]
    if n_fft < 2:
        return signal
    fft_data = np.fft.rfft(signal, axis=0)
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / rate)
    bass_mask = (freqs > 1e-6) & (freqs <= config.EQ_BASS_CUTOFF_HZ)
    treble_mask = freqs >= config.EQ_TREBLE_CUTOFF_HZ
    fft_data[bass_mask] *= np.clip(bass_gain, *config.EQ_GAIN_CLIP)
    fft_data[treble_mask] *= np.clip(treble_gain, *config.EQ_GAIN_CLIP)
    return np.fft.irfft(fft_data, n=n_fft, axis=0).astype(np.float32)


# ---------------------------------------------------------------------------
# Mixing
# ---------------------------------------------------------------------------

def dynamic_dry_wet_mix(
    dry_signal: np.ndarray,
    wet_signal: np.ndarray,
    dry_wet: float,
    kill_start: float = 0.5,
) -> np.ndarray:
    """Dry/wet crossfade with linear dry-kill past ``kill_start``.

    Semantics of dynamic_dry_wet_mix (raytracer_studio.py:84-121): the dry
    contribution is ``k·(1−dw)·dry`` where k fades 1→0 over [kill_start, 1];
    the longer signal's tail is appended with the matching scale.
    """
    dry = np.asarray(dry_signal, dtype=np.float32)
    wet = np.asarray(wet_signal, dtype=np.float32)
    dw = float(np.clip(float(dry_wet), 0.0, 1.0))
    ks = float(np.clip(float(kill_start), 0.0, 1.0))

    # ONE implementation of the reference's dry-kill fade (:97-105) — shared
    # with the JAX pipeline via params.dry_kill_factor (parity-bearing)
    dry_mix_factor = dry_kill_factor(dw, ks)

    min_len = min(dry.shape[0], wet.shape[0])
    mixed = (dry_mix_factor * (1.0 - dw) * dry[:min_len]) + (dw * wet[:min_len])
    if dry.shape[0] > min_len:
        mixed = np.concatenate(
            (mixed, dry[min_len:] * dry_mix_factor * (1.0 - dw)), axis=0
        )
    elif wet.shape[0] > min_len:
        mixed = np.concatenate((mixed, wet[min_len:] * dw), axis=0)
    return mixed.astype(np.float32)


def _conditional_normalize(x: np.ndarray) -> np.ndarray:
    """Peak-normalize only when |x| exceeds 1; zero out denormal residue.

    Matches the post-EQ / post-pan normalization at raytracer_studio.py:402-404,
    :457, :497-499, :558-560.
    """
    if x is None or x.size == 0:
        return x
    max_val = np.max(np.abs(x))
    if max_val > 1.0:
        return x / max_val
    if np.any(x) and max_val < 1e-9:
        return np.zeros_like(x)
    return x


def _ensure_stereo(data: np.ndarray) -> np.ndarray:
    """Mono → duplicated stereo; >2 channels → first two (raytracer_studio.py:343-346)."""
    if data.ndim == 1:
        data = np.stack((data, data), axis=1)
    elif data.shape[1] == 1:
        data = np.repeat(data, 2, axis=1)
    elif data.shape[1] > 2:
        data = data[:, :2]
    return data.astype(np.float32)


# ---------------------------------------------------------------------------
# Convolution engines
# ---------------------------------------------------------------------------

def convolve_audio_split(
    data: np.ndarray,
    early_ir: np.ndarray,
    late_ir: np.ndarray,
    early_level: float,
    late_level: float,
    dry_wet: float,
    bass_gain: float = 1.0,
    treble_gain: float = 1.0,
    rate: int = 44100,
    kill_start_dw: float = 0.5,
    air_absorption_factor: float = 0.0,
) -> np.ndarray:
    """Internal-hall wet path: early/late convolution + air LP + mix + EQ.

    Semantics of convolve_audio_split_3d (raytracer_studio.py:338-408).
    """
    if data is None or data.size == 0:
        return np.zeros((0, 2), dtype=np.float32)
    data = _ensure_stereo(data)
    early_ir = np.asarray(early_ir, dtype=np.float32).flatten()
    late_ir = np.asarray(late_ir, dtype=np.float32).flatten()

    len_data = data.shape[0]
    len_out_early = len_data + len(early_ir) - 1 if len(early_ir) > 0 else len_data
    len_out_late = len_data + len(late_ir) - 1 if len(late_ir) > 0 else len_data
    len_out_max = max(len_data, len_out_early, len_out_late)
    data_padded = (
        np.pad(data, ((0, len_out_max - len_data), (0, 0)))
        if len_out_max > len_data
        else data
    )

    # each stream writes INTO its zeros(len_out_max) buffer: with IRs of
    # unequal length (possible through the public compat surface — the
    # reference always generates equal-length pairs) the shorter stream's
    # conv result is shorter than len_out_max, and reassigning the variable
    # to the short stack would crash the level-combine broadcast below
    early_wet = np.zeros((len_out_max, 2), dtype=np.float32)
    if early_ir.size > 1 and np.any(early_ir) and early_level > 1e-6:
        early_left = fftconvolve(data[:, 0], early_ir, mode="full")
        early_right = fftconvolve(data[:, 1], early_ir, mode="full")
        n = min(len_out_max, early_left.shape[0])
        early_wet[:n] = np.stack((early_left[:n], early_right[:n]), axis=1)

    late_wet = np.zeros((len_out_max, 2), dtype=np.float32)
    if late_ir.size > 1 and np.any(late_ir) and late_level > 1e-6:
        late_left = fftconvolve(data[:, 0], late_ir, mode="full")
        late_right = fftconvolve(data[:, 1], late_ir, mode="full")
        n = min(len_out_max, late_left.shape[0])
        late_wet[:n] = np.stack((late_left[:n], late_right[:n]), axis=1)

    if air_absorption_factor > config.AIR_ABSORPTION_MIN_FACTOR and late_wet.size > 0:
        late_wet = apply_air_absorption(late_wet, rate, air_absorption_factor)

    wet_combined = (early_wet * early_level) + (late_wet * late_level)
    mixed = dynamic_dry_wet_mix(data_padded, wet_combined, dry_wet, kill_start_dw)
    mixed_eq = apply_shelf_eq(mixed, rate, bass_gain, treble_gain)
    mixed_norm = _conditional_normalize(mixed_eq)
    return mixed_norm.astype(np.float32)


def convolve_audio_external_ir(
    data: np.ndarray,
    external_ir_data: np.ndarray,
    dry_wet: float,
    bass_gain: float = 1.0,
    treble_gain: float = 1.0,
    rate: int = 44100,
    kill_start_dw: float = 0.5,
) -> np.ndarray:
    """True-stereo external-IR convolution: L⊛IR_L, R⊛IR_R, then mix + EQ.

    Semantics of convolve_audio_external_ir (raytracer_studio.py:410-462),
    including the non-stereo-IR rejection that returns the input unchanged.
    """
    if data is None or data.size == 0:
        return np.zeros((0, 2), dtype=np.float32)
    if (
        external_ir_data is None
        or not isinstance(external_ir_data, np.ndarray)
        or external_ir_data.ndim != 2
        or external_ir_data.shape[1] != 2
    ):
        return data.astype(np.float32)

    data = _ensure_stereo(data)
    ir = external_ir_data.astype(np.float32)

    len_data = data.shape[0]
    len_ir = ir.shape[0]
    len_out_max = len_data + len_ir - 1 if len_ir > 0 else len_data
    data_padded = (
        np.pad(data, ((0, len_out_max - len_data), (0, 0)))
        if len_out_max > len_data
        else data
    )

    wet_left = fftconvolve(data[:, 0], ir[:, 0], mode="full")
    wet_right = fftconvolve(data[:, 1], ir[:, 1], mode="full")
    wet_signal = np.stack((wet_left[:len_out_max], wet_right[:len_out_max]), axis=1)

    mixed = dynamic_dry_wet_mix(data_padded, wet_signal, dry_wet, kill_start_dw)
    mixed_eq = apply_shelf_eq(mixed, rate, bass_gain, treble_gain)
    mixed_norm = _conditional_normalize(mixed_eq)
    return mixed_norm.astype(np.float32)


# ---------------------------------------------------------------------------
# Spatialization
# ---------------------------------------------------------------------------

def surround_panning_gains(x_pos: float, y_pos: float, z_pos: float) -> dict:
    """Scalar 5.1 pan gains from normalized 3D position.

    The gain math of apply_surround_panning_3d (raytracer_studio.py:474-485),
    exposed separately so the JAX pipeline can consume identical scalars.
    """
    x = float(np.clip(float(x_pos), 0.0, 1.0))
    y = float(np.clip(float(y_pos), 0.0, 1.0))
    z = float(np.clip(float(z_pos), 0.0, 1.0))

    gain_l = math.sqrt(1.0 - x)
    gain_r = math.sqrt(x)
    gain_f_base = math.sqrt(1.0 - y)
    gain_re_base = math.sqrt(y)
    z_effect_scale = abs(y - 0.5) * config.PAN_Z_EFFECT_SCALE
    z_pull = (0.5 - z) * z_effect_scale
    gain_f = max(0.0, gain_f_base + z_pull)
    gain_re = max(0.0, gain_re_base - z_pull)

    center_x_factor = math.cos((x - 0.5) * math.pi)
    return {
        "fl": gain_l * gain_f,
        "fr": gain_r * gain_f,
        "rl": gain_l * gain_re,
        "rr": gain_r * gain_re,
        "center": center_x_factor * gain_f,
        "lfe": config.PAN_LFE_GAIN,
    }


def apply_surround_panning(
    audio_data: np.ndarray, x_pos: float, y_pos: float, z_pos: float
) -> np.ndarray:
    """Stereo → 5.1 constant-power pan (raytracer_studio.py:464-505)."""
    if audio_data is None or audio_data.size == 0:
        return np.zeros((0, 6), dtype=np.float32)
    audio = _ensure_stereo(audio_data)
    g = surround_panning_gains(x_pos, y_pos, z_pos)
    mono = (audio[:, 0] + audio[:, 1]) * config.PAN_MONO_MIX_GAIN

    out = np.zeros((audio.shape[0], 6), dtype=np.float32)
    out[:, 0] = audio[:, 0] * g["fl"]
    out[:, 1] = audio[:, 1] * g["fr"]
    out[:, 2] = mono * g["center"]
    out[:, 3] = mono * g["lfe"]
    out[:, 4] = audio[:, 0] * g["rl"]
    out[:, 5] = audio[:, 1] * g["rr"]
    return _conditional_normalize(out).astype(np.float32)


def apply_delay(signal: np.ndarray, delay_samples: int) -> np.ndarray:
    """Zero-pad front, trim tail to original length (raytracer_studio.py:507-515)."""
    if signal.ndim != 2:
        return signal
    delay_samples = int(delay_samples)
    if delay_samples <= 0:
        return signal
    num_samples, num_channels = signal.shape
    padding = np.zeros((delay_samples, num_channels), dtype=signal.dtype)
    return np.concatenate((padding, signal), axis=0)[:num_samples, :]


def map_channels(
    data_5_1: np.ndarray, target_layout_name: str, rate: int, z_pos: float = 0.5
) -> tuple[np.ndarray, list[str]]:
    """Map internal 6-channel audio onto the target layout.

    Semantics of map_channels (raytracer_studio.py:517-571): stereo downmix
    (C·0.707 + rear·0.5), identity 5.1, delayed/attenuated side channels for
    7.1, z-scaled delayed height channels for 5.1.2.
    """
    if target_layout_name not in config.CHANNEL_LAYOUTS:
        target_layout_name = config.DEFAULT_CHANNEL_LAYOUT
    layout = config.CHANNEL_LAYOUTS[target_layout_name]
    target_channels = layout["channels"]
    target_names = list(layout["names"])

    if data_5_1 is None or data_5_1.ndim != 2 or data_5_1.shape[1] != 6:
        return np.zeros((0, target_channels), dtype=np.float32), target_names

    num_samples = data_5_1.shape[0]
    out = np.zeros((num_samples, target_channels), dtype=data_5_1.dtype)

    if target_layout_name == "Stereo":
        c = config.DOWNMIX_CENTER_GAIN
        r = config.DOWNMIX_REAR_GAIN
        out[:, 0] = data_5_1[:, 0] + data_5_1[:, 2] * c + data_5_1[:, 4] * r
        out[:, 1] = data_5_1[:, 1] + data_5_1[:, 2] * c + data_5_1[:, 5] * r
    elif target_layout_name == "5.1 (Standard)":
        out = data_5_1
    elif target_layout_name == "7.1 (Surround)":
        out[:, 0:6] = data_5_1[:, 0:6]
        delay = int(rate * config.SIDE_DELAY_MS / 1000)
        out[:, 6:7] = apply_delay(data_5_1[:, 4:5], delay) * config.SIDE_GAIN
        out[:, 7:8] = apply_delay(data_5_1[:, 5:6], delay) * config.SIDE_GAIN
    elif target_layout_name == "5.1.2 (Atmos Light)":
        out[:, :6] = data_5_1[:, :6]
        delay = int(rate * config.HEIGHT_DELAY_MS / 1000)
        height_gain = float(np.clip(float(z_pos), 0.0, 1.0)) * config.HEIGHT_Z_GAIN
        out[:, 6:7] = apply_delay(data_5_1[:, 4:5], delay) * height_gain
        out[:, 7:8] = apply_delay(data_5_1[:, 5:6], delay) * height_gain

    out = _conditional_normalize(out)
    return out, target_names


# ---------------------------------------------------------------------------
# Full render
# ---------------------------------------------------------------------------

def render(
    audio: np.ndarray,
    rate: int,
    p: RenderParams,
    draws: Optional[IRDraws] = None,
    rng: Optional[np.random.Generator] = None,
    external_ir: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Full pipeline: stereo-ize → convolve → pan → layout-map.

    The compute path of apply_raytrace_convolution_3d
    (raytracer_studio.py:991-1084) without the file I/O shell.  Either
    ``draws`` (explicit randomness) or ``rng`` (seeded Generator) must be
    given for the internal-hall path.
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[:, np.newaxis]
    samples_stereo = _ensure_stereo(audio)

    if p.use_external_ir:
        if external_ir is None:
            raise ValueError("use_external_ir=True requires external_ir data")
        output_stereo = convolve_audio_external_ir(
            samples_stereo,
            np.asarray(external_ir, dtype=np.float32),
            p.dry_wet,
            p.bass_gain,
            p.treble_gain,
            rate,
            p.dry_wet_kill_start,
        )
    else:
        adj_duration, adj_ref_count, adj_max_delay, adj_split = adjust_parameters_for_3d(
            p.hall_type, p.room_size, p.z_pos
        )
        directionality = compute_final_directionality_3d(
            p.x_pos, p.y_pos, p.z_pos, p.hall_type, p.diffusion, p.dry_wet
        )
        geometry = derive_ir_geometry(
            rate,
            adj_duration,
            adj_ref_count,
            adj_max_delay,
            p.material,
            directionality,
            adj_split,
            p.diffusion,
        )
        if draws is None:
            if rng is None:
                raise ValueError("internal hall render requires draws or rng")
            draws = IRDraws.sample(rng, geometry)
        early_ir, late_ir = generate_impulse_response_split(geometry, draws)
        early_lvl, late_lvl = adapt_early_late_levels(
            p.dry_wet, p.early_level, p.late_level
        )
        output_stereo = convolve_audio_split(
            samples_stereo,
            early_ir,
            late_ir,
            early_lvl,
            late_lvl,
            p.dry_wet,
            p.bass_gain,
            p.treble_gain,
            rate,
            p.dry_wet_kill_start,
            p.air_absorption,
        )

    surround = apply_surround_panning(output_stereo, p.x_pos, p.y_pos, p.z_pos)
    final, _names = map_channels(surround, p.target_layout, rate, p.z_pos)
    return final


def quantize_pcm16(x: np.ndarray) -> np.ndarray:
    """Clip to ±0.9999, scrub non-finite values, quantize to int16.

    The output contract of raytracer_studio.py:1082-1084 (libsndfile PCM_16:
    scale by 32768 with round-half-even, matching lrintf).
    """
    clipped = np.clip(x, -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
    clipped = np.nan_to_num(clipped, nan=0.0, posinf=0.0, neginf=0.0)
    return np.rint(clipped * 32768.0).astype(np.int16)
