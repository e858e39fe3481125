"""Visualizer: per-channel waveforms + spectrogram PNG for a WAV file.

Product-parity port of plot_waveform_and_spectrogram_v4
(/root/reference/raytracer_studio.py:573-672): layout detection by channel
count, ≤4 waveform rows × 2 columns, symlog-frequency spectrogram of channel
0 with duration-adaptive FFT size and a [max(median−40, max−80), max] dB
color scale, error-PNG fallback.  Matplotlib stays host-side; the STFT can
run on device via the JAX path.
"""

from __future__ import annotations

import functools
import os
import tempfile
import traceback
from typing import Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from .. import config
from ..utils import wavio


def detect_layout_names(channels: int) -> list[str]:
    """Channel names by count, falling back to Ch N (ref :592-594)."""
    for layout_info in config.CHANNEL_LAYOUTS.values():
        if layout_info["channels"] == channels:
            return list(layout_info["names"])
    return [f"Ch {i + 1}" for i in range(channels)]


def spectrogram_nperseg(duration: float) -> int:
    """Duration-adaptive FFT size (ref :626-628)."""
    if duration > 30:
        return 4096
    if duration > 5:
        return 2048
    return 1024


def _stft_power_jit(frames, window, scale, double_even: bool):
    """scipy-density STFT power — module-level jit body (CLAUDE.md: per-call
    jit closures re-trace every call and closure-captured scalars bake into
    HLO literals, defeating both executable caches).  ``scale`` arrives as a
    traced f32 argument; only ``double_even`` (bin-doubling layout) is static.

    Jitted so the complex |rfft|² stays inside one compiled graph."""
    import jax.numpy as jnp

    # scipy's default detrend='constant': remove each segment's mean
    fr = frames - jnp.mean(frames, axis=-1, keepdims=True)
    sx = jnp.abs(jnp.fft.rfft(fr * window, axis=-1)) ** 2 * scale
    # scipy doubles every onesided bin except DC — and except Nyquist
    # ONLY when nfft is even (an odd nfft has no pure-Nyquist bin); a
    # short clip clamps nperseg to the odd signal length, where always
    # excluding the last bin would read it 3 dB low vs use_device=False
    hi = -1 if double_even else None
    return sx.at[..., 1:hi].multiply(2.0)


@functools.lru_cache(maxsize=1)
def _stft_power_compiled():
    import jax

    return jax.jit(_stft_power_jit, static_argnames=("double_even",))


def compute_spectrogram(
    data: np.ndarray, rate: int, nperseg: int, use_device: bool = False
):
    """Hann spectrogram (f, t, Sxx).  use_device routes the STFT through JAX."""
    if use_device:
        import jax.numpy as jnp

        hop = nperseg // 2
        n = data.shape[0]
        num_frames = max(1, (n - nperseg) // hop + 1)
        idx = np.arange(num_frames)[:, None] * hop + np.arange(nperseg)[None, :]
        frames = jnp.asarray(data)[idx]
        # periodic hann, exactly scipy.signal.spectrogram's default window
        # (np.hanning is the symmetric variant — ~0.1% different Σw²)
        from scipy.signal import get_window

        win_np = get_window("hann", nperseg).astype(np.float32)
        # scipy 'density' scaling: |X|²/(fs·Σw²), interior bins doubled
        scale = 1.0 / (rate * float(np.sum(win_np.astype(np.float64) ** 2)))
        sxx = _stft_power_compiled()(
            frames,
            jnp.asarray(win_np),
            jnp.float32(scale),
            double_even=(nperseg % 2 == 0),
        )
        f = np.fft.rfftfreq(nperseg, 1.0 / rate)
        t = (np.arange(num_frames) * hop + nperseg / 2) / rate
        return f, t, np.asarray(sxx).T
    from scipy.signal import spectrogram as scipy_spectrogram

    return scipy_spectrogram(
        data, fs=rate, nperseg=nperseg, noverlap=nperseg // 2, window="hann"
    )


def plot_waveform_and_spectrogram(
    file_path, title: str = "Audio", use_device_stft: bool = False
) -> Optional[str]:
    """Render the analysis PNG; returns its temp path (error-PNG on failure)."""
    actual_path = getattr(file_path, "name", file_path)
    fig = None
    try:
        if not actual_path or not isinstance(actual_path, str) or not os.path.exists(actual_path):
            raise FileNotFoundError(f"Ungültiger Pfad '{actual_path}'")
        data_float, rate = wavio.read(actual_path)
        if data_float.size == 0:
            raise ValueError(f"Leere Audiodaten: {os.path.basename(actual_path)}")
        channels = data_float.shape[1]
        duration = data_float.shape[0] / rate if rate > 0 else 0

        plot_ch_names = detect_layout_names(channels)

        max_wf_rows = 4
        wf_rows = min(max_wf_rows, (channels + 1) // 2)
        total_rows = wf_rows + 1
        height_ratios = [1] * wf_rows + [max(2, wf_rows)]
        fig_height = 2.0 * total_rows + 1.0
        fig = plt.figure(figsize=(12, fig_height))
        gs = fig.add_gridspec(
            total_rows, 2, height_ratios=height_ratios, hspace=0.5, wspace=0.15
        )
        fig.suptitle(
            f"Audioanalyse: {title} - {os.path.basename(actual_path)} ({channels}-Kanal)",
            fontsize=14,
        )
        time_axis = (
            np.linspace(0, duration, num=data_float.shape[0])
            if rate > 0
            else np.arange(data_float.shape[0])
        )

        base_ax = None
        for i in range(channels):
            row, col = i // 2, i % 2
            if row >= wf_rows:
                break
            ax = fig.add_subplot(gs[row, col], sharex=base_ax)
            if base_ax is None:
                base_ax = ax
            ax.plot(time_axis, data_float[:, i], lw=1)
            ax.set_title(plot_ch_names[i], fontsize=9)
            ax.grid(True, linestyle=":", alpha=0.6)
            ax.set_ylim([-1.05, 1.05])
            ax.axhline(0, color="black", linewidth=0.5, alpha=0.5)
            if col == 0:
                ax.set_ylabel("Amplitude", fontsize="small")
            if row < wf_rows - 1:
                plt.setp(ax.get_xticklabels(), visible=False)

        spec_ax = fig.add_subplot(gs[wf_rows, :], sharex=base_ax)
        spec_data = data_float[:, 0]
        if spec_data.size > 0 and rate > 0:
            try:
                nperseg = min(spectrogram_nperseg(duration), spec_data.shape[0])
                if nperseg < 2:
                    raise ValueError("Signal zu kurz für Spektrogramm.")
                f, t, sxx = compute_spectrogram(
                    spec_data, rate, nperseg, use_device=use_device_stft
                )
                sxx_db = 10 * np.log10(np.maximum(sxx, 1e-10))
                median_db, max_db = np.median(sxx_db), np.max(sxx_db)
                vmin = max(median_db - 40, max_db - 80)
                vmax = max_db
                if vmin >= vmax:
                    vmin = vmax - 10
                img = spec_ax.pcolormesh(
                    t, f, sxx_db, shading="auto", cmap="magma",
                    vmin=vmin, vmax=vmax, rasterized=True,
                )
                spec_ax.set_yscale("symlog", linthresh=100, linscale=0.5)
                spec_ax.set_ylim(bottom=20, top=rate / 2)
                cbar = fig.colorbar(img, ax=spec_ax, format="%+2.0f dB", pad=0.01, aspect=40)
                cbar.set_label("Intensität (dB)", size="small")
            except Exception as spe:  # noqa: BLE001 — plot must still save
                spec_ax.text(
                    0.5, 0.5, f"Spektrogramm Fehler:\n{type(spe).__name__}",
                    ha="center", va="center", color="orange", transform=spec_ax.transAxes,
                )
            spec_ax.set_title(f"Spektrogramm ({plot_ch_names[0]})", fontsize=12)
            spec_ax.set_ylabel("Frequenz (Hz)")
            spec_ax.set_xlabel("Zeit (s)")
        else:
            spec_ax.text(
                0.5, 0.5, "Keine Daten für Spektrogramm.",
                ha="center", va="center", transform=spec_ax.transAxes,
            )

        plt.tight_layout(rect=[0, 0.03, 1, 0.96])
        with tempfile.NamedTemporaryFile(delete=False, suffix=".png", prefix="vis_v4_") as tmp:
            plot_path = tmp.name
        plt.savefig(plot_path, dpi=120)
        return plot_path
    except Exception as e:  # noqa: BLE001 — error-PNG fallback (ref :659-669)
        traceback.print_exc()
        try:
            err_fig, err_ax = plt.subplots(1, 1, figsize=(10, 3))
            err_ax.text(
                0.5, 0.5, f"Fehler beim Plotten:\n{type(e).__name__}: {str(e)[:100]}",
                ha="center", va="center", color="red", fontsize=9, wrap=True,
            )
            err_ax.set_axis_off()
            with tempfile.NamedTemporaryFile(delete=False, suffix=".png", prefix="vis_err_") as tmp:
                error_path = tmp.name
            err_fig.savefig(error_path)
            plt.close(err_fig)
            return error_path
        except Exception:  # noqa: BLE001
            return None
    finally:
        if fig is not None:
            plt.close(fig)
