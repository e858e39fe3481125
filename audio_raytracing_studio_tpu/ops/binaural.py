"""Binaural (headphone) downmix of surround renders — rebuild extension.

The reference's docs explain why its surround renders still read as spatial
on stereo headphones (ITD/ILD survive a plain downmix) but it ships no
binaural renderer.  This module adds one: a parametric spherical-head model
(no external HRTF data) applied in the frequency domain, one pass:

  Ear(f) = Σ_ch X_ch(f) · G_ild(ch, ear, f) · e^{−i 2π f τ_itd(ch, ear)}

- ITD: Woodworth spherical-head delay τ(θ) = (a/c)·(θ + sin θ) toward the
  contralateral ear (a = 8.75 cm head radius),
- ILD: frequency-dependent head shadow — a smooth high-frequency rolloff on
  the contralateral ear that deepens with source azimuth,
- elevation (5.1.2 height channels): gentle presence-band tilt, the dominant
  monaural elevation cue that survives non-individualized rendering.

Channel azimuths follow ITU-R BS.775 speaker placement.  Everything is a
host-precomputed complex gain table × one batched FFT — XLA-friendly and
exact for any clip length via zero-padded pow2 transforms.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from . import fftops
from .fftops import next_power_of_two

HEAD_RADIUS_M = 0.0875
SPEED_OF_SOUND = 343.0

# (azimuth degrees, elevation degrees) per channel name; azimuth >0 = right.
CHANNEL_ANGLES = {
    "FL": (-30.0, 0.0),
    "FR": (30.0, 0.0),
    "C": (0.0, 0.0),
    "LFE": (0.0, 0.0),
    "RL": (-110.0, 0.0),
    "RR": (110.0, 0.0),
    "SL": (-90.0, 0.0),
    "SR": (90.0, 0.0),
    "TFL": (-45.0, 45.0),
    "TFR": (45.0, 45.0),
}


def _itd_seconds(azimuth_rad: float) -> float:
    """Woodworth ITD toward the far ear for a source at ``azimuth``."""
    a = abs(azimuth_rad)
    return HEAD_RADIUS_M / SPEED_OF_SOUND * (a + math.sin(a))


def _ear_filters(
    azimuth_deg: float, elevation_deg: float, freqs: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Complex (left, right) ear responses for one source direction."""
    az = math.radians(azimuth_deg)
    out = []
    for ear_sign in (-1.0, 1.0):  # -1 = left ear, +1 = right ear
        same_side = az * ear_sign >= 0
        # ITD: far ear delayed; near ear reference
        tau = 0.0 if same_side else _itd_seconds(az)
        phase = np.exp(-2j * np.pi * freqs * tau)

        # ILD head shadow: first-order rolloff on the far ear whose corner
        # drops with azimuth (fully lateral source → ~1.2 kHz corner, ~9 dB
        # deep at 8 kHz); near ear gets a mild bright boost.
        lateral = abs(math.sin(az))
        if same_side:
            gain = 1.0 + 0.15 * lateral * np.clip(freqs / 4000.0, 0.0, 1.5)
        else:
            fc = 12000.0 - 10800.0 * lateral  # 12 kHz (front) → 1.2 kHz (side)
            gain = 1.0 / np.sqrt(1.0 + (freqs / max(fc, 200.0)) ** 2)
            gain *= 1.0 - 0.25 * lateral

        # Elevation: presence-band (~7 kHz) tilt upward for height channels.
        if elevation_deg > 0:
            bump = 0.2 * (elevation_deg / 45.0)
            gain = gain * (1.0 + bump * np.exp(-(((freqs - 7000.0) / 2500.0) ** 2)))

        out.append(gain * phase)
    return out[0], out[1]


@functools.lru_cache(maxsize=4)
def _binaural_table(layout_key: tuple, rate: int, nfft: int) -> np.ndarray:
    """(num_channels, 2, nfft//2+1) complex64 ear-filter table (host).

    maxsize stays SMALL: one entry is ~nfft·C·16 bytes (~0.8 GB at a
    3-minute 48 kHz clip), so a large cache could pin tens of GB of host
    RAM on this 1-core box when render_dir sweeps many length buckets."""
    freqs = np.fft.rfftfreq(nfft, 1.0 / rate)
    table = np.zeros((len(layout_key), 2, len(freqs)), dtype=np.complex64)
    for i, name in enumerate(layout_key):
        az, el = CHANNEL_ANGLES.get(name, (0.0, 0.0))
        left, right = _ear_filters(az, el, freqs)
        # constant-power normalization over ears
        table[i, 0] = left / math.sqrt(2.0)
        table[i, 1] = right / math.sqrt(2.0)
    return table


@functools.partial(jax.jit, static_argnums=(3, 4))
def _binaural_mix(data_cn, table_re, table_im, nfft: int, n: int):
    # jitted, and the ear-filter table arrives as real/imag float32 pairs:
    # complex values exist only inside the compiled graph
    table = jax.lax.complex(table_re, table_im)
    spec = fftops.rfft_rows(fftops.pad_last(data_cn, nfft))
    # elementwise sum over the small channel axis — a default-precision
    # einsum could run at reduced precision (bf16/TF32) on an accelerator
    ears = jnp.sum(spec[:, None, :] * table, axis=0)
    return fftops.irfft_rows(ears)[:, :n].astype(jnp.float32)


def binauralize(data_nc: np.ndarray, rate: int, layout_name: str) -> np.ndarray:
    """Surround (n, C) → binaural stereo (n, 2) for headphone playback."""
    layout = config.CHANNEL_LAYOUTS.get(layout_name)
    if layout is None or layout["channels"] != data_nc.shape[1]:
        raise ValueError(
            f"layout {layout_name!r} does not match {data_nc.shape[1]} channels"
        )
    names = tuple(layout["names"])
    n = data_nc.shape[0]
    # Bucket the static shape to the half-second grid: every distinct clip
    # length would otherwise be a fresh trace + compile (cli.render_dir
    # renders many lengths) and a
    # fresh 100+ MB ear-table cache entry.  Zero-padding is exact here —
    # the mix is linear and the output is trimmed back to n.
    from ..parallel.sharding import bucket_length

    n_bucket = bucket_length(n, rate)
    # FFT headroom: the ITD delay in SAMPLES scales with the rate (~0.00073 s
    # for a fully lateral source — 35 samples at 48 kHz but ~280 at 384 kHz),
    # so a fixed pad would wrap the delayed contralateral tail into the clip
    # start at high rates; +256 covers the zero-phase shadow-filter smear.
    max_itd = max(
        _itd_seconds(math.radians(CHANNEL_ANGLES.get(nm, (0.0, 0.0))[0]))
        for nm in names
    )
    # power of two ONLY: this rfft runs over 6-8 channel rows, the batched
    # case the render conv also keeps on pow2 grids (ROADMAP D2)
    nfft = next_power_of_two(n_bucket + int(math.ceil(max_itd * rate)) + 256)

    padded = data_nc.astype(np.float32)
    if n_bucket > n:
        padded = np.pad(padded, ((0, n_bucket - n), (0, 0)))
    table = _binaural_table(names, int(rate), nfft)
    out = _binaural_mix(
        jnp.asarray(padded.T),
        jnp.asarray(np.ascontiguousarray(table.real, dtype=np.float32)),
        jnp.asarray(np.ascontiguousarray(table.imag, dtype=np.float32)),
        nfft, n_bucket,
    )
    return np.asarray(out, dtype=np.float32).T[:n]
