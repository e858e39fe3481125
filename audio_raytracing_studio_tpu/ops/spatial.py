"""Spatialization as matrix ops: 3D pan (2→6) and layout mapping (6→{2,6,8}).

The reference's per-channel assignments (raytracer_studio.py:464-505) and
mapping branches (:517-571) become einsums against small mixing matrices plus
two static integer delays — the form XLA fuses into the surrounding graph.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

from .. import config


def pan_matrix(
    x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray
) -> jnp.ndarray:
    """(2, 6) stereo→5.1 mixing matrix from traced position scalars.

    Row = input channel (L, R); column = [FL, FR, C, LFE, RL, RR].
    C and LFE rows fold in the reference's mono mixdown (L+R)·0.707
    (raytracer_studio.py:483-485).
    """
    x = jnp.clip(x, 0.0, 1.0)
    y = jnp.clip(y, 0.0, 1.0)
    z = jnp.clip(z, 0.0, 1.0)

    gain_l = jnp.sqrt(1.0 - x)
    gain_r = jnp.sqrt(x)
    gain_f_base = jnp.sqrt(1.0 - y)
    gain_re_base = jnp.sqrt(y)
    z_pull = (0.5 - z) * (jnp.abs(y - 0.5) * config.PAN_Z_EFFECT_SCALE)
    gain_f = jnp.maximum(0.0, gain_f_base + z_pull)
    gain_re = jnp.maximum(0.0, gain_re_base - z_pull)

    fl = gain_l * gain_f
    fr = gain_r * gain_f
    rl = gain_l * gain_re
    rr = gain_r * gain_re
    center = jnp.cos((x - 0.5) * jnp.pi) * gain_f
    mono = config.PAN_MONO_MIX_GAIN
    c_coef = mono * center
    lfe_coef = mono * config.PAN_LFE_GAIN

    zero = jnp.zeros_like(fl)
    row_l = jnp.stack([fl, zero, c_coef, lfe_coef, rl, zero])
    row_r = jnp.stack([zero, fr, c_coef, lfe_coef, zero, rr])
    return jnp.stack([row_l, row_r]).astype(jnp.float32)  # (2, 6)


def apply_pan(audio: jnp.ndarray, matrix: jnp.ndarray) -> jnp.ndarray:
    """audio (..., 2, n) @ pan matrix (2, 6) → (..., 6, n).

    Channel mixes are deliberately elementwise, not einsum: a
    default-precision matmul may run in bf16/TF32 on an accelerator —
    ~0.3% error on every sample, far past the 1e-3 parity budget — and the
    2×6 contraction is too small to earn a matmul anyway.
    """
    left = audio[..., 0, :]
    right = audio[..., 1, :]
    out = [left * matrix[0, c] + right * matrix[1, c] for c in range(6)]
    return jnp.stack(out, axis=-2)


def _delay_last_axis(x: jnp.ndarray, delay: int) -> jnp.ndarray:
    """Zero-pad front, trim tail — apply_delay (raytracer_studio.py:507-515)."""
    if delay <= 0:
        return x
    n = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(delay, 0)]
    return jnp.pad(x, pad)[..., :n]


def map_layout(
    data_6ch: jnp.ndarray,
    target_layout_name: str,
    rate: int,
    z_pos: jnp.ndarray,
) -> jnp.ndarray:
    """Map (..., 6, n) onto the target layout (static branch by layout name).

    Mirrors map_channels (raytracer_studio.py:517-571) minus the trailing
    conditional normalization (the pipeline applies that separately).
    """
    if target_layout_name not in config.CHANNEL_LAYOUTS:
        target_layout_name = config.DEFAULT_CHANNEL_LAYOUT

    if target_layout_name == "Stereo":
        c = config.DOWNMIX_CENTER_GAIN
        r = config.DOWNMIX_REAR_GAIN
        left = data_6ch[..., 0, :] + data_6ch[..., 2, :] * c + data_6ch[..., 4, :] * r
        right = data_6ch[..., 1, :] + data_6ch[..., 2, :] * c + data_6ch[..., 5, :] * r
        return jnp.stack([left, right], axis=-2)

    if target_layout_name == "5.1 (Standard)":
        return data_6ch

    if target_layout_name == "7.1 (Surround)":
        delay = int(rate * config.SIDE_DELAY_MS / 1000)
        sides = _delay_last_axis(data_6ch[..., 4:6, :], delay) * config.SIDE_GAIN
        return jnp.concatenate([data_6ch, sides], axis=-2)

    # 5.1.2 (Atmos Light)
    delay = int(rate * config.HEIGHT_DELAY_MS / 1000)
    height_gain = jnp.clip(z_pos, 0.0, 1.0) * config.HEIGHT_Z_GAIN
    heights = _delay_last_axis(data_6ch[..., 4:6, :], delay) * height_gain
    return jnp.concatenate([data_6ch, heights], axis=-2)


def layout_channel_names(target_layout_name: str) -> List[str]:
    layout = config.CHANNEL_LAYOUTS.get(
        target_layout_name, config.CHANNEL_LAYOUTS[config.DEFAULT_CHANNEL_LAYOUT]
    )
    return list(layout["names"])
