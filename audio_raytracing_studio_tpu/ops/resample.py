"""Sample-rate conversion on device.

Two complementary converters:

- ``resample_fft``: Fourier resampling with ``scipy.signal.resample``'s
  exact semantics (spectrum truncation / zero-padding, unpaired-Nyquist-bin
  handling) — the method the reference uses on external IRs
  (raytracer_studio.py:1037-1040, via scipy).  Arbitrary in/out lengths run
  through the exact-length transforms of ``ops.fftops`` (Bluestein over
  pow2 FFTs — this backend lowers non-pow2 FFTs to dense O(n²) matmuls).

- ``resample_poly``: polyphase windowed-sinc rate conversion expressed as a
  single ``lax.conv_general_dilated`` (zero-stuffing as ``lhs_dilation``,
  decimation as ``window_strides``) — the accelerator form: one fused XLA
  convolution, static shapes, no gathers.  Used by the analyzer's
  ``convert --samplerate`` (a rebuild extension; the reference's converter
  can only change containers, not rates, analyser.py:73-83).

Both operate on float32 ``(n,)`` or ``(n, channels)`` arrays and accept
NumPy or device inputs.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from . import fftops


def resample_fft(x: jnp.ndarray, num: int) -> jnp.ndarray:
    """Fourier-resample the leading axis to ``num`` samples.

    Matches ``scipy.signal.resample(x, num, axis=0)`` for real input: keep
    the ``min(num, n)//2 + 1`` lowest rfft bins, double/halve the unpaired
    bin at ``m//2`` when ``m = min(num, n)`` is even, inverse-transform at
    the new length, scale by ``num/n``.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = int(x.shape[0])
    num = int(num)
    if n < 2 or num < 1:
        raise ValueError(f"cannot resample {n} samples to {num}")
    if num == n:
        return x[:, 0] if squeeze else x
    out = _resample_fft_jit(x, num)
    return out[:, 0] if squeeze else out


@functools.partial(jax.jit, static_argnums=(1,))
def _resample_fft_jit(x: jnp.ndarray, num: int) -> jnp.ndarray:
    # jitted: the Bluestein chirp products are complex64 multiplies, kept
    # inside one compiled graph
    n = int(x.shape[0])
    m = min(num, n)
    m2 = m // 2 + 1
    spec = fftops.rfft_exact(x.T, n)[..., :m2]
    if m % 2 == 0:  # unpaired bin at m//2 (num == n handled by the caller)
        spec = spec.at[..., m // 2].multiply(2.0 if num < n else 0.5)
    if num > n:  # upsampling: zero-pad the half spectrum to the new length
        spec = jnp.pad(spec, [(0, 0)] * (spec.ndim - 1) + [(0, num // 2 + 1 - m2)])
    out = fftops.irfft_exact(spec, num).T * (np.float32(num) / np.float32(n))
    return out.astype(jnp.float32)


@functools.lru_cache(maxsize=32)
def _kaiser_sinc_filter(up: int, down: int, half_width: int, beta: float):
    """Host-designed lowpass prototype for L=up / M=down conversion.

    Kaiser-windowed sinc at cutoff ``1/max(up, down)`` (normalized to the
    upsampled Nyquist), ``2·half_width·max(up, down) + 1`` taps, unit DC
    gain scaled by ``up`` to preserve amplitude through zero-stuffing.
    Returns float32 NumPy (device constants materialize per trace).
    """
    max_rate = max(up, down)
    half_len = half_width * max_rate
    k = np.arange(-half_len, half_len + 1, dtype=np.float64)
    cutoff = 1.0 / max_rate  # fraction of the upsampled Nyquist
    h = cutoff * np.sinc(cutoff * k)
    h *= np.kaiser(2 * half_len + 1, beta)
    h /= h.sum()  # exact unit DC gain
    return (h * up).astype(np.float32), half_len


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _poly_kernel(x_cn: jnp.ndarray, up: int, down: int, n_out: int, half_width: int):
    h_np, half_len = _kaiser_sinc_filter(up, down, half_width, 8.555)
    h = jnp.asarray(h_np)
    k = int(h.shape[0])
    n_up = (x_cn.shape[-1] - 1) * up + 1
    pad_right = (n_out - 1) * down + k - half_len - n_up
    out = jax.lax.conv_general_dilated(
        x_cn[:, None, :],  # (C, 1, N) — NCH layout
        h[None, None, :],  # (1, 1, K)
        window_strides=(down,),
        padding=((half_len, max(pad_right, 0)),),
        lhs_dilation=(up,),
        # a default-precision conv may run in bf16/TF32 on an accelerator
        # (~-50 dB error), swamping the Kaiser stopband
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :n_out]


def resample_poly(x: jnp.ndarray, rate_out: int, rate_in: int,
                  half_width: int = 10) -> jnp.ndarray:
    """Polyphase-resample the leading axis from ``rate_in`` to ``rate_out``.

    Output length is ``ceil(n · rate_out / rate_in)``; ``half_width`` is
    the number of sinc zero-crossings kept per side (10 ≈ −80 dB Kaiser
    stopband).  One ``conv_general_dilated`` per call: the zero-stuffed
    upsample is ``lhs_dilation`` and the decimation is the window stride,
    so XLA sees a single dilated convolution with static shapes.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = int(x.shape[0])
    if n < 2 or rate_in <= 0 or rate_out <= 0:
        raise ValueError(f"cannot resample {n} samples {rate_in}→{rate_out}")
    g = math.gcd(int(rate_in), int(rate_out))
    up, down = int(rate_out) // g, int(rate_in) // g
    if up == down:
        return x[:, 0] if squeeze else x
    n_out = -(-n * up // down)  # ceil
    out = _poly_kernel(x.T, up, down, n_out, half_width).T
    return out[:, 0] if squeeze else out
