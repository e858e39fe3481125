"""FFT linear convolution on device.

Replaces the reference's per-channel ``scipy.signal.fftconvolve`` calls
(/root/reference/raytracer_studio.py:362-372, :430-431) with one batched
rfft/irfft pass: all channels (and, under vmap, all clips in a batch) share
the forward transform of the signal.  Zero-padding the FFT to a hardware-
friendly length is numerically exact for linear convolution, so the output
equals the reference's ``mode='full'`` result to float32 round-off.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import fftops
from .fftops import next_power_of_two


def fast_fft_length(n: int) -> int:
    """Smallest hardware-fast transform length ≥ n (static host computation).

    Candidates are 2^k and 3·2^k (both fast transform sizes), so admitting
    the radix-3 sizes cuts worst-case zero-pad overhead from 2× to 1.33×.  Zero-padding is numerically exact for linear convolution.
    """
    if n <= 1:
        return 1
    p = next_power_of_two(n)
    m = next_power_of_two((n + 2) // 3)
    return min(p, 3 * m)


def convolve_full(
    signal: jnp.ndarray,
    kernels: jnp.ndarray,
    out_length: int,
    kernel_gains: jnp.ndarray | None = None,
    pow2: bool = False,
) -> jnp.ndarray:
    """Linear convolution of each signal channel with each kernel.

    Args:
      signal: (..., C, N) float32 — channels-leading layout keeps the FFT
        over the last (longest) axis, which XLA tiles best.
      kernels: (K, L) float32 — e.g. stacked (early, late) IRs, or per-channel
        external IRs.
      out_length: static output sample count (the reference's N+L−1 slice).
      kernel_gains: optional (K, F) per-bin gains (F = nfft//2+1) multiplied
        into each kernel's spectrum — lets a smooth filter (e.g. air
        absorption in fast mode) ride the convolution for free.

    Returns:
      (..., K, C, out_length) float32 — one convolved stream per kernel per
      channel.
    """
    n = signal.shape[-1]
    l = kernels.shape[-1]
    need = max(out_length, n + l - 1)
    # Batched renderers pass ``pow2=True`` (via StaticSpec.pow2_conv): the
    # rank-4 (batch, K, C, nfft) shape this function produces under vmap
    # padded 8-16× in memory at 3·2^k lengths on the accelerator this was
    # first built for.  Single clips and streaming chunks keep the cheaper
    # 3·2^k grid.  Whether batched 3·2^k grids are fine on the GPU is an
    # open A/B (ROADMAP D2) — under vmap this trace only sees the
    # per-example shape, so no heuristic here can detect the batch.
    if kernel_gains is not None:
        # gains are (K, F) per-bin curves built by the caller — the grid is
        # fixed by their bin count, so a pow2 override cannot desync them
        nfft = 2 * (kernel_gains.shape[-1] - 1)
        if nfft < need:
            raise ValueError(
                f"kernel_gains imply nfft={nfft} < required {need}"
            )
    else:
        p2 = next_power_of_two(need)
        fast = fast_fft_length(need)
        if pow2 and fast < p2 and signal.shape[-2] == 2:
            # Batched context, but the 3·2^k grid is still reachable: pack
            # the stereo pair into one complex stream and run the transform
            # through the explicit radix-3 decimation (fftops.fft_fast) —
            # only pow2 device FFTs are issued, so the rank-4 3·2^k layout
            # hazard above never arises, and the grid is 25% shorter.
            return _convolve_full_packed_stereo(signal, kernels, out_length, fast)
        nfft = p2 if pow2 else fast

    # flat-batching transforms (fftops.*_rows): under vmap the rank-3/4
    # shapes these produce pay a measured ~28% tiling tax vs flat rows
    sig_f = fftops.rfft_rows(fftops.pad_last(signal, nfft))  # (..., C, F)
    ker_f = fftops.rfft_rows(fftops.pad_last(kernels, nfft))  # (K, F)
    if kernel_gains is not None:
        ker_f = ker_f * kernel_gains
    prod = sig_f[..., None, :, :] * ker_f[..., :, None, :]  # (..., K, C, F)
    full = fftops.irfft_rows(prod)
    return full[..., :out_length].astype(jnp.float32)


def _convolve_full_packed_stereo(
    signal: jnp.ndarray,
    kernels: jnp.ndarray,
    out_length: int,
    nfft: int,
) -> jnp.ndarray:
    """convolve_full for C=2 via one pair-packed complex transform per pass.

    Convolution with a *real* kernel is ℝ-linear, so z = x_L + i·x_R stays
    separated: z ⊛ h = (x_L ⊛ h) + i·(x_R ⊛ h) — real/imag of the complex
    product transform ARE the two channel streams (no Hermitian splitting
    needed).  Transform count matches the rfft form (a complex FFT does the
    work of two real ones), but every FFT goes through fftops.fft_fast, so
    a 3·2^k grid is usable under a vmap batch.
    """
    z = jax.lax.complex(signal[..., 0, :], signal[..., 1, :])  # (..., N)
    zf = fftops.fft_fast(z, nfft)  # (..., nfft)
    ker_f = fftops.fft_fast(kernels, nfft)  # (K, nfft) — real in, Hermitian out
    prod = zf[..., None, :] * ker_f  # (..., K, nfft)
    conv = fftops.ifft_fast(prod)
    out = jnp.stack([jnp.real(conv), jnp.imag(conv)], axis=-2)  # (..., K, 2, nfft)
    return out[..., :out_length].astype(jnp.float32)


def convolve_combined(
    signal: jnp.ndarray,
    kernels: jnp.ndarray,
    weights: jnp.ndarray,
    out_length: int,
    kernel_gains: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Linear convolution with the weighted kernel *sum*: Σ_k w_k·(x ⊛ h_k·g_k).

    Exact (by linearity) equal to weighting the per-kernel convolutions in
    the time domain, but needs one inverse FFT per channel instead of K —
    the fast path when no per-kernel time-domain processing is required.

    signal: (..., C, N); kernels: (K, L); weights: (K,) traced scalars.
    Returns (..., C, out_length).
    """
    n = signal.shape[-1]
    l = kernels.shape[-1]
    need = max(out_length, n + l - 1)
    if kernel_gains is not None:
        # like convolve_full: the gains' bin count FIXES the grid — deriving
        # nfft from it (instead of recomputing fast_fft_length and trusting
        # the caller to have used the same expression) turns any grid
        # mismatch into this explicit error rather than a broadcast failure
        nfft = 2 * (kernel_gains.shape[-1] - 1)
        if nfft < need:
            raise ValueError(f"kernel_gains imply nfft={nfft} < required {need}")
    else:
        nfft = fast_fft_length(need)

    sig_f = fftops.rfft_rows(fftops.pad_last(signal, nfft))  # (..., C, F)
    ker_f = fftops.rfft_rows(fftops.pad_last(kernels, nfft))  # (K, F)
    if kernel_gains is not None:
        ker_f = ker_f * kernel_gains
    # elementwise weighted sum over the tiny K axis (a default-precision
    # tensordot could run at reduced precision on an accelerator)
    combined = jnp.sum(weights.astype(ker_f.dtype)[:, None] * ker_f, axis=0)  # (F,)
    full = fftops.irfft_rows(sig_f * combined)
    return full[..., :out_length].astype(jnp.float32)


def convolve_pairwise(signal: jnp.ndarray, kernels: jnp.ndarray, out_length: int) -> jnp.ndarray:
    """True-stereo convolution: channel c ⊛ kernel c (external-IR mode).

    Args:
      signal: (..., C, N); kernels: (C, L); → (..., C, out_length).
    Matches convolve_audio_external_ir's L⊛IR_L / R⊛IR_R pairing
    (raytracer_studio.py:430-431).
    """
    n = signal.shape[-1]
    l = kernels.shape[-1]
    nfft = fast_fft_length(max(out_length, n + l - 1))
    sig_f = fftops.rfft_rows(fftops.pad_last(signal, nfft))
    ker_f = fftops.rfft_rows(fftops.pad_last(kernels, nfft))
    full = fftops.irfft_rows(sig_f * ker_f)
    return full[..., :out_length].astype(jnp.float32)
