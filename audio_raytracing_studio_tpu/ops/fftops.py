"""Exact arbitrary-length FFTs via Bluestein's chirp-z transform.

The reference applies its EQ and air-absorption filters as circular gain
curves at the *exact* signal length (raytracer_studio.py:318, :392) — a
parity-bearing choice (see ops.filters).  This module keeps every device
transform at a power-of-two (or 3·2^k) length; whether cuFFT's native
arbitrary-length transforms can replace it is an open A/B (ROADMAP D1),
and the traced-length EQ (ops.chirp) needs it regardless.  Bluestein
re-expresses a length-n DFT as one length-m
(power-of-two, m ≥ 2n−1) convolution:

    X[k] = w[k] · IFFT_m( FFT_m(x·w) · B )[k],   w[k] = exp(−iπ k² / n)

with the chirp ``w`` and the spectrum ``B`` of the symmetric chirp kernel
precomputed on host in float64 (k² is reduced mod 2n in int64 so the phase
stays exact even at n ~ 10⁷).  Cost: ~3 power-of-two FFTs per transform.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _rows_transform(fn, grid_of=None):
    """Last-axis device transform that batches FLAT (custom_vmap).

    Rank mattered on the accelerator this was first built for: the same 96
    pow2-FFT rows ran ~1.4× faster as a flat (96, m) op than as a rank-3
    (48, 2, m) op (tools/profile_conv.py; not yet measured on the GPU,
    ROADMAP D1).  The batched renderers build their transforms under ``jax.vmap``, where a
    reshape inside the per-example trace cannot collapse the batch axis —
    so the collapse is expressed as a *custom batching rule*: under vmap
    (nested vmaps included — the rule re-enters itself) all leading batch
    dims flatten into one row axis around the transform, and the reshapes
    are free (leading-dim collapse of a row-major array is a bitcast).

    Only POWER-OF-TWO grids flatten.  The real 3·2^k transforms are
    left alone: at a non-pow2 grid the rule reproduces the pre-flattening batched op
    bit-for-bit (fft along the last axis is row-independent, so applying
    ``fn`` to the full-rank batched array IS what vmap would have built).
    ``grid_of`` maps the batched array's last dim to the time-domain grid
    length (identity for complex transforms; 2·(F−1) for irfft).

    ``ARS_FLAT_FFT=0`` (read at import) disables the custom rule entirely
    — every call lowers exactly like the raw jnp.fft op, batched or not —
    the A/B switch for isolating this change in measurements on the card.
    """
    grid_of = grid_of or (lambda last: last)
    import os

    if os.environ.get("ARS_FLAT_FFT", "1") == "0":
        return fn
    wrapped = jax.custom_batching.custom_vmap(fn)

    @wrapped.def_vmap
    def _rule(axis_size, in_batched, z):  # noqa: ARG001 — jax API shape
        (zb,) = in_batched
        if not zb:
            return wrapped(z), False
        if not is_power_of_two(grid_of(z.shape[-1])):
            return fn(z), True
        if z.ndim <= 2:
            return wrapped(z), True
        out = wrapped(z.reshape((-1, z.shape[-1])))
        return out.reshape(z.shape[:-1] + (out.shape[-1],)), True

    return wrapped


# Flat-batching device transforms (use these instead of raw jnp.fft.* on any
# array that can acquire batch dims under vmap).  Length is implicit: pad the
# last axis to the grid FIRST (``pad_last``) — jnp.fft's ``n=`` kwarg does the
# same pad internally, so this costs nothing extra.  ``irfft_rows`` implies an
# even output length 2·(F−1) — every conv/filter grid here is even; odd exact
# lengths go through the Bluestein path, not these.
fft_rows = _rows_transform(lambda z: jnp.fft.fft(z, axis=-1))
ifft_rows = _rows_transform(lambda z: jnp.fft.ifft(z, axis=-1))
rfft_rows = _rows_transform(lambda x: jnp.fft.rfft(x, axis=-1))
irfft_rows = _rows_transform(
    lambda z: jnp.fft.irfft(z, axis=-1), grid_of=lambda f: 2 * (f - 1)
)


def pad_last(x: jnp.ndarray, m: int) -> jnp.ndarray:
    """Zero-pad (or truncate) the last axis to exactly ``m`` samples."""
    n = x.shape[-1]
    if n == m:
        return x
    if n > m:
        return x[..., :m]
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, m - n)])


def next_power_of_two(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


def _bluestein_length(n: int) -> int:
    """Smallest supported convolution length m ≥ 2n−1.

    Preferred: m = 3·2^k (25% shorter than the next power of two when it
    fits) — NOT via the backend's native 3·2^k paths (the complex FFT hangs
    there, and batched 3·2^k rffts mis-tile under vmap) but via the explicit
    radix-3 decimation in ``_fft_radix3``, which only ever issues
    power-of-two device FFTs and is therefore layout-safe at any batch.
    """
    m2 = next_power_of_two(2 * n - 1)
    m3 = 3 * (m2 // 4)
    if m2 >= 64 and m3 >= 2 * n - 1:
        return m3
    return m2


@functools.lru_cache(maxsize=8)
def _radix3_twiddles(m: int):
    """Host float64 twiddles for the length-m = 3M DIF split -> complex64.

    Returns (t1, t2): t1[j] = exp(-2pi i j/m), t2[j] = t1[j]^2, j < M."""
    M = m // 3
    r = np.arange(M, dtype=np.float64)
    t1 = np.exp(-2j * np.pi * r / m)
    return t1.astype(np.complex64), (t1 * t1).astype(np.complex64)


def radix3_permute(x: np.ndarray) -> np.ndarray:
    """Host-side reorder into ``_fft_radix3``'s PERMUTED spectrum order:
    [X[0::3], X[1::3], X[2::3]] as three contiguous blocks."""
    return np.concatenate([x[..., 0::3], x[..., 1::3], x[..., 2::3]], axis=-1)


def _fft_radix3(z: jnp.ndarray) -> jnp.ndarray:
    """Complex FFT at m = 3*2^k via three pow2 FFTs - PERMUTED output.

    One decimation-in-FREQUENCY step done by hand: the backend's native
    complex FFT hangs at 3*2^k lengths, its batched 3*2^k real paths pick
    a pathologically padded layout, and stride-3 device slices cost more
    than the whole transform (measured 458 ms vs 88 ms at m = 6.29M) - so
    the split reads the CONTIGUOUS thirds of the input, combines them
    elementwise with host twiddles, and emits the spectrum in the permuted
    block order [X[0::3], X[1::3], X[2::3]].  Pair with ``_ifft_radix3``
    (which consumes that order and returns natural-order time samples) and
    keep everything in between elementwise; host constants multiply in via
    ``radix3_permute``.
    """
    m = z.shape[-1]
    M = m // 3
    t1_np, t2_np = _radix3_twiddles(m)
    a = z[..., :M]
    b = z[..., M : 2 * M]
    c = z[..., 2 * M :]
    w3 = np.complex64(np.exp(-2j * np.pi / 3.0))
    w3c = np.conj(w3)
    u0 = a + b + c
    u1 = (a + w3 * b + w3c * c) * jnp.asarray(t1_np)
    u2 = (a + w3c * b + w3 * c) * jnp.asarray(t2_np)
    return jnp.concatenate([fft_rows(u) for u in (u0, u1, u2)], axis=-1)


def _ifft_radix3(z: jnp.ndarray) -> jnp.ndarray:
    """Normalized inverse of ``_fft_radix3``: permuted spectrum blocks in,
    natural-order samples out.  Contiguous reads/writes only (see above)."""
    m = z.shape[-1]
    M = m // 3
    t1_np, t2_np = _radix3_twiddles(m)
    v0 = ifft_rows(z[..., :M])
    v1 = ifft_rows(z[..., M : 2 * M]) * jnp.conj(jnp.asarray(t1_np))
    v2 = ifft_rows(z[..., 2 * M :]) * jnp.conj(jnp.asarray(t2_np))
    w3i = np.complex64(np.exp(2j * np.pi / 3.0))  # conj(omega)
    w3ic = np.conj(w3i)
    third = np.float32(1.0 / 3.0)
    return jnp.concatenate(
        [
            (v0 + v1 + v2) * third,
            (v0 + w3i * v1 + w3ic * v2) * third,
            (v0 + w3ic * v1 + w3i * v2) * third,
        ],
        axis=-1,
    )


def fft_fast(z: jnp.ndarray, m: int) -> jnp.ndarray:
    """Convolution-domain complex FFT at m ∈ {2^k, 3·2^k}, zero-padded.

    The 3·2^k case goes through the explicit radix-3 decimation — safe at
    any batch (only pow2 device FFTs are issued), unlike the backend's
    native 3·2^k paths (complex hangs; batched real mis-tiles at rank 4).
    CONVENTION: at 3·2^k the spectrum comes back PERMUTED (see
    ``_fft_radix3``); pair with ``ifft_fast`` and keep everything between
    the two elementwise (host constants reorder via ``radix3_permute``).
    """
    if is_power_of_two(m):
        return fft_rows(pad_last(z, m))
    if m % 3 != 0 or not is_power_of_two(m // 3):
        raise ValueError(f"fft_fast supports 2^k and 3·2^k lengths, got {m}")
    return _fft_radix3(pad_last(z.astype(jnp.complex64), m))


def ifft_fast(z: jnp.ndarray) -> jnp.ndarray:
    """Normalized inverse of ``fft_fast`` at m = z.shape[-1] (consumes the
    permuted spectrum order at 3·2^k; emits natural-order samples)."""
    m = z.shape[-1]
    if is_power_of_two(m):
        return ifft_rows(z)
    if m % 3 != 0 or not is_power_of_two(m // 3):
        raise ValueError(f"ifft_fast supports 2^k and 3·2^k lengths, got {m}")
    return _ifft_radix3(z)


@functools.lru_cache(maxsize=8)  # ~0.34 GB/entry at n~1e7 — keep the host
def _bluestein_constants(n: int, inverse: bool):  # cache bounded
    """Host-precomputed (w, B, m) for a length-n (i)DFT, float64 → complex64.

    Returns NumPy arrays only — device constants must be materialized inside
    the calling trace (caching jnp arrays here would leak tracers between
    jit traces).
    """
    # Power of two, or 3·2^k through the explicit radix-3 decimation — the
    # backend's native *complex* FFT path hangs at 3·2^k sizes (the real
    # rfft path handles them fine — see convolution.fast_fft_length).
    m = _bluestein_length(n)
    k = np.arange(n, dtype=np.int64)
    q = (k * k) % (2 * n)  # exact phase: k² mod 2n keeps |angle| < 2π
    sign = 1.0 if inverse else -1.0
    w = np.exp(sign * 1j * np.pi * q / n)  # chirp

    kernel = np.zeros(m, dtype=np.complex128)
    wc = np.conj(w)
    kernel[:n] = wc
    kernel[m - (n - 1) :] = wc[1:][::-1]
    B = np.fft.fft(kernel)
    if not is_power_of_two(m):
        # the radix-3 device transforms work in permuted spectrum order —
        # reorder the host constant once instead of the device data
        B = radix3_permute(B)

    return w.astype(np.complex64), B.astype(np.complex64), m


def _bluestein_dft(x: jnp.ndarray, n: int, inverse: bool) -> jnp.ndarray:
    """Length-n (i)DFT of complex input (..., n) via one length-m convolution.

    The inverse variant returns the *unnormalized* sum (caller divides by n).
    """
    w_np, B_np, m = _bluestein_constants(n, inverse)
    w = jnp.asarray(w_np)
    B = jnp.asarray(B_np)
    a = x.astype(jnp.complex64) * w
    if is_power_of_two(m):
        conv = ifft_rows(fft_rows(pad_last(a, m)) * B)[..., :n]
    else:  # m = 3·2^k via the explicit radix-3 decimation
        conv = _ifft_radix3(_fft_radix3(pad_last(a, m)) * B)[..., :n]
    return conv * w


def rfft_exact(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """rfft of real input at exactly length n (any n ≥ 2); like
    ``np.fft.rfft(x, n)``, shorter input is zero-padded, longer truncated."""
    if is_power_of_two(n):
        return rfft_rows(pad_last(x, n))
    full = _bluestein_dft(
        pad_last(x, n).astype(jnp.complex64), n, inverse=False
    )
    return full[..., : n // 2 + 1]


def irfft_exact(spec: jnp.ndarray, n: int) -> jnp.ndarray:
    """irfft back to real length n from a (..., n//2+1) half spectrum."""
    if is_power_of_two(n):
        # Pin the bin count to n//2+1 so irfft_rows' implicit length matches
        # jnp.fft.irfft(spec, n=n) for over-long AND under-length spectra
        # (pad_last zero-pads short ones, matching numpy's zero-pad).
        return irfft_rows(pad_last(spec, n // 2 + 1))
    # Rebuild the full Hermitian spectrum, inverse-DFT, take the real part.
    spec = pad_last(spec, n // 2 + 1)
    if n % 2 == 0:
        mirror = jnp.conj(spec[..., -2:0:-1])
    else:
        mirror = jnp.conj(spec[..., -1:0:-1])
    full = jnp.concatenate([spec, mirror], axis=-1)
    out = _bluestein_dft(full, n, inverse=True) / n
    return jnp.real(out)


def _full_gain(gain: jnp.ndarray, n: int) -> jnp.ndarray:
    """(n//2+1,) real rfft gain → full two-sided (n,) gain (even symmetry)."""
    if n % 2 == 0:
        mirror = gain[..., -2:0:-1]
    else:
        mirror = gain[..., -1:0:-1]
    return jnp.concatenate([gain, mirror], axis=-1)


def apply_circular_gain(signal: jnp.ndarray, gain: jnp.ndarray) -> jnp.ndarray:
    """y = irfft_n( rfft_n(signal) · gain ) at n = signal.shape[-1].

    The primitive both reference filters reduce to.  ``gain`` is a real
    (n//2+1,) per-bin curve (possibly traced), shared across channels.

    Real-pair fast path: a stereo pair under one gain packs into a single
    complex transform — ``y0 + i·y1 = IDFT(g_full ⊙ DFT(x0 + i·x1))`` (the
    gain is real and even, so it maps real→real on each part).  That halves
    the Bluestein work of the exact-length filters (air + EQ), the dominant
    cost of the exact (non-fast_air) render path.
    """
    n = signal.shape[-1]
    if is_power_of_two(n):
        spec = rfft_rows(signal) * gain
        return irfft_rows(spec).astype(jnp.float32)
    if signal.ndim >= 2 and signal.shape[-2] == 2:
        z = jax.lax.complex(signal[..., 0, :], signal[..., 1, :])
        spec = _bluestein_dft(z, n, inverse=False) * _full_gain(gain, n)
        y = _bluestein_dft(spec, n, inverse=True) / n
        return jnp.stack(
            [jnp.real(y), jnp.imag(y)], axis=-2
        ).astype(jnp.float32)
    spec = rfft_exact(signal, n) * gain
    return irfft_exact(spec, n).astype(jnp.float32)
