"""Exact-length shelf EQ on ONE chip for clips too long for a whole-signal FFT.

The reference's shelf EQ is a circular FFT gain at the exact signal length
(raytracer_studio.py:392-397).  The single-shot path (models.pipeline) takes
that FFT directly and tops out around ~10 minutes on a 16 GB chip; the
multi-device path (parallel.distributed_fft) shards it over a mesh.  This
module is the missing single-chip long-clip case (round-3 VERDICT item 2):
the same Bluestein factorization, but the inner power-of-two transform runs
**blockwise on one device** via the four-step decomposition —

    FFT_m  (m = D·B, both pow2)  =  D-point DFT across row-blocks (one
    complex matmul on the (D, B) view)  →  twiddle e^{-2πi·c·b/m}  →
    length-B FFT per row,

so the working set stays O(m) data arrays with only row-sized FFT workspace,
instead of XLA's whole-m FFT scratch.  Bluestein wraps the arbitrary exact
length n0 into that m-circular convolution with int32-exact chirp phases
(reused from parallel.distributed_fft: j² mod 2n0 in uint32 — exact for
n0 < 2^30).  A further structural saving: the forward transform's post-chirp
e^{-iπk²/n0} and the inverse's pre-chirp e^{+iπk²/n0} cancel, so the full
EQ is

    u   = x · w⁻                    (time chirp)
    c₁  = IFFT_m(FFT_m(u) · K⁺)     (forward Bluestein convolution)
    u₂  = c₁ · gain · [k < n0]      (the EQ gain, chirp pair cancelled)
    c₂  = IFFT_m(FFT_m(u₂) · K⁻)    (inverse Bluestein convolution)
    y   = c₂ · w⁺ / n0              (real part per real channel)

— four blockwise transforms for a stereo pair plus two kernel-spectrum
transforms per render:

* The EQ gain is real and symmetric under k → n0−k, so the circular EQ
  operator has a REAL impulse response and commutes with complex packing:
  the stereo pair runs as ONE complex stream z = L + iR and splits
  exactly as L' = Re(y), R' = Im(y) (the same pair-packing the batched
  exact filters use, ops/filters.py).  Float chirp round-off leaks
  channels into each other only at ~1e-6 relative — inside the parity
  envelope, pinned by tests/test_streaming_eq.py.
* K⁻ is mathematically the conjugate bin-reversal of K⁺ — but a
  bin-reversal of the strided (D, B) view is a gather over the whole
  buffer, which proved far slower than a second four-step kernel
  transform on the accelerator this was first built for; so K⁻ is simply
  FFT_m(k⁻) with the opposite-sign chirp kernel (not yet re-measured on
  the GPU).

Peak device memory ≈ 4.5·m complex64 ≈ 9 GB at m = 2^28 (clips to
~46 min @ 48 kHz); longer clips use the distributed path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .distributed_fft import (
    _chirp,
    chirp_kernel_at_bins,
    fft_length_for,
    is_power_of_two,
    shelf_gain_at_bins,
)

DEFAULT_D_ROWS = 16


def _dft_matrix(d: int, sign: float) -> np.ndarray:
    """(D, D) complex64 DFT matrix e^{sign·2πi·c·d/D}, built in float64."""
    idx = np.arange(d)
    phase = sign * 2.0 * np.pi * np.outer(idx, idx) / d
    return (np.cos(phase) + 1j * np.sin(phase)).astype(np.complex64)


def _twiddle_db(d: int, b: int, sign: float) -> jnp.ndarray:
    """(D, B) twiddle e^{sign·2πi·c·j/m}: c·j < m < 2^31 stays exact int32."""
    m = d * b
    c = jnp.arange(d, dtype=jnp.int32)[:, None]
    j = jnp.arange(b, dtype=jnp.int32)[None, :]
    cj = (c * j).astype(jnp.float32)
    phase = (np.float32(sign * 2.0 * np.pi) / np.float32(m)) * cj
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def _fftm(x_db: jnp.ndarray, d: int, b: int) -> jnp.ndarray:
    """FFT_m of the natural (D, B) block view → bin-strided (D, B):
    row c holds bins c + D·t.  Four-step; HIGHEST matmul precision (the
    D-point DFT is parity-bearing — cf. CLAUDE.md on small einsums)."""
    w = jnp.asarray(_dft_matrix(d, -1.0))
    s = jnp.einsum("cd,db->cb", w, x_db, precision=jax.lax.Precision.HIGHEST)
    s = s * _twiddle_db(d, b, -1.0)
    return jnp.fft.fft(s, axis=-1)


def _ifftm(x_strided: jnp.ndarray, d: int, b: int) -> jnp.ndarray:
    """Inverse of ``_fftm``: strided (D, B) → natural (D, B), 1/m applied."""
    w = jnp.asarray(_dft_matrix(d, +1.0))
    t = jnp.fft.ifft(x_strided, axis=-1)  # 1/B
    t = t * _twiddle_db(d, b, +1.0)
    out = jnp.einsum("cd,cb->db", w, t, precision=jax.lax.Precision.HIGHEST)
    return out / d


def _global_index(d: int, b: int) -> jnp.ndarray:
    return (
        jnp.arange(d, dtype=jnp.int32)[:, None] * b
        + jnp.arange(b, dtype=jnp.int32)[None, :]
    )


def _chirp_kernel_db(n0: int, d: int, b: int, sign: float) -> jnp.ndarray:
    """Bluestein chirp kernel on the (D, B) view — the ONE definition lives
    in distributed_fft.chirp_kernel_at_bins (shared with the mesh path)."""
    return chirp_kernel_at_bins(_global_index(d, b), n0, d * b, sign)


def _eq_gain_db(
    n0: int, rate: int, d: int, b: int,
    bass_gain: jnp.ndarray, treble_gain: jnp.ndarray,
) -> jnp.ndarray:
    """Two-sided shelf gain on the (D, B) view — the ONE definition of the
    parity-bearing edge-bin semantics lives in
    distributed_fft.shelf_gain_at_bins (shared with the mesh path)."""
    return shelf_gain_at_bins(_global_index(d, b), n0, rate, bass_gain, treble_gain)


@functools.lru_cache(maxsize=8)
def _compiled_eq(n0: int, rate: int, d: int, b: int, n_total: int):
    """Jitted callables for one static EQ configuration.

    Built ONCE per (n0, rate, d, b, n_total) and cached: re-jitting fresh
    closures on every ``shelf_eq_streaming`` call cost ~13 s/call of pure
    HOST work at m = 2^28 (re-trace + executable-cache lookup on a huge
    graph) against 0.75 s of device work.  The cache holds only function objects, never
    traced arrays (CLAUDE.md lru_cache rule).
    """
    m = d * b
    n_copy = min(n0, n_total)

    @jax.jit
    def kernel_spectra():
        """K⁺ and K⁻ via two four-step transforms (k⁻ = conj(k⁺) in time;
        no bin-reversal — see the module docstring)."""
        kf = _fftm(_chirp_kernel_db(n0, d, b, sign=-1.0), d, b)
        ki = _fftm(_chirp_kernel_db(n0, d, b, sign=+1.0), d, b)
        return kf, ki

    def _eq_core(x_db, kspec_fwd, kspec_inv, bg, tg, w_fwd, w_inv):
        """The chirp-cancelled double Bluestein convolution on one (D, B)
        complex stream (real channel or packed L+iR pair)."""
        u = x_db * w_fwd
        conv1 = _ifftm(_fftm(u, d, b) * kspec_fwd, d, b)
        # forward post-chirp w⁻[k] and inverse pre-chirp w⁺[k] cancel:
        # only the gain (zeroed past n0) sits between the two convolutions
        u2 = conv1 * _eq_gain_db(n0, rate, d, b, bg, tg)
        conv2 = _ifftm(_fftm(u2, d, b) * kspec_inv, d, b)
        return conv2 * w_inv / np.float32(n0)

    def _chirps():
        j = _global_index(d, b)
        valid = j < n0
        jv = jnp.where(valid, j, 0)
        w_fwd = jnp.where(valid, _chirp(jv, n0, -1.0), 0.0)
        w_inv = jnp.where(valid, _chirp(jv, n0, +1.0), 0.0)
        return w_fwd, w_inv

    def _pad_db(row):
        return jnp.zeros(m, jnp.float32).at[:n_copy].set(row[:n_copy]).reshape(d, b)

    @jax.jit
    def eq_channel(row, kspec_fwd, kspec_inv, bg, tg):
        w_fwd, w_inv = _chirps()
        y = jnp.real(
            _eq_core(
                _pad_db(row).astype(jnp.complex64),
                kspec_fwd, kspec_inv, bg, tg, w_fwd, w_inv,
            )
        ).reshape(m)
        out = jnp.zeros(n_total, jnp.float32)
        return out.at[:n_copy].set(y[:n_copy])

    @jax.jit
    def eq_pair(row_l, row_r, kspec_fwd, kspec_inv, bg, tg):
        """Both channels in ONE complex stream z = L + iR: the EQ operator
        has a real impulse response (real gain, symmetric under k → n0−k),
        so EQ(L+iR) = EQ(L) + i·EQ(R) — half the transforms."""
        w_fwd, w_inv = _chirps()
        z = jax.lax.complex(_pad_db(row_l), _pad_db(row_r))
        y = _eq_core(z, kspec_fwd, kspec_inv, bg, tg, w_fwd, w_inv).reshape(m)
        out_l = jnp.zeros(n_total, jnp.float32).at[:n_copy].set(
            jnp.real(y)[:n_copy]
        )
        out_r = jnp.zeros(n_total, jnp.float32).at[:n_copy].set(
            jnp.imag(y)[:n_copy]
        )
        return out_l, out_r

    return kernel_spectra, eq_channel, eq_pair


@functools.lru_cache(maxsize=4)
def _compiled_eq_dynamic(d: int, b: int, n_total: int):
    """Jitted callables whose exact length n0 is a TRACED scalar.

    One executable per (d, b, n_total) serves EVERY exact length n0 ≤
    (m+1)/2: the chirp phases and gain masks derive on device from traced
    int32 scalars (ops.chirp — the batched dynamic EQ's machinery), with
    the parity-bearing float64 band edges computed on the host per call.
    Trade vs ``_compiled_eq``: m keys on the PADDED buffer length instead
    of n0 (≤ ~2× the FFT work at worst), but long jobs of *varying* length
    stop paying a fresh compile per distinct n0.  The default;
    ARS_STREAM_EQ_DYNAMIC=0 forces the per-n0 exact executables
    (``_compiled_eq``).
    """
    m = d * b

    def _dyn_chirps(n0):
        j = _global_index(d, b)
        valid = j < n0
        jv = jnp.where(valid, j, 0)
        zero = jnp.complex64(0.0)
        w_fwd = jnp.where(valid, _chirp(jv, n0, -1.0), zero)
        w_inv = jnp.where(valid, _chirp(jv, n0, +1.0), zero)
        return w_fwd, w_inv

    @jax.jit
    def kernel_spectra(n0):
        kf = _fftm(chirp_kernel_at_bins(_global_index(d, b), n0, m, -1.0), d, b)
        ki = _fftm(chirp_kernel_at_bins(_global_index(d, b), n0, m, +1.0), d, b)
        return kf, ki

    def _eq_core_dyn(x_db, kf, ki, gain, n0):
        w_fwd, w_inv = _dyn_chirps(n0)
        u = x_db * w_fwd
        conv1 = _ifftm(_fftm(u, d, b) * kf, d, b)
        u2 = conv1 * gain  # chirp pair cancelled; gain zeroed past n0
        conv2 = _ifftm(_fftm(u2, d, b) * ki, d, b)
        return conv2 * w_inv / jnp.asarray(n0, jnp.float32)

    def _pad_db(row):
        return jnp.zeros(m, jnp.float32).at[:n_total].set(row).reshape(d, b)

    def _gain(n0, k_lo, k_bass, k_treble, bg, tg):
        from ..ops.chirp import shelf_gain_from_edges

        return shelf_gain_from_edges(
            _global_index(d, b), n0, k_lo, k_bass, k_treble, bg, tg
        )

    @jax.jit
    def eq_channel(row, kf, ki, bg, tg, n0, k_lo, k_bass, k_treble):
        gain = _gain(n0, k_lo, k_bass, k_treble, bg, tg)
        y = jnp.real(
            _eq_core_dyn(_pad_db(row).astype(jnp.complex64), kf, ki, gain, n0)
        ).reshape(m)[:n_total]
        # the buffer past n0 must come back zero (w masks the EQ; the input
        # tail was zero by construction)
        j = jnp.arange(n_total, dtype=jnp.int32)
        return jnp.where(j < n0, y, 0.0)

    @jax.jit
    def eq_pair(row_l, row_r, kf, ki, bg, tg, n0, k_lo, k_bass, k_treble):
        gain = _gain(n0, k_lo, k_bass, k_treble, bg, tg)
        z = jax.lax.complex(_pad_db(row_l), _pad_db(row_r))
        y = _eq_core_dyn(z, kf, ki, gain, n0).reshape(m)[:n_total]
        j = jnp.arange(n_total, dtype=jnp.int32)
        out_l = jnp.where(j < n0, jnp.real(y), 0.0)
        out_r = jnp.where(j < n0, jnp.imag(y), 0.0)
        return out_l, out_r

    return kernel_spectra, eq_channel, eq_pair


@functools.lru_cache(maxsize=4)
def _compiled_air_dynamic(d: int, b: int, n_total: int):
    """Jitted air-absorption callables with TRACED exact length n0 — the
    length-dynamic counterpart of ``_compiled_eq_dynamic`` with the air
    gain (ops.chirp.air_gain_from_bins) between the two Bluestein
    convolutions instead of the shelf gain.

    Only the traced-n0 variant exists (it bounds the compile surface), so
    there is no per-n0 static flavor to maintain.  The chirp kernel spectra are the EQ's own (same (d, b, n0)),
    shared via ``_compiled_eq_dynamic``.
    """
    m = d * b
    kernel_spectra = _compiled_eq_dynamic(d, b, n_total)[0]

    def _dyn_chirps(n0):
        j = _global_index(d, b)
        valid = j < n0
        jv = jnp.where(valid, j, 0)
        zero = jnp.complex64(0.0)
        w_fwd = jnp.where(valid, _chirp(jv, n0, -1.0), zero)
        w_inv = jnp.where(valid, _chirp(jv, n0, +1.0), zero)
        return w_fwd, w_inv

    def _core(x_db, kf, ki, gain, n0):
        w_fwd, w_inv = _dyn_chirps(n0)
        u = x_db * w_fwd
        conv1 = _ifftm(_fftm(u, d, b) * kf, d, b)
        u2 = conv1 * gain  # chirp pair cancelled; gain zeroed past n0
        conv2 = _ifftm(_fftm(u2, d, b) * ki, d, b)
        return conv2 * w_inv / jnp.asarray(n0, jnp.float32)

    def _pad_db(row):
        return jnp.zeros(m, jnp.float32).at[:n_total].set(row).reshape(d, b)

    def _gain(n0, rate_f, factor):
        from ..ops.chirp import air_gain_from_bins

        return air_gain_from_bins(_global_index(d, b), n0, rate_f, factor)

    @jax.jit
    def air_channel(row, kf, ki, factor, n0, rate_f):
        gain = _gain(n0, rate_f, factor)
        y = jnp.real(
            _core(_pad_db(row).astype(jnp.complex64), kf, ki, gain, n0)
        ).reshape(m)[:n_total]
        j = jnp.arange(n_total, dtype=jnp.int32)
        return jnp.where(j < n0, y, 0.0)

    @jax.jit
    def air_pair(row_l, row_r, kf, ki, factor, n0, rate_f):
        gain = _gain(n0, rate_f, factor)
        z = jax.lax.complex(_pad_db(row_l), _pad_db(row_r))
        y = _core(z, kf, ki, gain, n0).reshape(m)[:n_total]
        j = jnp.arange(n_total, dtype=jnp.int32)
        out_l = jnp.where(j < n0, jnp.real(y), 0.0)
        out_r = jnp.where(j < n0, jnp.imag(y), 0.0)
        return out_l, out_r

    return kernel_spectra, air_channel, air_pair


def air_absorption_streaming(
    buf_cn: jnp.ndarray,
    n0: int,
    rate: int,
    factor,
    d_rows: int = DEFAULT_D_ROWS,
) -> jnp.ndarray:
    """Exact-length circular air absorption of a (C, n_total) device buffer.

    Matches ``ops.filters.apply_air_absorption`` at length n0 to float32
    round-off (the reference's exact-length transform,
    raytracer_studio.py:310-336) with bounded FFT workspace — the missing
    piece that let the streaming path honor ``fast_filters=False`` end to
    end (round-4 VERDICT item 4).  Always the traced-n0 executables: one
    compile per padded slab grid serves every clip length.
    """
    c_count, n_total = int(buf_cn.shape[0]), int(buf_cn.shape[1])
    if n0 < 2:
        return buf_cn
    if n0 >= (1 << 30):
        raise ValueError("exact streaming air absorption supports n0 < 2^30")
    m = fft_length_for(n_total)
    d = min(d_rows, m)
    if d < 1 or not is_power_of_two(d):
        raise ValueError(f"d_rows must be a power of two (got {d_rows})")
    b = m // d

    kernel_spectra, air_channel, air_pair = _compiled_air_dynamic(d, b, n_total)
    n0_s = jnp.int32(n0)
    rate_f = jnp.float32(rate)
    fac = jnp.float32(factor) if np.isscalar(factor) else factor
    kf, ki = kernel_spectra(n0_s)
    rows = []
    for ch in range(0, c_count - 1, 2):
        out_l, out_r = air_pair(
            buf_cn[ch], buf_cn[ch + 1], kf, ki, fac, n0_s, rate_f
        )
        rows.extend([out_l, out_r])
    if c_count % 2:
        rows.append(
            air_channel(buf_cn[c_count - 1], kf, ki, fac, n0_s, rate_f)
        )
    return jnp.stack(rows)


def shelf_eq_streaming(
    buf_cn: jnp.ndarray,
    n0: int,
    rate: int,
    bass_gain,
    treble_gain,
    d_rows: int = DEFAULT_D_ROWS,
    dynamic: bool = False,
) -> jnp.ndarray:
    """Exact-length circular shelf EQ of a (C, n_total) device buffer.

    The signal occupies ``[0, n0)`` of the buffer (positions beyond are
    ignored and return as zeros).  Matches ``ops.filters.apply_shelf_eq``
    at length n0 to float32 round-off; bounded FFT workspace regardless of
    n0.  Channels run sequentially to cap peak HBM.

    ``dynamic=True`` keys the executables on the PADDED buffer length and
    passes n0 (+ host float64 band edges) as traced scalars — one compile
    serves every clip length sharing a slab grid, at ≤ ~2× the EQ-stage
    FFT cost (see ``_compiled_eq_dynamic``).
    """
    c_count, n_total = int(buf_cn.shape[0]), int(buf_cn.shape[1])
    if n0 < 2:
        return buf_cn
    if n0 >= (1 << 30):
        raise ValueError("exact streaming EQ supports n0 < 2^30")
    m = fft_length_for(n_total if dynamic else n0)
    d = min(d_rows, m)
    if d < 1 or not is_power_of_two(d):
        # m is a power of two: a non-pow2 d truncates b = m // d, silently
        # running the Bluestein convolution at the wrong length (circular
        # aliasing) AND hands jnp.fft a non-pow2 complex size — the
        # documented pathological/hanging path on this backend
        raise ValueError(f"d_rows must be a power of two (got {d_rows})")
    b = m // d

    bg = jnp.float32(bass_gain)
    tg = jnp.float32(treble_gain)
    if dynamic:
        from ..ops.chirp import band_edges

        kernel_spectra, eq_channel, eq_pair = _compiled_eq_dynamic(d, b, n_total)
        k_lo, k_bass, k_treble = band_edges(n0, rate)
        scalars = tuple(
            jnp.int32(v) for v in (n0, k_lo, k_bass, k_treble)
        )
        kf, ki = kernel_spectra(scalars[0])
        extra = scalars
    else:
        kernel_spectra, eq_channel, eq_pair = _compiled_eq(n0, rate, d, b, n_total)
        kf, ki = kernel_spectra()
        extra = ()
    rows = []
    for ch in range(0, c_count - 1, 2):
        out_l, out_r = eq_pair(buf_cn[ch], buf_cn[ch + 1], kf, ki, bg, tg, *extra)
        rows.extend([out_l, out_r])
    if c_count % 2:
        rows.append(eq_channel(buf_cn[c_count - 1], kf, ki, bg, tg, *extra))
    return jnp.stack(rows)
