"""Distributed exact-length DFT and shelf EQ over the block-sharded sample axis.

The reference's shelf EQ is a circular FFT gain at the *exact* signal length
(raytracer_studio.py:392-397) — a parity-bearing choice (shifting the FFT
length even by a few samples moves the brick-wall cutoff bins and deviates
~1e-2, measured).  In long-render mode the signal's sample axis is sharded
over the mesh's "block" axis, so the exact transform must be distributed.

Construction: collectives over the device interconnect and pow2 local FFTs:

1. **Four-step FFT** at m = 2^a = D·B_m over blocks: a D-point DFT across
   devices (D-step `ppermute` ring accumulation), twiddle
   ``exp(-2πi·c·j/m)`` (c·j < m < 2^31 — exact int32), then a *local* pow2
   FFT per device.  Output lands bin-strided (device c holds bins ≡ c mod D);
   the inverse runs the steps backwards (strided → block layout).
2. **Bluestein** wraps the arbitrary exact length n0 into that pow2-m
   circular convolution: ``X = w ⊙ IFFT_m(FFT_m(x⊙w) ⊙ B)``.  Chirp phases
   ``k² mod 2n0`` are computed ON DEVICE in pure int32/uint32 modular
   arithmetic (`_modsq`) — exact for n0 < 2^30 (~6 h @ 48 kHz), no host
   transfers, every device derives its own shard of every constant from its
   global indices.
3. **Block alignment**: the long renderer picks block_len = m/(2D), so each
   m-layout block is exactly two renderer blocks — the reshard between the
   signal layout and the FFT layout is two static `ppermute`s each way.

Per-device memory stays flat in the clip length (O(m/D)); per-EQ cost is
5 distributed transforms: forward + inverse Bluestein each take a data FFT
and a conv IFFT, and the two data-independent chirp-kernel spectra are
batched into one extra (double-width) distributed FFT.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .. import config

# The modular-chirp and shelf-gain core moved to ops.chirp (one definition
# for every exact-EQ backend, incl. the batched length-dynamic EQ); the
# names below remain this module's API for the mesh/streaming paths.
from ..ops.chirp import (  # noqa: F401  (re-exports)
    _chirp,
    _modsq,
    band_edges as _band_edges,
    chirp_kernel_at_bins,
    fft_length_for,
    is_power_of_two,
    shelf_gain_at_bins,
)


def block_len_for(n0: int, num_blocks: int) -> int:
    """The renderer block length that aligns with the EQ's FFT layout."""
    return fft_length_for(n0) // (2 * num_blocks)


# --------------------------------------------------------------------------
# Four-step distributed FFT at m = D·B_m (pow2), block ↔ strided layouts.
# --------------------------------------------------------------------------


def _ring_dft(x: jnp.ndarray, axis_name: str, num_blocks: int, sign: float) -> jnp.ndarray:
    """On device c: Σ_d x_d · exp(sign·2πi·c·d/D) via a D-step ppermute ring.

    ``x`` is each device's (..., B) complex block; one block circulates per
    step (flat memory, ICI neighbour traffic only).
    """
    d_count = num_blocks
    c = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % d_count) for i in range(d_count)]
    acc = jnp.zeros_like(x)
    buf = x
    for step in range(d_count):
        src = (c - step) % d_count  # who `buf` originally belonged to
        phase = (np.float32(sign * 2.0 * np.pi) / np.float32(d_count)) * (
            (c * src) % d_count
        ).astype(jnp.float32)
        weight = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
        acc = acc + buf * weight
        if step < d_count - 1:
            buf = jax.lax.ppermute(buf, axis_name, perm)
    return acc


def _twiddle(c, length: int, m: int, sign: float) -> jnp.ndarray:
    """exp(sign·2πi·c·j/m) for j ∈ [0, length); c·j < m < 2^31 stays exact."""
    j = jnp.arange(length, dtype=jnp.int32)
    cj = (c.astype(jnp.int32) * j).astype(jnp.float32)
    phase = (np.float32(sign * 2.0 * np.pi) / np.float32(m)) * cj
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def dist_fft(x_block: jnp.ndarray, axis_name: str, num_blocks: int) -> jnp.ndarray:
    """FFT_m of a block-sharded (..., B_m) complex array → bin-strided shards.

    Device c returns X[c + D·t] for t ∈ [0, B_m): X = Σ over the full
    length-m array.  m = D·B_m must be a power of two (B_m pow2 ⇒ the local
    FFT takes XLA's fast path).
    """
    b_m = x_block.shape[-1]
    m = num_blocks * b_m
    c = jax.lax.axis_index(axis_name)
    s = _ring_dft(x_block, axis_name, num_blocks, sign=-1.0)
    s = s * _twiddle(c, b_m, m, sign=-1.0)
    return jnp.fft.fft(s, axis=-1)


def dist_ifft(x_strided: jnp.ndarray, axis_name: str, num_blocks: int) -> jnp.ndarray:
    """Inverse of ``dist_fft``: strided shards → block-sharded, 1/m applied."""
    b_m = x_strided.shape[-1]
    m = num_blocks * b_m
    c = jax.lax.axis_index(axis_name)
    t = jnp.fft.ifft(x_strided, axis=-1)  # 1/B_m
    t = t * _twiddle(c, b_m, m, sign=+1.0)
    return _ring_dft(t, axis_name, num_blocks, sign=+1.0) / num_blocks


# --------------------------------------------------------------------------
# Layout reshard: renderer blocks (B_sig = m/2D) ↔ FFT blocks (B_m = 2·B_sig).
# --------------------------------------------------------------------------


def _to_fft_layout(u: jnp.ndarray, axis_name: str, num_blocks: int) -> jnp.ndarray:
    """(..., B_sig) renderer blocks → (..., 2·B_sig) m-layout blocks.

    The global m-array is the n_total = m/2 signal followed by zeros, so
    FFT block d = [signal block 2d | signal block 2d+1] (zeros for 2d ≥ D).
    Two static partial ppermutes; non-receiving devices get zeros.
    """
    d_count = num_blocks
    even = [(2 * t, t) for t in range(d_count) if 2 * t < d_count]
    odd = [(2 * t + 1, t) for t in range(d_count) if 2 * t + 1 < d_count]
    first = jax.lax.ppermute(u, axis_name, even)
    second = jax.lax.ppermute(u, axis_name, odd)
    return jnp.concatenate([first, second], axis=-1)


def _from_fft_layout(y: jnp.ndarray, axis_name: str, num_blocks: int) -> jnp.ndarray:
    """(..., 2·B_sig) m-layout blocks → (..., B_sig) renderer blocks."""
    d_count = num_blocks
    b_sig = y.shape[-1] // 2
    even = [(t, 2 * t) for t in range(d_count) if 2 * t < d_count]
    odd = [(t, 2 * t + 1) for t in range(d_count) if 2 * t + 1 < d_count]
    a = jax.lax.ppermute(y[..., :b_sig], axis_name, even)
    b = jax.lax.ppermute(y[..., b_sig:], axis_name, odd)
    return a + b


# --------------------------------------------------------------------------
# Distributed Bluestein DFT at exact length n0 (renderer-block layout).
# --------------------------------------------------------------------------


def _chirp_kernel(
    n0: int, m: int, axis_name: str, num_blocks: int, sign: float
) -> jnp.ndarray:
    """Chirp kernel shard, built per device from global indices."""
    b_m = m // num_blocks
    c = jax.lax.axis_index(axis_name)
    k = c * b_m + jnp.arange(b_m, dtype=jnp.int32)  # global m-index
    return chirp_kernel_at_bins(k, n0, m, sign)


def _chirp_kernel_spectrum(
    n0: int, m: int, axis_name: str, num_blocks: int, sign: float
) -> jnp.ndarray:
    """B = FFT_m(chirp kernel), bin-strided."""
    kernel = _chirp_kernel(n0, m, axis_name, num_blocks, sign)
    return dist_fft(kernel, axis_name, num_blocks)


def dist_dft_exact(
    x_block: jnp.ndarray,
    n0: int,
    axis_name: str,
    num_blocks: int,
    inverse: bool = False,
    kernel_spectrum: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Exact length-n0 (i)DFT of a block-sharded (..., B_sig) complex array.

    Requires B_sig = m/(2·D) (see ``block_len_for``) so the layouts align.
    Positions ≥ n0 of the input are ignored; output positions ≥ n0 are zero.
    The inverse includes the 1/n0 normalization.  ``kernel_spectrum``, when
    given, is a precomputed ``_chirp_kernel_spectrum(n0, m, …, sign)`` shard
    (callers doing a forward+inverse pair batch both kernel FFTs into one
    distributed transform — see ``shelf_eq_sharded``).
    """
    b_sig = x_block.shape[-1]
    m = 2 * num_blocks * b_sig
    if m != fft_length_for(n0):
        raise ValueError(
            f"block length {b_sig} does not align with the exact-DFT layout "
            f"for n0={n0}: need block_len_for(n0, D) = {block_len_for(n0, num_blocks)}"
        )
    if n0 >= (1 << 30):
        raise ValueError("exact distributed DFT supports n0 < 2^30")
    sign = +1.0 if inverse else -1.0
    c = jax.lax.axis_index(axis_name)
    j = c * b_sig + jnp.arange(b_sig, dtype=jnp.int32)  # global signal index
    valid = j < n0
    w = _chirp(jnp.where(valid, j, 0), n0, sign)
    w = jnp.where(valid, w, jnp.zeros_like(w))

    u = x_block.astype(jnp.complex64) * w
    spec = dist_fft(_to_fft_layout(u, axis_name, num_blocks), axis_name, num_blocks)
    if kernel_spectrum is None:
        kernel_spectrum = _chirp_kernel_spectrum(n0, m, axis_name, num_blocks, sign)
    spec = spec * kernel_spectrum
    conv = _from_fft_layout(
        dist_ifft(spec, axis_name, num_blocks), axis_name, num_blocks
    )
    out = conv * w
    if inverse:
        out = out / np.float32(n0)
    return out


# --------------------------------------------------------------------------
# Sharded exact shelf EQ (the long-render stage).
# --------------------------------------------------------------------------


def shelf_eq_sharded(
    x_block: jnp.ndarray,
    rate: int,
    bass_gain: jnp.ndarray,
    treble_gain: jnp.ndarray,
    n0: int,
    axis_name: str,
    num_blocks: int,
) -> jnp.ndarray:
    """Exact-length circular shelf EQ of a block-sharded real signal.

    Matches ``ops.filters.apply_shelf_eq`` at length n0 (reference
    raytracer_studio.py:392-397): bass gain on (0, 250] Hz, treble on
    [4 kHz, ∞), treble mask wins on overlap; applied over the full (two-
    sided) spectrum with band edges replicating the single-device rfftfreq
    masks bit-for-bit (``_band_edges``).
    """
    if not is_power_of_two(num_blocks):
        raise ValueError("shelf_eq_sharded requires a power-of-two block axis")
    b_sig = x_block.shape[-1]
    m = 2 * num_blocks * b_sig
    c = jax.lax.axis_index(axis_name)

    # both chirp-kernel spectra (forward + inverse) in one batched
    # distributed FFT — they are data-independent, only the sign differs
    kernels = jnp.stack(
        [
            _chirp_kernel(n0, m, axis_name, num_blocks, sign=-1.0),
            _chirp_kernel(n0, m, axis_name, num_blocks, sign=+1.0),
        ]
    )
    kspec_fwd, kspec_inv = dist_fft(kernels, axis_name, num_blocks)

    spec = dist_dft_exact(
        x_block, n0, axis_name, num_blocks, inverse=False,
        kernel_spectrum=kspec_fwd,
    )

    k = c * b_sig + jnp.arange(b_sig, dtype=jnp.int32)  # global bin index
    # bins ≥ n0 multiply by 0 — they are already zero out of dist_dft_exact
    spec = spec * shelf_gain_at_bins(k, n0, rate, bass_gain, treble_gain)

    y = dist_dft_exact(
        spec, n0, axis_name, num_blocks, inverse=True,
        kernel_spectrum=kspec_inv,
    )
    out = jnp.real(y).astype(jnp.float32)
    j = k
    return jnp.where(j < n0, out, jnp.zeros_like(out))
