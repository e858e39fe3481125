"""Exact modular Bluestein chirps and shelf-gain bin semantics (shared core).

THE single definition of three parity-bearing pieces, used by every exact-
length shelf-EQ backend (ops.filters single-shot, parallel.distributed_fft
mesh-sharded, parallel.streaming_eq single-chip blockwise, and the batched
length-dynamic EQ):

* **Chirp phases ``exp(±iπ·j²/n0)`` with the phase reduced exactly mod 2π**:
  ``j² mod 2n0`` is computed in pure int32/uint32 modular arithmetic
  (`_modsq`) — exact for n0 < 2^30 (~6 h @ 48 kHz), no int64 (JAX runs int32 unless
  x64 is enabled), no host transfers.  ``n0`` may be a Python int (static
  graphs) or a traced int32 scalar (the length-dynamic EQ: one executable
  per padded bucket serves every true clip length inside it).
* **Bluestein kernel layout** (`chirp_kernel_at_bins`): K[k] = w̄[k] for
  k < n0, K[m−k] = w̄[k] for 1 ≤ k < n0, else 0.
* **Shelf-gain edge bins** (`_band_edges` + `shelf_gain_from_edges`): the
  reference's masks come from ``np.fft.rfftfreq`` float64 arithmetic
  (raytracer_studio.py:392-397), and a bin can land *exactly* on a cutoff
  with float dust — the edges must be derived on the host in float64 and,
  for traced n0, passed into the graph as scalar arguments.

Moved out of parallel.distributed_fft (which re-exports them) so ops-layer
code can use them without an ops → parallel import inversion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from .fftops import is_power_of_two  # noqa: F401  (one definition, re-exported)


def fft_length_for(n0: int) -> int:
    """Bluestein conv length: the next pow2 ≥ 2·n0 − 1."""
    m = 1
    while m < 2 * n0 - 1:
        m <<= 1
    return m


def _mod_double(x: jnp.ndarray, times: int, modulus) -> jnp.ndarray:
    """x·2^times mod modulus for uint32 x < modulus < 2^31 (unrolled)."""
    mu = jnp.asarray(modulus, dtype=jnp.uint32)
    for _ in range(times):
        x = x + x  # < 2^32, exact in uint32
        x = jnp.where(x >= mu, x - mu, x)
    return x


def _modsq(j: jnp.ndarray, modulus) -> jnp.ndarray:
    """(j² mod modulus) for int32 j ∈ [0, 2^30), modulus < 2^31 — exact.

    j = q·2^15 + r  ⇒  j² = q²·2^30 + q·r·2^16 + r², each term reduced in
    uint32 (products < 2^30; power-of-two factors via modular doubling).
    ``modulus`` may be a Python int or a traced int32/uint32 scalar.
    """
    mu = jnp.asarray(modulus, dtype=jnp.uint32)
    q = (j >> 15).astype(jnp.uint32)
    r = (j & 0x7FFF).astype(jnp.uint32)
    a = _mod_double((q * q) % mu, 30, mu)
    b = _mod_double((q * r) % mu, 16, mu)
    c = (r * r) % mu
    s = a + b  # < 2·modulus < 2^32
    s = jnp.where(s >= mu, s - mu, s)
    s = s + c
    s = jnp.where(s >= mu, s - mu, s)
    return s


def _chirp(j: jnp.ndarray, n0, sign: float) -> jnp.ndarray:
    """exp(sign·iπ·j²/n0) with the phase reduced exactly mod 2π.

    ``j`` int32 indices (values outside [0, n0) produce garbage — callers
    mask).  sign=-1 for the forward chirp, +1 for the inverse.  ``n0`` may
    be a Python int or a traced int32 scalar.

    The integer phase q = j² mod 2n0 is reduced further, exactly, to a
    quadrant and an angle of at most π/4 (the complement within the
    quadrant swaps cos and sin), so cos/sin only ever see small float32
    arguments.  A float32 angle up to 2π carries up to ~6e-7 rad of
    rounding; through the two Bluestein passes of the exact filters that
    left a one-sample image of the signal's spectral peak (8.4e-5 at a
    10-minute 48 kHz length).
    """
    n0_u = jnp.asarray(n0, dtype=jnp.uint32)
    # 2q < 4·n0 ≤ 2^32 for n0 < 2^30: the angle is (π/2)·(2q/n0)
    q2 = _modsq(j, n0_u * jnp.uint32(2)) * jnp.uint32(2)
    quad = q2 // n0_u  # quadrant 0..3
    rem = q2 - quad * n0_u  # in-quadrant angle (π/2)·rem/n0, rem < n0
    upper = rem + rem > n0_u  # past π/4: use the complement angle
    part = jnp.where(upper, n0_u - rem, rem)
    a = np.float32(np.pi / 2) * (
        part.astype(jnp.float32) / n0_u.astype(jnp.float32)
    )
    ca, sa = jnp.cos(a), jnp.sin(a)
    c = jnp.where(upper, sa, ca)
    s = jnp.where(upper, ca, sa)
    # rotate (c, s) by quad·π/2 — exact sign flips and swaps
    cos_t = jnp.select([quad == 0, quad == 1, quad == 2], [c, -s, -c], s)
    sin_t = jnp.select([quad == 0, quad == 1, quad == 2], [s, c, -s], -c)
    return jax.lax.complex(cos_t, np.float32(sign) * sin_t)


def chirp_kernel_at_bins(k: jnp.ndarray, n0, m: int, sign: float) -> jnp.ndarray:
    """Bluestein time-domain chirp kernel at global m-indices ``k``:
    K[k] = w̄[k] (k < n0), K[m−k] = w̄[k] (1 ≤ k < n0), else 0.

    THE definition of the kernel layout — shared by the mesh-sharded path,
    the single-chip blockwise path (parallel.streaming_eq) and the batched
    length-dynamic EQ, which must stay bit-identical.  ``n0`` may be traced.
    """
    head = k < n0
    tail = k > m - n0  # mirror region; maps to w̄[m−k]
    idx = jnp.where(head, k, jnp.where(tail, m - k, 0))
    wbar = _chirp(idx, n0, sign=-sign)  # conj of the length-n0 chirp
    return jnp.where(head | tail, wbar, jnp.zeros_like(wbar))


def air_gain_from_bins(k: jnp.ndarray, n0, rate, factor) -> jnp.ndarray:
    """Two-sided air-absorption gain at full-FFT bins ``k`` of an n0-point
    transform: 1 below 2 kHz, falling linearly to 1 − 0.8·factor at Nyquist
    (0 outside [0, n0)) — the device mirror of
    ``ops.filters._air_ramp_np``/``air_absorption_gain`` (reference
    semantics raytracer_studio.py:310-336) for the exact-length streaming
    air filter.

    Unlike the shelf masks there are no edge bins to pin: the ramp is
    continuous, so the float32 bin→frequency arithmetic here differs from
    the host float64 curve by ≤ ~1e-7 relative (folded bin index ≤ 2^29
    rounds at 2^-24 relative; the per-bin ramp slope is ~2/n0).  ``n0`` may
    be a Python int or a traced int32 scalar; ``rate``/``factor`` may be
    traced.  The gain is real and symmetric under k → n0−k (the ramp reads
    the FOLDED bin), so the channel-pair complex packing used by the
    blockwise EQ stays exact for this filter too.
    """
    in_band = k < n0
    k_fold = jnp.minimum(k, jnp.asarray(n0, jnp.int32) - k)
    df = jnp.asarray(rate, jnp.float32) / jnp.asarray(n0, jnp.float32)
    f = k_fold.astype(jnp.float32) * df
    start = jnp.float32(config.AIR_ABSORPTION_START_HZ)
    max_freq = jnp.asarray(n0 // 2, jnp.float32) * df  # rfftfreq's last bin
    ramp = jnp.clip((f - start) / (max_freq - start), 0.0, 1.0)
    ramp = jnp.where(f >= start, ramp, 0.0)
    damping = (
        jnp.clip(jnp.asarray(factor, jnp.float32), 0.0, 1.0)
        * jnp.float32(config.AIR_ABSORPTION_MAX_DAMPING)
    )
    gain = 1.0 - ramp * damping
    return jnp.where(in_band, gain, 0.0).astype(jnp.float32)


def band_edges(n0: int, rate: int):
    """(k_lo, k_bass, k_treble): bass bins are [k_lo, k_bass], treble bins
    start at k_treble — replicating ``np.fft.rfftfreq``'s float64 arithmetic
    bit-for-bit.  ``ops.filters.shelf_eq_gain`` builds its masks from
    rfftfreq, and a bin can land *exactly* on a cutoff with float dust (e.g.
    250.00000000000003 Hz at 44.1 kHz), so an integer floor/ceil of
    cutoff·n0/rate disagrees with the single-device mask on edge bins.

    HOST float64 code — n0 must be a Python int here; the traced-n0 EQ
    receives these as scalar graph arguments.
    """
    val = 1.0 / (n0 * (1.0 / rate))  # rfftfreq(n0, d=1/rate) bin spacing
    half = n0 // 2
    bass_hz = float(config.EQ_BASS_CUTOFF_HZ)
    treble_hz = float(config.EQ_TREBLE_CUTOFF_HZ)

    k_lo = 0  # smallest bin with freq > 1e-6 (the bass mask's DC exclusion)
    while k_lo <= half and k_lo * val <= 1e-6:
        k_lo += 1
    k_bass = min(int(np.floor(bass_hz * n0 / rate)) + 2, half)
    while k_bass >= 0 and k_bass * val > bass_hz:
        k_bass -= 1
    k_treble = max(int(np.ceil(treble_hz * n0 / rate)) - 2, 0)
    while k_treble <= half and k_treble * val < treble_hz:
        k_treble += 1
    return k_lo, k_bass, k_treble


def shelf_gain_from_edges(
    k: jnp.ndarray, n0, k_lo, k_bass, k_treble, bass_gain, treble_gain
) -> jnp.ndarray:
    """Two-sided shelf gain at bin indices ``k`` given precomputed edge bins
    (0 outside [0, n0); in-band out-of-mask bins return 1).

    All of n0/k_lo/k_bass/k_treble may be Python ints or traced int32
    scalars — the parity-bearing float64 edge derivation stays on the host
    (`band_edges`).
    """
    in_band = k < n0
    bass_mask = in_band & (
        ((k >= k_lo) & (k <= k_bass)) | ((k >= n0 - k_bass) & (k <= n0 - k_lo))
    )
    treble_mask = in_band & (k >= k_treble) & (k <= n0 - k_treble)
    lo, hi = config.EQ_GAIN_CLIP
    gain = jnp.where(bass_mask, jnp.clip(bass_gain, lo, hi), 1.0)
    gain = jnp.where(treble_mask, jnp.clip(treble_gain, lo, hi), gain)
    return jnp.where(in_band, gain, 0.0).astype(jnp.float32)


def shelf_gain_at_bins(
    k: jnp.ndarray, n0: int, rate: int, bass_gain, treble_gain
) -> jnp.ndarray:
    """Static-n0 convenience: host band edges + `shelf_gain_from_edges`."""
    k_lo, k_bass, k_treble = band_edges(n0, rate)
    return shelf_gain_from_edges(
        k, n0, k_lo, k_bass, k_treble, bass_gain, treble_gain
    )
