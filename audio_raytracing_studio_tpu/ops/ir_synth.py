"""On-device impulse-response synthesis (the "audio raytracer").

Accelerator-first reformulation of the reference's Python reflection loop and noise
shaping (/root/reference/raytracer_studio.py:238-308):

- early reflections: the per-tap interpreted loop (:261-268) becomes one
  vectorized masked scatter-add over a static 80-tap budget,
- late tail: uniform noise → static-width moving average → exponential decay
  envelope computed as ``exp(k·log d)`` (no sequential dependence),
- normalizations: data-dependent rescales via ``jnp.where`` (XLA-friendly,
  no host sync).

Static shape ints live in ``IRShape`` (hashable → jit static arg); value
scalars (directionality, decay, amplitudes) live in the traced ``IRScalars``
pytree so slider moves don't recompile.  Randomness is either injected
(``IRDraws`` — oracle-parity mode) or drawn from a ``jax.random`` key (the
framework's deterministic contract, fixing the reference's unseeded global
RNG at :262-285).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..params import IRDraws, IRGeometry

MAX_REFLECTIONS = config.REF_COUNT_CLIP[1]  # static tap budget (80)


class IRShape(NamedTuple):
    """Shape-determining (static, hashable) part of an IR synthesis."""

    length: int
    split_point: int
    actual_max_early_delay: int
    reflection_count: int
    late_length: int
    noise_smooth_width: int
    early_taps_active: bool

    @classmethod
    def from_geometry(cls, g: IRGeometry) -> "IRShape":
        return cls(
            length=g.length,
            split_point=g.split_point,
            actual_max_early_delay=g.actual_max_early_delay,
            reflection_count=g.reflection_count,
            late_length=g.late_length,
            noise_smooth_width=g.noise_smooth_width,
            early_taps_active=g.early_taps_active,
        )


class IRScalars(NamedTuple):
    """Traced f32 value scalars (host-derived in float64)."""

    one_minus_absorption: jax.Array
    directionality: jax.Array
    log_decay_factor: jax.Array
    initial_late_amp: jax.Array

    @classmethod
    def from_geometry(cls, g: IRGeometry) -> "IRScalars":
        # log of the decay factor MUST be taken on host in float64: the
        # factor sits within ~2e-5 of 1.0, so a float32 log would lose ~3
        # digits and skew the tail envelope by percents over a 10 s IR.
        return cls(
            one_minus_absorption=jnp.float32(1.0 - g.absorption),
            directionality=jnp.float32(g.directionality),
            log_decay_factor=jnp.float32(math.log(g.decay_factor)),
            initial_late_amp=jnp.float32(g.initial_late_amp),
        )


def hash_draws(
    seed: jax.Array | int, shape: IRShape
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Draw (delays, strengths, noise) from the counter-based stream (ops.rng).

    Every value is a pure function of (seed, stream, index), so every
    renderer (batched, streaming, sequence-parallel) draws identical values
    for the same seed (PARITY.md "seed streams v2").

    Uses the full static MAX_REFLECTIONS budget; taps beyond the shape's
    reflection_count are masked out downstream, so the same seed gives the
    same IR for any tap count up to the budget (counts above
    MAX_REFLECTIONS cap there — the reference product path clips to the
    same 80, raytracer_studio.py:224).
    """
    from . import rng

    if isinstance(seed, (int, np.integer)):
        # any Python int (e.g. os.urandom 32-bit values ≥ 2^31) wraps into
        # the int32 carrier; the stream only sees the uint32 bit pattern
        seed = np.uint32(int(seed) & 0xFFFFFFFF).astype(np.int32)
    seed = jnp.asarray(seed, dtype=jnp.int32)
    hi = max(2, shape.actual_max_early_delay)
    k = jnp.arange(MAX_REFLECTIONS, dtype=jnp.uint32)
    delay_bits = rng.counter_bits(rng.stream_mix(seed, rng.DELAY_STREAM), k)
    delays = 1 + (delay_bits % np.uint32(max(1, hi - 1))).astype(jnp.int32)
    strengths = rng.uniform_from_bits(
        rng.counter_bits(rng.stream_mix(seed, rng.STRENGTH_STREAM), k),
        config.EARLY_STRENGTH_RANGE[0],
        config.EARLY_STRENGTH_RANGE[1],
    )
    t = jnp.arange(max(1, shape.late_length), dtype=jnp.uint32)
    noise = rng.uniform_from_bits(
        rng.counter_bits(rng.stream_mix(seed, rng.NOISE_STREAM), t), -1.0, 1.0
    )
    return delays, strengths, noise


def draws_to_device(draws: IRDraws) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pad host IRDraws to the static tap budget and move to device arrays."""
    n = len(draws.delays)
    if n > MAX_REFLECTIONS:
        # derive_ir_geometry does not clip reflection_count (only the
        # product path's adjust_parameters_for_3d does, ref :224) — a
        # >80-tap injection must fail clearly, not as a broadcast error
        raise ValueError(
            f"injected draws carry {n} early taps; the compiled kernels' "
            f"static budget is MAX_REFLECTIONS={MAX_REFLECTIONS} "
            "(the reference product path clips to the same range, "
            "raytracer_studio.py:224)"
        )
    delays = np.zeros(MAX_REFLECTIONS, dtype=np.int32)
    strengths = np.zeros(MAX_REFLECTIONS, dtype=np.float32)
    delays[:n] = draws.delays
    strengths[:n] = draws.strengths
    noise = np.asarray(draws.noise, dtype=np.float32)
    if noise.size == 0:
        noise = np.zeros(1, dtype=np.float32)
    return jnp.asarray(delays), jnp.asarray(strengths), jnp.asarray(noise)


def _moving_average_same(noise: jax.Array, width: int) -> jax.Array:
    """np.convolve(x, ones(w)/w, mode='same') with static width.

    Matches the reference's smoothing alignment (raytracer_studio.py:288):
    'same' keeps the centre of the full convolution, leading offset w//2.
    """
    if width <= 1:
        return noise
    n = noise.shape[-1]
    lead = width // 2
    trail = width - 1 - lead
    padded = jnp.pad(noise, (lead, trail))
    # Direct sum of `width` (≤ 10) shifted copies.  A cumsum-based sliding
    # window would be O(n) too but its float32 running sum accumulates
    # random-walk error ~sqrt(n)·eps that the downstream dense convolution
    # amplifies past the 1e-3 parity budget; the shifted-add form keeps
    # per-sample error at a few ulps.
    acc = padded[0:n]
    for k in range(1, width):
        acc = acc + padded[k : k + n]
    return acc / width


def early_tap_amps(
    delays: jax.Array,
    strengths: jax.Array,
    actual_max_early_delay: int,
    one_minus_absorption,
    directionality,
) -> jax.Array:
    """The parity-bearing early-tap amplitude law (ref :263-267):
    strength · (1−absorption) · clip(directionality, 0.1, 1) · distance
    falloff.  The ONE definition of it on the device path.
    """
    falloff = 1.0 - (
        delays.astype(jnp.float32) / float(actual_max_early_delay)
    ) ** config.EARLY_DELAY_DECAY_EXP
    return (
        strengths
        * one_minus_absorption
        * jnp.clip(directionality, 0.1, 1.0)
        * falloff
    )


def synthesize(
    shape: IRShape,
    delays: jax.Array,
    strengths: jax.Array,
    noise: jax.Array,
    scalars: IRScalars,
) -> Tuple[jax.Array, jax.Array]:
    """Build (early_ir, late_ir), both of static length ``shape.length``."""
    s = shape
    early_ir = jnp.zeros(s.length, dtype=jnp.float32)
    late_ir = jnp.zeros(s.length, dtype=jnp.float32)

    # --- Early reflections: masked scatter-add (ref :258-268) ---
    if s.early_taps_active:
        tap_index = jnp.arange(MAX_REFLECTIONS)
        active = tap_index < s.reflection_count
        valid = active & (delays > 0) & (delays < s.split_point)
        amp = early_tap_amps(
            delays, strengths, s.actual_max_early_delay,
            scalars.one_minus_absorption, scalars.directionality,
        )
        amp = jnp.where(valid, amp, 0.0)
        safe_delays = jnp.where(valid, delays, 0)
        early_ir = early_ir.at[safe_delays].add(amp)
        # masked taps accumulate 0.0 at sample 0 — harmless; sample 0 of the
        # early IR is by construction silent (delays >= 1, ref :262)

    # --- Late tail (ref :270-296) ---
    if s.late_length > 0:
        w = s.noise_smooth_width
        if w > 1 and s.late_length >= w:
            smoothed = _moving_average_same(noise, w)
            std_raw = jnp.std(noise)
            std_smooth = jnp.std(smoothed)
            smoothed = jnp.where(
                std_smooth > 1e-6, smoothed / std_smooth * std_raw, noise
            )
        else:
            smoothed = noise
        k = jnp.arange(s.late_length, dtype=jnp.float32)
        envelope = jnp.exp(k * scalars.log_decay_factor)
        tail = smoothed[: s.late_length] * scalars.initial_late_amp * envelope
        late_ir = late_ir.at[s.split_point :].set(tail)

    # --- Normalization (ref :299-303) ---
    if s.length > 1:
        early_max = jnp.max(jnp.abs(early_ir[1:]))
        early_ir = early_ir * jnp.where(
            early_max > 1e-6, config.EARLY_NORM_PEAK / early_max, 1.0
        )
        # sample 0 is excluded from scaling in the reference; it is always 0
        # here, so whole-array scaling is equivalent.
    late_max = jnp.max(jnp.abs(late_ir))
    late_ir = late_ir * jnp.where(
        late_max > 1e-6, config.LATE_NORM_PEAK / late_max, 1.0
    )

    return early_ir, late_ir
