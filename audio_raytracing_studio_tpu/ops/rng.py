"""Counter-based random stream for IR synthesis.

The reference uses an unseeded global ``np.random`` (raytracer_studio.py:
262-285).  Here every random draw is a pure function of
``(seed, stream, index)`` computed with uint32 arithmetic —

    bits(index) = lowbias32(stream_mix + index * PHI)
    stream_mix  = lowbias32(seed ^ stream_salt)

``lowbias32`` is a public-domain 32-bit finalizer (a Murmur3-style
xor-shift/multiply avalanche) — pure elementwise integer ops, identical
under jit on any backend and on the host.  Counter-based draws are
order-invariant: any block of an IR can be regenerated on its own, so a
blocked or sharded synthesis cannot change the audio.

Contract (PARITY.md "seed streams v2"): for a given ``seed``,
``ops.ir_synth.hash_draws`` draws the same values on every backend and in
every renderer (batched, streaming, sequence-parallel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PHI = np.uint32(0x9E3779B9)  # 2^32 / golden ratio — Weyl increment

# Distinct salts → independent streams per draw family.
DELAY_STREAM = np.uint32(0xA511E9B3)
STRENGTH_STREAM = np.uint32(0x63D83595)
NOISE_STREAM = np.uint32(0xC2B2AE35)


def lowbias32(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit avalanche hash (lowbias32); input/output uint32."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return x


def stream_mix(seed: jnp.ndarray, stream_salt: np.uint32) -> jnp.ndarray:
    """Per-(seed, stream) mixing constant (uint32 scalar or array)."""
    s = jnp.asarray(seed).astype(jnp.uint32)
    return lowbias32(s ^ stream_salt)


def counter_bits(mix: jnp.ndarray, index: jnp.ndarray) -> jnp.ndarray:
    """Random uint32 bits for each counter value ``index`` (any shape)."""
    return lowbias32(mix + index.astype(jnp.uint32) * PHI)


def uniform_from_bits(bits: jnp.ndarray, lo: float, hi: float) -> jnp.ndarray:
    """uint32 bits → float32 uniform [lo, hi) via the mantissa trick."""
    mantissa = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    one_to_two = jax.lax.bitcast_convert_type(mantissa, jnp.float32)
    return lo + (one_to_two - np.float32(1.0)) * np.float32(hi - lo)
