"""On-device loudness / peak / RMS metering (JAX).

Replaces the reference's host-side pyloudnorm call
(/root/reference/raytracer_studio.py:674-711) so metering runs inside the
same compiled graph as the render.

Accelerator-first reformulation: the two K-weighting IIR biquads become one FIR
filter (their impulse response truncated at 8192 taps, where it has decayed
below 1e-18 — the RLB high-pass pole radius is ~0.9975 at 48 kHz), applied
via the existing batched FFT convolution.  That turns a 3M-step sequential
recurrence into two FFTs.  Gating blocks are mean squares gathered from a
cumulative energy sum at host-precomputed indices (pyloudnorm's block
grid), and both gates are masked reductions — no data-dependent shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import convolution
from . import kweighting as kw

K_FIR_LENGTH = 8192


@functools.lru_cache(maxsize=16)
def k_weighting_fir(rate: int, length: int = K_FIR_LENGTH) -> np.ndarray:
    """Truncated float64 impulse response of the K-weighting cascade (host)."""
    from scipy.signal import lfilter

    impulse = np.zeros(length, dtype=np.float64)
    impulse[0] = 1.0
    out = impulse
    for b, a in kw.k_weighting_coefficients(rate):
        out = lfilter(b, a, out)
    return out


@functools.lru_cache(maxsize=64)
def _block_bounds(num_samples: int, rate: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(lower, upper) sample indices of each 400 ms gating block (host)."""
    T_g = kw.BLOCK_SECONDS
    step = 1.0 - kw.BLOCK_OVERLAP
    num_blocks = kw.block_count(num_samples, rate)
    j = np.arange(max(num_blocks, 1))
    lo = (T_g * (j * step) * rate).astype(np.int64)
    hi = (T_g * (j * step + 1) * rate).astype(np.int64)
    hi = np.minimum(hi, num_samples)
    return lo, hi, num_blocks


def _k_weight_impl(signal: jnp.ndarray, rate: int, pow2: bool = False) -> jnp.ndarray:
    n = signal.shape[-1]
    fir = jnp.asarray(k_weighting_fir(rate).astype(np.float32))
    need = n + int(fir.shape[0]) - 1
    # pow2: batched/vmapped meters use power-of-two grids, the same rule
    # as StaticSpec.pow2_conv on the render conv (batched 3·2^k grids are
    # an open A/B on the GPU, ROADMAP D2)
    from ..ops import fftops
    from ..ops.fftops import next_power_of_two

    nfft = next_power_of_two(need) if pow2 else convolution.fast_fft_length(need)
    sig_f = fftops.rfft_rows(fftops.pad_last(signal, nfft))
    fir_f = fftops.rfft_rows(fftops.pad_last(fir, nfft))
    out = fftops.irfft_rows(sig_f * fir_f)
    return out[..., :n].astype(jnp.float32)


_k_weight_jit = jax.jit(_k_weight_impl, static_argnames=("rate", "pow2"))


def k_weight(signal: jnp.ndarray, rate: int, pow2: bool = False) -> jnp.ndarray:
    """Apply the K-weighting prefilter over the last axis (causal FIR form).

    One kernel FFT broadcast against all channels (a per-channel kernel
    copy would redundantly transform the same 8192 taps C times).

    Jitted so a host caller gets one compiled graph (the spectrum product
    is complex64); under an enclosing jit the nested jit inlines.
    """
    return _k_weight_jit(jnp.asarray(signal), rate=int(rate), pow2=bool(pow2))


def _block_mean_squares_impl(
    signal: jnp.ndarray, rate: int, valid_len: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Shared body of the unmasked/masked block meters (one copy of the
    precision-sensitive energy-prefix logic — see block_mean_squares)."""
    n = signal.shape[-1]
    lo, hi, num_blocks = _block_bounds(n, rate)
    if num_blocks <= 0:
        return jnp.zeros(signal.shape[:-1] + (0,), dtype=jnp.float32)
    energy = jnp.cumsum(jnp.square(signal), axis=-1)
    padded = jnp.concatenate(
        [jnp.zeros(signal.shape[:-1] + (1,), energy.dtype), energy], axis=-1
    )
    if valid_len is None:
        block_energy = padded[..., hi] - padded[..., lo]
    else:
        hi_c = jnp.minimum(jnp.asarray(hi, dtype=jnp.int32), valid_len)
        lo_c = jnp.minimum(jnp.asarray(lo, dtype=jnp.int32), valid_len)
        block_energy = padded[..., hi_c] - padded[..., lo_c]
    return block_energy / (kw.BLOCK_SECONDS * rate)


def block_mean_squares(signal: jnp.ndarray, rate: int) -> jnp.ndarray:
    """Per-gating-block mean square z_j over the last axis → (..., num_blocks).

    Energy-cumsum + gather at pyloudnorm's block grid: z_j = Σ x² / (T_g·rate).

    Precision envelope: XLA lowers the float32 cumsum as a parallel scan,
    so a block energy (difference of two prefixes) carries ~log2(n)·eps of
    the *total* energy — ≈0.01 dB at the ~10-minute ceiling of the single-
    shot render path.  Hour-scale clips go through the streaming meter
    (30 s chunk prefixes + host-float64 running carry,
    parallel/streaming.py) or the sequence-parallel meter (segmented
    per-shard prefixes bounded to one gating block span,
    parallel/long_render.py) — both bound the prefix magnitude instead.
    """
    return _block_mean_squares_impl(signal, rate)


def gated_loudness_from_blocks(
    z: jnp.ndarray, w: jnp.ndarray, valid: jnp.ndarray | None = None
) -> jnp.ndarray:
    """BS.1770 two-stage gating over per-block mean squares z (C, J).

    Shared by the single-device meter and the sequence-parallel meter
    (parallel.long_render), which assemble z differently.

    ``valid`` (J,) bool, optional: blocks to include in the measurement —
    the masked meter of zero-padded batch buckets (audio_metrics_masked)
    passes the blocks that lie inside the clip's true output length.
    """
    weighted = jnp.einsum("c,cj->j", w, z, precision=jax.lax.Precision.HIGHEST)
    block_loudness = kw.LOUDNESS_OFFSET + 10.0 * jnp.log10(
        jnp.maximum(weighted, 1e-30)
    )

    def gated_mean(mask):
        count = jnp.sum(mask)
        z_avg = jnp.sum(z * mask[None, :], axis=-1) / jnp.maximum(count, 1)
        loud = kw.LOUDNESS_OFFSET + 10.0 * jnp.log10(
            jnp.maximum(jnp.einsum("c,c->", w, z_avg, precision=jax.lax.Precision.HIGHEST), 1e-30)
        )
        return jnp.where(count > 0, loud, -jnp.inf), count

    abs_mask = block_loudness >= kw.ABSOLUTE_GATE_LUFS
    if valid is not None:
        abs_mask = abs_mask & valid
    abs_loud, abs_count = gated_mean(abs_mask.astype(jnp.float32))
    gamma_r = abs_loud + kw.RELATIVE_GATE_LU

    rel_mask = (block_loudness > gamma_r) & (
        block_loudness > kw.ABSOLUTE_GATE_LUFS
    )
    if valid is not None:
        rel_mask = rel_mask & valid
    loud, count = gated_mean(rel_mask.astype(jnp.float32))
    return jnp.where((abs_count > 0) & (count > 0), loud, -jnp.inf).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("rate", "pow2"))
def _integrated_loudness_jit(
    signal: jnp.ndarray, w: jnp.ndarray, *, rate: int, pow2: bool = False
) -> jnp.ndarray:
    filtered = _k_weight_impl(signal, rate, pow2=pow2)
    z = block_mean_squares(filtered, rate)  # (C, J)
    if z.shape[-1] == 0:
        return jnp.float32(-jnp.inf)
    return gated_loudness_from_blocks(z, w)


def integrated_loudness(
    signal: jnp.ndarray,
    rate: int,
    weights: np.ndarray | None = None,
    pow2: bool = False,
) -> jnp.ndarray:
    """Gated integrated loudness (LUFS) of (n,) mono or (C, n) multichannel.

    Mirrors the oracle meter (oracle/loudness.py) / BS.1770-4 gating: absolute
    −70 LUFS gate, then a relative gate 10 LU below the abs-gated mean.
    Returns −inf as an f32 scalar when everything is gated out.

    Jitted for the same reason as audio_metrics: one compiled graph for a
    host caller, complex spectra included.
    """
    signal = jnp.asarray(signal)
    if signal.ndim == 1:
        signal = signal[None, :]
    num_channels = signal.shape[0]
    if weights is None:
        weights = kw.channel_weights(num_channels)  # LFE excluded (BS.1770-4)
    w = jnp.asarray(np.asarray(weights).astype(np.float32))
    return _integrated_loudness_jit(signal, w, rate=int(rate), pow2=bool(pow2))


def _masked_block_mean_squares(
    signal: jnp.ndarray, rate: int, valid_len: jnp.ndarray
) -> jnp.ndarray:
    """block_mean_squares over ``signal[..., :valid_len]`` — the static block
    grid comes from the PADDED length; each block's upper bound clamps to the
    traced ``valid_len`` (pyloudnorm truncates a final partial block the same
    way, metering/loudness._block_bounds).  Samples past valid_len never
    enter any gathered prefix, so zero-padding junk (FFT roundoff in the
    batch bucket's tail) cannot leak into block energies."""
    return _block_mean_squares_impl(signal, rate, valid_len)


def audio_metrics_masked(
    data_cn: jnp.ndarray,
    rate: int,
    valid_len: jnp.ndarray,
    valid_blocks: jnp.ndarray,
    pow2: bool = False,
) -> dict:
    """``audio_metrics`` of ``data_cn[:, :valid_len]`` without slicing —
    shape-static, so a batch of clips padded to one bucket length can meter
    each clip's TRUE output length under one vmap (parallel.sharding).

    ``valid_len``: traced int32 scalar, the clip's true sample count.
    ``valid_blocks``: traced int32 scalar, ``kw.block_count(valid_len, rate)``
    — computed on HOST (the rounding in block_count is float64 host math;
    reproducing it on device in float32 could disagree at block boundaries).

    Assumes the tail ``data_cn[:, valid_len:]`` is (near-)zero padding: the
    sample peak is taken over the full buffer (exact-zero or roundoff-level
    tails cannot raise it), RMS divides the full-buffer energy by
    ``valid_len``, and gating blocks are masked to the first valid_blocks.
    """
    num_channels = data_cn.shape[0]
    mono = data_cn[0] if num_channels == 1 else jnp.mean(data_cn[:2], axis=0)

    # _impl, not the jitted wrapper: this function always runs under an
    # enclosing jit/vmap (parallel.sharding's batched meter)
    filtered = _k_weight_impl(mono[None, :], rate, pow2=pow2)
    z = _masked_block_mean_squares(filtered, rate, valid_len)
    if z.shape[-1] == 0:
        lufs = jnp.float32(-jnp.inf)
    else:
        valid = jnp.arange(z.shape[-1], dtype=jnp.int32) < valid_blocks
        lufs = gated_loudness_from_blocks(
            z, jnp.ones(1, jnp.float32), valid=valid
        )
        lufs = jnp.where(valid_blocks > 0, lufs, -jnp.inf)
    lufs = jnp.where(jnp.max(jnp.abs(mono)) < 1e-6, -jnp.inf, lufs)

    sq = jnp.sum(jnp.square(data_cn))
    rms = jnp.sqrt(sq / jnp.maximum(valid_len * num_channels, 1))
    rms_db = jnp.where(
        rms > 1e-15, 20.0 * jnp.log10(jnp.maximum(rms, 1e-30)), -jnp.inf
    ).astype(jnp.float32)
    return {
        "lufs": lufs,
        "true_peak_dbfs": sample_peak_dbfs(data_cn),
        "rms_dbfs": rms_db,
    }


def sample_peak_dbfs(data: jnp.ndarray) -> jnp.ndarray:
    """Plain sample peak in dBFS — the reference's "true peak" (:695-697)."""
    peak = jnp.max(jnp.abs(data))
    return jnp.where(
        peak > 1e-15, 20.0 * jnp.log10(jnp.maximum(peak, 1e-30)), -jnp.inf
    ).astype(jnp.float32)


def rms_dbfs(data: jnp.ndarray) -> jnp.ndarray:
    """RMS over all samples/channels in dBFS (:696-698)."""
    rms = jnp.sqrt(jnp.mean(jnp.square(data)))
    return jnp.where(
        rms > 1e-15, 20.0 * jnp.log10(jnp.maximum(rms, 1e-30)), -jnp.inf
    ).astype(jnp.float32)


@functools.lru_cache(maxsize=8)
def _polyphase_kernels(factor: int, taps_per_phase: int) -> np.ndarray:
    """(factor, taps) windowed-sinc interpolation bank, per-phase DC gain 1."""
    length = factor * taps_per_phase
    m = np.arange(length) - (length - 1) / 2.0
    # Kaiser β=10 keeps passband ripple ~1e-4 up to ≈0.45·fs, so tones close
    # to Nyquist meter within ~0.01 dB (a Hann-windowed sinc overshoots ~1 dB
    # there).
    h = np.sinc(m / factor) * np.kaiser(length, 10.0)
    phases = np.stack([h[p::factor] for p in range(factor)])
    phases /= phases.sum(axis=1, keepdims=True)  # exact unity DC gain
    return phases.astype(np.float32)


def oversampled_true_peak_dbfs(
    data: jnp.ndarray, factor: int = 4, taps_per_phase: int = 32
) -> jnp.ndarray:
    """Inter-sample true peak via polyphase 4× windowed-sinc interpolation —
    the BS.1770 Annex 2 capability the reference lacks despite its "true
    peak" label (raytracer_studio.py:695-697) — north-star extension.

    Polyphase (not FFT zero-pad upsampling): FFT interpolation of a finite
    block rings at the block edges and overstates the peak.

    data: (..., n) over the last axis.
    """
    phases = jnp.asarray(_polyphase_kernels(factor, taps_per_phase))
    n = data.shape[-1]
    if n < taps_per_phase:  # too short for one full tap window: zero-pad
        pad = [(0, 0)] * (data.ndim - 1) + [(0, taps_per_phase - n)]
        data = jnp.pad(data, pad)
        n = taps_per_phase
    valid = max(1, n - taps_per_phase + 1)
    # interpolated sample (phase p, offset i) = Σ_k x[i+k]·h_p[k], evaluated
    # only where the full tap window fits — running the kernel off the signal
    # edge rings against the implicit zero padding and overstates the peak.
    peak = jnp.max(jnp.abs(data))
    for p in range(factor):
        acc = jnp.zeros(data.shape[:-1] + (valid,), data.dtype)
        for k in range(taps_per_phase):
            acc = acc + data[..., k : k + valid] * phases[p, k]
        peak = jnp.maximum(peak, jnp.max(jnp.abs(acc)))
    return jnp.where(
        peak > 1e-15, 20.0 * jnp.log10(jnp.maximum(peak, 1e-30)), -jnp.inf
    ).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("rate", "pow2"))
def _audio_metrics_jit(data_cn: jnp.ndarray, *, rate: int, pow2: bool = False) -> dict:
    num_channels = data_cn.shape[0]
    mono = data_cn[0] if num_channels == 1 else jnp.mean(data_cn[:2], axis=0)
    lufs = integrated_loudness(mono, rate, weights=np.array([1.0]), pow2=pow2)
    lufs = jnp.where(jnp.max(jnp.abs(mono)) < 1e-6, -jnp.inf, lufs)
    return {
        "lufs": lufs,
        "true_peak_dbfs": sample_peak_dbfs(data_cn),
        "rms_dbfs": rms_dbfs(data_cn),
    }


def audio_metrics(data_cn: jnp.ndarray, rate: int, pow2: bool = False) -> dict:
    """LUFS / sample-peak / RMS with the reference's conventions.

    data_cn: (C, n) channels-leading.  LUFS meters the mean of the first ≤2
    channels (raytracer_studio.py:687-688); silence (< 1e-6 peak) short-
    circuits to −inf like the reference (:689).

    Jitted: host callers (pipeline.render(return_metrics=True), the
    analyzer CLI) get one compiled graph instead of op-by-op dispatch of
    the complex64 K-weighting spectra.  Under an enclosing jit
    (batched/sharded meters) the call inlines.
    """
    return _audio_metrics_jit(jnp.asarray(data_cn), rate=int(rate), pow2=bool(pow2))
