"""Bluestein exact-FFT unit tests at awkward lengths."""

import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracing_studio_tpu.ops import fftops


@pytest.mark.parametrize("n", [3, 17, 100, 1000, 12289, 129599, 65536])
def test_rfft_matches_numpy(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    ours = np.asarray(fftops.rfft_exact(jnp.asarray(x), n))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(ours - ref)) / scale < 5e-6


@pytest.mark.parametrize("n", [3, 17, 100, 999, 12288, 129599])
def test_roundtrip(rng, n):
    x = rng.standard_normal((1, n)).astype(np.float32)
    back = np.asarray(fftops.irfft_exact(fftops.rfft_exact(jnp.asarray(x), n), n))
    assert np.max(np.abs(back - x)) < 2e-5


@pytest.mark.parametrize("n", [64, 100])  # pow2 + Bluestein branches
def test_irfft_zero_pads_short_spectrum(rng, n):
    # np.fft.irfft(spec, n) zero-pads a spectrum with < n//2+1 bins; the
    # pow2 branch used to only truncate, returning the wrong length.
    short = (
        rng.standard_normal((2, n // 4)) + 1j * rng.standard_normal((2, n // 4))
    ).astype(np.complex64)
    ours = np.asarray(fftops.irfft_exact(jnp.asarray(short), n))
    ref = np.fft.irfft(short, n=n, axis=-1)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 2e-5


def test_circular_gain_matches_numpy(rng):
    n = 48001  # odd length
    x = rng.standard_normal((2, n)).astype(np.float32)
    gain = rng.uniform(0.2, 2.0, size=n // 2 + 1).astype(np.float32)
    ours = np.asarray(fftops.apply_circular_gain(jnp.asarray(x), jnp.asarray(gain)))
    ref = np.fft.irfft(np.fft.rfft(x, axis=-1) * gain, n=n, axis=-1)
    assert np.max(np.abs(ours - ref)) < 5e-5


def test_pow2_uses_direct_path(rng):
    n = 4096
    x = rng.standard_normal((1, n)).astype(np.float32)
    ours = np.asarray(fftops.rfft_exact(jnp.asarray(x), n))
    ref = np.fft.rfft(x, axis=-1)
    assert np.max(np.abs(ours - ref)) / np.max(np.abs(ref)) < 1e-6


def test_bluestein_length_prefers_radix3():
    # 3·2^k fits whenever 2n−1 ≤ 3/4·next_pow2(2n−1); one-off boundary: at
    # n=12289, 2n−1 = 24577 just exceeds 3·2^13 = 24576 → power of two.
    assert fftops._bluestein_length(12288) == 3 * 2**13
    assert fftops._bluestein_length(12289) == 2**15
    assert fftops._bluestein_length(2951999) == 3 * 2**21  # bench air length
    assert fftops._bluestein_length(5) == 16  # tiny n stays pow2


@pytest.mark.parametrize("n", [48001, 12288, 90001])
def test_radix3_lengths_match_numpy(rng, n):
    # all three land on the m = 3·2^k Bluestein path
    assert fftops._bluestein_length(n) % 3 == 0
    x = rng.standard_normal((2, n)).astype(np.float32)
    ours = np.asarray(fftops.rfft_exact(jnp.asarray(x), n))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    scale = max(1.0, np.max(np.abs(ref)))
    assert np.max(np.abs(ours - ref)) / scale < 5e-6
    back = np.asarray(fftops.irfft_exact(jnp.asarray(ours), n))
    assert np.max(np.abs(back - x)) < 2e-5


def test_packed_stereo_conv_radix3_grid(rng):
    # batched-context convolve_full (pow2=True) must reach the 3·2^k grid
    # through the pair-packed complex radix-3 path and stay exact
    import jax

    from audio_raytracing_studio_tpu.ops import convolution

    n, l = 3000, 1100  # need=4099 → pow2 8192, fast 3·2^11=6144 → packed path
    assert convolution.fast_fft_length(n + l - 1) == 3 * 2**11
    sig = rng.standard_normal((4, 2, n)).astype(np.float32)
    ker = rng.standard_normal((2, l)).astype(np.float32)
    out_len = n + l - 1
    f = jax.jit(
        jax.vmap(
            lambda s: convolution.convolve_full(s, jnp.asarray(ker), out_len, pow2=True)
        )
    )
    got = np.asarray(f(jnp.asarray(sig)))
    assert got.shape == (4, 2, 2, out_len)
    ref = np.stack(
        [
            np.stack(
                [
                    np.stack(
                        [
                            np.convolve(sig[b, c].astype(np.float64), ker[k])
                            for c in range(2)
                        ]
                    )
                    for k in range(2)
                ]
            )
            for b in range(4)
        ]
    )
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got - ref)) / scale < 1e-5


def test_affine_circular_filters_match_bluestein(rng):
    # the affine fast path (one real wrap-conv roundtrip) must equal the
    # generic Bluestein circular gain above the size threshold, for both
    # filters, including under vmap (rank-3 real transforms)
    import jax

    from audio_raytracing_studio_tpu.ops import filters

    n = 150001  # > _AFFINE_MIN_N, odd, non-pow2
    assert n >= filters._AFFINE_MIN_N
    rate = 48000
    x = rng.standard_normal((2, n)).astype(np.float32) * 0.3

    for fname, args in [
        ("apply_air_absorption", (rate, jnp.float32(0.7))),
        ("apply_shelf_eq", (rate, jnp.float32(1.6), jnp.float32(0.7))),
    ]:
        fn = getattr(filters, fname)
        if fname == "apply_air_absorption":
            gain = filters.air_absorption_gain(n, rate, args[1])
        else:
            gain = filters.shelf_eq_gain(n, rate, args[1], args[2])
        # stereo (2, n): the pair-packed complex fft_fast path
        fast = np.asarray(fn(jnp.asarray(x), *args))
        exact = np.asarray(
            fftops.apply_circular_gain(jnp.asarray(x), gain)
        )
        assert np.max(np.abs(fast - exact)) < 5e-5, fname
        # non-stereo shapes fall back to the real rfft roundtrip; batched
        # renderers force power-of-two wrap grids there (ROADMAP D2) —
        # same identity
        x1 = x[:1]
        exact1 = np.asarray(
            fftops.apply_circular_gain(jnp.asarray(x1), gain)
        )
        real = np.asarray(fn(jnp.asarray(x1), *args))
        assert np.max(np.abs(real - exact1)) < 5e-5, fname
        pow2 = np.asarray(fn(jnp.asarray(x1), *args, pow2=True))
        assert np.max(np.abs(pow2 - exact1)) < 5e-5, fname
        m_pow2 = filters._wrap_spectrum(
            "air_ramp" if fname == "apply_air_absorption" else "bass_mask",
            n,
            rate,
            True,
        )[1]
        assert fftops.is_power_of_two(m_pow2) and m_pow2 >= 2 * n

    # vmapped (batched exact render shape)
    xs = rng.standard_normal((3, 2, n)).astype(np.float32) * 0.3
    f = jax.jit(
        jax.vmap(lambda s: filters.apply_shelf_eq(s, rate, 1.6, 0.7))
    )
    got = np.asarray(f(jnp.asarray(xs)))
    ref = np.stack(
        [
            np.asarray(
                fftops.apply_circular_gain(
                    jnp.asarray(xs[i]), filters.shelf_eq_gain(n, rate, 1.6, 0.7)
                )
            )
            for i in range(3)
        ]
    )
    assert np.max(np.abs(got - ref)) < 5e-5


def test_radix3_pair_packed_under_vmap(rng):
    # the batched exact render hits apply_circular_gain through vmap — the
    # radix-3 decimation must only issue pow2 device FFTs there (the native
    # batched 3·2^k layouts are the known pathological case)
    import jax

    n = 12288
    gain = rng.uniform(0.3, 1.8, size=n // 2 + 1).astype(np.float32)
    sigs = rng.standard_normal((6, 2, n)).astype(np.float32)
    f = jax.jit(jax.vmap(lambda s: fftops.apply_circular_gain(s, jnp.asarray(gain))))
    got = np.asarray(f(jnp.asarray(sigs)))
    ref = np.fft.irfft(np.fft.rfft(sigs.astype(np.float64), axis=-1) * gain, n, axis=-1)
    assert np.max(np.abs(got - ref)) < 5e-5


class TestFlatBatching:
    """*_rows transforms: under vmap, batch dims must collapse into rows.

    Flat rows were the faster layout on the accelerator this was first
    built for (tools/profile_conv.py; open on the GPU, ROADMAP D1).  These
    tests pin (a) the custom batching rule's
    numerics against per-example application and (b) that the lowered
    module really contains only rank-2 FFT ops under (nested) vmap.
    """

    def test_vmapped_fft_fast_matches_per_example(self, rng):
        import jax

        for m in (256, 384):  # pow2 and 3·2^k
            x = rng.standard_normal((6, 2, 200)).astype(np.float32)
            f = jax.jit(jax.vmap(lambda a, m=m: fftops.fft_fast(a, m)))
            got = np.asarray(f(jnp.asarray(x)))
            ref = np.stack(
                [np.asarray(fftops.fft_fast(jnp.asarray(x[i]), m)) for i in range(6)]
            )
            assert np.max(np.abs(got - ref)) < 1e-5, m
            gi = np.asarray(jax.jit(jax.vmap(fftops.ifft_fast))(jnp.asarray(got)))
            ri = np.stack(
                [np.asarray(fftops.ifft_fast(jnp.asarray(ref[i]))) for i in range(6)]
            )
            assert np.max(np.abs(gi - ri)) < 1e-5, m

    def test_nested_vmap_flattens_and_matches(self, rng):
        import jax

        y = rng.standard_normal((3, 4, 2, 128)).astype(np.float32)
        g = jax.jit(jax.vmap(jax.vmap(lambda a: fftops.fft_fast(a, 128))))
        got = np.asarray(g(jnp.asarray(y)))
        ref = np.fft.fft(y, n=128, axis=-1)
        assert np.max(np.abs(got - ref)) < 1e-4

    def test_lowered_ffts_are_rank2_under_vmap(self):
        import re

        import jax

        txt = (
            jax.jit(jax.vmap(lambda a: fftops.fft_fast(a, 256)))
            .lower(jnp.zeros((6, 2, 200), jnp.float32))
            .as_text()
        )
        shapes = re.findall(r"stablehlo\.fft[^:]*:\s*\(tensor<([0-9x]+)x", txt)
        assert shapes, "no fft op found in lowered module"
        for s in shapes:
            assert s.count("x") == 1, f"fft not flattened to rank 2: {s}x..."

    def test_rows_transforms_unbatched_passthrough(self, rng):
        x = rng.standard_normal((5, 64)).astype(np.float32)
        assert np.allclose(
            np.asarray(fftops.rfft_rows(jnp.asarray(x))),
            np.fft.rfft(x, axis=-1),
            atol=1e-4,
        )
        z = np.fft.rfft(x, axis=-1).astype(np.complex64)
        assert np.allclose(
            np.asarray(fftops.irfft_rows(jnp.asarray(z))),
            np.fft.irfft(z, axis=-1),
            atol=1e-5,
        )

    def test_non_pow2_real_grid_keeps_batched_rank(self, rng):
        # 3·2^k REAL transforms are rank-sensitive the other way (CLAUDE.md:
        # rank-3 (B,2,3·2^k) rfft measured clean at B=48, other layouts
        # mis-tile) — the rule must reproduce the pre-flattening batched op
        import re

        import jax

        x = rng.standard_normal((6, 2, 300)).astype(np.float32)
        fn = jax.vmap(lambda a: fftops.rfft_rows(fftops.pad_last(a, 384)))
        txt = jax.jit(fn).lower(jnp.asarray(x)).as_text()
        shapes = re.findall(r"stablehlo\.fft[^:]*:\s*\(tensor<([0-9x]+)x", txt)
        assert shapes and all(s.count("x") == 2 for s in shapes), shapes
        got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
        ref = np.fft.rfft(x, n=384, axis=-1)
        assert np.max(np.abs(got - ref)) < 1e-3
