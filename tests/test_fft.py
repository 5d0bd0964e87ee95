"""Matmul FFT engine vs numpy.fft."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from astroburst_tpu.ops import fft as F


@pytest.mark.parametrize("n", [8, 64, 256, 512, 1024, 4096])
def test_fft_1d_matches_numpy(n, rng):
    x = rng.random((4, n)).astype(np.float32)
    ref = np.fft.fft(x)
    fr, fi = jax.jit(F.fft)(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    got = np.asarray(fr) + 1j * np.asarray(fi)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale)


def test_fft_complex_input(rng):
    xr = rng.random((2, 128)).astype(np.float32)
    xi = rng.random((2, 128)).astype(np.float32)
    ref = np.fft.fft(xr + 1j * xi)
    fr, fi = jax.jit(F.fft)(jnp.asarray(xr), jnp.asarray(xi))
    got = np.asarray(fr) + 1j * np.asarray(fi)
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n", [64, 1024])
def test_ifft_roundtrip(n, rng):
    x = rng.random((3, n)).astype(np.float32)
    xr = jnp.asarray(x)
    xi = jnp.zeros_like(xr)
    fr, fi = F.fft(xr, xi)
    br, bi = F.ifft(fr, fi)
    np.testing.assert_allclose(np.asarray(br), x, atol=1e-5)
    np.testing.assert_allclose(np.asarray(bi), 0.0, atol=1e-5)


def test_fft2_matches_numpy(rng):
    x = rng.random((64, 128)).astype(np.float32)
    ref = np.fft.fft2(x)
    fr, fi = jax.jit(F.fft2)(jnp.asarray(x), jnp.zeros((64, 128), jnp.float32))
    got = np.asarray(fr) + 1j * np.asarray(fi)
    np.testing.assert_allclose(got, ref, atol=3e-5 * np.abs(ref).max())


def test_ifft2_scaling(rng):
    x = rng.random((32, 32)).astype(np.float32)
    xr = jnp.asarray(x)
    z = jnp.zeros_like(xr)
    fr, fi = F.fft2(xr, z)
    br, _ = F.ifft2(fr, fi)
    np.testing.assert_allclose(np.asarray(br), x, atol=1e-5)


def test_cross_power_unit_magnitude(rng):
    ar = jnp.asarray(rng.random(64).astype(np.float32))
    ai = jnp.asarray(rng.random(64).astype(np.float32))
    br = jnp.asarray(rng.random(64).astype(np.float32))
    bi = jnp.asarray(rng.random(64).astype(np.float32))
    cr, ci = F.cross_power(ar, ai, br, bi)
    mag = np.asarray(cr) ** 2 + np.asarray(ci) ** 2
    np.testing.assert_allclose(mag, 1.0, atol=1e-4)


def test_find_peak():
    surf = np.zeros((16, 32), np.float32)
    surf[5, 20] = 3.0
    py, px, pv = F.find_peak(jnp.asarray(surf))
    assert (int(py), int(px)) == (5, 20)
    assert float(pv) == 3.0


def test_next_power_of_two():
    assert F.next_power_of_two(1) == 1
    assert F.next_power_of_two(512) == 512
    assert F.next_power_of_two(513) == 1024


def test_shifted_log_magnitude_centers_dc(rng):
    x = np.full((16, 16), 5.0, np.float32)
    fr, fi = F.fft2(jnp.asarray(x), jnp.zeros((16, 16), jnp.float32))
    out = np.asarray(F.shifted_log_magnitude(fr, fi))
    assert out.argmax() == 8 * 16 + 8  # DC moved to center


def test_fft2_two_real_matches_separate(rng):
    from astroburst_tpu.ops.fft import fft2, fft2_two_real
    import jax.numpy as jnp
    x1 = jnp.asarray(rng.random((16, 32)).astype("float32"))
    x2 = jnp.asarray(rng.random((16, 32)).astype("float32"))
    z = jnp.zeros_like(x1)
    f1r, f1i = fft2(x1, z)
    f2r, f2i = fft2(x2, z)
    g1r, g1i, g2r, g2i = fft2_two_real(x1, x2)
    np.testing.assert_allclose(np.asarray(g1r), np.asarray(f1r), atol=1e-3)
    np.testing.assert_allclose(np.asarray(g1i), np.asarray(f1i), atol=1e-3)
    np.testing.assert_allclose(np.asarray(g2r), np.asarray(f2r), atol=1e-3)
    np.testing.assert_allclose(np.asarray(g2i), np.asarray(f2i), atol=1e-3)


def test_ifft2_two_real_matches_separate(rng):
    from astroburst_tpu.ops.fft import fft2, ifft2, ifft2_two_real
    import jax.numpy as jnp
    # spectra of real planes -> inverse results are real
    x1 = jnp.asarray(rng.random((16, 16)).astype("float32"))
    x2 = jnp.asarray(rng.random((16, 16)).astype("float32"))
    z = jnp.zeros_like(x1)
    c1r, c1i = fft2(x1, z)
    c2r, c2i = fft2(x2, z)
    r1, _ = ifft2(c1r, c1i)
    r2, _ = ifft2(c2r, c2i)
    g1, g2 = ifft2_two_real(c1r, c1i, c2r, c2i)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(r1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(r2), atol=1e-4)


def test_fft2_four_step_axes_match_numpy(rng):
    """Sizes beyond _DIRECT_MAX exercise the transpose-free four-step
    on BOTH axes (axis=-1 and the dot_general axis=-2 path)."""
    from astroburst_tpu.ops.fft import fft2, ifft2
    import jax.numpy as jnp
    x = rng.random((512, 1024)).astype("float32")
    fr, fi = fft2(jnp.asarray(x), jnp.zeros((512, 1024), "float32"))
    want = np.fft.fft2(x.astype(np.float64))
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(np.asarray(fr), want.real, atol=3e-4 * scale)
    np.testing.assert_allclose(np.asarray(fi), want.imag, atol=3e-4 * scale)
    rr, ri = ifft2(fr, fi)
    np.testing.assert_allclose(np.asarray(rr), x, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ri), 0.0, atol=2e-3)


def test_fft_batched_four_step(rng):
    from astroburst_tpu.ops.fft import fft
    import jax.numpy as jnp
    x = rng.random((3, 512)).astype("float32")
    fr, fi = fft(jnp.asarray(x), jnp.zeros((3, 512), "float32"))
    want = np.fft.fft(x.astype(np.float64), axis=-1)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(np.asarray(fr), want.real, atol=3e-4 * scale)
    np.testing.assert_allclose(np.asarray(fi), want.imag, atol=3e-4 * scale)


def test_fft2_real_matches_complex_path(rng):
    from astroburst_tpu.ops.fft import fft2, fft2_real
    import jax.numpy as jnp
    for shape in [(64, 128), (512, 512)]:
        x = jnp.asarray(rng.random(shape).astype("float32"))
        fr, fi = fft2(x, jnp.zeros_like(x))
        gr, gi = fft2_real(x)
        np.testing.assert_allclose(np.asarray(gr), np.asarray(fr),
                                   atol=1e-3, err_msg=str(shape))
        np.testing.assert_allclose(np.asarray(gi), np.asarray(fi),
                                   atol=1e-3, err_msg=str(shape))


def test_ifft2_real_matches_complex_path(rng):
    from astroburst_tpu.ops.fft import fft2, ifft2, ifft2_real
    import jax.numpy as jnp
    for shape in [(64, 128), (512, 512)]:
        x = jnp.asarray(rng.random(shape).astype("float32"))
        cr, ci = fft2(x, jnp.zeros_like(x))
        rr, _ = ifft2(cr, ci)
        gr = ifft2_real(cr, ci)
        np.testing.assert_allclose(np.asarray(gr), np.asarray(rr),
                                   atol=1e-4, err_msg=str(shape))
        np.testing.assert_allclose(np.asarray(gr), np.asarray(x),
                                   atol=1e-3, err_msg=str(shape))


def test_rfft2_matches_full_spectrum(rng):
    """Half-spectrum rfft2 == fft2_real's non-redundant columns, and
    irfft2 roundtrips to the input exactly (used end-to-end by RL
    deconvolution's real-input packing)."""
    from astroburst_tpu.ops import fft as F
    x = rng.normal(size=(64, 128)).astype(np.float32)
    fr, fi = F.fft2_real(jnp.asarray(x))
    hr, hi = F.rfft2(jnp.asarray(x))
    scale = float(np.abs(np.asarray(fr)).max())
    np.testing.assert_allclose(np.asarray(hr), np.asarray(fr)[:, :65],
                               atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(hi), np.asarray(fi)[:, :65],
                               atol=2e-5 * scale)
    back = F.irfft2(hr, hi, 128)
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-5)


def test_rl_packed_convolve_matches_unpacked(rng):
    """RL's rfft2-packed convolution == the full-spectrum convolution
    it replaced, through a whole deconvolution run."""
    import jax.numpy as jnp2
    from astroburst_tpu.analysis.deconvolution import (
        generate_gaussian_psf, richardson_lucy)
    from astroburst_tpu.dtypes import RLConfig
    from astroburst_tpu.ops import fft as F

    img = rng.normal(50, 4, (96, 80)).astype(np.float32)
    img[40:43, 30:33] += 400.0
    psf = generate_gaussian_psf(15, 2.0)
    res = richardson_lucy(jnp2.asarray(img), psf,
                          RLConfig(iterations=6, dering=False))

    # independent full-spectrum RL in numpy via the same math
    fr_, fc_ = 128, 128
    buf = np.zeros((fr_, fc_), np.float64)
    buf[:15, :15] = psf
    buf = np.roll(buf, (-7, -7), axis=(0, 1))
    K = np.fft.fft2(buf)

    def conv(x, k):
        b = np.zeros((fr_, fc_), np.float64)
        b[:96, :80] = x
        return np.real(np.fft.ifft2(np.fft.fft2(b) * k))[:96, :80]

    est = img.astype(np.float64)
    for _ in range(6):
        ratio = img / (conv(est, K) + 1e-6)
        est = np.maximum(est * conv(ratio, np.conj(K)), 0.0)
    np.testing.assert_allclose(np.asarray(res.image), est,
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n,expect", [(2111, 2176), (100, 104),
                                      (4096, 4096), (5000, 5120)])
def test_next_fast_size(n, expect):
    m = F.next_fast_size(n)
    assert m == expect
    assert m >= n
    if m > F._DIRECT_MAX:
        n1, n2 = F._split(m)
        assert n1 * n2 == m and n2 <= F._DIRECT_MAX
        assert m % 128 == 0


@pytest.mark.parametrize("n", [2176, 2304, 5120])
def test_fft_composite_sizes_match_numpy(n, rng):
    """next_fast_size pads are non-power-of-two composites — the
    four-step engine must stay exact there (used by RL's linear
    convolution pads; deconvolution.rs:47 contract)."""
    x = rng.random((2, n)).astype(np.float32)
    ref = np.fft.fft(x)
    fr, fi = jax.jit(F.fft)(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
    got = np.asarray(fr) + 1j * np.asarray(fi)
    np.testing.assert_allclose(got, ref, atol=3e-5 * np.abs(ref).max())


def test_rfft2_composite_roundtrip(rng):
    x = rng.random((416, 544)).astype(np.float32)  # 416=32·13, 544=32·17
    xr, xi = F.rfft2(jnp.asarray(x))
    back = F.irfft2(xr, xi, 544)
    np.testing.assert_allclose(np.asarray(back), x, atol=2e-5)


def test_rl_fast_precision_plumbing(rng):
    """fast_precision reroutes the FFT matmuls through the DEFAULT-
    precision trace (a distinct jit cache entry) and restores the
    module default afterwards. On the CPU backend DEFAULT == HIGHEST
    numerically, so the result must match exactly."""
    import jax.numpy as jnp2
    from astroburst_tpu.analysis.deconvolution import (
        generate_gaussian_psf, richardson_lucy)
    from astroburst_tpu.dtypes import RLConfig
    from astroburst_tpu.ops import fft as F

    img = rng.normal(50, 4, (64, 48)).astype(np.float32)
    img[20:23, 30:33] += 400.0
    psf = generate_gaussian_psf(9, 1.5)
    slow = richardson_lucy(jnp2.asarray(img), psf,
                           RLConfig(iterations=4, dering=False))
    fast = richardson_lucy(jnp2.asarray(img), psf,
                           RLConfig(iterations=4, dering=False,
                                    fast_precision=True))
    assert F._prec() is F._HIGHEST  # context restored after tracing
    assert fast.iterations_run == slow.iterations_run
    np.testing.assert_allclose(np.asarray(fast.image),
                               np.asarray(slow.image), atol=1e-6)


def test_matmul_precision_context_restores_on_error():
    from astroburst_tpu.ops import fft as F

    try:
        with F.matmul_precision("default"):
            assert F._prec() is not F._HIGHEST
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    assert F._prec() is F._HIGHEST
    with pytest.raises(ValueError):
        F.matmul_precision("Highest")


def test_rl_fast_precision_accuracy_bound(rng):
    """Accuracy gate for the opt-in precision mode: fast_precision
    must stay within 1e-3 max rel error of the f32 path on a realistic
    PSF/image pair. On the CPU DEFAULT == HIGHEST, so this checks the
    plumbing (the flag reaches the FFT matmuls and nothing else
    changes). On the H100 the DEFAULT-precision matmuls run in TF32
    (10-bit mantissa products, f32 accumulation); bench_ops.py reports
    that error as rl_deconv_2048_x20_fast.max_rel_err_vs_f32."""
    import jax.numpy as jnp2
    from astroburst_tpu.analysis.deconvolution import (
        generate_gaussian_psf, richardson_lucy)
    from astroburst_tpu.dtypes import RLConfig

    img = rng.normal(100, 8, (192, 160)).astype(np.float32)
    img[60:64, 70:74] += 900.0
    img[120:122, 40:42] += 500.0
    psf = generate_gaussian_psf(15, 2.0)
    slow = richardson_lucy(jnp2.asarray(img), psf,
                           RLConfig(iterations=10, dering=False))
    fast = richardson_lucy(jnp2.asarray(img), psf,
                           RLConfig(iterations=10, dering=False,
                                    fast_precision=True))
    ref = np.asarray(slow.image)
    got = np.asarray(fast.image)
    rel = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert rel <= 1e-3, f"fast_precision rel error {rel:.2e} > 1e-3"
