"""Oracle-pinning and implementation↔oracle parity tests.

Two layers of protection:
1. pin tests — each oracle's output on a fixed input is compared
   byte-for-byte against the committed fixture tensor, so an oracle
   edit cannot silently drift together with the implementation;
2. parity tests — the jax implementations match the oracles,
   including the drizzle gather-vs-scatter delta quantification on
   adversarial configs.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from tests.reference_impl import (ref_apply_levels, ref_apply_scnr,
                                  ref_apply_stf_u8, ref_auto_stf,
                                  ref_drizzle, ref_sigma_clip_combine,
                                  ref_spline_lut, ref_stats)

FIX = np.load(os.path.join(os.path.dirname(__file__), "reference_impl",
                           "fixtures", "pinned.npz"))


# --- oracle pins -------------------------------------------------------------


def test_pin_stats():
    st = ref_stats(FIX["stats_input"])
    got = np.float64([st["min"], st["max"], st["mean"], st["median"],
                      st["mad"], st["sigma"], st["valid_count"]])
    np.testing.assert_array_equal(got, FIX["stats_output"])


def test_pin_auto_stf_and_u8():
    st = ref_stats(FIX["stats_input"])
    sh, mt, hl = ref_auto_stf(st)
    np.testing.assert_array_equal(np.float64([sh, mt, hl]), FIX["auto_stf"])
    np.testing.assert_array_equal(
        ref_apply_stf_u8(FIX["stats_input"], st, sh, mt, hl), FIX["stf_u8"])


def test_pin_sigma_clip():
    clip_in = FIX["clip_input"]
    for j in range(clip_in.shape[1]):
        v, r = ref_sigma_clip_combine(clip_in[:, j], 2.5, 3.0, 5)
        assert np.float32(v) == FIX["clip_values"][j]
        assert r == FIX["clip_rejected"][j]


def test_pin_scnr():
    ro, go, bo = ref_apply_scnr(FIX["scnr_r_in"], FIX["scnr_g_in"],
                                FIX["scnr_b_in"], "average_neutral", 0.8,
                                True)
    np.testing.assert_array_equal(ro, FIX["scnr_r"])
    np.testing.assert_array_equal(go, FIX["scnr_g"])
    np.testing.assert_array_equal(bo, FIX["scnr_b"])


def test_pin_curves():
    np.testing.assert_array_equal(
        ref_spline_lut([(0.0, 0.0), (0.25, 0.4), (0.7, 0.65), (1.0, 1.0)]),
        FIX["spline_lut"])
    np.testing.assert_array_equal(
        ref_apply_levels(FIX["stats_input"], 0.1, 0.8, 1.6), FIX["levels"])


def test_pin_drizzle():
    frames = list(FIX["drizzle_frames"])
    offs = [tuple(o) for o in FIX["drizzle_offsets"]]
    for kern in ("square", "gaussian", "lanczos3"):
        img, wgt, rej = ref_drizzle(frames, offs, 2.0, 0.8, kern,
                                    2.5, 2.5, 3)
        np.testing.assert_array_equal(img, FIX[f"drizzle_{kern}_img"])
        np.testing.assert_array_equal(wgt, FIX[f"drizzle_{kern}_wgt"])
        assert rej == int(FIX[f"drizzle_{kern}_rej"])


# --- implementation ↔ oracle parity -----------------------------------------


def test_impl_stats_matches_oracle():
    from astroburst_tpu.ops.stats import compute_image_stats
    st = compute_image_stats(jnp.asarray(FIX["stats_input"]))
    ref = ref_stats(FIX["stats_input"])
    assert st.valid_count == ref["valid_count"]
    for k in ("min", "max", "mean", "median", "mad"):
        assert getattr(st, k) == pytest.approx(ref[k], abs=2e-5), k


def test_impl_stf_matches_oracle():
    from astroburst_tpu.imaging.stf import apply_stf_u8, auto_stf
    from astroburst_tpu.ops.stats import compute_image_stats
    img = jnp.asarray(FIX["stats_input"])
    st = compute_image_stats(img)
    params = auto_stf(st)
    ref = ref_auto_stf(ref_stats(FIX["stats_input"]))
    assert params.shadow == pytest.approx(ref[0], abs=2e-5)
    assert params.midtone == pytest.approx(ref[1], abs=2e-4)
    got = np.asarray(apply_stf_u8(img, params, st))
    want = ref_apply_stf_u8(FIX["stats_input"],
                            ref_stats(FIX["stats_input"]), *ref)
    assert (got.astype(int) - want.astype(int) == 0).mean() > 0.99
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_impl_scnr_matches_oracle():
    from astroburst_tpu.dtypes import ScnrConfig, ScnrMethod
    from astroburst_tpu.imaging.scnr import apply_scnr
    ro, go, bo = apply_scnr(jnp.asarray(FIX["scnr_r_in"]),
                            jnp.asarray(FIX["scnr_g_in"]),
                            jnp.asarray(FIX["scnr_b_in"]),
                            ScnrConfig(ScnrMethod.AVERAGE_NEUTRAL, 0.8,
                                       True))
    np.testing.assert_allclose(np.asarray(ro), FIX["scnr_r"], atol=1e-6)
    np.testing.assert_allclose(np.asarray(go), FIX["scnr_g"], atol=1e-6)
    np.testing.assert_allclose(np.asarray(bo), FIX["scnr_b"], atol=1e-6)


def test_impl_curves_match_oracle():
    from astroburst_tpu.imaging.curves import (LevelsParams, SplineCurve,
                                               apply_levels)
    curve = SplineCurve([(0.0, 0.0), (0.25, 0.4), (0.7, 0.65), (1.0, 1.0)])
    np.testing.assert_allclose(curve.lut(), FIX["spline_lut"], atol=1e-6)
    got = apply_levels(jnp.asarray(FIX["stats_input"]),
                       LevelsParams(black=0.1, white=0.8, gamma=1.6))
    np.testing.assert_allclose(np.asarray(got), FIX["levels"], atol=1e-5)


def test_impl_clip_matches_oracle():
    from astroburst_tpu.stacking import sigma_clip_combine_stack
    clip_in = FIX["clip_input"][:, None, :]  # [N, 1, W]
    got, got_rej = sigma_clip_combine_stack(jnp.asarray(clip_in), 2.5, 3.0, 5)
    np.testing.assert_allclose(np.asarray(got)[0], FIX["clip_values"],
                               atol=2e-4)
    assert int(got_rej) == int(FIX["clip_rejected"].sum())


# --- drizzle gather-vs-scatter delta -----------------------------------------


def _drizzle_impl(frames, offsets, scale, pixfrac, kernel_name, lo, hi,
                  iters, exact):
    from astroburst_tpu.dtypes import DrizzleKernel
    from astroburst_tpu.stacking.drizzle import (_drizzle_kernel,
                                                 _drizzle_kernel_exact)
    kern = {"square": DrizzleKernel.SQUARE,
            "gaussian": DrizzleKernel.GAUSSIAN,
            "lanczos3": DrizzleKernel.LANCZOS3}[kernel_name]
    import math
    in_rows, in_cols = frames[0].shape
    stack = jnp.stack([jnp.asarray(f) for f in frames])
    d_xs = jnp.asarray([o[0] for o in offsets], jnp.float32)
    d_ys = jnp.asarray([o[1] for o in offsets], jnp.float32)
    fn = _drizzle_kernel_exact if exact else _drizzle_kernel
    img, wgt, rej = fn(
        stack, d_ys, d_xs, scale, pixfrac, kern,
        math.ceil(in_rows * scale), math.ceil(in_cols * scale), lo, hi,
        iters)
    return np.asarray(img), np.asarray(wgt), int(rej)


@pytest.mark.parametrize("kern", ["square", "gaussian", "lanczos3"])
def test_drizzle_exact_matches_scatter_oracle(rng, kern):
    """The exact capped-list kernel reproduces the scatter oracle
    on the adversarial config scale=2, pixfrac=1,
    including the cosmic-ray rejection and the weights map."""
    frames = [rng.normal(10, 1, (16, 18)).astype(np.float32)
              for _ in range(4)]
    frames[1][8, 9] = 500.0  # outlier the clip must reject identically
    offs = [(0.0, 0.0), (0.35, -0.2), (-0.6, 0.45), (0.15, 0.7)]
    ref_img, ref_wgt, ref_rej = ref_drizzle(frames, offs, 2.0, 1.0, kern,
                                            3.0, 3.0, 3)
    got_img, got_wgt, got_rej = _drizzle_impl(frames, offs, 2.0, 1.0, kern,
                                              3.0, 3.0, 3, exact=True)
    np.testing.assert_allclose(got_img, ref_img, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got_wgt, ref_wgt, rtol=1e-4, atol=1e-5)
    # gaussian tails sit exactly at the w > 1e-12 push threshold where
    # f32 (impl) vs f64 (oracle) exp() flips membership of near-zero
    # contributions; the clip makes the IMAGE insensitive to them but
    # the raw rejection count shifts by a few
    assert abs(got_rej - ref_rej) <= max(5, int(0.05 * ref_rej))


def test_drizzle_preaverage_delta_quantified(rng):
    """The cheap pre-averaging mode's documented delta vs the oracle,
    quantified: small on clean data, concentrated where same-frame
    contributions mix with outliers."""
    frames = [rng.normal(10, 1, (16, 18)).astype(np.float32)
              for _ in range(4)]
    offs = [(0.0, 0.0), (0.35, -0.2), (-0.6, 0.45), (0.15, 0.7)]
    ref_img, _, _ = ref_drizzle(frames, offs, 2.0, 1.0, "square",
                                3.0, 3.0, 3)
    got_img, _, _ = _drizzle_impl(frames, offs, 2.0, 1.0, "square",
                                  3.0, 3.0, 3, exact=False)
    b = 3
    delta = np.abs(ref_img[b:-b, b:-b] - got_img[b:-b, b:-b])
    rel = delta / np.abs(ref_img[b:-b, b:-b]).mean()
    # clean data: the pre-average tracks the oracle to a few percent;
    # this pins the APPROXIMATION quality so regressions are visible
    assert np.median(rel) < 0.02, np.median(rel)
    assert rel.max() < 0.25, rel.max()


@pytest.mark.parametrize("kern", ["square", "gaussian"])
def test_drizzle_exact_nan_pixels_match_scatter_oracle(rng, kern):
    """NaN input pixels are never pushed (drizzle.rs:60-118): the exact
    path's image, weights and rejections still follow the oracle, with
    an outlier and integer-plus-fraction offsets in the mix."""
    frames = [rng.normal(10, 1, (14, 20)).astype(np.float32)
              for _ in range(4)]
    frames[1][7, 9] = 300.0
    frames[0][3, 4] = np.nan
    frames[2][10, 15] = np.nan
    offs = [(0.0, 0.0), (0.4, -0.25), (-0.3, 0.6), (1.2, 0.8)]
    ref_img, ref_wgt, ref_rej = ref_drizzle(frames, offs, 2.0, 1.0, kern,
                                            3.0, 3.0, 3)
    got_img, got_wgt, got_rej = _drizzle_impl(frames, offs, 2.0, 1.0, kern,
                                              3.0, 3.0, 3, exact=True)
    np.testing.assert_allclose(got_img, ref_img, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got_wgt, ref_wgt, rtol=1e-4, atol=1e-5)
    assert abs(got_rej - ref_rej) <= max(5, int(0.05 * ref_rej))


def test_drizzle_exact_bench_config_matches_scatter_oracle(rng):
    """The benchmark's configuration (scale 2, pixfrac 0.7, square,
    5 clip rounds) on a small plane, offsets in its ±2 px range."""
    frames = [rng.normal(100, 8, (12, 16)).astype(np.float32)
              for _ in range(5)]
    offs = [tuple(o) for o in rng.uniform(-2, 2, (5, 2))]
    ref_img, ref_wgt, ref_rej = ref_drizzle(frames, offs, 2.0, 0.7,
                                            "square", 3.0, 3.0, 5)
    got_img, got_wgt, got_rej = _drizzle_impl(frames, offs, 2.0, 0.7,
                                              "square", 3.0, 3.0, 5,
                                              exact=True)
    np.testing.assert_allclose(got_img, ref_img, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got_wgt, ref_wgt, rtol=1e-4, atol=1e-5)
    assert got_rej == ref_rej


@pytest.mark.parametrize("band_rows", [8, 13])
def test_drizzle_exact_banding_is_exact(rng, band_rows):
    """Banding over output rows only bounds the candidate tensor: any
    band height gives the same rejections, and image and weights to f32
    rounding (a band re-expresses its offset as d_y − r0/scale), as one
    band over the whole output, ragged last band included."""
    from astroburst_tpu.dtypes import DrizzleKernel
    from astroburst_tpu.stacking.drizzle import _drizzle_kernel_exact

    stack = jnp.asarray(rng.normal(10, 1, (3, 14, 20)).astype(np.float32))
    stack = stack.at[1, 7, 9].set(300.0)
    d_ys = jnp.asarray([0.0, 0.25, -0.6], jnp.float32)
    d_xs = jnp.asarray([0.0, -0.4, 0.3], jnp.float32)
    args = (stack, d_ys, d_xs, 2.0, 1.0, DrizzleKernel.SQUARE, 28, 40,
            3.0, 3.0, 3)
    whole = _drizzle_kernel_exact(*args, band_rows=28)
    banded = _drizzle_kernel_exact(*args, band_rows=band_rows)
    for a, b in zip(whole[:2], banded[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-5)
    assert int(whole[2]) == int(banded[2])


@pytest.mark.parametrize("dy,dx", [(0.0, 0.0), (2.0, -3.0), (0.37, -1.62),
                                   (-5.5, 30.25)])
def test_impl_shift_matches_oracle(rng, dy, dx):
    """shift_bicubic (ops/resample.py) == the align.rs Catmull-Rom
    oracle: clamped taps, zero outside the source, raw on zero shift."""
    from astroburst_tpu.ops.resample import shift_bicubic
    from tests.reference_impl import ref_shift_rows

    img = rng.normal(100, 10, (24, 40)).astype(np.float32)
    img[5, 7] = np.nan if (dy, dx) == (0.0, 0.0) else img[5, 7]
    got = np.asarray(shift_bicubic(jnp.asarray(img), jnp.float32(dy),
                                   jnp.float32(dx)))
    want = ref_shift_rows(img, dy, dx, 0, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
