"""Imaging processing tests mirroring the reference's unit suites:
stretch.rs:92-188, scnr.rs:55-103, curves.rs:215-277,
white_balance.rs:22-90, lrgb.rs tests, masked_stretch semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

from astroburst_tpu.compose.channel_blend import blend_channels
from astroburst_tpu.compose.lrgb import apply_lrgb
from astroburst_tpu.compose.white_balance import select_wb_reference
from astroburst_tpu.dtypes import ImageStats, ScnrConfig, ScnrMethod
from astroburst_tpu.imaging.curves import (LevelsParams, SplineCurve,
                                           apply_levels, is_identity_curve)
from astroburst_tpu.imaging.masked_stretch import (MaskedStretchConfig,
                                                   masked_stretch)
from astroburst_tpu.imaging.scnr import apply_scnr
from astroburst_tpu.imaging.star_mask import (StarMaskConfig,
                                              generate_star_mask)
from astroburst_tpu.imaging.stretch import (arcsinh_stretch,
                                            arcsinh_stretch_rgb)


# --- arcsinh ------------------------------------------------------------------

def test_arcsinh_boundaries():
    data = jnp.asarray([[0.0, 0.5, 1.0]], dtype=jnp.float32)
    out = np.asarray(arcsinh_stretch(data, 10.0))
    # min maps to 0, max to 1 (stretch.rs boundaries test); note min of
    # *valid* values is 0.5 here (0.0 is below the padding threshold)
    assert out[0, 2] == pytest.approx(1.0, abs=1e-6)


def test_arcsinh_monotonic():
    x = jnp.asarray(np.linspace(0.01, 1.0, 50, dtype=np.float32)[None])
    out = np.asarray(arcsinh_stretch(x, 30.0)).ravel()
    assert (np.diff(out) > 0).all()


def test_arcsinh_nan_safe():
    x = jnp.asarray([[0.1, np.nan, 0.9, np.inf]], dtype=jnp.float32)
    out = np.asarray(arcsinh_stretch(x, 5.0))
    assert out[0, 1] == 0.0 and out[0, 3] == 0.0
    assert np.isfinite(out).all()


@pytest.mark.slow
def test_arcsinh_rgb_shared_range_preserves_ratios():
    r = jnp.full((4, 4), 0.8, jnp.float32)
    g = jnp.full((4, 4), 0.4, jnp.float32)
    b = jnp.full((4, 4), 0.2, jnp.float32)
    ro, go, bo = arcsinh_stretch_rgb(r, g, b, 10.0)
    # shared min/max: brighter channel stays brighter
    assert float(ro[0, 0]) > float(go[0, 0]) > float(bo[0, 0])


def test_arcsinh_zero_factor_identity():
    x = jnp.asarray(np.random.default_rng(0).random((4, 4), np.float32)
                    if False else np.ones((4, 4), np.float32) * 0.3)
    out = arcsinh_stretch_rgb(x, x, x, 0.0)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(x))


# --- SCNR ---------------------------------------------------------------------

def test_scnr_removes_dominant_green():
    r = jnp.full((2, 2), 0.3, jnp.float32)
    g = jnp.full((2, 2), 0.9, jnp.float32)
    b = jnp.full((2, 2), 0.3, jnp.float32)
    ro, go, bo = apply_scnr(r, g, b, ScnrConfig(ScnrMethod.AVERAGE_NEUTRAL,
                                                1.0, False))
    assert float(go[0, 0]) == pytest.approx(0.3, abs=1e-5)
    assert float(ro[0, 0]) == pytest.approx(0.3, abs=1e-5)


def test_scnr_preserve_skips_saturated():
    r = jnp.full((1, 1), 2.5, jnp.float32)
    g = jnp.full((1, 1), 1.8, jnp.float32)
    b = jnp.full((1, 1), 1.2, jnp.float32)
    ro, go, bo = apply_scnr(r, g, b, ScnrConfig(ScnrMethod.MAXIMUM_NEUTRAL,
                                                1.0, True))
    assert float(ro[0, 0]) == pytest.approx(2.5, abs=1e-5)
    assert float(bo[0, 0]) == pytest.approx(1.2, abs=1e-5)


def test_scnr_preserve_boosts_low_range():
    r = jnp.full((1, 1), 0.2, jnp.float32)
    g = jnp.full((1, 1), 0.6, jnp.float32)
    b = jnp.full((1, 1), 0.2, jnp.float32)
    ro, go, bo = apply_scnr(r, g, b, ScnrConfig(ScnrMethod.AVERAGE_NEUTRAL,
                                                1.0, True))
    assert float(ro[0, 0]) > 0.2
    assert float(bo[0, 0]) > 0.2
    assert float(go[0, 0]) == pytest.approx(0.2, abs=1e-5)


def test_scnr_amount_zero_noop():
    g = jnp.full((1, 1), 0.9, jnp.float32)
    _, go, _ = apply_scnr(jnp.full((1, 1), 0.3, jnp.float32), g,
                          jnp.full((1, 1), 0.3, jnp.float32),
                          ScnrConfig(ScnrMethod.AVERAGE_NEUTRAL, 0.0, True))
    assert float(go[0, 0]) == pytest.approx(0.9, abs=1e-5)


# --- curves / levels -----------------------------------------------------------

def test_levels_identity():
    x = jnp.asarray(np.linspace(0, 1, 16, dtype=np.float32).reshape(4, 4))
    out = apply_levels(x, LevelsParams())
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))


def test_levels_black_white():
    x = jnp.asarray([[0.2, 0.5, 0.8]], dtype=jnp.float32)
    out = np.asarray(apply_levels(x, LevelsParams(black=0.2, white=0.8)))
    assert out[0, 0] == pytest.approx(0.0, abs=1e-6)
    assert out[0, 1] == pytest.approx(0.5, abs=1e-6)
    assert out[0, 2] == pytest.approx(1.0, abs=1e-6)


def test_spline_monotonic():
    curve = SplineCurve([(0.0, 0.0), (0.3, 0.5), (0.7, 0.8), (1.0, 1.0)])
    lut = curve.lut()
    assert (np.diff(lut) >= -1e-6).all()  # monotone (curves.rs:266-277)
    assert lut[0] == pytest.approx(0.0, abs=1e-6)
    assert lut[-1] == pytest.approx(1.0, abs=1e-6)


def test_spline_interpolates_control_points():
    pts = [(0.0, 0.0), (0.5, 0.7), (1.0, 1.0)]
    curve = SplineCurve(pts)
    x = jnp.asarray([[0.5]], dtype=jnp.float32)
    # quantization grid: 0.5*4095 = 2047.5 → floor → slight offset
    assert float(curve.apply(x)[0, 0]) == pytest.approx(0.7, abs=2e-3)


def test_spline_identity_detection():
    assert is_identity_curve([(0.0, 0.0), (1.0, 1.0)])
    assert not is_identity_curve([(0.0, 0.0), (0.5, 0.6), (1.0, 1.0)])


def test_curve_invalid_to_zero():
    curve = SplineCurve([(0.0, 0.1), (1.0, 1.0)])
    x = jnp.asarray([[np.nan, -0.5, 0.5]], dtype=jnp.float32)
    out = np.asarray(curve.apply(x))
    assert out[0, 0] == 0.0 and out[0, 1] == 0.0
    assert out[0, 2] > 0.0


# --- blend / WB / LRGB ----------------------------------------------------------

def test_blend_channels_weight_matrix():
    c0 = jnp.full((2, 2), 1.0, jnp.float32)
    c1 = jnp.full((2, 2), 2.0, jnp.float32)
    weights = [
        {"channel_idx": 0, "r_weight": 1.0, "g_weight": 0.5, "b_weight": 0.0},
        {"channel_idx": 1, "r_weight": 0.0, "g_weight": 0.5, "b_weight": 1.0},
        {"channel_idx": 9, "r_weight": 9.0, "g_weight": 9.0, "b_weight": 9.0},
    ]
    r, g, b = blend_channels([c0, c1], weights)
    assert float(r[0, 0]) == pytest.approx(1.0)
    assert float(g[0, 0]) == pytest.approx(0.5 + 1.0)
    assert float(b[0, 0]) == pytest.approx(2.0)


def _stats(median, mad):
    return ImageStats(min=0.0, max=1.0, median=median, mad=mad,
                      sigma=mad * 1.4826, mean=median, valid_count=1000)


def test_wb_equal_channels_ones():
    s = _stats(0.5, 0.01)
    assert select_wb_reference(s, s, s) == (1.0, 1.0, 1.0)


def test_wb_red_most_stable():
    r, g, b = select_wb_reference(_stats(0.5, 0.001), _stats(0.4, 0.02),
                                  _stats(0.3, 0.03))
    assert r == 1.0
    assert g == pytest.approx(0.5 / 0.4)
    assert b == pytest.approx(0.5 / 0.3)


def test_wb_blue_most_stable():
    r, g, b = select_wb_reference(_stats(0.5, 0.05), _stats(0.4, 0.04),
                                  _stats(0.3, 0.001))
    assert b == 1.0
    assert r == pytest.approx(0.3 / 0.5)


def test_wb_near_zero_median():
    r, g, b = select_wb_reference(_stats(0.0, 0.0), _stats(0.5, 0.01),
                                  _stats(0.3, 0.02))
    assert np.isfinite([r, g, b]).all()


def test_lrgb_preserves_gray():
    l = jnp.full((4, 4), 0.5, jnp.float32)
    r, g, b = apply_lrgb(l, l, l, l, 1.0, 1.0)
    np.testing.assert_allclose(np.asarray(r), 0.5, atol=0.01)


def test_lrgb_boosts_luminance():
    l = jnp.full((4, 4), 0.8, jnp.float32)
    r, g, b = apply_lrgb(l, jnp.full((4, 4), 0.3, jnp.float32),
                         jnp.full((4, 4), 0.1, jnp.float32),
                         jnp.full((4, 4), 0.05, jnp.float32), 1.0, 1.0)
    assert float(r[2, 2]) > 0.3
    assert float(g[2, 2]) > 0.1


# --- star mask / masked stretch --------------------------------------------------

def _star_image(shape=(128, 128), bg=0.1, seed=2):
    rng = np.random.default_rng(seed)
    img = rng.normal(bg, 0.005, shape)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    for cy, cx in [(40, 40), (90, 70), (60, 100)]:
        img += 0.8 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 2.0 ** 2))
    return img.astype(np.float32)


def test_star_mask_covers_stars():
    img = _star_image()
    res = generate_star_mask(img, StarMaskConfig(detection_sigma=5.0))
    mask = np.asarray(res.mask)
    assert res.stars_masked == 3
    assert mask[40, 40] == pytest.approx(1.0, abs=1e-5)
    assert mask[90, 70] == pytest.approx(1.0, abs=1e-5)
    assert mask[5, 5] == 0.0
    assert 0.0 < res.coverage_fraction < 0.5


def test_star_mask_luminance_protection():
    img = _star_image()
    img[100:105, 10:15] = 0.95  # bright non-star region
    res = generate_star_mask(img, StarMaskConfig(detection_sigma=5.0,
                                                 luminance_protect=True,
                                                 luminance_ceiling=0.85))
    assert float(np.asarray(res.mask)[102, 12]) > 0.5


@pytest.mark.slow
def test_masked_stretch_reaches_target_background():
    img = _star_image()
    res = masked_stretch(img, MaskedStretchConfig(iterations=10,
                                                  target_background=0.25))
    assert res.iterations_run >= 1
    assert res.final_background == pytest.approx(0.25, abs=0.02)
    out = np.asarray(res.image)
    assert out.min() >= 0.0 and out.max() <= 1.0
    # background raised toward target, stars still bright
    assert out[5, 5] > 0.1
    assert out[40, 40] > out[5, 5]


@pytest.mark.slow
def test_masked_stretch_converges_flag():
    img = _star_image()
    res = masked_stretch(img, MaskedStretchConfig(iterations=10))
    assert isinstance(res.converged, bool)
    assert res.stars_masked >= 3


def test_star_mask_tiled_paint_matches_sequential_oracle():
    """The tiled rasterizer must reproduce the per-star sequential
    window paint (star_mask.rs:61-98) exactly: same 96-px window clip,
    same max-combine, same smoothstep edge."""
    from astroburst_tpu.imaging.star_mask import WINDOW, _mask_kernel

    def sequential_paint(h, w, xs, ys, radii, softness):
        half = WINDOW // 2
        mask = np.zeros((h + WINDOW, w + WINDOW), np.float32)
        wy = np.arange(WINDOW, dtype=np.float32)[:, None]
        wx = np.arange(WINDOW, dtype=np.float32)[None, :]
        for x, y, radius in zip(xs, ys, radii):
            soft_radius = radius + softness
            r2i, r2o = radius * radius, soft_radius * soft_radius
            fade = max(r2o - r2i, 1e-10)
            y0 = int(np.clip(np.round(y), 0, h))
            x0 = int(np.clip(np.round(x), 0, w))
            py = y0 + wy - half
            px = x0 + wx - half
            d2 = (px - x) ** 2 + (py - y) ** 2
            t = np.clip((d2 - r2i) / fade, 0.0, 1.0)
            val = np.where(d2 <= r2i, 1.0,
                           np.where(d2 <= r2o,
                                    1.0 - t * t * (3.0 - 2.0 * t), 0.0))
            if radius <= 0:
                val = val * 0
            win = mask[y0:y0 + WINDOW, x0:x0 + WINDOW]
            mask[y0:y0 + WINDOW, x0:x0 + WINDOW] = np.maximum(
                win, val.astype(np.float32))
        return mask[half:half + h, half:half + w]

    rng = np.random.default_rng(7)
    for h, w, k in [(128, 160, 7), (300, 200, 60), (97, 513, 25)]:
        xs = rng.uniform(-10, w + 10, k).astype(np.float32)  # off-edge too
        ys = rng.uniform(-10, h + 10, k).astype(np.float32)
        radii = rng.uniform(0, 40, k).astype(np.float32)
        radii[0] = 0.0  # dummy slot
        img = rng.random((h, w), np.float32)
        got, _ = _mask_kernel(jnp.asarray(img), jnp.asarray(xs),
                              jnp.asarray(ys), jnp.asarray(radii),
                              jnp.float32(4.0), jnp.float32(0.85), False)
        want = sequential_paint(h, w, xs, ys, radii, 4.0)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)


@pytest.mark.slow
def test_masked_stretch_early_stop_counts_iterations():
    """while_loop early exit: iterations_run reflects the actual break
    point (masked_stretch.rs:79-103), not the configured maximum."""
    img = _star_image()
    res = masked_stretch(img, MaskedStretchConfig(iterations=25,
                                                  target_background=0.25))
    assert 1 <= res.iterations_run <= 25
    # a converged/stagnated run stops before the cap
    if res.converged:
        assert res.iterations_run < 25


def test_star_mask_raster_matches_numpy():
    """The tiled soft-disk raster == painting each star's smoothstep
    disk (star_mask.rs:61-98) into its 96×96 window anchored at
    round(position), max-combined — including off-plane stars,
    zero-radius slots and the luminance branch."""
    import jax.numpy as jnp
    from astroburst_tpu.imaging.star_mask import WINDOW, _mask_kernel

    rng = np.random.default_rng(9)
    h, w = 300, 420
    img = rng.normal(0.3, 0.05, (h, w)).astype(np.float32)
    img[50:60, 70:80] = 0.95
    k = 60
    xs = rng.uniform(-5, w + 5, k).astype(np.float32)
    ys = rng.uniform(-5, h + 5, k).astype(np.float32)
    radii = np.where(rng.random(k) < 0.1, 0.0,
                     rng.uniform(1, 40, k)).astype(np.float32)
    soft, ceiling = np.float32(4.0), np.float32(0.85)

    want = np.zeros((h, w), np.float32)
    half = WINDOW // 2
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    for x, y, r in zip(xs, ys, radii):
        if r <= 0:
            continue
        y0 = min(max(int(np.round(y)), 0), h) - half
        x0 = min(max(int(np.round(x)), 0), w) - half
        win = ((gy >= y0) & (gy < y0 + WINDOW) & (gx >= x0)
               & (gx < x0 + WINDOW))
        ro = r + soft
        d2 = (gx - x) ** 2 + (gy - y) ** 2
        t = np.clip((d2 - r * r) / max(ro * ro - r * r, 1e-10), 0, 1)
        val = np.where(d2 <= r * r, 1.0,
                       np.where(d2 <= ro * ro, 1.0 - t * t * (3 - 2 * t),
                                0.0))
        want = np.maximum(want, np.where(win, val, 0.0))
    for lum in (False, True):
        mask, cov = _mask_kernel(jnp.asarray(img), jnp.asarray(xs),
                                 jnp.asarray(ys), jnp.asarray(radii),
                                 jnp.float32(soft), jnp.float32(ceiling),
                                 lum)
        exp = want
        if lum:
            e = np.clip((img - ceiling) / (1 - ceiling), 0, 1)
            smooth = e * e * (3 - 2 * e)
            exp = np.where((img > ceiling) & (want < 1.0),
                           np.maximum(want, smooth), want)
        np.testing.assert_allclose(np.asarray(mask), exp, atol=2e-5)
        assert float(cov) == pytest.approx((exp > 0.01).mean(), abs=1e-4)
