"""Star detection on synthetic Gaussian stars with centroid-accuracy
asserts, mirroring star_detection.rs:260-329."""

import numpy as np
import pytest
import jax.numpy as jnp

from astroburst_tpu.analysis import detect_stars, estimate_background


def add_star(img, cy, cx, amp, sigma):
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]].astype(np.float64)
    img += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def make_field(shape=(256, 256), stars=((60.3, 80.7, 900.0, 1.8),
                                        (150.0, 40.0, 700.0, 2.2),
                                        (200.5, 200.5, 1200.0, 1.5)),
               bg=100.0, noise=2.0, seed=5):
    rng = np.random.default_rng(seed)
    img = rng.normal(bg, noise, shape)
    for cy, cx, amp, sig in stars:
        add_star(img, cy, cx, amp, sig)
    return img.astype(np.float32)


def test_detects_all_stars_with_accurate_centroids():
    truth = [(60.3, 80.7), (150.0, 40.0), (200.5, 200.5)]
    img = make_field()
    res = detect_stars(img, 5.0)
    assert len(res.stars) == 3
    for ty, tx in truth:
        best = min(res.stars, key=lambda s: (s.y - ty) ** 2 + (s.x - tx) ** 2)
        assert abs(best.y - ty) < 0.3, (best.y, ty)
        assert abs(best.x - tx) < 0.3, (best.x, tx)


def test_fwhm_estimate():
    img = make_field(stars=((128.0, 128.0, 1000.0, 2.0),), noise=0.5)
    res = detect_stars(img, 5.0)
    assert len(res.stars) == 1
    # FWHM = 2.3548 * sigma = 4.71 (threshold truncation biases slightly low)
    assert res.stars[0].fwhm == pytest.approx(4.71, abs=1.2)
    assert res.stars[0].eccentricity < 0.45


def test_background_estimate():
    img = make_field(stars=(), bg=500.0, noise=10.0)
    med, sig = estimate_background(img, 64)
    assert med == pytest.approx(500.0, abs=2.0)
    assert sig == pytest.approx(10.0, rel=0.25)


def test_brightest_first_ordering():
    img = make_field()
    res = detect_stars(img, 5.0)
    fluxes = [s.flux for s in res.stars]
    assert fluxes == sorted(fluxes, reverse=True)


def test_no_stars_in_flat_noise():
    rng = np.random.default_rng(0)
    img = rng.normal(100.0, 3.0, (128, 128)).astype(np.float32)
    res = detect_stars(img, 6.0)
    assert len(res.stars) <= 2  # noise may rarely spike


def test_nan_safe():
    img = make_field()
    img[10:20, 10:20] = np.nan
    img[100, :] = np.inf
    res = detect_stars(img, 5.0)
    assert len(res.stars) >= 3 - 1
    for s in res.stars:
        assert np.isfinite(s.x) and np.isfinite(s.fwhm)


def test_tiny_image_returns_empty():
    res = detect_stars(np.ones((2, 2), np.float32), 5.0)
    assert res.stars == []


def test_elongated_star_eccentricity():
    rng = np.random.default_rng(1)
    img = rng.normal(100.0, 1.0, (128, 128))
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float64)
    img += 800.0 * np.exp(-((yy - 64) ** 2 / (2 * 1.5 ** 2) +
                            (xx - 64) ** 2 / (2 * 4.0 ** 2)))
    res = detect_stars(img.astype(np.float32), 5.0)
    assert len(res.stars) == 1
    assert res.stars[0].eccentricity > 0.7


def test_snr_positive_and_scaled():
    img = make_field(stars=((128.0, 128.0, 1000.0, 2.0),), noise=2.0)
    res = detect_stars(img, 5.0)
    s = res.stars[0]
    assert s.snr == pytest.approx(1000.0 / res.background_sigma, rel=0.15)


def _np_sigma_clipped(vals, kappa=3.0, iterations=2):
    """sigma_clipped_stats (math/sigma_clip.rs:4-34) in numpy: median
    and MAD with even-count averaging, the retained set re-clipped to
    median ± κ·σ while at least 3 values remain."""
    v = np.sort(vals)
    for _ in range(iterations):
        if len(v) < 3:
            break
        med = np.median(v)
        sig = max(np.median(np.abs(v - med)) * 1.4826, 1e-30)
        v = v[(v >= np.float32(med - kappa * sig))
              & (v <= np.float32(med + kappa * sig))]
    if len(v) == 0:
        return 0.0, 1.0
    med = np.median(v)
    return med, max(np.median(np.abs(v - med)) * 1.4826, 1e-30)


def test_background_matches_numpy_tile_stats(rng):
    """_estimate_background_kernel == per-tile sigma-clipped stats in
    numpy, then the median tile (rank n//2) over tiles with ≥ 8 valid
    pixels (star_detection.rs:40-75); NaN, padding-level and hot pixels
    included."""
    from astroburst_tpu.analysis.star_detection import (
        _estimate_background_kernel)

    img = rng.normal(50, 4, (70, 90)).astype(np.float32)
    img[10:12, 20:24] = np.nan
    img[40, 50] = 900.0
    img[60:70, 0:40] = 0.0   # below the padding threshold: invalid
    step = 32
    meds, sigs = [], []
    for ty in range(0, 70, step):
        for tx in range(0, 90, step):
            t = img[ty:ty + step, tx:tx + step].ravel()
            t = t[np.isfinite(t) & (t > 1e-7)]
            if len(t) >= 8:
                m, sg = _np_sigma_clipped(t)
                meds.append(m)
                sigs.append(sg)
    want_med = np.sort(meds)[len(meds) // 2]
    want_sig = np.sort(sigs)[len(sigs) // 2]
    got_med, got_sig = _estimate_background_kernel(jnp.asarray(img), step)
    assert float(got_med) == pytest.approx(float(want_med), rel=1e-5)
    assert float(got_sig) == pytest.approx(float(want_sig), rel=1e-4)


def test_local_maxima_match_numpy(rng):
    """The 8-neighbour peak stencil: strictly above the neighbours
    after the pixel in scan order, at least equal to those before it
    (one peak per flat plateau), border excluded."""
    from astroburst_tpu.analysis.star_detection import _local_maxima

    img = np.round(rng.normal(0, 1, (40, 50)) * 2).astype(np.float32)
    img[10:13, 10:13] = 9.0                   # a flat plateau
    mask = rng.random(img.shape) < 0.9
    got = np.asarray(_local_maxima(jnp.asarray(img), jnp.asarray(mask)))
    want = np.zeros_like(mask)
    for y in range(1, 39):
        for x in range(1, 49):
            ok = True
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if (dy, dx) == (0, 0):
                        continue
                    nb = img[y + dy, x + dx]
                    ok &= (img[y, x] > nb if (dy, dx) > (0, 0)
                           else img[y, x] >= nb)
            want[y, x] = ok and mask[y, x]
    np.testing.assert_array_equal(got, want)
    assert got[10:13, 10:13].sum() == 1


def test_window_moments_match_numpy_flood_fill():
    """Flux, pixel count and centroid of each isolated star == the
    8-connected component of above-threshold pixels holding its peak
    (scipy.ndimage.label), with background-subtracted weights."""
    from scipy import ndimage

    from astroburst_tpu.analysis.star_detection import (
        _detect_fused, _estimate_background_kernel)

    rng = np.random.default_rng(5)
    h, w = 256, 320
    img = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    centers = [(40.3, 50.7), (120.0, 200.2), (200.6, 80.1), (60.2, 280.4)]
    for k, (sy, sx) in enumerate(centers):
        img += (500.0 + 300 * k) * np.exp(
            -((yy - sy) ** 2 + (xx - sx) ** 2) / 4.0)
    x = jnp.asarray(img)
    bg_med, bg_sig = (float(v) for v in _estimate_background_kernel(x, 32))
    packed = np.asarray(_detect_fused(x, 32, 5.0, 64))
    valid = packed[8] > 0.5
    labels, _ = ndimage.label(img > bg_med + 5.0 * bg_sig,
                              structure=np.ones((3, 3)))
    for sy, sx in centers:
        k = int(np.argmin(np.where(valid, (packed[0] - sy) ** 2
                                   + (packed[1] - sx) ** 2, np.inf)))
        comp = labels == labels[int(round(sy)), int(round(sx))]
        wts = np.where(comp, np.maximum(img - bg_med, 0.0), 0.0)
        flux = wts.sum()
        assert packed[6, k] == comp.sum()
        assert packed[2, k] == pytest.approx(flux, rel=1e-4)
        assert packed[0, k] == pytest.approx((wts * yy).sum() / flux,
                                             abs=1e-3)
        assert packed[1, k] == pytest.approx((wts * xx).sum() / flux,
                                             abs=1e-3)


def test_detect_stars_small_image_no_crash(rng):
    """Images whose 2×2 block-max grid is smaller than max_peaks must
    not crash top_k (r3 review finding: 40×40 raised ValueError)."""
    from astroburst_tpu.analysis.star_detection import detect_stars

    img = rng.normal(100, 3, (40, 40)).astype(np.float32)
    yy, xx = np.mgrid[0:40, 0:40].astype(np.float32)
    for sy, sx in [(12, 12), (28, 30)]:
        img += 800.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 3.0)
    res = detect_stars(img)
    assert len(res.stars) >= 2
    got = {(round(s.y), round(s.x)) for s in res.stars[:2]}
    assert (12, 12) in got and (28, 30) in got


def test_detect_stars_dense_slab_overflow_fallback(rng):
    """>64 peaks inside one 2-image-row slab must all survive: the
    two-level top_k detects per-slab overflow and falls back to the
    lossless full-plane top_k (r3 review finding)."""
    from astroburst_tpu.analysis.star_detection import (_detect_kernel,
                                                        detect_stars)

    h, w = 64, 512
    img = rng.normal(100.0, 0.5, (h, w)).astype(np.float32)
    xs = np.arange(5, 502, 7)  # 71 blobs peaking in rows 2-3 (one slab)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for x in xs:
        # tight blobs: tails must NOT bridge above threshold or the
        # flood fill merges neighbors into one component
        img += 500.0 * np.exp(-((yy - 2.0) ** 2 + (xx - x) ** 2) / 1.0)
    res = detect_stars(img, sigma_threshold=5.0, max_peaks=256)
    found = {(round(s.y), round(s.x)) for s in res.stars}
    missing = [x for x in xs if (2, x) not in found]
    assert not missing, f"lost {len(missing)} slab peaks: {missing[:5]}"


def test_device_dedupe_matches_host_accept_set():
    """dedupe_packed_device must reproduce _postprocess_packed's
    brightest-first 3-px greedy accept set exactly (star_detection.rs:
    215), including chained suppressions (A<3px from B<3px from C)."""
    import jax.numpy as jnp
    from astroburst_tpu.analysis.star_detection import (
        _detect_fused, _postprocess_packed, dedupe_packed_device)

    rng = np.random.default_rng(11)
    h, w = 256, 320
    img = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # isolated stars + tight pairs/chains within 3 px
    spots = [(40, 40, 900), (41.5, 41.5, 700), (43.0, 43.0, 800),
             (120, 200, 1000), (121.2, 201.0, 950),
             (200, 60, 600), (80, 280, 850), (30, 150, 500)]
    for sy, sx, a in spots:
        img += a * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 3.0)
    packed = _detect_fused(jnp.asarray(img), 32, 5.0, 256)
    host = _postprocess_packed(np.asarray(packed), 5.0, h, w)
    accepted = np.asarray(dedupe_packed_device(packed))
    pk = np.asarray(packed)
    got = sorted((round(float(y), 3), round(float(x), 3))
                 for y, x, a in zip(pk[0], pk[1], accepted) if a)
    want = sorted((round(s.y, 3), round(s.x, 3)) for s in host.stars)
    assert got == want
    assert len(want) >= 5  # duplicates were actually suppressed
