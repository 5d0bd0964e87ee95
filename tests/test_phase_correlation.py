"""Phase correlation tests mirroring the reference's
(phase_correlation.rs:171-240) plus a coarse-to-fine case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from astroburst_tpu.alignment import phase_correlate


def make_pattern(rows, cols, seed=7):
    """Broadband star-field-like pattern: Gaussian spots + noise.

    (The reference's test pattern — smooth global sinusoids — is
    near-periodic; whitened phase correlation on such a pattern has
    ambiguous sidelobe peaks under any FFT library. Real astro frames
    are broadband, which is what this models.)
    """
    rng = np.random.default_rng(seed)
    img = rng.normal(100.0, 3.0, (rows, cols)).astype(np.float32)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    for _ in range(40):
        sy, sx = rng.random(2) * [rows - 20, cols - 20] + 10
        amp = 200.0 + rng.random() * 800.0
        img += amp * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 4.0)
    return img.astype(np.float32)


def shift_array(img, dy, dx):
    rows, cols = img.shape
    out = np.zeros_like(img)
    ys = np.arange(rows) - dy
    xs = np.arange(cols) - dx
    yv = (ys >= 0) & (ys < rows)
    xv = (xs >= 0) & (xs < cols)
    out[np.ix_(yv, xv)] = img[np.ix_(ys[yv], xs[xv])]
    return out


def test_identical_images():
    img = make_pattern(128, 128)
    r = phase_correlate(img, img)
    assert abs(r.dx) < 0.5
    assert abs(r.dy) < 0.5


def test_known_integer_shift():
    img = make_pattern(256, 256)
    shifted = shift_array(img, 10, -5)
    r = phase_correlate(img, shifted)
    assert abs(r.dx - (-5.0)) < 1.0
    assert abs(r.dy - 10.0) < 1.0


def test_subpixel_confidence_positive():
    img = make_pattern(128, 128)
    r = phase_correlate(img, shift_array(img, 3, 2))
    assert r.confidence > 2.0  # clean synthetic shift is high confidence


def test_nan_no_panic():
    img = make_pattern(64, 64)
    img[10, 10] = np.nan
    img[20, 30] = np.inf
    img[5, 5] = -np.inf
    r = phase_correlate(img, img)
    assert np.isfinite(r.dx) and np.isfinite(r.dy)


def test_constant_image():
    img = np.full((64, 64), 100.0, np.float32)
    r = phase_correlate(img, img)
    assert r.dx == 0.0 and r.dy == 0.0 and r.confidence == 0.0


def test_mismatched_dims_cropped():
    img = make_pattern(128, 128)
    r = phase_correlate(img, shift_array(img, 4, 4)[:120, :100])
    assert abs(r.dy - 4.0) < 1.5
    assert abs(r.dx - 4.0) < 1.5


def test_coarse_to_fine_large_image():
    img = make_pattern(700, 640)  # > 512 → coarse-to-fine path
    shifted = shift_array(img, 17, -23)
    r = phase_correlate(img, shifted)
    assert abs(r.dy - 17.0) < 1.0
    assert abs(r.dx - (-23.0)) < 1.0


def test_correlate_two_matches_single():
    from astroburst_tpu.alignment.phase_correlation import (correlate_single,
                                                            correlate_two)
    img = make_pattern(128, 96)
    t1 = np.roll(img, (4, -3), axis=(0, 1))
    t2 = np.roll(img, (-6, 2), axis=(0, 1))
    a = jnp.asarray(img)
    s1 = correlate_single(a, jnp.asarray(t1))
    s2 = correlate_single(a, jnp.asarray(t2))
    d1y, d1x, c1, d2y, d2x, c2 = correlate_two(a, jnp.asarray(t1),
                                               jnp.asarray(t2))
    assert float(d1y) == pytest.approx(float(s1[0]), abs=0.05)
    assert float(d1x) == pytest.approx(float(s1[1]), abs=0.05)
    assert float(d2y) == pytest.approx(float(s2[0]), abs=0.05)
    assert float(d2x) == pytest.approx(float(s2[1]), abs=0.05)
    assert float(c1) > 2.0 and float(c2) > 2.0


def test_phase_correlate_stack_odd_batch():
    from astroburst_tpu.alignment.phase_correlation import (
        phase_correlate_stack)
    img = make_pattern(128, 96)
    shifts = [(3, -2), (-5, 4), (7, 1)]
    tgts = jnp.asarray(np.stack([np.roll(img, s, axis=(0, 1))
                                 for s in shifts]))
    dys, dxs, confs = phase_correlate_stack(jnp.asarray(img), tgts)
    for i, (sy, sx) in enumerate(shifts):
        assert float(dys[i]) == pytest.approx(sy, abs=0.3)
        assert float(dxs[i]) == pytest.approx(sx, abs=0.3)
        assert float(confs[i]) > 2.0


def test_stack_pc_matches_per_frame(rng):
    """phase_correlate_stack_traced (3D dynamic-slice crops, no
    gathers) == the per-frame coarse-to-fine path."""
    from astroburst_tpu.alignment.phase_correlation import (
        _phase_correlate_traced, phase_correlate_stack_traced)

    base = rng.normal(100, 5, (900, 700)).astype(np.float32)
    yy, xx = np.mgrid[0:900, 0:700].astype(np.float32)
    for sy, sx in [(220, 150), (600, 500), (420, 350)]:
        base += 800.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 8.0)
    shifts = [(11, -7), (0, 0), (-15, 9)]
    targets = np.stack([np.roll(base, s, axis=(0, 1)) for s in shifts])
    dys, dxs, confs = phase_correlate_stack_traced(
        jnp.asarray(base), jnp.asarray(targets))
    for i, (sy, sx) in enumerate(shifts):
        rdy, rdx, rc = _phase_correlate_traced(jnp.asarray(base),
                                               jnp.asarray(targets[i]))
        assert abs(float(dys[i]) - float(rdy)) < 1e-5
        assert abs(float(dxs[i]) - float(rdx)) < 1e-5
        assert abs(float(dys[i]) - sy) < 0.5
        assert abs(float(dxs[i]) - sx) < 0.5


def _star_plane(rng, h, w, spots):
    base = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sy, sx in spots:
        base += 900.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 8.0)
    return base


def test_stack_align_recovers_offsets_wide_plane(rng):
    """Coarse-to-fine on a plane past the coarse cap on both axes, with
    a zero-offset frame among the targets."""
    from astroburst_tpu.alignment.phase_correlation import (
        phase_correlate_stack_traced)

    base = _star_plane(rng, 640, 1152, [(100, 200), (400, 800),
                                        (300, 500), (520, 950)])
    shifts = [(3, -5), (-7, 11), (0, 0)]
    tgts = np.stack([np.roll(np.roll(base, dy, 0), dx, 1)
                     for dy, dx in shifts])
    dys, dxs, confs = phase_correlate_stack_traced(jnp.asarray(base),
                                                   jnp.asarray(tgts))
    for i, (sy, sx) in enumerate(shifts):
        assert float(dys[i]) == pytest.approx(sy, abs=0.05)
        assert float(dxs[i]) == pytest.approx(sx, abs=0.05)
        assert float(confs[i]) > 2.0


def test_stack_align_zeroes_constant_frame(rng):
    """A constant target gets offset 0 and confidence 0
    (phase_correlation.rs:143-161), the others are unaffected."""
    from astroburst_tpu.alignment.phase_correlation import (
        phase_correlate_stack_traced)

    base = _star_plane(rng, 640, 1152, [(100, 200), (400, 800),
                                        (300, 500)])
    tgts = np.stack([np.roll(np.roll(base, 3, 0), -5, 1),
                     np.full(base.shape, 7.0, np.float32)])
    dys, dxs, confs = phase_correlate_stack_traced(jnp.asarray(base),
                                                   jnp.asarray(tgts))
    assert float(dys[0]) == pytest.approx(3.0, abs=0.05)
    assert float(dxs[0]) == pytest.approx(-5.0, abs=0.05)
    assert float(dys[1]) == 0.0 and float(dxs[1]) == 0.0
    assert float(confs[1]) == 0.0


def test_coarse_large_box_plane_recovers_offsets():
    """Tall planes (coarse box spanning >=5 rows) must still recover
    known integer offsets through coarse→refine, at shapes the small
    unit planes never hit."""
    from astroburst_tpu.alignment.phase_correlation import (
        phase_correlate_stack_traced)

    rng = np.random.default_rng(8)
    h, w = 2560, 640  # by = ceil(2560/512) = 5
    base = rng.normal(100, 4, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(40):
        sy, sx = rng.uniform(30, h - 30), rng.uniform(30, w - 30)
        base += rng.uniform(300, 1500) * np.exp(
            -((yy - sy) ** 2 + (xx - sx) ** 2) / 4.0)
    shifts = [(3, -2), (-5, 4), (0, 0)]
    tgts = np.stack([np.roll(base, s, (0, 1)) for s in shifts])
    dys, dxs, confs = phase_correlate_stack_traced(
        jnp.asarray(base), jnp.asarray(tgts))
    for i, (sy, sx) in enumerate(shifts):
        assert abs(float(dys[i]) - sy) < 0.35, (i, float(dys[i]), sy)
        assert abs(float(dxs[i]) - sx) < 0.35, (i, float(dxs[i]), sx)


@pytest.mark.parametrize("shape,boxes", [
    ((3, 850, 1200), (2, 3)),     # both axes boxed, ragged remainders
    ((2, 400, 1200), (1, 3)),     # wide-short: column boxes only
    ((2, 1200, 400), (3, 1)),     # tall-narrow: row boxes only
    ((1, 1030, 2060), (3, 5)),    # boxes leave a remainder on both axes
])
def test_coarse_box_downsample_matches_numpy(rng, shape, boxes):
    """The coarse pass's box mean (a reshape + mean) == the numpy box
    mean over the largest divisible region, NaN propagating."""
    from astroburst_tpu.alignment.phase_correlation import (
        COARSE_MAX_DIM, _coarse_box_downsample)

    frames = rng.normal(50, 5, shape).astype(np.float32)
    frames[0, 3, 4] = np.nan
    ds, by, bx = _coarse_box_downsample(jnp.asarray(frames),
                                        COARSE_MAX_DIM)
    assert (by, bx) == boxes
    n, h, w = shape
    r, c = h // by, w // bx
    want = frames[:, :r * by, :c * bx].astype(np.float64).reshape(
        n, r, by, c, bx).mean(axis=(2, 4))
    got = np.asarray(ds)
    assert got.shape == (n, r, c) and r <= 512 and c <= 512
    assert np.isnan(got[0, 3 // by, 4 // bx])
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("cy,cx", [(320, 576), (3, 5), (639, 1151)])
def test_refine_crop_matches_numpy(rng, cy, cx):
    """The refine crop is a dynamic_slice centered on (cy, cx),
    clamped to the plane — checked against numpy slicing at interior
    and both edge corners."""
    from astroburst_tpu.alignment.phase_correlation import (
        REFINE_CROP_SIZE, _dynamic_crop)

    h, w = 640, 1152
    img = rng.normal(0, 1, (h, w)).astype(np.float32)
    got = np.asarray(_dynamic_crop(jnp.asarray(img), jnp.int32(cy),
                                   jnp.int32(cx), REFINE_CROP_SIZE))
    size = REFINE_CROP_SIZE
    y0 = min(max(cy - size // 2, 0), h - size)
    x0 = min(max(cx - size // 2, 0), w - size)
    np.testing.assert_array_equal(got, img[y0:y0 + size, x0:x0 + size])
