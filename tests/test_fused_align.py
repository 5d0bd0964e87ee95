"""Fused single-program alignment chain vs the host-orchestrated path
(affine.rs:129-270 semantics on both sides)."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from astroburst_tpu.alignment import affine as A
from astroburst_tpu.alignment import fused_chain as FC
from astroburst_tpu.analysis import star_detection as SD


def make_star_field(shape=(256, 256), n=40, seed=11, bg=50.0):
    rng = np.random.default_rng(seed)
    img = rng.normal(bg, 1.5, shape)
    pts = rng.random((n, 2)) * (np.array(shape[::-1]) - 40) + 20
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    for x, y in pts:
        amp = 300 + rng.random() * 700
        img += amp * np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                            / (2 * 1.6 ** 2))
    return img.astype(np.float32)


def invert(t):
    det = t.a * t.d - t.b * t.c
    ia, ib, ic, id_ = t.d / det, -t.b / det, -t.c / det, t.a / det
    return A.AffineTransform(a=ia, b=ib, tx=-(ia * t.tx + ib * t.ty),
                             c=ic, d=id_, ty=-(ic * t.tx + id_ * t.ty))


def _np_votes(ratios_r, verts_r, ratios_t, verts_t):
    """votes[a, b]: tolerance-matched (ref, tgt) triangle pairs whose
    p-th vertices are stars a and b, summed over p (affine.rs:320-384)."""
    votes = np.zeros((A._STAR_CAP, A._STAR_CAP), np.int64)
    ok_r = np.isfinite(ratios_r).all(axis=1)
    ok_t = np.isfinite(ratios_t).all(axis=1)
    for i in np.flatnonzero(ok_r):
        m = ok_t & (np.abs(ratios_t[:, 0] - ratios_r[i, 0])
                    <= A.TRIANGLE_TOLERANCE) & (
            np.abs(ratios_t[:, 1] - ratios_r[i, 1]) <= A.TRIANGLE_TOLERANCE)
        for j in np.flatnonzero(m):
            for p in range(3):
                votes[verts_r[i, p], verts_t[j, p]] += 1
    return votes


def test_vote_kernel_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    stars_r = rng.random((15, 2)) * 2000
    stars_t = stars_r + np.array([7.0, -4.0]) + rng.normal(0, 0.01, (15, 2))
    vr, rr = A.build_triangles(stars_r)
    vt, tr = A.build_triangles(stars_t)

    def pad(v, r):  # +inf ratio rows to a vote-chunk multiple
        t = -(-len(v) // A._VOTE_CHUNK) * A._VOTE_CHUNK
        return (np.concatenate([v, np.zeros((t - len(v), 3), np.int32)]),
                np.concatenate([r, np.full((t - len(r), 2), np.inf,
                                           np.float32)]))

    pv_r, pr_r = pad(vr, rr)
    pv_t, pr_t = pad(vt, tr)
    got = np.asarray(A._vote_kernel(
        jnp.asarray(pr_r), jnp.asarray(pv_r), jnp.asarray(pr_t),
        jnp.asarray(pv_t), A._STAR_CAP, A._STAR_CAP))
    want = _np_votes(pr_r, pv_r, pr_t, pv_t)
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0


def test_fused_chain_votes_match_numpy_oracle():
    """The fused chain's votes from its device triangle tables (star
    slots past the real stars are +inf and build no triangle)."""
    rng = np.random.default_rng(1)
    n = FC._N_TRI_STARS
    pts = rng.random((12, 2)) * 900 + 50
    xs = np.full(n, np.inf, np.float32)
    ys = np.full(n, np.inf, np.float32)
    xs[:12], ys[:12] = pts[:, 0], pts[:, 1]
    rr_t, rv_t = FC._device_triangles(jnp.asarray(xs), jnp.asarray(ys))
    xt = xs.copy()
    xt[:12] += 5.0
    tr_t, tv_t = FC._device_triangles(jnp.asarray(xt), jnp.asarray(ys))
    got = np.asarray(FC._votes(rr_t, rv_t, tr_t, tv_t))
    want = _np_votes(np.asarray(rr_t).T, np.asarray(rv_t).T,
                     np.asarray(tr_t).T, np.asarray(tv_t).T)
    np.testing.assert_array_equal(got, want)
    # a pure translation matches every star to itself
    assert (np.argmax(want[:12, :12], axis=1) == np.arange(12)).all()


def test_device_dedupe_matches_host():
    img = make_star_field((256, 256), n=60, seed=3)
    norm = A.normalize_for_detection(jnp.asarray(img))
    packed = SD._detect_fused(norm, 32, A.DETECTION_SIGMA, SD.MAX_PEAKS)
    host = SD._postprocess_packed(np.asarray(packed), A.DETECTION_SIGMA,
                                  256, 256)
    xs, ys, n = FC._dedupe_topk(packed)
    xs, ys, n = np.asarray(xs), np.asarray(ys), int(n)
    expect = host.stars[:FC._N_TRI_STARS]
    assert n == min(len(host.stars), FC._N_TRI_STARS)
    for i, s in enumerate(expect):
        assert xs[i] == pytest.approx(s.x, abs=1e-5)
        assert ys[i] == pytest.approx(s.y, abs=1e-5)
    assert np.all(np.isinf(xs[n:]))


def test_device_triangles_match_host():
    rng = np.random.default_rng(5)
    stars = (rng.random((45, 2)) * 400 + 20).astype(np.float64)
    verts_h, ratios_h = A.build_triangles(stars)

    xs = np.full(FC._N_TRI_STARS, np.inf, np.float32)
    ys = np.full(FC._N_TRI_STARS, np.inf, np.float32)
    xs[:45] = stars[:, 0]
    ys[:45] = stars[:, 1]
    ratios_t, verts_t = FC._device_triangles(jnp.asarray(xs),
                                             jnp.asarray(ys))
    ratios_t = np.asarray(ratios_t)
    verts_t = np.asarray(verts_t)
    finite = np.isfinite(ratios_t[0])
    assert finite.sum() == len(ratios_h)
    # key by the (unique) unordered vertex triple; every triangle must
    # agree on both ratios AND the sorted vertex order
    got = {}
    for r1, r2, v0, v1, v2 in zip(
            ratios_t[0][finite], ratios_t[1][finite], verts_t[0][finite],
            verts_t[1][finite], verts_t[2][finite]):
        got[tuple(sorted((int(v0), int(v1), int(v2))))] = \
            (float(r1), float(r2), (int(v0), int(v1), int(v2)))
    for (v0, v1, v2), (r1, r2) in zip(verts_h, ratios_h):
        key = tuple(sorted((int(v0), int(v1), int(v2))))
        dr1, dr2, dverts = got.pop(key)
        assert dverts == (int(v0), int(v1), int(v2))
        assert dr1 == pytest.approx(r1, abs=1e-3)
        assert dr2 == pytest.approx(r2, abs=1e-3)
    assert not got


def test_greedy_match_matches_host_sweep():
    rng = np.random.default_rng(7)
    votes = rng.integers(0, 20, (64, 64)).astype(np.float32)
    votes[rng.random((64, 64)) < 0.7] = 0.0
    ris, tis, cnt = FC._greedy_match(jnp.asarray(votes))
    ris, tis, cnt = np.asarray(ris), np.asarray(tis), int(cnt)

    flat = votes.reshape(-1)
    order = np.argsort(-flat, kind="stable")
    used_r = np.zeros(64, bool)
    used_t = np.zeros(64, bool)
    expect = []
    for idx in order:
        if flat[idx] < 1:
            break
        ri, ti = divmod(int(idx), 64)
        if used_r[ri] or used_t[ti]:
            continue
        used_r[ri] = used_t[ti] = True
        expect.append((ri, ti))
    assert cnt == len(expect)
    assert [(int(r), int(t)) for r, t in zip(ris[:cnt], tis[:cnt])] == expect


@pytest.mark.slow
def test_fused_align_matches_host_translation():
    img = make_star_field()
    t = A.AffineTransform(tx=6.0, ty=-8.0)
    target = np.asarray(A.warp_image(img, invert(t), 256, 256))
    warped, res = FC.align_and_warp(img, target)
    host = A.align_channel_affine(img, target)
    assert res.method == host.method
    assert res.inliers == host.inliers
    for a, b in zip(res.transform.as_tuple(), host.transform.as_tuple()):
        assert a == pytest.approx(b, abs=5e-3)
    # the fused in-program warp equals the host warp of the same params
    w_host = np.asarray(A.warp_image(target, res.transform, 256, 256))
    np.testing.assert_allclose(np.asarray(warped)[8:-8, 8:-8],
                               w_host[8:-8, 8:-8], atol=2e-3)


@pytest.mark.slow
def test_fused_align_recovers_rotation():
    th = math.radians(2.0)
    ct, st = math.cos(th), math.sin(th)
    cx = cy = 128.0
    t = A.AffineTransform(a=ct, b=-st, tx=cx - ct * cx + st * cy,
                          c=st, d=ct, ty=cy - st * cx - ct * cy)
    img = make_star_field(seed=9)
    target = np.asarray(A.warp_image(img, invert(t), 256, 256))
    warped, res = FC.align_and_warp(img, target)
    assert res.method in ("affine", "rigid")
    assert res.transform.rotation_deg() == pytest.approx(2.0, abs=0.2)


@pytest.mark.slow
def test_fused_align_starless_fallback():
    rng = np.random.default_rng(4)
    a = rng.normal(100, 2, (128, 128)).astype(np.float32)
    b = np.roll(a, (4, 3), axis=(0, 1))
    _, res = FC.align_and_warp(a, b)
    assert res.method in ("phase_correlation", "identity")


def test_ref_stars_cached_path_identical():
    img = make_star_field(seed=5)
    t = A.AffineTransform(tx=4.0, ty=-3.0)
    target = np.asarray(A.warp_image(img, invert(t), 256, 256))
    w_direct, r_direct = FC.align_and_warp(img, target)
    stars = FC.detect_ref_stars(img)
    w_cached, r_cached = FC.align_and_warp(img, target, ref_stars=stars)
    assert r_cached.method == r_direct.method
    assert r_cached.inliers == r_direct.inliers
    assert r_cached.transform.as_tuple() == r_direct.transform.as_tuple()
    np.testing.assert_array_equal(np.asarray(w_cached),
                                  np.asarray(w_direct))


def test_ref_stars_shape_mismatch_rejected():
    img = make_star_field(seed=5)
    stars = FC.detect_ref_stars(img)
    other = np.zeros((128, 256), np.float32)
    with pytest.raises(ValueError):
        FC.align_and_warp(other, other, ref_stars=stars)


@pytest.mark.parametrize("method", ["affine", "rigid"])
def test_ransac_device_matches_host(method):
    """_ransac_device vs the host ransac_affine on the same matches —
    same hypothesis table (affine._RANSAC_U), so the winning transform
    must agree to f32 tolerance (affine.rs:400-517)."""
    import math

    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n = 40
    rows, cols = 512, 640
    rx = rng.uniform(20, cols - 20, n)
    ry = rng.uniform(20, rows - 20, n)
    th = math.radians(0.8)
    ct, st = math.cos(th), math.sin(th)
    tx_ = ct * rx - st * ry + 6.0 + rng.normal(0, 0.05, n)
    ty_ = st * rx + ct * ry - 3.0 + rng.normal(0, 0.05, n)
    # a few gross outliers
    tx_[::13] += 40.0

    host = A.ransac_affine(
        [(float(a), float(b), float(c), float(d))
         for a, b, c, d in zip(rx, ry, tx_, ty_)], method)
    assert host is not None

    cap = FC.STAR_CAP
    pad = cap - n
    mx = jnp.asarray(np.pad(rx, (0, pad)).astype(np.float32))
    my = jnp.asarray(np.pad(ry, (0, pad)).astype(np.float32))
    mu = jnp.asarray(np.pad(tx_, (0, pad)).astype(np.float32))
    mv = jnp.asarray(np.pad(ty_, (0, pad)).astype(np.float32))
    mvalid = jnp.arange(cap) < n
    params, ok, inl, resid = FC._ransac_device(
        mx, my, mu, mv, mvalid, jnp.int32(n), rows, cols, method)
    assert bool(ok)
    got = np.asarray(params, np.float64)
    want = np.array(host.transform.as_tuple())
    # translations are O(10) px, linear parts O(1): scale tolerances
    np.testing.assert_allclose(got[[0, 1, 3, 4]], want[[0, 1, 3, 4]],
                               atol=5e-4)
    np.testing.assert_allclose(got[[2, 5]], want[[2, 5]], atol=0.25)
    assert int(inl) == host.inliers


@pytest.mark.slow
def test_align_and_warp_many_matches_per_target():
    """One-program multi-target chain == per-target fused chain
    (blend.rs:226 workload: G and B aligned to a shared R)."""
    img = make_star_field(seed=5)
    t1 = A.AffineTransform(tx=4.0, ty=-3.0)
    t2 = A.AffineTransform(tx=-2.0, ty=5.0)
    tg1 = np.asarray(A.warp_image(img, invert(t1), 256, 256))
    tg2 = np.asarray(A.warp_image(img, invert(t2), 256, 256))

    stars = FC.detect_ref_stars(img)
    singles = [FC.align_and_warp(img, t, ref_stars=stars)
               for t in (tg1, tg2)]
    many = FC.align_and_warp_many(img, [tg1, tg2], ref_stars=stars)
    assert len(many) == 2
    for (w_m, r_m), (w_s, r_s) in zip(many, singles):
        assert r_m.method == r_s.method
        assert r_m.inliers == r_s.inliers
        assert r_m.transform.as_tuple() == r_s.transform.as_tuple()
        np.testing.assert_array_equal(np.asarray(w_m), np.asarray(w_s))


def test_align_and_warp_many_shape_fallback():
    """Mismatched target shapes route through the per-target path."""
    img = make_star_field(seed=5)
    small = np.asarray(img)[:128, :128]
    out = FC.align_and_warp_many(img, [small])
    assert len(out) == 1
    warped, res = out[0]
    assert warped.shape == img.shape or warped.shape == small.shape
