"""The whole star-alignment chain as ONE device program.

The host-orchestrated chain (`affine.align_channel_affine`) is the
canonical implementation of affine.rs:129-270: detect stars on both
planes, dedupe, build triangles, vote, greedy-match, RANSAC, sanity
gates, warp. Run stage-by-stage it pays a host round trip per device
result plus host time for the triangle build.

Here every stage is traced into a single XLA program; the host fetches
one small info vector and the warped plane never leaves the device:

- detection: the same `_estimate_background_kernel` + `_detect_kernel`
  the canonical path jits (bit-identical candidates).
- dedupe: the reference's brightest-first 3-px greedy
  (star_detection.rs:215) as a `lax.scan` over flux-ordered
  candidates — each step tests one candidate against the accepted
  set with a masked distance reduction; identical output order.
- triangles (affine.rs:279-318): the C(60,3) vertex triples are a
  static module constant, so side lengths are three index-vector
  takes from one [64, 64] pairwise distance table; a 3-element
  min/max network sorts sides, vertex order comes from a stable
  3-rank network. Sorted by first ratio so the vote kernel's
  block-overlap skip can prune.
- votes: `affine._vote_kernel`, the host chain's own matmul votes.
- greedy one-to-one pairing (affine.rs:320-384): 64-step scan of
  masked argmax — same pair sequence as the host's sorted sweep
  (ties resolve to the lowest flat index on both).
- RANSAC (affine.rs:400-517): all 2000 hypotheses as dense math in
  image-center-normalized coordinates; the hypothesis sample table
  `affine._RANSAC_U` is shared with the host path so both draw the
  same samples for the same match count. Affine and rigid results
  plus the reference's sanity gates are all evaluated on device;
  nested selects pick the surviving transform.
- warp: the shear-decomposed Catmull-Rom warp (`warp_shear`) with
  traced params — pad widths are static, sized for a configurable
  rotation envelope (default ±2°); transforms outside it set a flag
  and the host re-warps with concrete params instead.

The phase-correlation / identity fallbacks stay host-side: they only
run when the star chain fails, which the info vector reports.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.alignment import affine as A
from astroburst_tpu.alignment.warp_shear import _bucket, _warp_shear_impl
from astroburst_tpu.analysis import star_detection as SD

STAR_CAP = 64          # star slots in the vote table (> TRIANGLE_STAR_LIMIT)
_N_TRI_STARS = A.TRIANGLE_STAR_LIMIT   # 60
_TRI_PAD = 2048        # triangle-table padding multiple

# static C(60,3) vertex triples, i < j < k
_TRIPLES = np.array(
    [(a, b, c) for a in range(_N_TRI_STARS)
     for b in range(a + 1, _N_TRI_STARS)
     for c in range(b + 1, _N_TRI_STARS)], dtype=np.int32)
_N_TRI = len(_TRIPLES)                       # 34220
_TP = -(-_N_TRI // _TRI_PAD) * _TRI_PAD      # 34816


def _dedupe_topk(packed: jax.Array, n_keep: int = _N_TRI_STARS,
                 scan_cap: int = 256):
    """Brightest-first 3-px greedy dedupe of the packed detection
    candidates; returns the first ``n_keep`` accepted star positions
    ([n_keep] x/y, +inf in empty slots) and the accepted count.

    Identical accept sequence to `_postprocess_packed`: candidates in
    flux-descending order, accepted unless within 3 px of an earlier
    accept. The scan walks only the ``scan_cap`` brightest candidates
    — the output is the top ``n_keep`` deduped stars, so this differs
    from the full walk only if > scan_cap − n_keep of the brightest
    scan_cap candidates are 3-px duplicates (the scan is sequential,
    so its length is its latency)."""
    cys, cxs, fluxes = packed[0], packed[1], packed[2]
    valid = packed[8] > 0.5
    order = jnp.argsort(jnp.where(valid, -fluxes, jnp.inf))[:scan_cap]
    ys = jnp.take(cys, order)
    xs = jnp.take(cxs, order)
    val = jnp.take(valid, order)

    def step(acc, i):
        d2 = (ys - ys[i]) ** 2 + (xs - xs[i]) ** 2
        clash = jnp.any(acc & (d2 < 9.0))
        acc = acc.at[i].set(val[i] & ~clash)
        return acc, None

    n = ys.shape[0]
    acc, _ = jax.lax.scan(step, jnp.zeros(n, bool), jnp.arange(n))
    rank = jnp.cumsum(acc.astype(jnp.int32)) - 1
    total = jnp.sum(acc.astype(jnp.int32))
    # one-hot select of the first n_keep accepted (matmul, no scatter)
    sel = ((rank[None, :] == jnp.arange(n_keep)[:, None]) &
           acc[None, :]).astype(jnp.float32)
    x_top = sel @ xs
    y_top = sel @ ys
    have = jnp.arange(n_keep) < total
    return (jnp.where(have, x_top, jnp.inf),
            jnp.where(have, y_top, jnp.inf),
            jnp.minimum(total, n_keep))


def _sort3(d0, d1, d2):
    lo01 = jnp.minimum(d0, d1)
    hi01 = jnp.maximum(d0, d1)
    s0 = jnp.minimum(lo01, d2)
    s2 = jnp.maximum(hi01, d2)
    s1 = jnp.maximum(lo01, jnp.minimum(hi01, d2))
    return s0, s1, s2


def _device_triangles(xs: jax.Array, ys: jax.Array):
    """build_triangles (affine.rs:279-318) on device: [n_keep] star
    positions (+inf pads) → transposed ratio [2, TP] / vertex [3, TP]
    arrays sorted ascending by first ratio, +inf-ratio padding.

    Missing stars self-mask: any +inf coordinate makes every ratio of
    its triangles +inf/NaN, which the tolerance test rejects — the
    same triangles the host never builds."""
    n = _N_TRI_STARS
    dx = xs[:, None] - xs[None, :]
    dy = ys[:, None] - ys[None, :]
    dist = jnp.sqrt(dx * dx + dy * dy).reshape(-1)     # [n*n]
    ti = jnp.asarray(_TRIPLES[:, 0])
    tj = jnp.asarray(_TRIPLES[:, 1])
    tk = jnp.asarray(_TRIPLES[:, 2])
    d_ij = jnp.take(dist, ti * n + tj)
    d_jk = jnp.take(dist, tj * n + tk)
    d_ik = jnp.take(dist, ti * n + tk)
    s0, s1, s2 = _sort3(d_ij, d_jk, d_ik)
    keep = (s0 >= A.MIN_TRIANGLE_SIDE) & jnp.isfinite(s2)
    inf = jnp.float32(jnp.inf)
    r1 = jnp.where(keep, s1 / s0, inf)
    r2 = jnp.where(keep, s2 / s0, inf)

    # stable 3-rank by opposite side (opp_p ties break by position,
    # matching the host's stable argsort)
    opp = (d_jk, d_ik, d_ij)
    verts = (ti, tj, tk)
    ranks = []
    for p in range(3):
        r = jnp.zeros_like(ti)
        for q in range(3):
            if q == p:
                continue
            lt = opp[q] < opp[p]
            eq = (opp[q] == opp[p]) & (q < p)
            r = r + (lt | eq).astype(jnp.int32)
        ranks.append(r)
    v_sorted = []
    for slot in range(3):
        v = jnp.zeros_like(ti)
        for p in range(3):
            v = v + jnp.where(ranks[p] == slot, verts[p], 0)
        v_sorted.append(v)

    pad = _TP - _N_TRI
    r1 = jnp.concatenate([r1, jnp.full((pad,), inf, jnp.float32)])
    r2 = jnp.concatenate([r2, jnp.full((pad,), inf, jnp.float32)])
    vs = [jnp.concatenate([v, jnp.zeros((pad,), jnp.int32)])
          for v in v_sorted]

    order = jnp.argsort(r1)
    ratios_t = jnp.stack([jnp.take(r1, order), jnp.take(r2, order)])
    verts_t = jnp.stack([jnp.take(v, order) for v in vs])
    return ratios_t, verts_t


def _greedy_match(votes: jax.Array):
    """Greedy one-to-one pairing by descending votes (affine.rs:
    320-384): repeated masked argmax ≡ the host's stable sorted sweep
    (both take the lowest flat index among ties). Returns row/col
    index vectors [64] and the accepted count."""
    def step(carry, _):
        v, ris, tis, cnt = carry
        flat = v.reshape(-1)
        idx = jnp.argmax(flat).astype(jnp.int32)
        ok = flat[idx] >= A.MIN_VOTES
        ri = idx // STAR_CAP
        ti = idx % STAR_CAP
        ris = ris.at[cnt].set(jnp.where(ok, ri, ris[cnt]))
        tis = tis.at[cnt].set(jnp.where(ok, ti, tis[cnt]))
        kill = ((jnp.arange(STAR_CAP) == ri)[:, None] |
                (jnp.arange(STAR_CAP) == ti)[None, :])
        v = jnp.where(ok & kill, -1.0, v)
        return (v, ris, tis, cnt + ok.astype(jnp.int32)), None

    init = (votes, jnp.zeros(STAR_CAP, jnp.int32),
            jnp.zeros(STAR_CAP, jnp.int32), jnp.int32(0))
    (v, ris, tis, cnt), _ = jax.lax.scan(step, init, None,
                                         length=STAR_CAP)
    return ris, tis, cnt


def _solve3(m11, m12, m13, m22, m23, m33, b1, b2, b3):
    """Symmetric 3×3 solve by adjugate; returns solution + |det|."""
    c11 = m22 * m33 - m23 * m23
    c12 = m13 * m23 - m12 * m33
    c13 = m12 * m23 - m13 * m22
    det = m11 * c11 + m12 * c12 + m13 * c13
    c22 = m11 * m33 - m13 * m13
    c23 = m12 * m13 - m11 * m23
    c33 = m11 * m22 - m12 * m12
    safe = jnp.where(jnp.abs(det) < 1e-30, 1.0, det)
    x1 = (c11 * b1 + c12 * b2 + c13 * b3) / safe
    x2 = (c12 * b1 + c22 * b2 + c23 * b3) / safe
    x3 = (c13 * b1 + c23 * b2 + c33 * b3) / safe
    return x1, x2, x3, jnp.abs(det)


def _ransac_device(mx, my, mu, mv, mvalid, cnt, rows: int, cols: int,
                   method: str):
    """Vectorized RANSAC (affine.rs:400-517 semantics, all 2000
    hypotheses dense) on device, in image-center-normalized
    coordinates for f32 conditioning.

    Inputs: ref x/y, tgt x/y [64] with a validity mask and count.
    Returns (params [6] raw-pixel affine, ok flag, inliers, residual).
    """
    s = jnp.float32(1.0 / max(rows, cols))
    cx = jnp.float32(cols / 2.0)
    cy = jnp.float32(rows / 2.0)
    nx = (mx - cx) * s
    ny = (my - cy) * s
    nu = (mu - cx) * s
    nv = (mv - cy) * s

    min_sample = 3 if method == "affine" else 2
    u_tab = jnp.asarray(A._RANSAC_U[:, :min_sample])
    n = jnp.maximum(cnt, 1)
    idx = jnp.minimum((u_tab * n.astype(jnp.float32)).astype(jnp.int32),
                      n - 1)                        # [I, s]
    fx = jnp.take(nx, idx.reshape(-1)).reshape(idx.shape)
    fy = jnp.take(ny, idx.reshape(-1)).reshape(idx.shape)
    fu = jnp.take(nu, idx.reshape(-1)).reshape(idx.shape)
    fv = jnp.take(nv, idx.reshape(-1)).reshape(idx.shape)

    if method == "affine":
        x1, x2, x3 = fx[:, 0], fx[:, 1], fx[:, 2]
        y1, y2, y3 = fy[:, 0], fy[:, 1], fy[:, 2]
        det = (x1 * (y2 - y3) - y1 * (x2 - x3) + (x2 * y3 - x3 * y2))
        # the host gate (affine.py:351) is |det| > 1e-9 in RAW pixels;
        # det is a 2-form so it scales by s² under the center-normalize
        # — gate in the same units or the two paths reject different
        # hypotheses near degeneracy
        h_ok = jnp.abs(det) > 1e-9 * s * s
        safe = jnp.where(h_ok, det, 1.0)

        def cramer(w1, w2, w3):
            d0 = w1 * (y2 - y3) - y1 * (w2 - w3) + (w2 * y3 - w3 * y2)
            d1 = x1 * (w2 - w3) - w1 * (x2 - x3) + (x2 * w3 - x3 * w2)
            d2 = (x1 * (y2 * w3 - y3 * w2) - y1 * (x2 * w3 - x3 * w2)
                  + w1 * (x2 * y3 - x3 * y2))
            return d0 / safe, d1 / safe, d2 / safe

        pa, pb, ptx = cramer(fu[:, 0], fu[:, 1], fu[:, 2])
        pc, pd, pty = cramer(fv[:, 0], fv[:, 1], fv[:, 2])
    else:
        rcx = fx.mean(1)
        rcy = fy.mean(1)
        tcx = fu.mean(1)
        tcy = fv.mean(1)
        drx = fx - rcx[:, None]
        dry = fy - rcy[:, None]
        dtx = fu - tcx[:, None]
        dty = fv - tcy[:, None]
        num = (drx * dty - dry * dtx).sum(1)
        den = (drx * dtx + dry * dty).sum(1)
        # host gate (affine.py:367) is 1e-12 in raw px²; num/den are
        # coordinate products, so scale the gate by s²
        h_ok = (jnp.abs(num) + jnp.abs(den)) > 1e-12 * s * s
        theta = jnp.arctan2(num, den)
        pa = jnp.cos(theta)
        pb = -jnp.sin(theta)
        pc = jnp.sin(theta)
        pd = pa
        ptx = tcx - pa * rcx - pb * rcy
        pty = tcy - pc * rcx - pd * rcy

    # inlier counts for every hypothesis at once: [I, 64]
    px = pa[:, None] * nx[None, :] + pb[:, None] * ny[None, :] + \
        ptx[:, None]
    py = pc[:, None] * nx[None, :] + pd[:, None] * ny[None, :] + \
        pty[:, None]
    err2 = (px - nu[None, :]) ** 2 + (py - nv[None, :]) ** 2
    thr2 = (A.RANSAC_INLIER_PX * s) ** 2
    inl = (err2 < thr2) & mvalid[None, :]
    counts = jnp.where(h_ok, inl.sum(1), -1)
    best = jnp.argmax(counts)
    best_inl = counts[best]
    w = inl[best].astype(jnp.float32)

    # refit on the best hypothesis's inliers
    if method == "affine":
        sw = jnp.sum(w)
        sx_ = jnp.sum(w * nx)
        sy_ = jnp.sum(w * ny)
        sxx = jnp.sum(w * nx * nx)
        sxy = jnp.sum(w * nx * ny)
        syy = jnp.sum(w * ny * ny)
        ra, rb, rtx, adet = _solve3(
            sxx, sxy, sx_, syy, sy_, sw,
            jnp.sum(w * nx * nu), jnp.sum(w * ny * nu),
            jnp.sum(w * nu))
        rc, rd, rty, _ = _solve3(
            sxx, sxy, sx_, syy, sy_, sw,
            jnp.sum(w * nx * nv), jnp.sum(w * ny * nv),
            jnp.sum(w * nv))
        fit_ok = adet > 1e-12
    else:
        sw = jnp.maximum(jnp.sum(w), 1.0)
        rcx = jnp.sum(w * nx) / sw
        rcy = jnp.sum(w * ny) / sw
        tcx = jnp.sum(w * nu) / sw
        tcy = jnp.sum(w * nv) / sw
        num = jnp.sum(w * ((nx - rcx) * (nv - tcy) -
                           (ny - rcy) * (nu - tcx)))
        den = jnp.sum(w * ((nx - rcx) * (nu - tcx) +
                           (ny - rcy) * (nv - tcy)))
        theta = jnp.arctan2(num, den)
        ra = jnp.cos(theta)
        rb = -jnp.sin(theta)
        rc = jnp.sin(theta)
        rd = ra
        rtx = tcx - ra * rcx - rb * rcy
        rty = tcy - rc * rcx - rd * rcy
        fit_ok = jnp.sum(w) >= 2.0

    ra = jnp.where(fit_ok, ra, pa[best])
    rb = jnp.where(fit_ok, rb, pb[best])
    rtx = jnp.where(fit_ok, rtx, ptx[best])
    rc = jnp.where(fit_ok, rc, pc[best])
    rd = jnp.where(fit_ok, rd, pd[best])
    rty = jnp.where(fit_ok, rty, pty[best])

    # residual of the refined transform over the best inlier set
    qx = ra * nx + rb * ny + rtx
    qy = rc * nx + rd * ny + rty
    dist = jnp.sqrt((qx - nu) ** 2 + (qy - nv) ** 2)
    resid = jnp.sum(w * dist) / jnp.maximum(best_inl.astype(
        jnp.float32), 1.0) / s

    # denormalize: A unchanged, t = c - A·c + t'/s
    tx = cx - (ra * cx + rb * cy) + rtx / s
    ty = cy - (rc * cx + rd * cy) + rty / s

    # acceptance gates (affine.rs:14-22 + ransac thresholds)
    ratio_ok = (best_inl.astype(jnp.float32) /
                jnp.maximum(cnt.astype(jnp.float32), 1.0)
                ) >= A.MIN_INLIER_RATIO
    rot = jnp.abs(jnp.arctan2(rc, ra)) <= jnp.deg2rad(A.MAX_ROTATION_DEG)
    sx_scale = jnp.sqrt(ra * ra + rc * rc)
    sy_scale = jnp.sqrt(rb * rb + rd * rd)
    ok = ((cnt >= (A.MIN_MATCHES_AFFINE if method == "affine"
                   else A.MIN_MATCHES_RIGID)) &
          (best_inl >= A.MIN_MATCHES_RIGID) & ratio_ok &
          (resid <= A.MAX_RESIDUAL_PX) &
          (jnp.abs(tx) <= cols * A.MAX_OFFSET_FRACTION) &
          (jnp.abs(ty) <= rows * A.MAX_OFFSET_FRACTION) &
          rot & (sx_scale >= A.MIN_SCALE) & (sx_scale <= A.MAX_SCALE) &
          (sy_scale >= A.MIN_SCALE) & (sy_scale <= A.MAX_SCALE))
    params = jnp.stack([ra, rb, tx, rc, rd, ty])
    return params, ok, best_inl, resid


def _votes(rr_t, rv_t, tr_t, tv_t):
    """[STAR_CAP, STAR_CAP] triangle votes from the transposed device
    triangle tables — the host chain's own matmul vote kernel."""
    return A._vote_kernel(rr_t.T, rv_t.T, tr_t.T, tv_t.T, STAR_CAP,
                          STAR_CAP)


def _detect_device(plane, tile_size: int, max_peaks: int):
    """normalize → background → detect → dedupe-top60 (traced body)."""
    pn = A._normalize_kernel(plane)[0]
    bg_med, bg_sig = SD._estimate_background_kernel(pn, tile_size)
    packed = SD._detect_kernel(pn, bg_med, bg_sig,
                               A.DETECTION_SIGMA, max_peaks)
    return _dedupe_topk(packed)


def _chain_body(rxs, rys, rn, rr_t, rv_t, tgt, tile_size: int,
                max_peaks: int, m_v: int, m_h: int, nbits_v: int,
                nbits_h: int):
    """Everything after reference-star detection: detect the target,
    triangles, vote, greedy match, RANSAC ×2, gates, shear warp."""
    rows, cols = tgt.shape
    txs, tys, tn = _detect_device(tgt, tile_size, max_peaks)
    tr_t, tv_t = _device_triangles(txs, tys)
    votes = _votes(rr_t, rv_t, tr_t, tv_t)

    ris, tis, cnt = _greedy_match(votes)
    mvalid = jnp.arange(STAR_CAP) < cnt
    mx = jnp.where(mvalid, jnp.take(rxs, ris), 0.0)
    my = jnp.where(mvalid, jnp.take(rys, ris), 0.0)
    mu = jnp.where(mvalid, jnp.take(txs, tis), 0.0)
    mv_ = jnp.where(mvalid, jnp.take(tys, tis), 0.0)

    pa_aff, ok_aff, inl_aff, res_aff = _ransac_device(
        mx, my, mu, mv_, mvalid, cnt, rows, cols, "affine")
    pa_rig, ok_rig, inl_rig, res_rig = _ransac_device(
        mx, my, mu, mv_, mvalid, cnt, rows, cols, "rigid")

    use_aff = ok_aff
    use_rig = (~ok_aff) & ok_rig
    method = jnp.where(use_aff, 2, jnp.where(use_rig, 1, 0))
    params = jnp.where(use_aff, pa_aff,
                       jnp.where(use_rig, pa_rig,
                                 jnp.asarray([1., 0., 0., 0., 1., 0.])))

    # warp envelope check for the static shear pads (see warp_shear)
    a_, b_, _, c_, _, _ = [params[i] for i in range(6)]
    q = c_ / jnp.where(jnp.abs(a_) < 1e-6, 1e-6, a_)
    span_v = jnp.abs(q) * (cols - 1)
    span_h = jnp.abs(b_) * (rows - 1)
    env_ok = ((jnp.abs(a_) >= 1e-3) & (span_v <= m_v - 4) &
              (span_h <= m_h - 4) &
              (span_v < 2.0 ** nbits_v - 1) & (span_h < 2.0 ** nbits_h - 1))
    safe_params = jnp.where(env_ok & (method > 0), params,
                            jnp.asarray([1., 0., 0., 0., 1., 0.]))
    # envelope-sized nbits: most transforms use few bits — skip the
    # empty bit passes at runtime
    warped = _warp_shear_impl(tgt, safe_params, rows, cols,
                              m_v, m_h, nbits_v, nbits_h,
                              skip_empty_bits=True)

    inliers = jnp.where(use_aff, inl_aff, jnp.where(use_rig, inl_rig, 0))
    resid = jnp.where(use_aff, res_aff, jnp.where(use_rig, res_rig, 0.0))
    info = jnp.concatenate([
        params,
        jnp.stack([method.astype(jnp.float32),
                   cnt.astype(jnp.float32),
                   inliers.astype(jnp.float32), resid,
                   env_ok.astype(jnp.float32),
                   rn.astype(jnp.float32), tn.astype(jnp.float32)])])
    return warped, info


@partial(jax.jit, static_argnames=(
    "tile_size", "max_peaks", "m_v", "m_h", "nbits_v", "nbits_h"))
def _fused_align_warp(ref: jax.Array, tgt: jax.Array, tile_size: int,
                      max_peaks: int, m_v: int, m_h: int, nbits_v: int,
                      nbits_h: int):
    rxs, rys, rn = _detect_device(ref, tile_size, max_peaks)
    rr_t, rv_t = _device_triangles(rxs, rys)
    return _chain_body(rxs, rys, rn, rr_t, rv_t, tgt, tile_size,
                       max_peaks, m_v, m_h, nbits_v, nbits_h)


@partial(jax.jit, static_argnames=(
    "tile_size", "max_peaks", "m_v", "m_h", "nbits_v", "nbits_h"))
def _fused_align_warp_cached(rxs, rys, rn, rr_t, rv_t, tgt,
                             tile_size: int, max_peaks: int, m_v: int,
                             m_h: int, nbits_v: int, nbits_h: int):
    return _chain_body(rxs, rys, rn, rr_t, rv_t, tgt, tile_size,
                       max_peaks, m_v, m_h, nbits_v, nbits_h)


@partial(jax.jit, static_argnames=(
    "tile_size", "max_peaks", "m_v", "m_h", "nbits_v", "nbits_h"))
def _fused_align_warp_many(rxs, rys, rn, rr_t, rv_t, tgts,
                           tile_size: int, max_peaks: int, m_v: int,
                           m_h: int, nbits_v: int, nbits_h: int):
    """All targets in ONE device program: the per-target chains are
    unrolled over the leading axis of ``tgts`` [T, H, W], so the host
    pays one launch and one info fetch for the whole channel set
    (compose aligns G and B to R — blend.rs:226)."""
    outs = [_chain_body(rxs, rys, rn, rr_t, rv_t, tgts[k], tile_size,
                        max_peaks, m_v, m_h, nbits_v, nbits_h)
            for k in range(tgts.shape[0])]
    return (jnp.stack([w for w, _ in outs]),
            jnp.stack([i for _, i in outs]))


@partial(jax.jit, static_argnames=("tile_size", "max_peaks"))
def _detect_ref_jit(ref, tile_size: int, max_peaks: int):
    xs, ys, n = _detect_device(ref, tile_size, max_peaks)
    rr_t, rv_t = _device_triangles(xs, ys)
    return xs, ys, n, rr_t, rv_t


class RefStars:
    """Device-resident reference-channel star set (positions +
    triangle descriptors), detected once and reused across every
    target aligned to the same reference — compose aligns G and B to
    R, so the reference detection would otherwise run per channel."""

    __slots__ = ("xs", "ys", "n", "ratios_t", "verts_t", "shape",
                 "max_peaks")

    def __init__(self, xs, ys, n, ratios_t, verts_t, shape, max_peaks):
        self.xs, self.ys, self.n = xs, ys, n
        self.ratios_t, self.verts_t = ratios_t, verts_t
        self.shape = shape
        self.max_peaks = max_peaks


def detect_ref_stars(reference, max_peaks: int = SD.MAX_PEAKS
                     ) -> RefStars:
    """Detect + describe the reference channel's stars on device for
    reuse via ``align_and_warp(..., ref_stars=...)``."""
    ref = jnp.asarray(reference, jnp.float32)
    rows, cols = ref.shape
    tile_size = min(max(min(rows, cols) // 8, 32), 256)
    xs, ys, n, rr_t, rv_t = _detect_ref_jit(ref, tile_size, max_peaks)
    return RefStars(xs, ys, n, rr_t, rv_t, ref.shape, max_peaks)


def align_and_warp(reference, target, envelope: float = 0.035,
                   max_peaks: int = SD.MAX_PEAKS,
                   ref_stars: RefStars | None = None,
                   ) -> Tuple[jax.Array, "A.AffineAlignResult"]:
    """Fused align + warp: one device program, one host fetch (the
    small info vector); the warped plane stays on device.

    ``envelope`` bounds |c/a| and |b| for the static shear pads
    (0.035 ≈ ±2° rotation). Transforms outside it — or chains that
    fail entirely — fall back to the host path / phase correlation,
    exactly like `align_channel_affine`. Pass ``ref_stars`` (from
    :func:`detect_ref_stars`) to skip re-detecting the reference.
    """
    ref = jnp.asarray(reference, jnp.float32)
    tgt = jnp.asarray(target, jnp.float32)
    rows, cols = ref.shape
    if rows < 16 or cols < 16 or ref.shape != tgt.shape:
        res = A.align_channel_affine(reference, target)
        return A.warp_image(tgt, res.transform, rows, cols), res

    tile_size = min(max(min(rows, cols) // 8, 32), 256)
    span_v = envelope * max(cols - 1, 1)
    span_h = envelope * max(rows - 1, 1)
    m_v = _bucket(int(span_v) + 4)
    m_h = _bucket(int(span_h) + 4)
    nbits_v = max(int(span_v) + 1, 1).bit_length()
    nbits_h = max(int(span_h) + 1, 1).bit_length()

    if ref_stars is not None:
        if (ref_stars.shape != ref.shape
                or ref_stars.max_peaks != max_peaks):
            raise ValueError("ref_stars were detected for shape "
                             f"{ref_stars.shape}/max_peaks="
                             f"{ref_stars.max_peaks}; got {ref.shape}/"
                             f"{max_peaks}")
        warped, info = _fused_align_warp_cached(
            ref_stars.xs, ref_stars.ys, ref_stars.n, ref_stars.ratios_t,
            ref_stars.verts_t, tgt, tile_size, max_peaks, m_v, m_h,
            nbits_v, nbits_h)
    else:
        warped, info = _fused_align_warp(ref, tgt, tile_size, max_peaks,
                                         m_v, m_h, nbits_v, nbits_h)
    info = np.asarray(info)   # the ONE host fetch
    return _interpret_info(info, ref, tgt, rows, cols, warped)


def _interpret_info(info, ref, tgt, rows, cols, warped):
    """Host-side interpretation of one chain info vector: build the
    result dataclass, route chain failures to the phase-correlation
    fallback (affine.rs:258-270 semantics), and re-warp on the host
    path when the transform fell outside the static shear envelope."""
    params = info[:6]
    method = int(info[6])
    cnt = int(info[7])
    inliers = int(info[8])
    resid = float(info[9])
    env_ok = info[10] > 0.5

    if method == 0:
        # star chain failed: host fallback (rare path)
        res = A._fallback_phase_correlation(ref, tgt, rows, cols)
        return A.warp_image(tgt, res.transform, rows, cols), res

    t = A.AffineTransform(a=float(params[0]), b=float(params[1]),
                          tx=float(params[2]), c=float(params[3]),
                          d=float(params[4]), ty=float(params[5]))
    res = A.AffineAlignResult(t, cnt, inliers, resid,
                              "affine" if method == 2 else "rigid")
    if not env_ok:
        return A.warp_image(tgt, t, rows, cols), res
    return warped, res


def align_and_warp_many(reference, targets, envelope: float = 0.035,
                        max_peaks: int = SD.MAX_PEAKS,
                        ref_stars: RefStars | None = None,
                        ) -> list:
    """Align EVERY target to ``reference`` in one device program with
    one host info fetch (see :func:`_fused_align_warp_many`); returns
    a list of ``(warped, AffineAlignResult)`` pairs in target order.
    Falls back to per-target :func:`align_and_warp` for shapes the
    fused chain does not handle."""
    ref = jnp.asarray(reference, jnp.float32)
    tgts = [jnp.asarray(t, jnp.float32) for t in targets]
    rows, cols = ref.shape
    if (not tgts or rows < 16 or cols < 16
            or any(t.shape != ref.shape for t in tgts)):
        return [align_and_warp(ref, t, envelope, max_peaks,
                               ref_stars=ref_stars) for t in tgts]

    tile_size = min(max(min(rows, cols) // 8, 32), 256)
    span_v = envelope * max(cols - 1, 1)
    span_h = envelope * max(rows - 1, 1)
    m_v = _bucket(int(span_v) + 4)
    m_h = _bucket(int(span_h) + 4)
    nbits_v = max(int(span_v) + 1, 1).bit_length()
    nbits_h = max(int(span_h) + 1, 1).bit_length()

    if ref_stars is None:
        ref_stars = detect_ref_stars(ref, max_peaks)
    elif ref_stars.shape != ref.shape or ref_stars.max_peaks != max_peaks:
        raise ValueError("ref_stars were detected for shape "
                         f"{ref_stars.shape}/max_peaks="
                         f"{ref_stars.max_peaks}; got {ref.shape}/"
                         f"{max_peaks}")

    warped_all, infos = _fused_align_warp_many(
        ref_stars.xs, ref_stars.ys, ref_stars.n, ref_stars.ratios_t,
        ref_stars.verts_t, jnp.stack(tgts), tile_size, max_peaks,
        m_v, m_h, nbits_v, nbits_h)
    infos = np.asarray(infos)   # the ONE host fetch for all targets
    return [_interpret_info(infos[k], ref, tgts[k], rows, cols,
                            warped_all[k])
            for k in range(len(tgts))]
