"""Star-based affine channel alignment.

Reference: src-tauri/src/core/alignment/affine.rs — percentile
normalization, star detection at σ3.5 (top 120), triangle side-ratio
descriptors over the top 60 stars (min side 15 px), vote-based triangle
matching (tol 0.02), 2000-iteration RANSAC with 6-DOF affine (3×3
normal equations) or 4-DOF rigid (centroid + atan2) fits, sanity gates
(offset < 40% dim, rotation < 30°, scale ∈ [0.7, 1.4], residual < 5 px,
inliers ≥ 20%), and the fallback chain affine → rigid →
phase-correlation → identity.

Design:
- triangle voting is matrix products: the pairwise ratio-tolerance
  match matrix (chunked) is contracted against per-vertex one-hot
  matrices,
  accumulating the [60, 60] star-vote table in three matmuls per chunk
  — no hash maps, no data-dependent loops.
- RANSAC is vectorized host numpy over all 2000 hypotheses at once
  (≤120 matches is not pixel data; deterministic seed).
- the warp is a device kernel (bicubic at affine-mapped coordinates).
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.alignment.phase_correlation import phase_correlate
from astroburst_tpu.analysis.star_detection import (detect_stars,
                                                    detect_stars_pair)
from astroburst_tpu.ops.resample import catmull_rom

_LOG = logging.getLogger("astroburst_tpu.alignment")

MAX_STARS = 120
TRIANGLE_TOLERANCE = 0.02
MIN_MATCHES_AFFINE = 6
MIN_MATCHES_RIGID = 4
RANSAC_ITERATIONS = 2000
RANSAC_INLIER_PX = 3.0
DETECTION_SIGMA = 3.5
MIN_TRIANGLE_SIDE = 15.0
MIN_VOTES = 1
MIN_INLIER_RATIO = 0.20
MAX_RESIDUAL_PX = 5.0
MAX_OFFSET_FRACTION = 0.40
MAX_ROTATION_DEG = 30.0
MIN_SCALE = 0.70
MAX_SCALE = 1.40
TRIANGLE_STAR_LIMIT = 60


@dataclass(frozen=True)
class AffineTransform:
    a: float = 1.0
    b: float = 0.0
    tx: float = 0.0
    c: float = 0.0
    d: float = 1.0
    ty: float = 0.0

    @staticmethod
    def identity() -> "AffineTransform":
        return AffineTransform()

    @staticmethod
    def translation(tx: float, ty: float) -> "AffineTransform":
        return AffineTransform(tx=tx, ty=ty)

    def map(self, x: float, y: float) -> Tuple[float, float]:
        return (self.a * x + self.b * y + self.tx,
                self.c * x + self.d * y + self.ty)

    def rotation_deg(self) -> float:
        return math.degrees(math.atan2(self.c, self.a))

    def scale_x(self) -> float:
        return math.hypot(self.a, self.c)

    def scale_y(self) -> float:
        return math.hypot(self.b, self.d)

    def as_tuple(self):
        return (self.a, self.b, self.tx, self.c, self.d, self.ty)


@dataclass
class AffineAlignResult:
    transform: AffineTransform
    matched_stars: int
    inliers: int
    residual_px: float
    method: str  # "affine" | "rigid" | "phase_correlation" | "identity"


# --- normalization (affine.rs:24-54) -----------------------------------------


@jax.jit
def _normalize_kernel(image: jax.Array):
    # sample ~100k values as whole ROWS via an index-vector take
    rows, cols = image.shape
    n_rows = max(min(-(-100_000 // cols), rows), 1)
    ridx = jnp.minimum(
        (jnp.arange(n_rows) * (rows / n_rows)).astype(jnp.int32),
        rows - 1)
    samples = jnp.take(image, ridx, axis=0).reshape(-1)
    finite = jnp.isfinite(samples)
    cnt = jnp.sum(finite.astype(jnp.int32))
    svals = jnp.sort(jnp.where(finite, samples, jnp.inf))
    m = samples.shape[0]
    lo = svals[jnp.clip(cnt // 100, 0, m - 1)]
    hi = svals[jnp.clip(cnt * 999 // 1000, 0, m - 1)]
    rng = hi - lo
    ok = (cnt >= 100) & (rng >= 1e-15)
    norm = jnp.clip((image - lo) / jnp.where(ok, rng, 1.0), 0.0, 1.0)
    return jnp.where(ok, norm, image), ok


def normalize_for_detection(image: jax.Array) -> jax.Array:
    """1st–99.9th percentile clamp-normalize on sampled values."""
    out, _ = _normalize_kernel(image)
    return out


# --- triangles (affine.rs:279-318, host numpy, vectorized) -------------------


def build_triangles(stars: np.ndarray):
    """stars [S, 2] (x, y) → (vertex triples sorted by opposite side
    [T, 3], ratio descriptors [T, 2]); sides < 15 px filtered."""
    n = min(len(stars), TRIANGLE_STAR_LIMIT)
    if n < 3:
        return (np.zeros((0, 3), np.int32), np.zeros((0, 2), np.float32))
    pts = np.asarray(stars[:n], dtype=np.float64)
    # all C(n,3) index triples, vectorized
    ar = np.arange(n, dtype=np.int32)
    i, j, k = np.meshgrid(ar, ar, ar, indexing="ij")
    mask = (i < j) & (j < k)
    i, j, k = i[mask], j[mask], k[mask]
    # side lengths via ONE [n, n] pairwise table + three gathers
    diff = pts[:, None, :] - pts[None, :, :]
    dist = np.sqrt((diff * diff).sum(axis=2))
    d_ij = dist[i, j]
    d_jk = dist[j, k]
    d_ik = dist[i, k]
    sides = np.sort(np.stack([d_ij, d_jk, d_ik], axis=1), axis=1)
    keep = sides[:, 0] >= MIN_TRIANGLE_SIDE
    i, j, k = i[keep], j[keep], k[keep]
    sides = sides[keep]
    ratios = np.stack([sides[:, 1] / sides[:, 0],
                       sides[:, 2] / sides[:, 0]], axis=1).astype(np.float32)
    # vertices ordered by their opposite side length (affine.rs:386-398)
    opp = np.stack([d_jk[keep], d_ik[keep], d_ij[keep]], axis=1)
    order = np.argsort(opp, axis=1, kind="stable")
    verts = np.take_along_axis(np.stack([i, j, k], axis=1), order, axis=1)
    return verts.astype(np.int32), ratios


# --- matmul triangle voting ------------------------------------------------------

_VOTE_CHUNK = 256


@partial(jax.jit, static_argnames=("n_ref_stars", "n_tgt_stars"))
def _vote_kernel(ref_ratios, ref_verts, tgt_ratios, tgt_verts,
                 n_ref_stars: int, n_tgt_stars: int):
    """votes[a, b] = Σ over tolerance-matched triangle pairs of
    vertex-position agreement — three matmuls per ref chunk."""
    r = ref_ratios.shape[0]
    rows = r // _VOTE_CHUNK
    rr = ref_ratios.reshape(rows, _VOTE_CHUNK, 2)
    rv = ref_verts.reshape(rows, _VOTE_CHUNK, 3)
    tgt_oh = [(tgt_verts[:, p][:, None] ==
               jnp.arange(n_tgt_stars)[None, :]).astype(jnp.bfloat16)
              for p in range(3)]

    def body(acc, args):
        ratios, verts = args
        # bf16 mask: 0/1 are exact, traffic halves, and the product
        # still accumulates in f32
        m = ((jnp.abs(ratios[:, None, 0] - tgt_ratios[None, :, 0])
              <= TRIANGLE_TOLERANCE) &
             (jnp.abs(ratios[:, None, 1] - tgt_ratios[None, :, 1])
              <= TRIANGLE_TOLERANCE)).astype(jnp.bfloat16)
        # accumulate a_ohᵀ·m per vertex position; the contraction with
        # tgt_oh happens ONCE after the scan (inside the scan it was
        # ~40% of the vote FLOPs). Counts stay ≤ _VOTE_CHUNK = 256 per
        # step — exact in bf16 — and the f32 carry accumulates them.
        outs = []
        for p in range(3):
            a_oh = (verts[:, p][:, None] ==
                    jnp.arange(n_ref_stars)[None, :]).astype(jnp.bfloat16)
            outs.append(jnp.matmul(a_oh.T, m,
                                   preferred_element_type=jnp.float32))
        return (acc[0] + outs[0], acc[1] + outs[1], acc[2] + outs[2]), None

    t = tgt_ratios.shape[0]
    init = tuple(jnp.zeros((n_ref_stars, t), jnp.float32)
                 for _ in range(3))
    ams, _ = jax.lax.scan(body, init, (rr, rv))
    votes = jnp.zeros((n_ref_stars, n_tgt_stars), jnp.float32)
    for p in range(3):
        # per-(star, tgt-tri) counts are bounded by the REF triangle
        # count — beyond bf16's exact-integer range. Split hi·256+lo:
        # hi ≤ ⌈T/256⌉ and lo < 256 are both bf16-exact, each product
        # accumulates exactly in the f32 accumulator, so the
        # recombined votes are exact integers at DEFAULT precision.
        hi = jnp.floor(ams[p] / 256.0).astype(jnp.bfloat16)
        lo = (ams[p] - jnp.floor(ams[p] / 256.0) * 256.0
              ).astype(jnp.bfloat16)
        votes = (votes + 256.0 * jnp.matmul(
            hi, tgt_oh[p], preferred_element_type=jnp.float32)
            + jnp.matmul(lo, tgt_oh[p],
                         preferred_element_type=jnp.float32))
    return votes


# static vote-kernel shapes: triangles from ≤ TRIANGLE_STAR_LIMIT = 60
# stars are ≤ C(60,3) = 34220, padded to the next _VOTE_CHUNK multiple;
# vertex indices are < 60, padded one-hots to 64. Variable shapes would
# recompile the kernel for every new image pair.
_TRI_CAP = -(-34220 // _VOTE_CHUNK) * _VOTE_CHUNK
_STAR_CAP = 64


def _pad_tris(verts: np.ndarray, ratios: np.ndarray):
    pad = _TRI_CAP - len(verts)
    # +inf ratio rows can never be within tolerance of anything
    # (inf−x = inf, inf−inf = nan; both fail the ≤ test) → zero votes
    return (np.concatenate([verts, np.zeros((pad, 3), np.int32)]),
            np.concatenate([ratios,
                            np.full((pad, 2), np.inf, np.float32)]))


def match_triangles(ref_stars: np.ndarray, tgt_stars: np.ndarray,
                    ref_tris, tgt_tris) -> List[Tuple[float, float, float, float]]:
    """Vote accumulation on device, greedy one-to-one pairing on host
    (affine.rs:320-384)."""
    ref_verts, ref_ratios = ref_tris
    tgt_verts, tgt_ratios = tgt_tris
    if len(ref_verts) == 0 or len(tgt_verts) == 0:
        return []
    ref_verts, ref_ratios = _pad_tris(ref_verts, ref_ratios)
    tgt_verts, tgt_ratios = _pad_tris(tgt_verts, tgt_ratios)
    votes = np.asarray(_vote_kernel(
        jnp.asarray(ref_ratios), jnp.asarray(ref_verts),
        jnp.asarray(tgt_ratios), jnp.asarray(tgt_verts),
        _STAR_CAP, _STAR_CAP))
    votes = np.round(votes).astype(np.int64)

    flat = votes.reshape(-1)
    order = np.argsort(-flat, kind="stable")
    used_ref = np.zeros(_STAR_CAP, bool)
    used_tgt = np.zeros(_STAR_CAP, bool)
    matches = []
    for idx in order:
        v = flat[idx]
        if v < max(MIN_VOTES, 1):  # padded rows/cols carry zero votes
            break
        ri, ti = divmod(int(idx), _STAR_CAP)
        if used_ref[ri] or used_tgt[ti]:
            continue
        used_ref[ri] = True
        used_tgt[ti] = True
        matches.append((float(ref_stars[ri][0]), float(ref_stars[ri][1]),
                        float(tgt_stars[ti][0]), float(tgt_stars[ti][1])))
    return matches


# --- fits (affine.rs:519-642, host f64) ---------------------------------------


def fit_affine(matches: np.ndarray) -> Optional[AffineTransform]:
    if len(matches) < 3:
        return None
    rx, ry, tx, ty = matches.T
    a = np.stack([rx, ry, np.ones_like(rx)], axis=1)
    ata = a.T @ a
    if abs(np.linalg.det(ata)) < 1e-12:
        return None
    sol_x = np.linalg.solve(ata, a.T @ tx)
    sol_y = np.linalg.solve(ata, a.T @ ty)
    return AffineTransform(a=sol_x[0], b=sol_x[1], tx=sol_x[2],
                           c=sol_y[0], d=sol_y[1], ty=sol_y[2])


def fit_rigid(matches: np.ndarray) -> Optional[AffineTransform]:
    if len(matches) < 2:
        return None
    rx, ry, tx, ty = matches.T
    rcx, rcy, tcx, tcy = rx.mean(), ry.mean(), tx.mean(), ty.mean()
    drx, dry = rx - rcx, ry - rcy
    dtx, dty = tx - tcx, ty - tcy
    num = float((drx * dty - dry * dtx).sum())
    den = float((drx * dtx + dry * dty).sum())
    theta = math.atan2(num, den)
    ct, st = math.cos(theta), math.sin(theta)
    return AffineTransform(a=ct, b=-st, tx=tcx - ct * rcx + st * rcy,
                           c=st, d=ct, ty=tcy - st * rcx - ct * rcy)


def _residual(matches: np.ndarray, t: AffineTransform) -> float:
    if len(matches) == 0:
        return 0.0
    rx, ry, tx, ty = matches.T
    px = t.a * rx + t.b * ry + t.tx
    py = t.c * rx + t.d * ry + t.ty
    return float(np.sqrt((px - tx) ** 2 + (py - ty) ** 2).mean())


# one fixed uniform table drives hypothesis sampling for BOTH the host
# path and the fused device chain (fused_chain.py): idx = floor(u·n)
# gives identical samples for the same match count on either path,
# where a count-parameterized integer draw could not be reproduced
# under tracing. Deterministic like the reference's seeded sampling
# (affine.rs:400-517).
_RANSAC_U = np.random.default_rng(0xDEADBEEF).random(
    (RANSAC_ITERATIONS, 3)).astype(np.float32)


def ransac_affine(matches: List[Tuple[float, float, float, float]],
                  method: str) -> Optional[AffineAlignResult]:
    """All 2000 hypotheses vectorized; deterministic (affine.rs:400-517)."""
    m = np.asarray(matches, dtype=np.float64)
    n = len(m)
    min_sample = 3 if method == "affine" else 2
    if n < min_sample:
        return None
    idx = np.minimum((_RANSAC_U[:, :min_sample] * n).astype(np.int64), n - 1)
    # degenerate samples (repeated points) yield singular fits → dropped
    rx, ry = m[idx, 0], m[idx, 1]          # [I, s]
    tx, ty = m[idx, 2], m[idx, 3]

    if method == "affine":
        ones = np.ones_like(rx)
        a_mats = np.stack([rx, ry, ones], axis=2)          # [I, 3, 3]
        dets = np.linalg.det(a_mats)
        ok = np.abs(dets) > 1e-9
        a_ok = a_mats[ok]
        sol_x = np.linalg.solve(a_ok, tx[ok][..., None])[..., 0]
        sol_y = np.linalg.solve(a_ok, ty[ok][..., None])[..., 0]
        params = np.zeros((ok.sum(), 6))
        params[:, 0:2] = sol_x[:, 0:2]
        params[:, 2] = sol_x[:, 2]
        params[:, 3:5] = sol_y[:, 0:2]
        params[:, 5] = sol_y[:, 2]
    else:
        rcx, rcy = rx.mean(1), ry.mean(1)
        tcx, tcy = tx.mean(1), ty.mean(1)
        drx, dry = rx - rcx[:, None], ry - rcy[:, None]
        dtx, dty = tx - tcx[:, None], ty - tcy[:, None]
        num = (drx * dty - dry * dtx).sum(1)
        den = (drx * dtx + dry * dty).sum(1)
        ok = (np.abs(num) + np.abs(den)) > 1e-12
        theta = np.arctan2(num[ok], den[ok])
        ct, st = np.cos(theta), np.sin(theta)
        params = np.stack([
            ct, -st, tcx[ok] - ct * rcx[ok] + st * rcy[ok],
            st, ct, tcy[ok] - st * rcx[ok] - ct * rcy[ok]], axis=1)

    if len(params) == 0:
        return None
    # inlier counting for every hypothesis at once: [Iok, n]
    px = (params[:, 0:1] * m[None, :, 0] + params[:, 1:2] * m[None, :, 1]
          + params[:, 2:3])
    py = (params[:, 3:4] * m[None, :, 0] + params[:, 4:5] * m[None, :, 1]
          + params[:, 5:6])
    err2 = (px - m[None, :, 2]) ** 2 + (py - m[None, :, 3]) ** 2
    inlier_masks = err2 < RANSAC_INLIER_PX ** 2
    counts = inlier_masks.sum(1)
    best = int(np.argmax(counts))
    best_inliers = int(counts[best])
    if best_inliers < MIN_MATCHES_RIGID:
        return None
    if best_inliers / n < MIN_INLIER_RATIO:
        return None
    inl = m[inlier_masks[best]]
    refined = (fit_affine(inl) if method == "affine" else fit_rigid(inl))
    if refined is None:
        p = params[best]
        refined = AffineTransform(a=p[0], b=p[1], tx=p[2], c=p[3], d=p[4],
                                  ty=p[5])
    res = _residual(inl, refined)
    if res > MAX_RESIDUAL_PX:
        return None
    return AffineAlignResult(refined, n, best_inliers, res, method)


# --- sanity + fallback chain (affine.rs:14-22, 183-270) ------------------------


def check_transform_sanity(result: AffineAlignResult, rows: int,
                           cols: int) -> Optional[str]:
    t = result.transform
    if abs(t.tx) > cols * MAX_OFFSET_FRACTION or \
            abs(t.ty) > rows * MAX_OFFSET_FRACTION:
        return "translation exceeds limit"
    if abs(t.rotation_deg()) > MAX_ROTATION_DEG:
        return "rotation exceeds limit"
    sx, sy = t.scale_x(), t.scale_y()
    if not (MIN_SCALE <= sx <= MAX_SCALE and MIN_SCALE <= sy <= MAX_SCALE):
        return "scale outside range"
    return None


def _fallback_phase_correlation(reference, target, rows, cols
                                ) -> AffineAlignResult:
    pc = phase_correlate(reference, target)
    if (abs(pc.dx) > cols * MAX_OFFSET_FRACTION or
            abs(pc.dy) > rows * MAX_OFFSET_FRACTION or pc.confidence < 1.5):
        return AffineAlignResult(AffineTransform.identity(), 0, 0, 0.0,
                                 "identity")
    return AffineAlignResult(AffineTransform.translation(pc.dx, pc.dy),
                             0, 0, 0.0, "phase_correlation")


def align_channel_affine(reference, target) -> AffineAlignResult:
    """Full chain: detect → triangles → vote → RANSAC affine → rigid →
    phase correlation → identity (affine.rs:129-270). Fallback
    decisions are logged like the reference (affine.rs:141-207)."""
    ref = jnp.asarray(reference)
    tgt = jnp.asarray(target)
    rows, cols = ref.shape

    ref_det, tgt_det = detect_stars_pair(normalize_for_detection(ref),
                                         normalize_for_detection(tgt),
                                         DETECTION_SIGMA)
    ref_stars = np.array([(s.x, s.y) for s in ref_det.stars[:MAX_STARS]])
    tgt_stars = np.array([(s.x, s.y) for s in tgt_det.stars[:MAX_STARS]])

    if len(ref_stars) < MIN_MATCHES_RIGID or len(tgt_stars) < MIN_MATCHES_RIGID:
        _LOG.warning("affine: too few stars (ref=%d tgt=%d), falling back "
                     "to phase correlation", len(ref_stars), len(tgt_stars))
        return _fallback_phase_correlation(reference, target, rows, cols)

    ref_tris = build_triangles(ref_stars)
    tgt_tris = build_triangles(tgt_stars)
    if len(ref_tris[0]) == 0 or len(tgt_tris[0]) == 0:
        _LOG.warning("affine: no usable triangles, falling back to phase "
                     "correlation")
        return _fallback_phase_correlation(reference, target, rows, cols)

    matches = match_triangles(ref_stars, tgt_stars, ref_tris, tgt_tris)
    if len(matches) < MIN_MATCHES_RIGID:
        _LOG.warning("affine: %d star matches (< %d), falling back to "
                     "phase correlation", len(matches), MIN_MATCHES_RIGID)
        return _fallback_phase_correlation(reference, target, rows, cols)

    if len(matches) >= MIN_MATCHES_AFFINE:
        result = ransac_affine(matches, "affine")
        if result is not None:
            reason = check_transform_sanity(result, rows, cols)
            if reason is None:
                return result
            _LOG.warning("affine: transform rejected (%s), trying rigid",
                         reason)

    result = ransac_affine(matches, "rigid")
    if result is not None:
        reason = check_transform_sanity(result, rows, cols)
        if reason is None:
            return result
        _LOG.warning("affine: rigid transform rejected (%s)", reason)

    _LOG.warning("affine: star-based alignment failed, falling back to "
                 "phase correlation")
    return _fallback_phase_correlation(reference, target, rows, cols)


# --- warp (affine.rs:663-690) --------------------------------------------------


@partial(jax.jit, static_argnames=("out_rows", "out_cols"))
def _warp_kernel(image: jax.Array, params: jax.Array, out_rows: int,
                 out_cols: int):
    src_rows, src_cols = image.shape
    a, b, tx, c, d, ty = [params[i] for i in range(6)]
    y = jnp.arange(out_rows, dtype=jnp.float32)[:, None]
    x = jnp.arange(out_cols, dtype=jnp.float32)[None, :]
    sx = a * x + b * y + tx
    sy = c * x + d * y + ty
    ix = jnp.floor(sx)
    iy = jnp.floor(sy)
    fx = sx - ix
    fy = sy - iy
    ix = ix.astype(jnp.int32)
    iy = iy.astype(jnp.int32)
    flat = image.reshape(-1)
    out = jnp.zeros((out_rows, out_cols), jnp.float32)
    for j in range(4):
        wy = catmull_rom(fy - (j - 1))
        r = jnp.clip(iy + (j - 1), 0, src_rows - 1)
        row_val = jnp.zeros((out_rows, out_cols), jnp.float32)
        for i in range(4):
            wx = catmull_rom(fx - (i - 1))
            cc = jnp.clip(ix + (i - 1), 0, src_cols - 1)
            row_val = row_val + wx * flat[(r * src_cols + cc).reshape(-1)
                                          ].reshape(out_rows, out_cols)
        out = out + wy * row_val
    inside = (sx >= 0.0) & (sy >= 0.0) & (sx < src_cols - 1) & (sy < src_rows - 1)
    return jnp.where(inside, out, 0.0)


def _take_rows_4tap(img, row_idx_f):
    """Vertical Catmull-Rom resample: out[y,x] = CR(img[:, x], row_idx_f[y,x]).

    take_along_axis with whole-column index maps."""
    h = img.shape[0]
    base = jnp.floor(row_idx_f)
    frac = row_idx_f - base
    basei = base.astype(jnp.int32)
    out = None
    for j in range(4):
        w = catmull_rom(frac - (j - 1))
        idx = jnp.clip(basei + (j - 1), 0, h - 1)
        term = w * jnp.take_along_axis(img, idx, axis=0)
        out = term if out is None else out + term
    return out


def _take_cols_4tap(img, col_idx_f):
    w_ = img.shape[1]
    base = jnp.floor(col_idx_f)
    frac = col_idx_f - base
    basei = base.astype(jnp.int32)
    out = None
    for j in range(4):
        w = catmull_rom(frac - (j - 1))
        idx = jnp.clip(basei + (j - 1), 0, w_ - 1)
        term = w * jnp.take_along_axis(img, idx, axis=1)
        out = term if out is None else out + term
    return out


@partial(jax.jit, static_argnames=("out_rows", "out_cols"))
def _warp_two_pass_kernel(image: jax.Array, params: jax.Array,
                          out_rows: int, out_cols: int):
    """Catmull two-pass affine warp: a vertical then a horizontal 1D
    Catmull-Rom resample (exact for the affine coordinate map; the
    separable interpolation differs from the direct 2D sampler only by
    interpolation-order commutation). Requires |a| not tiny — the
    sanity gates guarantee scale ∈ [0.7, 1.4]."""
    src_rows, src_cols = image.shape
    a, b, tx, c, d, ty = [params[i] for i in range(6)]
    y = jnp.arange(out_rows, dtype=jnp.float32)[:, None]
    x = jnp.arange(out_cols, dtype=jnp.float32)[None, :]
    # pass 1: tmp[y, u] = img[p·y + q·u + r, u]
    q = c / a
    p = d - q * b
    r = ty - q * tx
    u = jnp.arange(src_cols, dtype=jnp.float32)[None, :]
    row_idx = p * jnp.broadcast_to(y, (out_rows, src_cols)) + q * u + r
    tmp = _take_rows_4tap(image, row_idx)
    # pass 2: out[y, x] = tmp[y, a·x + b·y + tx]
    sx = a * x + b * y + tx
    sy = c * x + d * y + ty
    out = _take_cols_4tap(tmp, jnp.broadcast_to(sx, (out_rows, out_cols)))
    inside = (sx >= 0.0) & (sy >= 0.0) & (sx < src_cols - 1) & \
        (sy < src_rows - 1)
    return jnp.where(inside, out, 0.0)


def warp_image(image, transform: AffineTransform, out_rows: int,
               out_cols: int, exact: bool = False) -> jax.Array:
    """Bicubic warp: out[y,x] = img(T·(x,y)); outside → 0.

    Default is the shear-decomposed form (rolls + index-vector takes —
    no 2D gathers; see alignment/warp_shear.py); exact=True uses the
    direct 2D sampler matching the reference bit-for-bit (slow
    elementwise gathers). Pure translations route to the separable
    shift (exact and fastest)."""
    img = jnp.asarray(image)
    t = transform
    if (abs(t.a - 1.0) < 1e-12 and abs(t.d - 1.0) < 1e-12 and
            abs(t.b) < 1e-12 and abs(t.c) < 1e-12 and
            img.shape == (out_rows, out_cols)):
        from astroburst_tpu.ops.resample import shift_bicubic
        return shift_bicubic(img, t.ty, t.tx)
    params = jnp.asarray(t.as_tuple(), dtype=jnp.float32)
    if exact or abs(t.a) < 1e-3:
        return _warp_kernel(img, params, out_rows, out_cols)
    from astroburst_tpu.alignment.warp_shear import (ShearEnvelopeError,
                                                     warp_shear)
    try:
        return warp_shear(img, t, out_rows, out_cols)
    except ShearEnvelopeError:
        return _warp_two_pass_kernel(img, params, out_rows, out_cols)
