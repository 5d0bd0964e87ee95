"""Star detection.

Reference: src-tauri/src/core/analysis/star_detection.rs — tile-based
sigma-clipped background, threshold at bg + σ·k, 8-connected flood-fill
components of 3..5000 px, flux-weighted centroid, second-moment
FWHM = 2.3548·σ, eigenvalue eccentricity, SNR = peak/bg_σ,
brightest-first 3 px dedup.

Design (flood fill is inherently sequential):
1. background: tiles → per-tile sort → sigma clip as a *contiguous
   sorted interval* (the clip window [med−kσ, med+kσ] is contiguous in
   sorted order), median/MAD by rank arithmetic + binary-searched
   deviation radius — all vmapped over tiles.
2. peaks: 3×3 local maxima above threshold (shifted-max stencil),
   top-K by peak value.
3. per-peak fixed windows (vmapped dynamic_slice) → in-window
   connectivity by iterative masked 3×3 dilation from the center
   (bounded flood fill) → masked moments: same outputs as the
   reference's component statistics.
4. host-side brightest-first 3 px grid dedup over ≤K candidates.

The output record and every filter (npix ∈ [3,5000], FWHM ∈ [0.5,30],
flux > 0) match star_detection.rs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.constants import MAD_TO_SIGMA, PADDING_THRESHOLD

FWHM_FACTOR = 2.3548200450309493
MAX_PEAKS = 1024
WINDOW = 41  # covers FWHM ≤ 30 components (σ ≤ 12.7)


@dataclass
class DetectedStar:
    x: float
    y: float
    flux: float
    fwhm: float
    eccentricity: float
    peak: float
    npix: int
    snr: float

    def to_dict(self) -> dict:
        return {"x": self.x, "y": self.y, "flux": self.flux,
                "fwhm": self.fwhm, "eccentricity": self.eccentricity,
                "peak": self.peak, "npix": self.npix, "snr": self.snr}


@dataclass
class DetectionResult:
    stars: List[DetectedStar]
    background_median: float
    background_sigma: float
    threshold_sigma: float
    image_width: int
    image_height: int


# --- tile background ---------------------------------------------------------


def _interval_median(sorted_rows, lo, hi):
    """Median of sorted_rows[t, lo[t]:hi[t]] with even-count averaging
    (math/median.rs:27-43)."""
    cnt = hi - lo
    i1 = lo + jnp.maximum((cnt - 1) // 2, 0)
    i2 = lo + jnp.maximum(cnt // 2, 0)
    v1 = jnp.take_along_axis(sorted_rows, i1[:, None], axis=1)[:, 0]
    v2 = jnp.take_along_axis(sorted_rows, i2[:, None], axis=1)[:, 0]
    return jnp.where(cnt > 0, (v1 + v2) * 0.5, 0.0)


def _sel_deviation_ranks(sorted_rows, med, lo, split, hi, ks):
    """Exact 0-based rank-k elements of the deviation multiset
    {|sorted_rows[t, i] − med[t]| : lo ≤ i < hi}, for a [T, R] stack of
    ranks searched simultaneously (one take_along_axis serves every
    rank per probe).

    The deviations form TWO ascending runs — A[i] = med − row[split−1−i]
    (values below med, walking down) and B[j] = row[split+j] − med — so
    the k-th smallest comes from the textbook two-sorted-arrays
    partition search: 18 rounds of four per-tile gathers, no
    full-width tensor ops at all."""
    p = sorted_rows.shape[1]
    la = (split - lo)[:, None]
    lb = (hi - split)[:, None]
    med = med[:, None]
    split = split[:, None]
    m = ks + 1

    def row_at(idx):
        return jnp.take_along_axis(sorted_rows, jnp.clip(idx, 0, p - 1),
                                   axis=1)

    def get_a(i):
        v = med - row_at(split - 1 - i)
        return jnp.where(i < 0, -jnp.inf, jnp.where(i >= la, jnp.inf, v))

    def get_b(j):
        v = row_at(split + j) - med
        return jnp.where(j < 0, -jnp.inf, jnp.where(j >= lb, jnp.inf, v))

    a_lo = jnp.maximum(m - lb, 0)
    a_hi = jnp.minimum(m, la)

    def body(_, carry):
        a_lo, a_hi = carry
        a = (a_lo + a_hi) // 2
        too_many = get_a(a - 1) > get_b(m - a)
        too_few = (~too_many) & (get_b(m - a - 1) > get_a(a))
        new_lo = jnp.where(too_few, a + 1, jnp.where(too_many, a_lo, a))
        new_hi = jnp.where(too_many, a - 1, jnp.where(too_few, a_hi, a))
        return new_lo, new_hi

    a_lo, a_hi = jax.lax.fori_loop(0, 18, body, (a_lo, a_hi))
    a = a_lo
    return jnp.maximum(get_a(a - 1), get_b(m - a - 1))


def _interval_mad(sorted_rows, lo, hi, med):
    """EXACT median absolute deviation of sorted_rows[t, lo:hi] with
    even-count averaging — one batched two-run rank selection
    (:func:`_sel_deviation_ranks` over both middle ranks) plus one
    compare-count pass for the split position (a binary search on the
    deviation radius would be approximate to range·2⁻ⁿ)."""
    cnt = hi - lo
    p = sorted_rows.shape[1]
    iota = jnp.arange(p)[None, :]
    window = (iota >= lo[:, None]) & (iota < hi[:, None])
    below = jnp.sum((window & (sorted_rows < med[:, None]))
                    .astype(jnp.int32), axis=1)
    split = lo + below
    n = jnp.maximum(cnt, 1)
    ks = jnp.stack([(n - 1) // 2, n // 2], axis=1)
    vv = _sel_deviation_ranks(sorted_rows, med, lo, split, hi, ks)
    return jnp.where(cnt > 0, (vv[:, 0] + vv[:, 1]) * 0.5, 0.0)


def _tile_sigma_clipped(sorted_rows, valid_counts,
                        kappa: float = 3.0, iterations: int = 2):
    """Vectorized sigma_clipped_stats (math/sigma_clip.rs:4-34) over
    pre-sorted tile rows; the retained set stays a contiguous interval."""
    t = sorted_rows.shape[0]
    lo = jnp.zeros(t, jnp.int32)
    hi = valid_counts.astype(jnp.int32)
    for _ in range(iterations):
        active = (hi - lo) >= 3
        med = _interval_median(sorted_rows, lo, hi)
        mad = _interval_mad(sorted_rows, lo, hi, med)
        sig = jnp.maximum(mad * MAD_TO_SIGMA, 1e-30)
        # rank of the clip bounds by compare-count (== searchsorted
        # left/right on the sorted rows, as two fused reductions)
        vlo = (med - kappa * sig).astype(jnp.float32)[:, None]
        vhi = (med + kappa * sig).astype(jnp.float32)[:, None]
        new_lo = jnp.sum((sorted_rows < vlo).astype(jnp.int32), axis=1)
        new_hi = jnp.sum((sorted_rows <= vhi).astype(jnp.int32), axis=1)
        lo = jnp.where(active, jnp.maximum(new_lo, lo), lo)
        hi = jnp.where(active, jnp.minimum(new_hi, hi), hi)
    empty = hi <= lo
    med = _interval_median(sorted_rows, lo, hi)
    mad = _interval_mad(sorted_rows, lo, hi, med)
    sig = jnp.maximum(mad * MAD_TO_SIGMA, 1e-30)
    return (jnp.where(empty, 0.0, med), jnp.where(empty, 1.0, sig))


@partial(jax.jit, static_argnames=("tile_size",))
def _estimate_background_kernel(image: jax.Array, tile_size: int):
    rows, cols = image.shape
    step = max(tile_size, 16)
    ty = -(-rows // step)
    tx = -(-cols // step)
    padded = jnp.pad(image, ((0, ty * step - rows), (0, tx * step - cols)),
                     constant_values=jnp.nan)
    tiles = padded.reshape(ty, step, tx, step).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(ty * tx, step * step)
    valid = jnp.isfinite(tiles) & (tiles > PADDING_THRESHOLD)
    counts = jnp.sum(valid.astype(jnp.int32), axis=1)
    sorted_rows = jnp.sort(jnp.where(valid, tiles, jnp.inf), axis=1)
    med, sig = _tile_sigma_clipped(sorted_rows, counts)
    # tiles with <8 valid pixels are excluded (star_detection.rs:60)
    ok = counts >= 8
    n_ok = jnp.sum(ok.astype(jnp.int32))
    meds = jnp.sort(jnp.where(ok, med, jnp.inf))
    sigs = jnp.sort(jnp.where(ok, sig, jnp.inf))
    g_med = meds[jnp.maximum(n_ok // 2, 0)]
    g_sig = sigs[jnp.maximum(n_ok // 2, 0)]
    none = n_ok == 0
    return (jnp.where(none, 0.0, g_med),
            jnp.where(none, 1.0, jnp.maximum(g_sig, 1e-10)))


def estimate_background(image, tile_size: int):
    med, sig = _estimate_background_kernel(jnp.asarray(image), tile_size)
    return float(med), float(sig)


# --- peak detection + windowed moments ---------------------------------------


def _local_maxima(img, mask):
    """mask & (img strictly ≥ all 8 neighbors, > at least by position).

    Neighbor shifts are static slices of ONE −inf-padded plane — XLA
    fuses slices of a shared buffer into the compare chain."""
    rows, cols = img.shape
    p = jnp.pad(img, 1, constant_values=-jnp.inf)
    strict = jnp.ones_like(mask)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            # the neighbor AT (dy, dx) seen from each pixel (the roll
            # form compared against the neighbor at (−dy, −dx), so the
            # strict set flips with it)
            shifted = jax.lax.slice(
                p, (1 + dy, 1 + dx), (1 + dy + rows, 1 + dx + cols))
            # ties broken so a flat plateau yields a single peak
            if (dy, dx) > (0, 0):
                strict = strict & (img > shifted)
            else:
                strict = strict & (img >= shifted)
    # kill the 1-px border like the reference's 1..rows-1 scan
    strict = strict.at[0, :].set(False).at[-1, :].set(False)
    strict = strict.at[:, 0].set(False).at[:, -1].set(False)
    return mask & strict


@partial(jax.jit, static_argnames=("max_peaks", "window"))
def _detect_kernel(image: jax.Array, bg_med: jax.Array, bg_sig: jax.Array,
                   sigma_threshold: float, max_peaks: int = MAX_PEAKS,
                   window: int = WINDOW):
    rows, cols = image.shape
    threshold = bg_med + sigma_threshold * bg_sig
    finite = jnp.isfinite(image)
    above = finite & (image > threshold)

    peaks = _local_maxima(jnp.where(finite, image, -jnp.inf), above)
    score = jnp.where(peaks, image, -jnp.inf)
    # reduce 2×2 blocks to their max before top_k (4× less top_k
    # work). Lossless: all four cells
    # of a 2×2 block are mutually 8-adjacent, and _local_maxima's
    # lexicographic strict/>= tie-break means no two 8-adjacent cells
    # can both be peaks — every block holds at most ONE candidate.
    r2 = -(-rows // 2) * 2
    c2 = -(-cols // 2) * 2
    sp = jnp.pad(score, ((0, r2 - rows), (0, c2 - cols)),
                 constant_values=-jnp.inf)
    # 2×2 block max via roll + index-VECTOR takes
    m = jnp.maximum(sp, jnp.roll(sp, -1, axis=0))
    m = jnp.take(m, jnp.arange(0, r2, 2), axis=0)
    m = jnp.maximum(m, jnp.roll(m, -1, axis=1))
    bmax = jnp.take(m, jnp.arange(0, c2, 2), axis=1)
    rows_b, cols_b = r2 // 2, c2 // 2
    k_row = min(64, cols_b)
    # small plane: the block-max grid can hold fewer cells than
    # max_peaks — clamp the selection and pad back (is_peak masks the
    # -inf tail downstream)
    k_flat = min(max_peaks, rows_b * cols_b)

    def _flat_top(bm):
        v, bidx = jax.lax.top_k(bm.reshape(-1), k_flat)
        if k_flat < max_peaks:
            v = jnp.pad(v, (0, max_peaks - k_flat),
                        constant_values=-jnp.inf)
            bidx = jnp.pad(bidx, (0, max_peaks - k_flat))
        return v, bidx // cols_b, bidx % cols_b

    if cols_b > 64 and rows_b * k_row >= max_peaks:
        # two-level top_k: per-row top-64
        # then a flat top_k over the 64·rows_b survivors. A row of
        # bmax spans TWO image rows, so >64 peaks there is an extreme
        # cluster core — but the reference finds them all, so detect
        # the overflow (count finite candidates per slab) and fall
        # back to the lossless full-plane top_k at runtime (lax.cond
        # executes one branch; the common case never pays for it).
        overflow = jnp.any(
            jnp.sum(jnp.isfinite(bmax), axis=1) > k_row)

        def _two_level(bm):
            rv, ri = jax.lax.top_k(bm, k_row)
            v, fi = jax.lax.top_k(rv.reshape(-1), max_peaks)
            return v, fi // k_row, jnp.take(ri.reshape(-1), fi)

        vals, by, bx = jax.lax.cond(overflow, _flat_top, _two_level,
                                    bmax)
    else:
        vals, by, bx = _flat_top(bmax)
    flat = sp.reshape(-1)
    base_idx = (2 * by) * c2 + 2 * bx
    c00 = jnp.take(flat, base_idx)
    c01 = jnp.take(flat, base_idx + 1)
    c10 = jnp.take(flat, base_idx + c2)
    # row-major first-match tie-break reproduces top_k's stable index
    # order within a block
    off = jnp.where(c00 == vals, 0,
                    jnp.where(c01 == vals, 1,
                              jnp.where(c10 == vals, c2, c2 + 1)))
    idx = base_idx + off
    py = idx // c2
    px = idx % c2
    is_peak = jnp.isfinite(vals)

    half = window // 2
    padded = jnp.pad(image, half, constant_values=jnp.nan)

    # windows with the PEAK axis LAST: [41, 41, n] keeps the
    # n=max_peaks axis contiguous for the 8-neighbour shifts of the
    # 20 dilation rounds.
    wins = jax.vmap(lambda y, x: jax.lax.dynamic_slice(
        padded, (y, x), (window, window)))(py.astype(jnp.int32),
                                           px.astype(jnp.int32))
    win = wins.transpose(1, 2, 0)
    wfinite = jnp.isfinite(win)
    wabove = wfinite & (win > threshold)
    # bounded flood fill from the center: iterative 3×3 dilation
    # (fori_loop keeps the HLO small — unrolling half×8 shifts made
    # compiles minutes-long)
    member0 = jnp.zeros((window, window, max_peaks),
                        bool).at[half, half, :].set(True)

    def grow(_, member):
        # zero-pad the two spatial axes: no wraparound connectivity
        m = jnp.pad(member, ((1, 1), (1, 1), (0, 0)))
        grown = member
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                grown = grown | m[dy:dy + window, dx:dx + window, :]
        return grown & wabove

    member = jax.lax.fori_loop(0, half, grow, member0)
    v = jnp.where(member, jnp.maximum(win - bg_med, 0.0), 0.0)
    npixs = jnp.sum(member.astype(jnp.int32), axis=(0, 1))
    fluxes = jnp.sum(v, axis=(0, 1))
    yy = jnp.arange(window, dtype=jnp.float32)[:, None, None]
    xx = jnp.arange(window, dtype=jnp.float32)[None, :, None]
    safe_flux = jnp.maximum(fluxes, 1e-30)
    cy = jnp.sum(yy * v, axis=(0, 1)) / safe_flux
    cx = jnp.sum(xx * v, axis=(0, 1)) / safe_flux
    dy = yy - cy[None, None, :]
    dx = xx - cx[None, None, :]
    r2m = jnp.sum((dx * dx + dy * dy) * v, axis=(0, 1))
    sxx = jnp.sum(dx * dx * v, axis=(0, 1)) / safe_flux
    syy = jnp.sum(dy * dy * v, axis=(0, 1)) / safe_flux
    sxy = jnp.sum(dx * dy * v, axis=(0, 1)) / safe_flux
    pvals_k = jnp.max(v, axis=(0, 1))
    sigma_star = jnp.sqrt(r2m / (2.0 * safe_flux))
    fwhms = sigma_star * FWHM_FACTOR
    trace = sxx + syy
    det = jnp.maximum(sxx * syy - sxy * sxy, 0.0)
    disc = jnp.sqrt(jnp.maximum(trace * trace / 4.0 - det, 0.0))
    l1 = trace / 2.0 + disc
    l2 = jnp.maximum(trace / 2.0 - disc, 0.0)
    eccs = jnp.where(l1 > 1e-15,
                     jnp.clip(jnp.sqrt(jnp.maximum(1.0 - l2 / l1, 0.0)),
                              0.0, 1.0), 0.0)
    pvals = pvals_k
    cys = cy + (py.astype(jnp.float32) - half)
    cxs = cx + (px.astype(jnp.float32) - half)
    snrs = jnp.where(bg_sig <= 1e-300, 0.0, pvals / bg_sig)

    valid = (is_peak & (npixs >= 3) & (npixs <= 5000) & (fluxes > 0.0) &
             (fwhms >= 0.5) & (fwhms <= 30.0))
    # ONE packed f32 array: the host reads all nine outputs PLUS the
    # background scalars in a single device fetch. npix ≤ 5000 and the
    # 0/1 valid flag are exact in f32.
    bg_row = jnp.zeros((max_peaks,), jnp.float32)
    bg_row = bg_row.at[0].set(bg_med).at[1].set(bg_sig)
    return jnp.stack([cys, cxs, fluxes, fwhms, eccs, pvals,
                      npixs.astype(jnp.float32),
                      snrs, valid.astype(jnp.float32), bg_row])


@partial(jax.jit, static_argnames=("tile_size", "max_peaks"))
def _detect_fused(img, tile_size, sigma_threshold, max_peaks):
    """Background estimation + detection in ONE dispatch (the
    intermediate bg scalars never visit the host)."""
    bg_med, bg_sig = _estimate_background_kernel(img, tile_size)
    return _detect_kernel(img, bg_med, bg_sig, sigma_threshold, max_peaks)


@partial(jax.jit, static_argnames=("tile_size", "max_peaks"))
def _detect_fused_pair(img_a, img_b, tile_size, sigma_threshold,
                       max_peaks):
    """Both planes of an alignment pair in ONE dispatch; the caller
    fetches one stacked [2, 10, max_peaks] array instead of two."""
    return jnp.stack([
        _detect_fused(img_a, tile_size, sigma_threshold, max_peaks),
        _detect_fused(img_b, tile_size, sigma_threshold, max_peaks)])


def detect_stars(image, sigma_threshold: float = 5.0,
                 max_peaks: int = MAX_PEAKS) -> DetectionResult:
    """Full detection pipeline (star_detection.rs:86-248)."""
    img = jnp.asarray(image, dtype=jnp.float32)
    rows, cols = img.shape
    if rows < 3 or cols < 3:
        return DetectionResult([], 0.0, 1.0, sigma_threshold, cols, rows)

    tile_size = min(max(min(rows, cols) // 8, 32), 256)
    packed = np.asarray(_detect_fused(img, tile_size,
                                      float(sigma_threshold), max_peaks))
    return _postprocess_packed(packed, float(sigma_threshold), rows, cols)


def detect_stars_pair(image_a, image_b, sigma_threshold: float = 5.0,
                      max_peaks: int = MAX_PEAKS):
    """detect_stars on two same-shape planes with one device dispatch
    and one host fetch (the alignment chain's detect ×2)."""
    a = jnp.asarray(image_a, dtype=jnp.float32)
    b = jnp.asarray(image_b, dtype=jnp.float32)
    rows, cols = a.shape
    if rows < 3 or cols < 3 or a.shape != b.shape:
        return (detect_stars(image_a, sigma_threshold, max_peaks),
                detect_stars(image_b, sigma_threshold, max_peaks))
    tile_size = min(max(min(rows, cols) // 8, 32), 256)
    both = np.asarray(_detect_fused_pair(a, b, tile_size,
                                         float(sigma_threshold), max_peaks))
    return (_postprocess_packed(both[0], float(sigma_threshold), rows, cols),
            _postprocess_packed(both[1], float(sigma_threshold), rows, cols))


def dedupe_packed_device(packed: jax.Array, scan_cap: int = 512):
    """Brightest-first 3-px greedy dedupe of the packed candidates ON
    DEVICE, exactly reproducing `_postprocess_packed`'s accept set.

    Decomposition that avoids a max_peaks-step sequential scan: a
    candidate with NO other valid candidate within 3 px can neither
    suppress nor be suppressed — it is accepted iff valid, in
    parallel. Only the CONFLICTED subset (3-px pairs — a handful of
    cluster cores on real fields) depends on order; those run the
    sequential greedy scan in global flux order, capped at
    ``scan_cap`` (the accept sequence is exact whenever the conflicted
    set fits the cap; beyond it the dimmest conflicted extras are
    dropped, same precedent as the align chain's scan_cap=256).

    Returns accepted [max_peaks] bool aligned with `packed`'s columns.
    """
    cys, cxs, fluxes = packed[0], packed[1], packed[2]
    valid = packed[8] > 0.5
    k = cys.shape[0]
    d2 = ((cys[:, None] - cys[None, :]) ** 2 +
          (cxs[:, None] - cxs[None, :]) ** 2)
    pair = valid[:, None] & valid[None, :] & (d2 < 9.0)
    eye = jnp.eye(k, dtype=bool)
    conflicted = jnp.any(pair & ~eye, axis=1) & valid
    acc_free = valid & ~conflicted

    # greedy scan over the conflicted subset in flux-desc order
    score = jnp.where(conflicted, -fluxes, jnp.inf)
    order = jnp.argsort(score)[:scan_cap]
    ys = jnp.take(cys, order)
    xs = jnp.take(cxs, order)
    val = jnp.take(conflicted, order)

    def step(acc, i):
        dd = (ys - ys[i]) ** 2 + (xs - xs[i]) ** 2
        clash = jnp.any(acc & (dd < 9.0))
        acc = acc.at[i].set(val[i] & ~clash)
        return acc, None

    acc_sub, _ = jax.lax.scan(step, jnp.zeros(order.shape[0], bool),
                              jnp.arange(order.shape[0]))
    accepted = acc_free.at[order].max(acc_sub)
    return accepted


def _postprocess_packed(packed: np.ndarray, sigma_threshold: float,
                        rows: int, cols: int) -> DetectionResult:
    (cys, cxs, fluxes, fwhms, eccs, pvals, npixs, snrs) = packed[:8]
    valid = packed[8] > 0.5
    bg_med, bg_sig = packed[9, 0], packed[9, 1]

    order = np.argsort(-fluxes)  # brightest first (star_detection.rs:215)
    cand = order[valid[order]]
    # greedy 3-px dedup in flux order over a 3-px bucket grid: each
    # candidate only checks the 9 neighboring cells, and all columns
    # cross numpy→Python ONCE via tolist() (not per-candidate numpy
    # slices and per-field float())
    oy = cys[cand].tolist()
    ox = cxs[cand].tolist()
    lfx, lfy = fluxes[cand].tolist(), fwhms[cand].tolist()
    lec, lpk = eccs[cand].tolist(), pvals[cand].tolist()
    lnp, lsn = npixs[cand].tolist(), snrs[cand].tolist()
    grid: dict = {}
    stars: List[DetectedStar] = []
    for pos in range(len(oy)):
        y = oy[pos]
        x = ox[pos]
        cy_i = int(y) // 3
        cx_i = int(x) // 3
        clash = False
        for gy in (cy_i - 1, cy_i, cy_i + 1):
            for gx in (cx_i - 1, cx_i, cx_i + 1):
                for (sy, sx) in grid.get((gy, gx), ()):
                    dy = sy - y
                    dx = sx - x
                    if dy * dy + dx * dx < 9.0:
                        clash = True
                        break
                if clash:
                    break
            if clash:
                break
        if clash:
            continue
        grid.setdefault((cy_i, cx_i), []).append((y, x))
        stars.append(DetectedStar(
            x=x, y=y, flux=lfx[pos], fwhm=lfy[pos],
            eccentricity=lec[pos], peak=lpk[pos],
            npix=int(lnp[pos]), snr=lsn[pos]))
    return DetectionResult(stars, float(bg_med), float(bg_sig),
                           sigma_threshold, cols, rows)
