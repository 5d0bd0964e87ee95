"""FFT phase correlation with coarse-to-fine refinement.

Reference: src-tauri/src/core/alignment/phase_correlation.rs —
Hann-windowed buffers → FFT → ε-guarded cross-power → inverse FFT →
peak + SNR confidence → circular unwrap + 3-point quadratic subpixel
(math/subpixel.rs:84), coarse pass capped at 512², refinement on 512²
centered crops.

Design: the whole coarse-to-fine pipeline is one jit per input
shape — matmul FFTs (ops.fft), box-mean coarse downsample, dynamic-slice
crops with clamped starts (the reference shrinks edge crops and skips
refinement on mismatch; we clamp so the refine always runs at 512²).
Batched use (vmap over a frame axis) is supported by `correlate_single`.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from astroburst_tpu.ops import fft as F
from astroburst_tpu.ops.window import hann_periodic

COARSE_MAX_DIM = 512        # phase_correlation.rs:10
REFINE_CROP_SIZE = 512      # phase_correlation.rs:11
CONFIDENCE_THRESHOLD = 2.0  # phase_correlation.rs:12
EPSILON = 1e-15


@dataclass(frozen=True)
class PhaseCorrelationResult:
    dy: float
    dx: float
    confidence: float


def is_low_confidence(confidence: float) -> bool:
    return confidence < CONFIDENCE_THRESHOLD


def _is_constant_or_zero(img):
    """finite_count < 16 or range < 1e-10 (phase_correlation.rs:143-161).

    One variadic ``lax.reduce`` carries count, min and max together, so
    the full-resolution stack is read once for all three."""
    finite = jnp.isfinite(img)
    dims = (img.ndim - 2, img.ndim - 1)
    mn, mx, cnt = jax.lax.reduce(
        (jnp.where(finite, img, jnp.inf),
         jnp.where(finite, img, -jnp.inf),
         finite.astype(jnp.int32)),
        (jnp.float32(jnp.inf), jnp.float32(-jnp.inf), jnp.int32(0)),
        lambda a, b: (jnp.minimum(a[0], b[0]), jnp.maximum(a[1], b[1]),
                      a[2] + b[2]),
        dims)
    return (cnt < 16) | (jnp.abs(mx - mn) < 1e-10)


def _windowed_padded(img, fft_rows: int, fft_cols: int):
    """Hann-window (zeroing non-finite) and zero-pad (fft.rs:202-226)."""
    rows, cols = img.shape[-2], img.shape[-1]
    wy = jnp.asarray(hann_periodic(rows))
    wx = jnp.asarray(hann_periodic(cols))
    vals = jnp.where(jnp.isfinite(img), img, 0.0)
    vals = vals * wy[:, None] * wx[None, :]
    pad = [(0, 0)] * (img.ndim - 2) + [(0, fft_rows - rows),
                                       (0, fft_cols - cols)]
    return jnp.pad(vals, pad)


def _peak_neighbors(corr, py, px):
    """Wraparound prev/next values on both axes (subpixel.rs:28-64)."""
    rows, cols = corr.shape[-2], corr.shape[-1]
    flat = corr.reshape(*corr.shape[:-2], rows * cols)

    def at(y, x):
        idx = y * cols + x
        return jnp.take_along_axis(flat, idx[..., None], axis=-1)[..., 0]

    center = at(py, px)
    y_prev = at((py - 1) % rows, px)
    y_next = at((py + 1) % rows, px)
    x_prev = at(py, (px - 1) % cols)
    x_next = at(py, (px + 1) % cols)
    return center, y_prev, y_next, x_prev, x_next


def _quadratic(prev, center, nxt):
    """3-point parabola vertex, clamped to ±0.5 (subpixel.rs:18-26)."""
    denom = 2.0 * (2.0 * center - prev - nxt)
    off = jnp.where(jnp.abs(denom) < 1e-15, 0.0, (prev - nxt) /
                    jnp.where(jnp.abs(denom) < 1e-15, 1.0, denom))
    return jnp.clip(off, -0.5, 0.5)


def _peak_stats(corr):
    """(argmax idx, peak, sum, sumsq) in ONE variadic ``lax.reduce``
    pass over the surface — separate argmax + peak gather + mean +
    centered-variance reductions cost four full passes and a dependent
    round trip each at 512²×15 (the refine stage's latency soup).
    Ties resolve to the lowest flat index, matching ``jnp.argmax``."""
    r, c = corr.shape[-2], corr.shape[-1]
    flat = corr.reshape(*corr.shape[:-2], r * c)
    idx = jax.lax.broadcasted_iota(jnp.int32, flat.shape, flat.ndim - 1)
    mv, mi, s, s2 = jax.lax.reduce(
        (flat, idx, flat, flat * flat),
        (jnp.float32(-jnp.inf), jnp.int32(2 ** 31 - 1), jnp.float32(0.0),
         jnp.float32(0.0)),
        lambda a, b: (
            jnp.maximum(a[0], b[0]),
            jnp.where((b[0] > a[0]) | ((b[0] == a[0]) & (b[1] < a[1])),
                      b[1], a[1]),
            a[2] + b[2],
            a[3] + b[3]),
        (flat.ndim - 1,))
    return mi, mv, s, s2


def _corr_to_shift(corr, fft_rows: int, fft_cols: int):
    """Peak + SNR confidence + circular unwrap + quadratic subpixel
    from a correlation surface (subpixel.rs:18-64). The variance uses
    the one-pass sum/sumsq form — (peak − mean)/σ only gates
    acceptance, and the surface's near-zero mean keeps the
    cancellation error far below the gate's resolution."""
    cols = fft_cols
    idx, peak_val, s, s2 = _peak_stats(corr)
    py, px = idx // cols, idx % cols
    n = fft_rows * fft_cols
    mean = s / n
    var = jnp.maximum(s2 - s * mean, 0.0) / max(n - 1, 1)
    sigma = jnp.sqrt(var)
    confidence = jnp.where(jnp.abs(sigma) < 1e-15, 0.0,
                           (peak_val - mean) / jnp.maximum(sigma, 1e-30))

    center, yp, yn, xp, xn = _peak_neighbors(corr, py, px)
    sub_dy = _quadratic(yp, center, yn)
    sub_dx = _quadratic(xp, center, xn)
    raw_dy = jnp.where(py > fft_rows // 2, py - fft_rows, py).astype(jnp.float32)
    raw_dx = jnp.where(px > fft_cols // 2, px - fft_cols, px).astype(jnp.float32)
    return raw_dy + sub_dy, raw_dx + sub_dx, confidence


def correlate_single(a, b):
    """Single-scale phase correlation; supports leading batch dims.

    Returns traced (dy, dx, confidence) f32 scalars (or batched).

    Both FFT stages run on the HALF spectrum (ops.fft.rfft2/irfft2):
    the inputs are real and the cross-power of two conjugate-symmetric
    spectra is conjugate-symmetric, so its inverse is the real
    correlation surface — the redundant spectrum half never exists.
    """
    rows, cols = a.shape[-2], a.shape[-1]
    fft_rows = F.next_power_of_two(rows)
    fft_cols = F.next_power_of_two(cols)

    fa = _windowed_padded(a, fft_rows, fft_cols)
    fb = _windowed_padded(b, fft_rows, fft_cols)
    # Fb·conj(Fa): with b displaced by (+dy, +dx) relative to a, the
    # inverse-FFT peak lands at (+dy, +dx), so shift_bicubic(b, dy, dx)
    # maps b back onto a — the contract the reference's align loop
    # relies on (core/stacking/align.rs:92-105).
    if fft_rows % 2 == 0 and fft_cols % 2 == 0:
        far, fai = F.rfft2(fa)
        fbr, fbi = F.rfft2(fb)
        cr, ci = F.cross_power(fbr, fbi, far, fai, EPSILON)
        corr = F.irfft2(cr, ci, fft_cols)
    else:  # degenerate 1-px axes: rfft2 requires even dims
        far, fai = F.fft2_real(fa)
        fbr, fbi = F.fft2_real(fb)
        cr, ci = F.cross_power(fbr, fbi, far, fai, EPSILON)
        corr = F.ifft2_real(cr, ci)

    dy, dx, confidence = _corr_to_shift(corr, fft_rows, fft_cols)

    bad = _is_constant_or_zero(a) | _is_constant_or_zero(b)
    zero = jnp.zeros_like(dy)
    return (jnp.where(bad, zero, dy), jnp.where(bad, zero, dx),
            jnp.where(bad, zero, confidence))


def correlate_two(a, b1, b2):
    """Phase-correlate TWO targets against one reference with rfft
    packing: one forward complex FFT carries both targets (real-input
    conjugate symmetry) and one inverse FFT carries both correlation
    surfaces (they are real) — half the matmul work of two
    correlate_single calls. Returns (dy1, dx1, c1, dy2, dx2, c2).
    """
    rows, cols = a.shape[-2], a.shape[-1]
    fft_rows = F.next_power_of_two(rows)
    fft_cols = F.next_power_of_two(cols)

    fa = _windowed_padded(a, fft_rows, fft_cols)
    far, fai = F.fft2_real(fa)
    p1 = _windowed_padded(b1, fft_rows, fft_cols)
    p2 = _windowed_padded(b2, fft_rows, fft_cols)
    f1r, f1i, f2r, f2i = F.fft2_two_real(p1, p2)
    c1r, c1i = F.cross_power(f1r, f1i, far, fai, EPSILON)
    c2r, c2i = F.cross_power(f2r, f2i, far, fai, EPSILON)
    corr1, corr2 = F.ifft2_two_real(c1r, c1i, c2r, c2i)

    dy1, dx1, conf1 = _corr_to_shift(corr1, fft_rows, fft_cols)
    dy2, dx2, conf2 = _corr_to_shift(corr2, fft_rows, fft_cols)

    bad_a = _is_constant_or_zero(a)
    bad1 = bad_a | _is_constant_or_zero(b1)
    bad2 = bad_a | _is_constant_or_zero(b2)
    zero = jnp.zeros_like(dy1)
    return (jnp.where(bad1, zero, dy1), jnp.where(bad1, zero, dx1),
            jnp.where(bad1, zero, conf1),
            jnp.where(bad2, zero, dy2), jnp.where(bad2, zero, dx2),
            jnp.where(bad2, zero, conf2))


def _coarse_box_downsample(img, max_dim: int):
    """Integer box-mean downsample for the coarse pass.

    The reference's coarse pass area-averages to ≤512²
    (phase_correlation.rs:10, sampling.rs area path). The coarse
    displacement only seeds the 512² refinement crop, so an integer
    box mean over the largest divisible region is equivalent for that
    purpose. A reshape and a mean in f32: XLA fuses it into one read of
    the plane. Returns (ds, box_y, box_x), ds ≤ max_dim."""
    rows, cols = img.shape[-2], img.shape[-1]
    by = -(-rows // max_dim)
    bx = -(-cols // max_dim)
    ds_r = rows // by
    ds_c = cols // bx
    lead = img.shape[:-2]
    boxes = img[..., :ds_r * by, :ds_c * bx].reshape(
        *lead, ds_r, by, ds_c, bx)
    return jnp.mean(boxes, axis=(-3, -1)), by, bx


def _crop_origin_static(rows: int, cols: int, size: int):
    """Origin of the reference's centered refine crop."""
    return max(rows // 2 - size // 2, 0), max(cols // 2 - size // 2, 0)


def _centered_crop_static(img, size: int):
    rows, cols = img.shape[-2], img.shape[-1]
    y0, x0 = _crop_origin_static(rows, cols, size)
    return img[..., y0:y0 + min(size, rows), x0:x0 + min(size, cols)]


def _refine_origin(cy, cx, rows: int, cols: int, size: int):
    """Origin of the target's refine crop: centered on (cy, cx) and
    clamped so the crop stays inside the plane (the reference shrinks
    edge crops instead; the clamp keeps the refine at size²). The
    refine result is corrected by the two crop origins."""
    y0 = jnp.clip(cy.astype(jnp.int32) - size // 2, 0, max(rows - size, 0))
    x0 = jnp.clip(cx.astype(jnp.int32) - size // 2, 0, max(cols - size, 0))
    return y0, x0


def _dynamic_crop(img, cy, cx, size: int):
    rows, cols = img.shape[-2], img.shape[-1]
    # the origin shift is reported back via the same clamped origin
    # the caller computes (_refine_origin)
    y0, x0 = _refine_origin(cy, cx, rows, cols, size)
    return jax.lax.dynamic_slice(img, (y0, x0),
                                 (min(size, rows), min(size, cols)))


@jax.jit
def _phase_correlate_traced(ref, tgt):
    """Full coarse-to-fine pipeline on device; 2D inputs, equal shapes."""
    rows, cols = ref.shape
    if rows <= COARSE_MAX_DIM and cols <= COARSE_MAX_DIM:
        return correlate_single(ref, tgt)

    ref_ds, by, bx = _coarse_box_downsample(ref, COARSE_MAX_DIM)
    tgt_ds, _, _ = _coarse_box_downsample(tgt, COARSE_MAX_DIM)
    cdy, cdx, cconf = correlate_single(ref_ds, tgt_ds)
    coarse_dy = cdy * by
    coarse_dx = cdx * bx

    ref_cy = rows // 2
    ref_cx = cols // 2
    tgt_cy = jnp.clip(jnp.round(ref_cy + coarse_dy), 0, rows - 1).astype(jnp.int32)
    tgt_cx = jnp.clip(jnp.round(ref_cx + coarse_dx), 0, cols - 1).astype(jnp.int32)

    ref_crop = _centered_crop_static(ref, REFINE_CROP_SIZE)
    tgt_crop = _dynamic_crop(tgt, tgt_cy, tgt_cx, REFINE_CROP_SIZE)
    # account for the actual crop origins (clamping can move them)
    ref_y0, ref_x0 = _crop_origin_static(rows, cols, REFINE_CROP_SIZE)
    tgt_y0, tgt_x0 = _refine_origin(tgt_cy, tgt_cx, rows, cols,
                                    REFINE_CROP_SIZE)

    rdy, rdx, rconf = correlate_single(ref_crop, tgt_crop)
    dy = (tgt_y0 - ref_y0).astype(jnp.float32) + rdy
    dx = (tgt_x0 - ref_x0).astype(jnp.float32) + rdx

    bad = _is_constant_or_zero(ref) | _is_constant_or_zero(tgt)
    zero = jnp.float32(0.0)
    return (jnp.where(bad, zero, dy), jnp.where(bad, zero, dx),
            jnp.where(bad, zero, rconf))


@jax.jit
def phase_correlate_stack_traced(ref, targets):
    """Coarse-to-fine phase correlation of a [N, H, W] target stack
    against one reference. Returns (dys [N], dxs [N], confidences [N]).
    The refine crops are per-frame ``dynamic_slice``s."""
    n, rows, cols = targets.shape
    if rows <= COARSE_MAX_DIM and cols <= COARSE_MAX_DIM:
        dy, dx, conf = correlate_single(ref, targets)
        bad = _is_constant_or_zero(ref) | _is_constant_or_zero(targets)
        zero = jnp.zeros_like(dy)
        return (jnp.where(bad, zero, dy), jnp.where(bad, zero, dx),
                jnp.where(bad, zero, conf))

    ref_ds, by, bx = _coarse_box_downsample(ref, COARSE_MAX_DIM)
    tgt_ds, _, _ = _coarse_box_downsample(targets, COARSE_MAX_DIM)
    cdy, cdx, _ = correlate_single(ref_ds, tgt_ds)

    ref_cy = rows // 2
    ref_cx = cols // 2
    tgt_cy = jnp.clip(jnp.round(ref_cy + cdy * by), 0,
                      rows - 1).astype(jnp.int32)
    tgt_cx = jnp.clip(jnp.round(ref_cx + cdx * bx), 0,
                      cols - 1).astype(jnp.int32)
    tgt_y0, tgt_x0 = _refine_origin(tgt_cy, tgt_cx, rows, cols,
                                    REFINE_CROP_SIZE)
    s_r = min(REFINE_CROP_SIZE, rows)
    s_c = min(REFINE_CROP_SIZE, cols)
    crops = jnp.concatenate([
        jax.lax.dynamic_slice(targets, (jnp.int32(k), tgt_y0[k],
                                        tgt_x0[k]), (1, s_r, s_c))
        for k in range(n)])
    ref_crop = _centered_crop_static(ref, REFINE_CROP_SIZE)
    ref_y0, ref_x0 = _crop_origin_static(rows, cols, REFINE_CROP_SIZE)
    rdy, rdx, rconf = correlate_single(ref_crop, crops)
    dy = (tgt_y0 - ref_y0).astype(jnp.float32) + rdy
    dx = (tgt_x0 - ref_x0).astype(jnp.float32) + rdx

    bad = _is_constant_or_zero(ref) | _is_constant_or_zero(targets)
    zero = jnp.zeros_like(dy)
    return (jnp.where(bad, zero, dy), jnp.where(bad, zero, dx),
            jnp.where(bad, zero, rconf))


def _refine_one(tgt, coarse_dy, coarse_dx, rows, cols):
    """Clamped dynamic refine crop + origin bookkeeping for one target."""
    ref_cy = rows // 2
    ref_cx = cols // 2
    tgt_cy = jnp.clip(jnp.round(ref_cy + coarse_dy), 0,
                      rows - 1).astype(jnp.int32)
    tgt_cx = jnp.clip(jnp.round(ref_cx + coarse_dx), 0,
                      cols - 1).astype(jnp.int32)
    tgt_crop = _dynamic_crop(tgt, tgt_cy, tgt_cx, REFINE_CROP_SIZE)
    ref_y0, ref_x0 = _crop_origin_static(rows, cols, REFINE_CROP_SIZE)
    tgt_y0, tgt_x0 = _refine_origin(tgt_cy, tgt_cx, rows, cols,
                                    REFINE_CROP_SIZE)
    return (tgt_crop, (tgt_y0 - ref_y0).astype(jnp.float32),
            (tgt_x0 - ref_x0).astype(jnp.float32))


@jax.jit
def _phase_correlate_traced_two(ref, t1, t2):
    """Coarse-to-fine phase correlation of TWO targets vs one
    reference, with both FFT stages rfft-packed (correlate_two)."""
    rows, cols = ref.shape
    if rows <= COARSE_MAX_DIM and cols <= COARSE_MAX_DIM:
        return correlate_two(ref, t1, t2)

    ref_ds, by, bx = _coarse_box_downsample(ref, COARSE_MAX_DIM)
    t1_ds, _, _ = _coarse_box_downsample(t1, COARSE_MAX_DIM)
    t2_ds, _, _ = _coarse_box_downsample(t2, COARSE_MAX_DIM)
    cdy1, cdx1, _, cdy2, cdx2, _ = correlate_two(ref_ds, t1_ds, t2_ds)

    ref_crop = _centered_crop_static(ref, REFINE_CROP_SIZE)
    crop1, off_y1, off_x1 = _refine_one(t1, cdy1 * by, cdx1 * bx,
                                        rows, cols)
    crop2, off_y2, off_x2 = _refine_one(t2, cdy2 * by, cdx2 * bx,
                                        rows, cols)
    rdy1, rdx1, rc1, rdy2, rdx2, rc2 = correlate_two(ref_crop, crop1, crop2)

    bad_r = _is_constant_or_zero(ref)
    bad1 = bad_r | _is_constant_or_zero(t1)
    bad2 = bad_r | _is_constant_or_zero(t2)
    zero = jnp.float32(0.0)
    return (jnp.where(bad1, zero, off_y1 + rdy1),
            jnp.where(bad1, zero, off_x1 + rdx1),
            jnp.where(bad1, zero, rc1),
            jnp.where(bad2, zero, off_y2 + rdy2),
            jnp.where(bad2, zero, off_x2 + rdx2),
            jnp.where(bad2, zero, rc2))


def phase_correlate_stack(ref, tgts):
    """Traced (dys, dxs, confs) of each frame of ``tgts`` [B, H, W]
    against ``ref``; frames run in rfft-packed pairs (odd counts pad
    by duplicating the last frame). The reference frame's spectrum is
    computed once — it is unbatched under the pair vmap."""
    b = tgts.shape[0]
    if b == 1:
        dy, dx, conf = _phase_correlate_traced(ref, tgts[0])
        return dy[None], dx[None], conf[None]
    if b % 2:
        tgts = jnp.concatenate([tgts, tgts[-1:]], axis=0)

    pair_fn = jax.vmap(lambda u, v: _phase_correlate_traced_two(ref, u, v))
    d1, x1, c1, d2, x2, c2 = pair_fn(tgts[0::2], tgts[1::2])
    dys = jnp.stack([d1, d2], axis=1).reshape(-1)[:b]
    dxs = jnp.stack([x1, x2], axis=1).reshape(-1)[:b]
    confs = jnp.stack([c1, c2], axis=1).reshape(-1)[:b]
    return dys, dxs, confs


def phase_correlate(reference, target) -> PhaseCorrelationResult:
    """Host-level API: crops to common dims, runs the device pipeline."""
    rows = min(reference.shape[0], target.shape[0])
    cols = min(reference.shape[1], target.shape[1])
    ref = jnp.asarray(reference)[:rows, :cols]
    tgt = jnp.asarray(target)[:rows, :cols]
    dy, dx, conf = _phase_correlate_traced(ref, tgt)
    return PhaseCorrelationResult(float(dy), float(dx), float(conf))
