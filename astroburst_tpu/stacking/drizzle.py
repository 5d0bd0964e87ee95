"""Drizzle stacking.

Reference: src-tauri/src/core/stacking/drizzle.rs — per input pixel
forward splat onto output pixels with square (exact overlap area),
Gaussian or Lanczos3 kernels truncated to the pixfrac·scale/2 window;
finalize each output pixel with per-pixel median/MAD sigma clipping of
the contribution list, then the unweighted mean of survivors (weights
map = Σw).

Gather-side formulation (documented delta, SURVEY §7.7): forward
splatting is a scatter with colliding writes. Because the
frame → output mapping is a uniform scale + per-frame offset and all
three kernels are separable, each frame's contribution field can be
computed *gather-side* as two 1D weighted-tap passes (axis-takes).
Per-frame contributions collapse into their weighted mean
E_f = ΣwV/Σw, and sigma clipping runs across the N per-frame estimates
(the same clip loop as the reference's finalize, with its
even-averaging medians). Same outputs for the common case of one
contribution per frame per output pixel; multi-contribution pixels see
their same-frame values pre-averaged instead of clipped individually.
Out-of-bounds splats are dropped rather than clamped onto border
pixels (a reference border artifact).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.alignment.pair import estimate_offset
from astroburst_tpu.alignment.phase_correlation import (is_low_confidence,
                                                        phase_correlate)
from astroburst_tpu.constants import MAD_TO_SIGMA
from astroburst_tpu.ops.sort_network import (bitonic_merge_axis0,
                                             bitonic_sort_axis0,
                                             pad_pow2_inf)
from astroburst_tpu.dtypes import AlignMethod, DrizzleConfig, DrizzleKernel
from astroburst_tpu.errors import InvalidInput
from astroburst_tpu.runtime.progress import ProgressHandle
def _lanczos3(x):
    ax = jnp.abs(x)
    pi_x = jnp.pi * jnp.where(ax < 1e-12, 1.0, x)
    val = (jnp.sin(pi_x) / pi_x) * (jnp.sin(pi_x / 3.0) / (pi_x / 3.0))
    return jnp.where(ax < 1e-12, 1.0, jnp.where(ax >= 3.0, 0.0, val))


def _support_taps(scale: float, half: float, kernel: DrizzleKernel,
                  exact: bool):
    """Minimal tap count covering every input pixel that can contribute
    to one output cell along one axis (zero-weight taps pruned: a
    symmetric window would carry 5 taps where 2 suffice, a 6.25×
    blowup on the candidate axis).

    Geometry: input centers c = (ix + d)·scale are spaced ``scale``
    apart in output coords. For the gather (pre-averaging) form only
    w > 0 matters: square needs overlap of [c−half, c+half] with
    [o, o+1] → c-window width 1 + 2·half; gaussian/lanczos are
    truncated at |o + 0.5 − c| ≤ half + 1 → width 2·half + 2. For the
    exact push-list form the reference pushes over
    floor(c−half) ≤ o ≤ ceil(c+half) (drizzle.rs:75-78) → width
    2 + 2·half — but for SQUARE the w > 1e-12 presence filter already
    drops the zero-overlap pushes, so the tighter w>0 window applies.

    Open-interval windows (square overlap; the exact push range) hold
    at most ``ceil(width)`` integers, all within
    [floor(lower)+1, floor(lower)+ceil(width)] — no margin slot needed
    (the window edges carry only ~zero-weight taps, and f32 jitter of
    the floor can only flip those). The gather gaussian/lanczos
    truncation window is CLOSED, so it keeps a slot at ``floor(lower)``
    for boundary-inclusive edges: floor(width)+2 taps.
    Returns (taps, base_offset) with base = floor(lower)+base_offset."""
    if kernel == DrizzleKernel.SQUARE:
        width = (1.0 + 2.0 * half) / scale
        return max(1, math.ceil(width - 1e-9)), 1
    if exact:
        width = (2.0 + 2.0 * half) / scale
        return max(1, math.ceil(width - 1e-9)), 1
    width = (2.0 * half + 2.0) / scale
    return math.floor(width + 1e-9) + 2, 0


def _axis_weights(n_out: int, n_in: int, d, scale: float, half: float,
                  kernel: DrizzleKernel, taps: int, base_off: int = 0):
    """Per-tap (index [n_out], weight [n_out]) for one axis.

    Input pixel ix has center c = (ix + d)·scale and half-width `half`
    in output coordinates; output pixel o covers [o, o+1). ``taps``
    consecutive input indices from floor(lower) + base_off cover every
    nonzero weight (``_support_taps``).
    """
    o = jnp.arange(n_out, dtype=jnp.float32)
    if kernel == DrizzleKernel.SQUARE:
        lower = (o - half) / scale - d
    else:
        lower = (o + 0.5 - half - 1.0) / scale - d
    base = jnp.floor(lower).astype(jnp.int32) + base_off
    out = []
    for t in range(taps):
        ix = base + t
        inside = (ix >= 0) & (ix <= n_in - 1)
        ixf = ix.astype(jnp.float32)
        c = (ixf + d) * scale
        if kernel == DrizzleKernel.SQUARE:
            w = jnp.maximum(jnp.minimum(c + half, o + 1.0) -
                            jnp.maximum(c - half, o), 0.0)
        elif kernel == DrizzleKernel.GAUSSIAN:
            sigma = max(half, 0.5)
            w = jnp.exp(-((o + 0.5 - c) ** 2) / (2.0 * sigma * sigma))
            w = jnp.where(jnp.abs(o + 0.5 - c) <= half + 1.0, w, 0.0)
        else:  # LANCZOS3
            w = _lanczos3(o + 0.5 - c)
            w = jnp.where(jnp.abs(o + 0.5 - c) <= half + 1.0, w, 0.0)
        w = jnp.where(inside, w, 0.0)
        out.append((jnp.clip(ix, 0, n_in - 1), w))
    return out


def _axis_taps_exact(n_out: int, n_in: int, d, scale: float, half: float,
                     kernel: DrizzleKernel, taps: int, base_off: int):
    """Per-tap (input index [n_out], weight [n_out]) reproducing the
    reference's push set exactly: input pixel ix contributes to output
    cell o iff floor(cx−half) ≤ o ≤ ceil(cx+half) (the scatter loop
    range, drizzle.rs:75-78), with the kernel weight evaluated at the
    cell (w > 1e-12 to count). ``taps`` consecutive indices from
    floor(lower) + base_off cover every push that can pass the 1e-12
    presence filter (``_support_taps``; for SQUARE the
    in-range-but-zero-overlap pushes are never present, so the tighter
    overlap window applies)."""
    o = jnp.arange(n_out, dtype=jnp.float32)
    if kernel == DrizzleKernel.SQUARE:
        lower = (o - half) / scale - d
    else:
        lower = (o - 1.0 - half) / scale - d
    base = jnp.floor(lower).astype(jnp.int32) + base_off
    out = []
    for t in range(taps):
        ix = base + t
        inside = (ix >= 0) & (ix <= n_in - 1)
        ixf = ix.astype(jnp.float32)
        c = (ixf + d) * scale
        in_range = (o >= jnp.floor(c - half)) & (o <= jnp.ceil(c + half))
        if kernel == DrizzleKernel.SQUARE:
            w = jnp.maximum(jnp.minimum(c + half, o + 1.0) -
                            jnp.maximum(c - half, o), 0.0)
        elif kernel == DrizzleKernel.GAUSSIAN:
            sigma = max(half, 0.5)
            w = jnp.exp(-((o + 0.5 - c) ** 2) / (2.0 * sigma * sigma))
        else:  # LANCZOS3
            w = _lanczos3(o + 0.5 - c)
        w = jnp.where(inside & in_range, w, 0.0)
        out.append((jnp.clip(ix, 0, n_in - 1), w))
    return out


def _frame_candidates(frame, d_y, d_x, scale: float, pixfrac: float,
                      kernel: DrizzleKernel, out_rows: int, out_cols: int):
    """All (value, weight) candidate planes for one frame, ordered
    (input-row tap asc, input-col tap asc) — the reference's per-pixel
    push order within a frame (row scan: iy asc, ix asc)."""
    in_rows, in_cols = frame.shape
    half = pixfrac * scale * 0.5
    taps, base_off = _support_taps(scale, half, kernel, exact=True)
    finite = jnp.isfinite(frame)
    vals = jnp.where(finite, frame, 0.0)
    xt = _axis_taps_exact(out_cols, in_cols, d_x, scale, half, kernel,
                          taps, base_off)
    yt = _axis_taps_exact(out_rows, in_rows, d_y, scale, half, kernel,
                          taps, base_off)
    cand_v, cand_w = [], []
    for idy, wy in yt:
        rows_v = jnp.take(vals, idy, axis=0)       # [out_rows, in_cols]
        rows_f = jnp.take(finite, idy, axis=0)
        for idx, wx in xt:
            v = jnp.take(rows_v, idx, axis=1)      # [out_rows, out_cols]
            f = jnp.take(rows_f, idx, axis=1)
            w = wy[:, None] * wx[None, :]
            cand_v.append(v)
            cand_w.append(jnp.where(f, w, 0.0))
    return jnp.stack(cand_v), jnp.stack(cand_w)


def _finalize_exact(cand_v, cand_w, cap: int, sigma_low, sigma_high,
                    iterations: int):
    """The reference finalize (drizzle.rs:121-195) over the ordered
    candidate axis: cap at max(2·n_frames, 4) in push order, per-pixel
    median/MAD clip of the surviving individual values, unweighted
    mean; empty → mean of ALL capped values; weights map = Σw of the
    capped pushes."""
    present = cand_w > 1e-12
    order_count = jnp.cumsum(present.astype(jnp.int32), axis=0)
    capped = present & (order_count <= cap)
    weight_map = jnp.sum(jnp.where(capped, cand_w, 0.0), axis=0)
    image, rej_map = _clip_mean_frames(
        cand_v.astype(jnp.float32), capped, sigma_low, sigma_high,
        iterations)
    return image, weight_map.astype(jnp.float32), rej_map


@partial(jax.jit,
         static_argnames=("scale", "pixfrac", "kernel", "out_rows",
                          "out_cols", "sigma_low", "sigma_high",
                          "sigma_iterations", "band_rows"))
def _drizzle_kernel_exact(stack, d_ys, d_xs, scale: float, pixfrac: float,
                          kernel: DrizzleKernel, out_rows: int,
                          out_cols: int, sigma_low: float,
                          sigma_high: float, sigma_iterations: int,
                          band_rows: int = 64, row0_offset=None):
    """Exact-parity drizzle: per-(frame, tap) candidate planes with the
    reference's capped push-list semantics, banded over output rows to
    bound the [n_frames·taps², rows, cols] candidate tensor."""
    n = stack.shape[0]
    cap = max(n * 2, 4)

    def one_band(r0):
        # shift the output grid: band rows [r0, r0+band_rows) are the
        # full drizzle of a vertically offset output; achieved by
        # offsetting d_y in output units: cy' = cy - r0
        parts = []
        for k in range(n):
            cv, cw = _frame_candidates(
                stack[k], d_ys[k] - r0 / scale, d_xs[k], scale, pixfrac,
                kernel, band_rows, out_cols)
            parts.append((cv, cw))
        cand_v = jnp.concatenate([p[0] for p in parts], axis=0)
        cand_w = jnp.concatenate([p[1] for p in parts], axis=0)
        return _finalize_exact(cand_v, cand_w, cap, sigma_low, sigma_high,
                               sigma_iterations)

    n_bands = -(-out_rows // band_rows)
    r0s = jnp.arange(n_bands, dtype=jnp.float32) * band_rows
    if row0_offset is not None:
        # row-sharded mode (parallel/drizzle.py): this call computes
        # output rows [row0_offset, row0_offset + out_rows) of the
        # global grid
        r0s = r0s + jnp.asarray(row0_offset, jnp.float32)
    img_b, wgt_b, rej_b = jax.lax.map(one_band, r0s)
    img = img_b.reshape(n_bands * band_rows, out_cols)[:out_rows]
    wgt = wgt_b.reshape(n_bands * band_rows, out_cols)[:out_rows]
    return img, wgt, jnp.sum(rej_b)


def _drizzle_frame(frame, d_y, d_x, scale: float, pixfrac: float,
                   kernel: DrizzleKernel, out_rows: int, out_cols: int):
    """(weighted-sum, weight) fields for one frame, gather-side."""
    in_rows, in_cols = frame.shape
    half = pixfrac * scale * 0.5
    taps, base_off = _support_taps(scale, half, kernel, exact=False)
    finite = jnp.isfinite(frame)
    vals = jnp.where(finite, frame, 0.0)
    ones = finite.astype(jnp.float32)

    xt = _axis_weights(out_cols, in_cols, d_x, scale, half, kernel,
                       taps, base_off)
    yt = _axis_weights(out_rows, in_rows, d_y, scale, half, kernel,
                       taps, base_off)

    # pass 1: along x → [in_rows, out_cols]
    a_val = None
    a_w = None
    for idx, w in xt:
        tv = w[None, :] * jnp.take(vals, idx, axis=1)
        tw = w[None, :] * jnp.take(ones, idx, axis=1)
        a_val = tv if a_val is None else a_val + tv
        a_w = tw if a_w is None else a_w + tw
    # pass 2: along y → [out_rows, out_cols]
    o_val = None
    o_w = None
    for idx, w in yt:
        tv = w[:, None] * jnp.take(a_val, idx, axis=0)
        tw = w[:, None] * jnp.take(a_w, idx, axis=0)
        o_val = tv if o_val is None else o_val + tv
        o_w = tw if o_w is None else o_w + tw
    return o_val, o_w


def _clip_mean_frames(estimates, weights_present, sigma_low, sigma_high,
                      iterations: int):
    """Sigma clip across the candidate axis with the drizzle-finalize
    semantics (drizzle.rs:121-178): even-averaging medians, len<3 stop,
    empty → mean of all.

    Sorted-window formulation: the keep condition is an interval in
    VALUE space (med − σlo·σ ≤ v ≤ med + σhi·σ), so the kept set is
    always contiguous in value-sorted order. One sort up front; each
    iteration then only needs two rank-selects for the median (iota
    compare + sum — no gather), one deviation sort for the MAD, and
    two window-shrink counts. 1 + iterations sorts total instead of
    the naive 2·iterations re-sorts — the sorts are the dominant cost
    of the exact kernel at scale (candidate axis × full output plane).

    Both sorts run as elementwise bitonic networks
    (ops/sort_network.py) rather than XLA's generic sort; the
    per-iteration deviation array ``|sv − med|`` masked to the window
    is V-shaped (each monotone branch extended by +inf), i.e. bitonic,
    so it needs only a log2(m)-round bitonic MERGE, not a full sort.
    """
    mask0 = weights_present
    count0 = jnp.sum(mask0.astype(jnp.int32), axis=0)
    # masked → +inf sorts to the tail; entries [0, count0) are the live
    # candidates in ascending value order (power-of-2 pad joins the
    # +inf tail and is dropped from every rank/count by construction)
    sv = bitonic_sort_axis0(pad_pow2_inf(
        jnp.where(mask0, estimates.astype(jnp.float32), jnp.inf)))
    iota = jax.lax.broadcasted_iota(jnp.int32, sv.shape, 0)

    def rank2(arr, r1, r2, cnt):
        """(arr@r1 + arr@r2)/2 with cnt>0 guard — the even-averaging
        median, via compare+sum instead of per-pixel gathers."""
        p = jnp.sum(jnp.where(iota == r1[None], arr, 0.0), axis=0)
        q = jnp.sum(jnp.where(iota == r2[None], arr, 0.0), axis=0)
        return jnp.where(cnt > 0, (p + q) * 0.5, 0.0)

    lo = jnp.zeros(sv.shape[1:], jnp.int32)
    hi = count0
    stopped = jnp.zeros(sv.shape[1:], bool)
    for _ in range(iterations):
        cnt = hi - lo
        med = rank2(sv, lo + jnp.maximum((cnt - 1) // 2, 0),
                    lo + jnp.maximum(cnt // 2, 0), cnt)
        window = (iota >= lo[None]) & (iota < hi[None])
        # V-shaped in sorted-v order (dec to the median position, inc
        # after, ±inf padding extending both branches) → bitonic, one
        # merge sorts it
        dv = bitonic_merge_axis0(
            jnp.where(window, jnp.abs(sv - med[None]), jnp.inf))
        mad = rank2(dv, jnp.maximum((cnt - 1) // 2, 0),
                    jnp.maximum(cnt // 2, 0), cnt)
        sigma = jnp.maximum(mad * MAD_TO_SIGMA, 1e-10)
        active = (cnt >= 3) & ~stopped
        vlo = med - sigma_low * sigma
        vhi = med + sigma_high * sigma
        cut_lo = jnp.sum((window & (sv < vlo[None])).astype(jnp.int32),
                         axis=0)
        cut_hi = jnp.sum((window & (sv > vhi[None])).astype(jnp.int32),
                         axis=0)
        removed = cut_lo + cut_hi
        lo = jnp.where(active, lo + cut_lo, lo)
        hi = jnp.where(active, hi - cut_hi, hi)
        stopped = stopped | (active & (removed == 0))

    final_cnt = hi - lo
    window = (iota >= lo[None]) & (iota < hi[None])
    mean_kept = jnp.sum(jnp.where(window, sv, 0.0), axis=0) / jnp.maximum(
        final_cnt.astype(jnp.float32), 1.0)
    mean_all = jnp.sum(jnp.where(iota < count0[None], sv, 0.0),
                       axis=0) / jnp.maximum(count0.astype(jnp.float32), 1.0)
    out = jnp.where(final_cnt > 0, mean_kept,
                    jnp.where(count0 > 0, mean_all, 0.0))
    return out, count0 - final_cnt  # (image, per-pixel rejected map)


@partial(jax.jit,
         static_argnames=("scale", "pixfrac", "kernel", "out_rows",
                          "out_cols", "sigma_low", "sigma_high",
                          "sigma_iterations"))
def _drizzle_kernel(stack, d_ys, d_xs, scale: float, pixfrac: float,
                    kernel: DrizzleKernel, out_rows: int, out_cols: int,
                    sigma_low: float, sigma_high: float,
                    sigma_iterations: int):
    def one(frame, dy, dx):
        return _drizzle_frame(frame, dy, dx, scale, pixfrac, kernel,
                              out_rows, out_cols)

    sums, weights = jax.vmap(one)(stack, d_ys, d_xs)
    present = weights > 1e-12
    estimates = jnp.where(present, sums / jnp.where(present, weights, 1.0),
                          0.0)
    image, rej_map = _clip_mean_frames(estimates, present, sigma_low,
                                       sigma_high, sigma_iterations)
    weight_map = jnp.sum(weights, axis=0)
    return image, weight_map, jnp.sum(rej_map)


@dataclass
class DrizzleResult:
    image: jax.Array
    weight_map: jax.Array
    frame_count: int
    output_scale: float
    input_dims: Tuple[int, int]
    output_dims: Tuple[int, int]
    offsets: List[Tuple[float, float]]
    rejected_pixels: int


def drizzle_stack(images: Sequence, config: DrizzleConfig = DrizzleConfig(),
                  progress: Optional[ProgressHandle] = None,
                  exact: bool = True) -> DrizzleResult:
    """Full drizzle driver (drizzle.rs:226-346).

    ``exact=True`` (default) uses the capped-candidate-list kernel that
    reproduces the reference's per-contribution clip finalize exactly;
    ``exact=False`` uses the cheaper pre-averaging approximation (one
    estimate per frame per output pixel) — fine when contributions
    rarely overlap (pixfrac·scale ≲ 1), documented delta otherwise."""
    if not images:
        raise InvalidInput("No images to drizzle")
    if len(images) < 2:
        raise InvalidInput(
            "Drizzle requires at least 2 frames for sub-pixel reconstruction")

    dims = [(int(i.shape[0]), int(i.shape[1])) for i in images]
    min_rows = min(d[0] for d in dims)
    min_cols = min(d[1] for d in dims)
    max_rows = max(d[0] for d in dims)
    max_cols = max(d[1] for d in dims)
    tolerance = int(max(min_rows, min_cols) * 0.05)
    if (max_rows - min_rows) > tolerance or (max_cols - min_cols) > tolerance:
        raise InvalidInput(
            f"Frame dimensions vary too much (rows: {max_rows - min_rows}px, "
            f"cols: {max_cols - min_cols}px, tolerance: {tolerance}px)")

    cropped = [jnp.asarray(img)[:min_rows, :min_cols] for img in images]
    scale = min(max(config.scale, 1.0), 4.0)
    pixfrac = min(max(config.pixfrac, 0.1), 1.0)
    out_rows = math.ceil(min_rows * scale)
    out_cols = math.ceil(min_cols * scale)

    reference = cropped[0]
    offsets: List[Tuple[float, float]] = [(0.0, 0.0)]
    if config.align:
        from astroburst_tpu.dtypes import AlignmentMethod
        for i, target in enumerate(cropped[1:], 1):
            if config.alignment_method == AlignmentMethod.PHASE_CORRELATION:
                pc = phase_correlate(reference, target)
                if is_low_confidence(pc.confidence):
                    dy, dx, _ = estimate_offset(reference, target,
                                                AlignMethod.AFFINE)
                    offsets.append((dx, dy))
                else:
                    offsets.append((pc.dx, pc.dy))
            else:  # ZNCC → Affine reroute (drizzle.rs:302-306)
                dy, dx, _ = estimate_offset(reference, target,
                                            AlignMethod.AFFINE)
                offsets.append((dx, dy))
            if progress is not None:
                progress.tick_with_stage(f"align {i}/{len(cropped) - 1}")
                progress.check_cancelled()
    else:
        offsets.extend([(0.0, 0.0)] * (len(cropped) - 1))

    stack = jnp.stack(cropped)
    d_xs = jnp.asarray([-dx for dx, _dy in offsets], jnp.float32)
    d_ys = jnp.asarray([-dy for _dx, dy in offsets], jnp.float32)
    if progress is not None:
        progress.tick_with_stage("drizzling")
    # Auto-route: when no output pixel can receive more than one
    # contribution per frame, the pre-averaging kernel is *identical*
    # to the capped push-list finalize (per-frame pre-average of a
    # single contribution is that contribution; the cap ≥ 2·n never
    # binds at ≤ n candidates; weight maps coincide) and runs without
    # the n·taps² candidate axis. One contribution per axis is
    # guaranteed iff the input-center support window (1 + pixfrac·scale
    # wide, centers spaced `scale` apart) never holds two centers:
    # 1 + pixfrac·scale ≤ scale. SQUARE only — the gaussian/lanczos
    # push range is wider than their weight support, so membership of
    # near-zero-weight pushes differs between the two forms.
    if (exact and config.kernel == DrizzleKernel.SQUARE
            and 1.0 + pixfrac * scale <= scale + 1e-9):
        exact = False
    kernel_fn = _drizzle_kernel_exact if exact else _drizzle_kernel
    image, weight_map, rejected = kernel_fn(
        stack, d_ys, d_xs, scale, pixfrac, config.kernel, out_rows,
        out_cols, config.sigma_low, config.sigma_high,
        config.sigma_iterations)
    return DrizzleResult(
        image=image, weight_map=weight_map, frame_count=len(cropped),
        output_scale=scale, input_dims=(min_rows, min_cols),
        output_dims=(out_rows, out_cols), offsets=offsets,
        rejected_pixels=int(rejected))
