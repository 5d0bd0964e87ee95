"""Oracle for src-tauri/src/core/stacking/drizzle.rs:14-224.

Full scatter-side accumulator: per output pixel a value list capped at
max(2·n_frames, 4) entries in deterministic push order (frame, then
input row asc, col asc, output oy asc, ox asc — drizzle.rs:60-118),
finalized with the per-pixel median/MAD sigma clip of the individual
contributions (drizzle.rs:121-195).

This is the exact semantics the gather-side reformulation
(astroburst_tpu/stacking/drizzle.py) approximates by pre-averaging
same-frame contributions; tests/test_reference_impl.py quantifies that
delta on adversarial configs.
"""

import math

import numpy as np


def _clamp_index(i, n):
    """boundary.rs clamp_index."""
    return min(max(i, 0), n - 1)


def _overlap_area(ax1, ay1, ax2, ay2, bx1, by1, bx2, by2):
    """drizzle.rs:197-204."""
    ox = max(min(ax2, bx2) - max(ax1, bx1), 0.0)
    oy = max(min(ay2, by2) - max(ay1, by1), 0.0)
    return ox * oy


def _lanczos3(x):
    """drizzle.rs:207-217."""
    if abs(x) < 1e-12:
        return 1.0
    if abs(x) >= 3.0:
        return 0.0
    pi_x = math.pi * x
    return (math.sin(pi_x) / pi_x) * (math.sin(pi_x / 3.0) / (pi_x / 3.0))


def _median_f32(vals):
    """median_f32_mut (math/median.rs:46-63): even n averages middles."""
    v = np.sort(np.asarray(vals, np.float32))
    n = len(v)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2 == 0:
        return (float(v[mid - 1]) + float(v[mid])) / 2.0
    return float(v[mid])


def ref_drizzle(frames, offsets, scale, pixfrac, kernel="square",
                sigma_low=3.0, sigma_high=3.0, sigma_iterations=3):
    """drizzle_frame + finalize → (image, weights, rejected).

    frames: list of 2D float32 arrays (same dims); offsets: list of
    (dx, dy) applied as (i + d)·scale like drizzle.rs:71-72.
    """
    in_rows, in_cols = frames[0].shape
    out_rows = math.ceil(in_rows * scale)
    out_cols = math.ceil(in_cols * scale)
    n_frames = len(frames)
    mpp = max(n_frames * 2, 4)
    storage = [[] for _ in range(out_rows * out_cols)]
    weights = np.zeros(out_rows * out_cols, np.float64)

    for frame, (dx, dy) in zip(frames, offsets):
        src = np.asarray(frame, np.float32)
        for iy in range(in_rows):
            for ix in range(in_cols):
                val = src[iy, ix]
                if not np.isfinite(val):
                    continue
                cx = (ix + dx) * scale
                cy = (iy + dy) * scale
                half = pixfrac * scale * 0.5
                ox_min = _clamp_index(math.floor(cx - half), out_cols)
                ox_max = _clamp_index(math.ceil(cx + half), out_cols)
                oy_min = _clamp_index(math.floor(cy - half), out_rows)
                oy_max = _clamp_index(math.ceil(cy + half), out_rows)
                for oy in range(oy_min, oy_max + 1):
                    for ox in range(ox_min, ox_max + 1):
                        if kernel == "square":
                            w = _overlap_area(cx - half, cy - half,
                                              cx + half, cy + half,
                                              ox, oy, ox + 1.0, oy + 1.0)
                        elif kernel == "gaussian":
                            dist2 = ((ox + 0.5 - cx) ** 2
                                     + (oy + 0.5 - cy) ** 2)
                            sigma = max(half, 0.5)
                            w = math.exp(-dist2 / (2.0 * sigma * sigma))
                        else:  # lanczos3
                            w = (_lanczos3(abs(ox + 0.5 - cx))
                                 * _lanczos3(abs(oy + 0.5 - cy)))
                        if w > 1e-12:
                            idx = oy * out_cols + ox
                            if len(storage[idx]) < mpp:
                                storage[idx].append(np.float32(val))
                                weights[idx] += w

    img = np.zeros(out_rows * out_cols, np.float32)
    total_rejected = 0
    for i, vals in enumerate(storage):
        count = len(vals)
        if count == 0:
            continue
        if count == 1:
            img[i] = vals[0]
            continue
        active = list(vals)
        for _ in range(sigma_iterations):
            if len(active) < 3:
                break
            med = _median_f32(active)
            mad = _median_f32([abs(v - med) for v in active])
            sigma = np.float32(max(mad * 1.4826, 1e-10))
            before = len(active)
            active = [v for v in active
                      if (-sigma_low * sigma <= np.float32(v - med)
                          <= sigma_high * sigma)]
            removed = before - len(active)
            total_rejected += removed
            if removed == 0:
                break
        if not active:
            img[i] = np.float32(
                np.asarray(vals, np.float64).sum() / count)
        else:
            img[i] = np.float32(
                np.asarray(active, np.float64).sum() / len(active))
    return (img.reshape(out_rows, out_cols),
            weights.astype(np.float32).reshape(out_rows, out_cols),
            total_rejected)
