"""Oracle for the stacking shift (src-tauri/src/core/stacking/align.rs:36-57
over core/imaging/sampling.rs Catmull-Rom with clamped taps)."""

import math

import numpy as np


def _catmull_rom(t):
    """sampling.rs:4-13."""
    a = abs(t)
    if a <= 1.0:
        return a * a * (1.5 * a - 2.5) + 1.0
    if a <= 2.0:
        return a * (a * (2.5 - 0.5 * a) - 4.0) + 2.0
    return 0.0


def ref_shift_rows(img, dy, dx, r0, r1):
    """Rows [r0, r1) of ``img`` shifted by (dy, dx): out[y, x] =
    bicubic(img, y + dy, x + dx) with taps clamped to the plane, 0 where
    the source center falls outside [-0.5, n - 0.5], and the raw image
    for a shift below 1e-12 on both axes."""
    img = np.asarray(img, np.float64)
    h, w = img.shape
    if abs(dy) < 1e-12 and abs(dx) < 1e-12:
        return img[r0:r1].astype(np.float32)
    ky, kx = math.floor(dy), math.floor(dx)
    fy, fx = dy - ky, dx - kx
    wy = [_catmull_rom(fy - (j - 1)) for j in range(4)]
    wx = [_catmull_rom(fx - (i - 1)) for i in range(4)]
    cols = [np.clip(np.arange(w) + kx + i - 1, 0, w - 1) for i in range(4)]
    out = np.zeros((r1 - r0, w))
    for y in range(r0, r1):
        rows = [min(max(y + ky + j - 1, 0), h - 1) for j in range(4)]
        tmp = sum(wy[j] * img[rows[j]] for j in range(4))
        val = sum(wx[i] * tmp[cols[i]] for i in range(4))
        sy = y + dy
        sx = np.arange(w) + dx
        inside = (sy >= -0.5) & (sy <= h - 0.5) & (sx >= -0.5) & (sx <= w - 0.5)
        out[y - r0] = np.where(inside, val, 0.0)
    return out.astype(np.float32)
