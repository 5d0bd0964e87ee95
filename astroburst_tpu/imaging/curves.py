"""Levels and spline tone curves.

Reference: src-tauri/src/core/imaging/curves.rs — levels
(black/gamma/white), Fritsch–Carlson monotone cubic Hermite tone
curves baked into a 4096-entry LUT.

Design: instead of a LUT gather we quantize the input to the LUT grid (floor(v·4095)/4095) and
evaluate the Hermite spline directly — segment selection by masked
sums over the ≤K control points. Bit-for-bit the same values the LUT
would return, with zero gathers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

LUT_SIZE = 4096


@dataclass(frozen=True)
class LevelsParams:
    black: float = 0.0
    gamma: float = 1.0
    white: float = 1.0

    def is_identity(self) -> bool:
        return (abs(self.black) < 1e-7 and abs(self.gamma - 1.0) < 1e-7
                and abs(self.white - 1.0) < 1e-7)


@jax.jit
def _levels_kernel(x, black, inv_range, inv_gamma):
    norm = jnp.clip((x - black) * inv_range, 0.0, 1.0)
    out = jnp.power(norm, inv_gamma)
    return jnp.where(jnp.isfinite(x) & (x >= 0.0), out, 0.0).astype(jnp.float32)


def apply_levels(data, params: LevelsParams) -> jax.Array:
    """black/gamma/white levels; invalid (non-finite or <0) → 0
    (curves.rs:31-52)."""
    data = jnp.asarray(data)
    if params.is_identity():
        return data
    rng = max(params.white - params.black, 1e-15)
    inv_gamma = 1.0 / min(max(params.gamma, 0.01), 10.0)
    return _levels_kernel(data, jnp.float32(params.black),
                          jnp.float32(1.0 / rng), jnp.float32(inv_gamma))


def apply_levels_rgb(r, g, b, lr: LevelsParams, lg: LevelsParams,
                     lb: LevelsParams):
    return apply_levels(r, lr), apply_levels(g, lg), apply_levels(b, lb)


def fritsch_carlson_tangents(pts: np.ndarray) -> np.ndarray:
    """Monotone cubic Hermite tangents (curves.rs:112-156), host f64."""
    n = len(pts)
    if n < 2:
        return np.zeros(n)
    if n == 2:
        slope = (pts[1, 1] - pts[0, 1]) / max(pts[1, 0] - pts[0, 0], 1e-15)
        return np.array([slope, slope])
    dx = np.maximum(np.diff(pts[:, 0]), 1e-15)
    slopes = np.diff(pts[:, 1]) / dx
    m = np.zeros(n)
    m[0] = slopes[0]
    m[-1] = slopes[-1]
    for i in range(1, n - 1):
        if np.sign(slopes[i - 1]) != np.sign(slopes[i]):
            m[i] = 0.0
        else:
            m[i] = (slopes[i - 1] + slopes[i]) * 0.5
    for i in range(n - 1):
        if abs(slopes[i]) < 1e-15:
            m[i] = 0.0
            m[i + 1] = 0.0
            continue
        alpha = m[i] / slopes[i]
        beta = m[i + 1] / slopes[i]
        tau = alpha * alpha + beta * beta
        if tau > 9.0:
            s = 3.0 / np.sqrt(tau)
            m[i] = s * alpha * slopes[i]
            m[i + 1] = s * beta * slopes[i]
    return m


def _prepare_points(points: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Sort, dedup, anchor at (0,0)/(1,1) (curves.rs:71-83)."""
    pts = sorted(points, key=lambda p: p[0])
    dedup: List[Tuple[float, float]] = []
    for p in pts:
        if dedup and abs(p[0] - dedup[-1][0]) < 1e-9:
            continue
        dedup.append(tuple(p))
    if not dedup or dedup[0][0] > 1e-6:
        dedup.insert(0, (0.0, 0.0))
    if dedup[-1][0] < 1.0 - 1e-6:
        dedup.append((1.0, 1.0))
    return np.asarray(dedup, dtype=np.float64)


def is_identity_curve(points: Sequence[Tuple[float, float]]) -> bool:
    """curves.rs:96-107."""
    if len(points) > 2:
        return False
    if len(points) == 0:
        return True
    if len(points) == 1:
        return abs(points[0][0] - points[0][1]) < 1e-6
    near_start = abs(points[0][0]) < 1e-6 and abs(points[0][1]) < 1e-6
    near_end = (abs(points[1][0] - 1.0) < 1e-6 and
                abs(points[1][1] - 1.0) < 1e-6)
    return near_start and near_end


class SplineCurve:
    """Monotone Hermite tone curve with LUT-grid quantization."""

    def __init__(self, points: Sequence[Tuple[float, float]]):
        pts = _prepare_points(points)
        self.pts = pts
        self.tangents = fritsch_carlson_tangents(pts)

    def _eval_traced(self, x):
        """Hermite evaluation at traced x ∈ [0,1]; segment selection by
        masked accumulation over the ≤K control points."""
        pts = self.pts
        tan = self.tangents
        n = len(pts)
        out = jnp.zeros_like(x)
        # endpoint clamps (curves.rs:160-162)
        below = x <= pts[0, 0]
        above = x >= pts[n - 1, 0]
        for seg in range(n - 1):
            x0, y0 = pts[seg]
            x1, y1 = pts[seg + 1]
            dx = max(x1 - x0, 1e-15)
            t = (x - x0) / dx
            t2 = t * t
            t3 = t2 * t
            h00 = 2.0 * t3 - 3.0 * t2 + 1.0
            h10 = t3 - 2.0 * t2 + t
            h01 = -2.0 * t3 + 3.0 * t2
            h11 = t3 - t2
            val = (h00 * y0 + h10 * dx * tan[seg] + h01 * y1 +
                   h11 * dx * tan[seg + 1])
            inseg = (x >= x0) & (x < x1)
            out = jnp.where(inseg, val, out)
        out = jnp.where(below, pts[0, 1], out)
        out = jnp.where(above, pts[n - 1, 1], out)
        return jnp.clip(out, 0.0, 1.0)

    def apply(self, data) -> jax.Array:
        """Quantize to the 4096 LUT grid, then evaluate the spline —
        identical values to the reference's LUT path (curves.rs:108)."""
        data = jnp.asarray(data)
        q = jnp.floor(jnp.clip(data, 0.0, 1.0) * (LUT_SIZE - 1.0))
        x = q / (LUT_SIZE - 1.0)
        out = self._eval_traced(x).astype(jnp.float32)
        return jnp.where(jnp.isfinite(data) & (data >= 0.0), out, 0.0)

    def lut(self) -> np.ndarray:
        """Materialized 4096-entry LUT (for tests/clients)."""
        x = np.arange(LUT_SIZE) / (LUT_SIZE - 1.0)
        return np.asarray(self._eval_traced(jnp.asarray(x, jnp.float32)),
                          dtype=np.float32)


def apply_curve(data, curve: SplineCurve) -> jax.Array:
    return curve.apply(data)


def apply_curve_rgb(r, g, b, cr: SplineCurve, cg: SplineCurve,
                    cb: SplineCurve):
    return cr.apply(r), cg.apply(g), cb.apply(b)
