"""Polynomial background extraction.

Reference: src-tauri/src/core/imaging/background.rs — grid sampling
(3–32 cells/side) with per-cell medians, global sigma-clip retention of
cell medians, 2D polynomial fit of degree 1–5 (≤21 terms) via ridge-
regularized normal equations, model evaluation, subtract/divide with
the model median as the restored pedestal, RMS residual.

Split: per-cell medians and the model evaluation/application run on
device; the ≤1024-sample retention loop and the ≤21×21 normal-equation
solve are host f64 (they are not pixel work).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.constants import MAD_TO_SIGMA
from astroburst_tpu.errors import InvalidInput
from astroburst_tpu.ops.quantile import masked_rank_values
from astroburst_tpu.runtime.progress import ProgressHandle

MAX_POLY_TERMS = 21


@dataclass
class BackgroundConfig:
    grid_size: int = 8
    poly_degree: int = 3
    sigma_clip: float = 2.5
    iterations: int = 3
    mode: str = "subtract"  # "subtract" | "divide"


@dataclass
class BackgroundResult:
    model: jax.Array
    corrected: jax.Array
    sample_count: int
    rms_residual: float


def min_samples_for_degree(degree: int) -> int:
    n_terms = (degree + 1) * (degree + 2) // 2
    return n_terms + 2


def _median_pair(flat_inf, cnt):
    """Even-averaging median (median_f32_mut) via compare-count."""
    n = cnt.astype(jnp.float32)
    r = jnp.floor(n / 2.0) + 1.0
    mx = jnp.max(jnp.where(jnp.isfinite(flat_inf), flat_inf, -jnp.inf))
    mn = jnp.min(flat_inf)
    mn = jnp.where(jnp.isfinite(mn), mn, 0.0)
    mx = jnp.where(jnp.isfinite(mx), mx, 1.0)
    v = masked_rank_values(flat_inf, r[None], mn, mx)[0]
    return jnp.where(cnt > 0, v, 0.0)


@partial(jax.jit, static_argnames=("grid", "cell_h", "cell_w"))
def _cell_medians_kernel(image, grid: int, cell_h: int, cell_w: int):
    """Per-cell inner-region medians + invalid fractions + global
    median/sigma (background.rs:117-190)."""
    margin_h = cell_h // 4
    margin_w = cell_w // 4
    inner_h = cell_h - 2 * margin_h
    inner_w = cell_w - 2 * margin_w
    # [grid, grid, inner_h, inner_w] via slicing the grid region
    region = image[:grid * cell_h, :grid * cell_w]
    cells = region.reshape(grid, cell_h, grid, cell_w).transpose(0, 2, 1, 3)
    inner = cells[:, :, margin_h:margin_h + inner_h,
                  margin_w:margin_w + inner_w]
    flat = inner.reshape(grid * grid, inner_h * inner_w)
    valid = jnp.isfinite(flat) & (flat > 1e-7)
    counts = jnp.sum(valid.astype(jnp.int32), axis=1)
    invalid_frac = 1.0 - counts.astype(jnp.float32) / (inner_h * inner_w)
    svals = jnp.sort(jnp.where(valid, flat, jnp.inf), axis=1)
    # even-averaging median per cell via the two middle order stats
    i1 = jnp.maximum((counts - 1) // 2, 0)
    i2 = jnp.maximum(counts // 2, 0)
    v1 = jnp.take_along_axis(svals, i1[:, None], axis=1)[:, 0]
    v2 = jnp.take_along_axis(svals, i2[:, None], axis=1)[:, 0]
    cell_median = jnp.where(counts > 0, (v1 + v2) * 0.5, 0.0)

    gflat = image.reshape(-1)
    gvalid = jnp.isfinite(gflat) & (gflat > 0.0)
    gcnt = jnp.sum(gvalid.astype(jnp.int32))
    gmed = _median_pair(jnp.where(gvalid, gflat, jnp.inf), gcnt)
    gdev = jnp.where(gvalid, jnp.abs(gflat - gmed), jnp.inf)
    gmad = _median_pair(gdev, gcnt)
    # ONE packed row: one host read instead of five (counts ≤ cell
    # area, exact in f32)
    return jnp.concatenate([cell_median, invalid_frac,
                            counts.astype(jnp.float32),
                            jnp.stack([gmed, gmad])])


def _poly_basis(ny: np.ndarray, nx: np.ndarray, degree: int) -> np.ndarray:
    """[n, terms] with the reference's term ordering
    (background.rs:218-228: total degree ascending, y-power descending)."""
    cols = []
    for total in range(degree + 1):
        for y_pow in range(total, -1, -1):
            x_pow = total - y_pow
            cols.append((ny ** y_pow) * (nx ** x_pow))
    return np.stack(cols, axis=1)


@lru_cache(maxsize=None)
def _model_kernel(rows: int, cols: int, degree: int):
    """Jitted model evaluator, cached per shape/degree — defining the
    jit inside `_evaluate_model` would recompile it on every call."""
    @jax.jit
    def kernel(c):
        ny = (jnp.arange(rows, dtype=jnp.float32) / rows - 0.5)[:, None]
        nx = (jnp.arange(cols, dtype=jnp.float32) / cols - 0.5)[None, :]
        out = jnp.zeros((rows, cols), jnp.float32)
        idx = 0
        for total in range(degree + 1):
            for y_pow in range(total, -1, -1):
                x_pow = total - y_pow
                out = out + c[idx] * (ny ** y_pow) * (nx ** x_pow)
                idx += 1
        return out

    return kernel


def _evaluate_model(coeffs: np.ndarray, rows: int, cols: int,
                    degree: int) -> jax.Array:
    return _model_kernel(rows, cols, degree)(
        jnp.asarray(coeffs, jnp.float32))


@jax.jit
def _apply_subtract(image, model, model_median):
    return image - model + model_median


@jax.jit
def _apply_divide(image, model, model_median):
    safe = jnp.abs(model) > 1e-10
    return jnp.where(safe, image / jnp.where(safe, model, 1.0) * model_median,
                     image)


@partial(jax.jit, static_argnames=("divide",))
def _finish_kernel(image, model, divide: bool):
    """Model median + correction as ONE program: run eagerly, every op
    of the compare-count median would be its own un-fused dispatch."""
    mflat = model.reshape(-1)
    mvalid = jnp.isfinite(mflat) & (mflat > 0.0)
    mcnt = jnp.sum(mvalid.astype(jnp.int32))
    model_median = _median_pair(jnp.where(mvalid, mflat, jnp.inf), mcnt)
    if divide:
        return _apply_divide(image, model, model_median)
    return _apply_subtract(image, model, model_median)


def extract_background(image, config: BackgroundConfig = BackgroundConfig(),
                       progress: Optional[ProgressHandle] = None
                       ) -> BackgroundResult:
    img = jnp.asarray(image, jnp.float32)
    rows, cols = img.shape
    grid = min(max(config.grid_size, 3), 32)
    degree = min(max(config.poly_degree, 1), 5)
    cell_h = rows // grid
    cell_w = cols // grid
    if cell_h < 4 or cell_w < 4:
        raise InvalidInput(f"Image too small for grid_size={grid}")

    if progress is not None:
        progress.tick_with_stage("sampling background")
    packed = np.asarray(_cell_medians_kernel(img, grid, cell_h, cell_w))
    nc = grid * grid
    cell_med = packed[:nc].astype(np.float64)
    invalid_frac = packed[nc:2 * nc]
    counts = packed[2 * nc:3 * nc].astype(np.int64)
    gmed = float(packed[3 * nc])
    sigma = float(packed[3 * nc + 1]) * MAD_TO_SIGMA

    margin_h, margin_w = cell_h // 4, cell_w // 4
    inner_h = cell_h - 2 * margin_h
    inner_w = cell_w - 2 * margin_w

    lo = gmed - config.sigma_clip * sigma
    hi = gmed + config.sigma_clip * sigma
    samples: List[Tuple[float, float, float]] = []
    for gy in range(grid):
        for gx in range(grid):
            i = gy * grid + gx
            if counts[i] == 0 or invalid_frac[i] > 0.3:
                continue
            v = cell_med[i]
            if lo <= v <= hi:
                cy = gy * cell_h + margin_h + inner_h // 2
                cx = gx * cell_w + margin_w + inner_w // 2
                samples.append((float(cy), float(cx), float(v)))

    # iterative retention on sample medians (background.rs:192-209)
    def _host_median(vals):
        v = np.sort(np.asarray(vals, np.float32))
        n = len(v)
        mid = n // 2
        if n == 0:
            return 0.0
        return float(v[mid]) if n % 2 else (float(v[mid - 1]) +
                                            float(v[mid])) / 2.0

    for _ in range(1, config.iterations):
        if len(samples) < min_samples_for_degree(degree):
            break
        vals = [s[2] for s in samples]
        med = _host_median(vals)
        mad = _host_median([abs(v - med) for v in vals])
        sig = mad * MAD_TO_SIGMA
        lo2, hi2 = med - config.sigma_clip * sig, med + config.sigma_clip * sig
        samples = [s for s in samples if lo2 <= s[2] <= hi2]

    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("fitting polynomial surface")
    if len(samples) < min_samples_for_degree(degree):
        raise InvalidInput(
            f"Not enough background samples ({len(samples)}) for polynomial "
            f"degree {degree}")

    s = np.asarray(samples, np.float64)
    ny = s[:, 0] / rows - 0.5
    nx = s[:, 1] / cols - 0.5
    basis = _poly_basis(ny, nx, degree)
    ata = basis.T @ basis + 1e-8 * np.eye(basis.shape[1])
    coeffs = np.linalg.solve(ata, basis.T @ s[:, 2])

    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("generating model")
    model = _evaluate_model(coeffs, rows, cols, degree)

    if progress is not None:
        progress.tick_with_stage("applying correction")
    corrected = _finish_kernel(img, model, config.mode == "divide")

    pred = basis @ coeffs
    rms = float(np.sqrt(np.mean((s[:, 2] - pred) ** 2)))
    return BackgroundResult(model=model, corrected=corrected,
                            sample_count=len(samples), rms_residual=rms)
