"""Resampling primitives: subpixel shift, area downsample.

Formulation notes (see DESIGN.md): a *global* subpixel translation
has constant Catmull-Rom weights, so bicubic shift = 8 clamped
whole-row/column axis-takes + weighted adds (separable), fully
traceable (dy/dx can be device scalars). Area downsampling with
non-integer ratios is two dense averaging matmuls.

Reference semantics: core/imaging/sampling.rs (Catmull-Rom, clamped
taps), core/stacking/align.rs:36-57 (out-of-bounds → 0, the ±0.5
boundary rule), core/alignment/downsample.rs (NaN-aware box average).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


def catmull_rom(t):
    """Catmull-Rom kernel, vectorized (sampling.rs:4-13)."""
    a = jnp.abs(t)
    inner = a * a * (1.5 * a - 2.5) + 1.0
    outer = a * (a * (2.5 - 0.5 * a) - 4.0) + 2.0
    return jnp.where(a <= 1.0, inner, jnp.where(a <= 2.0, outer, 0.0))


def _axis_take_clamped(x, shift, offset: int, axis: int):
    n = x.shape[axis]
    idx = jnp.clip(jnp.arange(n) + shift + offset, 0, n - 1)
    return jnp.take(x, idx, axis=axis)


def shift_bicubic(img: jax.Array, dy, dx) -> jax.Array:
    """out[y, x] = bicubic(img, y + dy, x + dx); zero where the source
    center falls outside [-0.5, n-0.5] (align.rs:36-57).

    dy/dx may be traced scalars — the whole op lives inside jit.
    """
    dy = jnp.asarray(dy, jnp.float32)
    dx = jnp.asarray(dx, jnp.float32)
    ky = jnp.floor(dy).astype(jnp.int32)
    kx = jnp.floor(dx).astype(jnp.int32)
    fy = dy - ky.astype(jnp.float32)
    fx = dx - kx.astype(jnp.float32)

    rows, cols = img.shape[-2], img.shape[-1]
    axis_y = img.ndim - 2
    axis_x = img.ndim - 1

    tmp = None
    for j in range(4):
        w = catmull_rom(fy - (j - 1))
        term = w * _axis_take_clamped(img, ky, j - 1, axis_y)
        tmp = term if tmp is None else tmp + term
    out = None
    for i in range(4):
        w = catmull_rom(fx - (i - 1))
        term = w * _axis_take_clamped(tmp, kx, i - 1, axis_x)
        out = term if out is None else out + term

    y = jnp.arange(rows, dtype=jnp.float32)[:, None]
    x = jnp.arange(cols, dtype=jnp.float32)[None, :]
    sy = y + dy
    sx = x + dx
    inside = ((sy >= -0.5) & (sy <= rows - 0.5) &
              (sx >= -0.5) & (sx <= cols - 0.5))
    shifted = jnp.where(inside, out, 0.0)
    # the reference returns the image untouched for a true zero shift
    # (align.rs:37-39) — without this, zero-weight taps bleed NaN
    # around dead pixels on the reference frame (0·NaN = NaN)
    exact_zero = (jnp.abs(dy) < 1e-12) & (jnp.abs(dx) < 1e-12)
    return jnp.where(exact_zero, img, shifted)


def shift_bicubic_batch(stack: jax.Array, dys, dxs) -> jax.Array:
    """Per-frame global shifts over a [N, H, W] stack."""
    return jax.vmap(shift_bicubic)(stack, dys, dxs)


@lru_cache(maxsize=None)
def _box_edges(n_in: int, n_out: int):
    """Per-output-box [y0, y1) bounds, host f64 exact
    (downsample.rs:19-27 edge semantics)."""
    scale = n_in / n_out
    y0 = np.empty(n_out, np.float32)
    y1 = np.empty(n_out, np.float32)
    for o in range(n_out):
        y0[o] = min(max(int(np.floor(o * scale)), 0), n_in - 1)
        y1_raw = int(np.ceil((o + 1) * scale))
        y1[o] = 0 if y1_raw <= 0 else min(y1_raw, n_in)
    return y0, y1


def _box_matrix_dev(n_in: int, n_out: int) -> jax.Array:
    """[n_out, n_in] 0/1 box-membership matrix built ON DEVICE from
    the tiny host edge vectors — a host-built dense matrix would embed
    an n_out·n_in constant in the program (225 MB for a full-res JWST
    plane → 4096 preview)."""
    y0_np, y1_np = _box_edges(n_in, n_out)
    y0 = jnp.asarray(y0_np)[:, None]
    y1 = jnp.asarray(y1_np)[:, None]
    j = jnp.arange(n_in, dtype=jnp.float32)[None, :]
    return ((j >= y0) & (j < y1)).astype(jnp.float32)


@partial(jax.jit, static_argnames=("out_rows", "out_cols"))
def area_downsample(img: jax.Array, out_rows: int, out_cols: int) -> jax.Array:
    """NaN-aware box-average downsample as two matmuls."""
    in_rows, in_cols = img.shape
    if (in_rows, in_cols) == (out_rows, out_cols):
        return img
    my = _box_matrix_dev(in_rows, out_rows)
    mx = _box_matrix_dev(in_cols, out_cols)
    finite = jnp.isfinite(img)
    vals = jnp.where(finite, img, 0.0)
    s = jnp.matmul(jnp.matmul(my, vals, precision=_HIGHEST), mx.T,
                   precision=_HIGHEST)
    c = jnp.matmul(jnp.matmul(my, finite.astype(jnp.float32),
                              precision=_HIGHEST), mx.T, precision=_HIGHEST)
    return jnp.where(c > 0, s / jnp.maximum(c, 1.0), 0.0)
