"""Deep-zoom tile pyramid.

Reference: src-tauri/src/infra/render/tiles.rs — NaN-aware 2× area
downsample, per-tile 8-bit render against global 0.1%/99.9% percentile
bounds, mono/RGB variants.

Design: each pyramid level is quantized to u8 in one device op
(masked 2×2 mean + global-bounds scale), then host code slices the
level into PNG tiles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.io.png import save_gray_png, save_rgb_png
from astroburst_tpu.ops.quantile import masked_rank_values


@dataclass
class TileParams:
    tile_size: int = 256


@dataclass
class TileLevel:
    level: int
    width: int
    height: int
    cols: int
    rows: int
    scale_factor: float

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class TilePyramid:
    tile_size: int
    original_width: int
    original_height: int
    levels: List[TileLevel]
    base_dir: str

    def to_dict(self) -> dict:
        d = self.__dict__.copy()
        d["levels"] = [lv.to_dict() for lv in self.levels]
        return d


@jax.jit
def downsample_2x(data: jax.Array) -> jax.Array:
    """NaN-aware 2× box downsample with edge clamping (tiles.rs:40-70)."""
    rows, cols = data.shape
    pr = rows % 2
    pc = cols % 2
    # replicate the last row/col like the min(y0+1, rows-1) clamp
    padded = jnp.pad(data, ((0, pr), (0, pc)), mode="edge")
    blocks = padded.reshape(padded.shape[0] // 2, 2,
                            padded.shape[1] // 2, 2)
    finite = jnp.isfinite(blocks)
    s = jnp.sum(jnp.where(finite, blocks, 0.0), axis=(1, 3))
    c = jnp.sum(finite.astype(jnp.float32), axis=(1, 3))
    return jnp.where(c > 0, s / jnp.maximum(c, 1.0), 0.0)


def compute_num_levels(width: int, height: int, tile_size: int) -> int:
    """tiles.rs:137-147."""
    max_dim = max(width, height)
    if max_dim <= tile_size:
        return 1
    return max(int(np.ceil(np.log2(max_dim / tile_size))) + 1, 1)


@jax.jit
def _percentile_bounds_kernel(data: jax.Array):
    flat = data.reshape(-1)
    valid = jnp.isfinite(flat) & (flat > 1e-7)
    cnt = jnp.sum(valid.astype(jnp.int32))
    n = cnt.astype(jnp.float32)
    xm = jnp.where(valid, flat, jnp.inf)
    mn = jnp.min(xm)
    mx = jnp.max(jnp.where(valid, flat, -jnp.inf))
    # ranks: floor(n*pct) 0-based index (tiles.rs:162-176)
    ranks = jnp.stack([jnp.minimum(jnp.floor(n * 0.001), n - 1.0) + 1.0,
                       jnp.minimum(jnp.floor(n * 0.999), n - 1.0) + 1.0])
    vals = masked_rank_values(xm, ranks,
                              jnp.where(jnp.isfinite(mn), mn, 0.0),
                              jnp.where(jnp.isfinite(mx), mx, 1.0))
    # empty → plain finite min/max
    fmn = jnp.min(jnp.where(jnp.isfinite(flat), flat, jnp.inf))
    fmx = jnp.max(jnp.where(jnp.isfinite(flat), flat, -jnp.inf))
    lo = jnp.where(cnt > 0, vals[0], jnp.where(jnp.isfinite(fmn), fmn, 0.0))
    hi = jnp.where(cnt > 0, vals[1], jnp.where(jnp.isfinite(fmx), fmx, 1.0))
    return lo, hi


def percentile_bounds(data) -> Tuple[float, float]:
    lo, hi = _percentile_bounds_kernel(jnp.asarray(data))
    return float(lo), float(hi)


@jax.jit
def _quantize_kernel(data, lo, hi):
    inv = 255.0 / jnp.maximum(hi - lo, 1e-10)
    q = jnp.clip(jnp.round((data - lo) * inv), 0.0, 255.0)
    return jnp.where(jnp.isfinite(data), q, 0.0).astype(jnp.uint8)


def _save_level_tiles(level_u8: List[np.ndarray], level_dir: str,
                      tile_size: int, rgb: bool) -> Tuple[int, int]:
    h, w = level_u8[0].shape
    tile_cols = -(-w // tile_size)
    tile_rows = -(-h // tile_size)
    os.makedirs(level_dir, exist_ok=True)
    for ty in range(tile_rows):
        for tx in range(tile_cols):
            y0, x0 = ty * tile_size, tx * tile_size
            path = os.path.join(level_dir, f"{tx}_{ty}.png")
            planes = []
            for p in level_u8:
                tile = np.zeros((tile_size, tile_size), np.uint8)
                sub = p[y0:y0 + tile_size, x0:x0 + tile_size]
                tile[:sub.shape[0], :sub.shape[1]] = sub
                planes.append(tile)
            if rgb:
                save_rgb_png(planes[0], planes[1], planes[2], path)
            else:
                save_gray_png(planes[0], path)
    return tile_cols, tile_rows


def _build_pyramid(planes, output_dir: str, params: TileParams,
                   bounds_plane, rgb: bool) -> TilePyramid:
    tile_size = params.tile_size
    orig_rows, orig_cols = planes[0].shape
    num_levels = compute_num_levels(orig_cols, orig_rows, tile_size)
    lo, hi = percentile_bounds(bounds_plane)
    os.makedirs(output_dir, exist_ok=True)

    stack = [planes]
    for _ in range(1, num_levels):
        stack.append([downsample_2x(p) for p in stack[-1]])

    max_level = num_levels - 1
    levels = []
    for level in range(num_levels):
        level_planes = stack[max_level - level]
        u8 = [np.asarray(_quantize_kernel(p, jnp.float32(lo),
                                          jnp.float32(hi)))
              for p in level_planes]
        level_dir = os.path.join(output_dir, str(level))
        tile_cols, tile_rows = _save_level_tiles(u8, level_dir, tile_size,
                                                 rgb)
        lh, lw = u8[0].shape
        levels.append(TileLevel(
            level=level, width=lw, height=lh, cols=tile_cols,
            rows=tile_rows, scale_factor=1.0 / (1 << (max_level - level))))
    return TilePyramid(tile_size=tile_size, original_width=orig_cols,
                       original_height=orig_rows, levels=levels,
                       base_dir=output_dir)


def generate_tile_pyramid(normalized, output_dir: str,
                          params: TileParams = TileParams()) -> TilePyramid:
    """Mono pyramid (tiles.rs:179-255)."""
    plane = jnp.asarray(normalized)
    return _build_pyramid([plane], output_dir, params, plane, rgb=False)


def generate_tile_pyramid_rgb(r, g, b, output_dir: str,
                              params: TileParams = TileParams()
                              ) -> TilePyramid:
    """RGB pyramid with shared luminance-based bounds (tiles.rs:363+)."""
    planes = [jnp.asarray(p) for p in (r, g, b)]
    lum = 0.2126 * planes[0] + 0.7152 * planes[1] + 0.0722 * planes[2]
    return _build_pyramid(planes, output_dir, params, lum, rgb=True)
