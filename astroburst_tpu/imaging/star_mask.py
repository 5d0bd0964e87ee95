"""Star mask generation.

Reference: src-tauri/src/core/imaging/star_mask.rs — per-star disks of
radius FWHM·growth with a smoothstep soft edge, max-combined, optional
luminance-ceiling protection, coverage fraction.

Design: detection gives ≤K stars as dense arrays; the mask is
rasterized tile-by-tile: the padded plane is cut into TILE×TILE
blocks, each block gets a candidate list of the stars whose 96×96
windows intersect it (built with one vmapped argsort over a [tiles,
stars] flag matrix), and a lax.map over blocks max-accumulates each
candidate's soft disk over the block with a dynamic-bound fori_loop.
Total work is (stars × ~3 tiles × TILE²) instead of K sequential
96² dynamic-update-slices. Window-clipping semantics match the
sequential kernel exactly: a star paints only inside its 96×96 window
anchored at round(position), so soft radii beyond 47 px truncate
identically.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.analysis.star_detection import detect_stars

WINDOW = 96  # covers soft_radius up to 47 px each side of center


@dataclass
class StarMaskConfig:
    growth_factor: float = 2.5
    softness: float = 4.0
    detection_sigma: float = 5.0
    min_fwhm: float = 1.5
    max_fwhm: float = 30.0
    luminance_protect: bool = False
    luminance_ceiling: float = 0.85


@dataclass
class StarMaskResult:
    mask: jax.Array
    stars_masked: int
    coverage_fraction: float


TILE = 128  # raster block edge; window (96) spans ≤2 tiles per axis


def _soft_disk(px, py, x, y, radius, softness):
    """Smoothstep soft disk value at image-space coords (px, py)
    (star_mask.rs:61-98). Exact math of the sequential kernel."""
    soft_radius = radius + softness
    r2_inner = radius * radius
    r2_outer = soft_radius * soft_radius
    fade = jnp.maximum(r2_outer - r2_inner, 1e-10)
    d2 = (px - x) ** 2 + (py - y) ** 2
    t = jnp.clip((d2 - r2_inner) / fade, 0.0, 1.0)
    val = jnp.where(d2 <= r2_inner, 1.0,
                    jnp.where(d2 <= r2_outer,
                              1.0 - t * t * (3.0 - 2.0 * t), 0.0))
    return jnp.where(radius > 0.0, val, 0.0)


@partial(jax.jit, static_argnames=("luminance_protect",))
def _mask_kernel(image, xs, ys, radii, softness, luminance_ceiling,
                 luminance_protect: bool):
    h, w = image.shape
    half = WINDOW // 2
    # padded plane (origin at image coord -half) rounded up to tiles
    hp = -(-(h + WINDOW) // TILE) * TILE
    wp = -(-(w + WINDOW) // TILE) * TILE
    ty_n, tx_n = hp // TILE, wp // TILE
    n_tiles = ty_n * tx_n
    k = xs.shape[0]

    # window anchor in padded space = round(star) clipped (the padded
    # origin sits at image coord -half, so image coord y0-half == padded y0)
    y0 = jnp.clip(jnp.round(ys).astype(jnp.int32), 0, h)
    x0 = jnp.clip(jnp.round(xs).astype(jnp.int32), 0, w)
    valid = radii > 0.0

    # tile ranges each window touches (inclusive)
    ty_lo, ty_hi = y0 // TILE, (y0 + WINDOW - 1) // TILE
    tx_lo, tx_hi = x0 // TILE, (x0 + WINDOW - 1) // TILE
    t_idx = jnp.arange(n_tiles, dtype=jnp.int32)
    t_y, t_x = t_idx // tx_n, t_idx % tx_n
    flags = ((t_y[:, None] >= ty_lo[None, :]) &
             (t_y[:, None] <= ty_hi[None, :]) &
             (t_x[:, None] >= tx_lo[None, :]) &
             (t_x[:, None] <= tx_hi[None, :]) & valid[None, :])
    counts = jnp.sum(flags, axis=1).astype(jnp.int32)  # [tiles]
    # candidate star indices per tile, flagged-first in index order
    cands = jnp.argsort(jnp.where(flags, 0, 1).astype(jnp.int32),
                        axis=1, stable=True).astype(jnp.int32)

    iy = jnp.arange(TILE, dtype=jnp.float32)[:, None]
    ix = jnp.arange(TILE, dtype=jnp.float32)[None, :]

    def paint_tile(t):
        oy = (t // tx_n) * TILE
        ox = (t % tx_n) * TILE
        # image-space coords of this tile's pixels
        py = oy.astype(jnp.float32) + iy - half
        px = ox.astype(jnp.float32) + ix - half
        # padded-space coords for the window-clip test
        gy = oy + jnp.arange(TILE, dtype=jnp.int32)[:, None]
        gx = ox + jnp.arange(TILE, dtype=jnp.int32)[None, :]

        def body(i, acc):
            s = cands[t, i]
            x, y, radius = xs[s], ys[s], radii[s]
            val = _soft_disk(px, py, x, y, radius, softness)
            # paint only inside the 96×96 window anchored at (y0, x0):
            # exact parity with the sequential dynamic-update-slice form
            inside = ((gy >= y0[s]) & (gy < y0[s] + WINDOW) &
                      (gx >= x0[s]) & (gx < x0[s] + WINDOW))
            return jnp.maximum(acc, jnp.where(inside, val, 0.0))

        return jax.lax.fori_loop(0, counts[t], body,
                                 jnp.zeros((TILE, TILE), jnp.float32))

    tiles = jax.lax.map(paint_tile, t_idx)
    mask = tiles.reshape(ty_n, tx_n, TILE, TILE).transpose(0, 2, 1, 3)
    mask = mask.reshape(hp, wp)[half:half + h, half:half + w]
    return _mask_finish(image, mask, luminance_ceiling,
                        luminance_protect, h, w)


def _mask_finish(image, mask, luminance_ceiling, luminance_protect: bool,
                 h: int, w: int):
    if luminance_protect:
        ceiling = luminance_ceiling
        inv_range = jnp.where(ceiling < 1.0, 1.0 / (1.0 - ceiling), 1.0)
        excess = jnp.clip((image - ceiling) * inv_range, 0.0, 1.0)
        smooth = excess * excess * (3.0 - 2.0 * excess)
        lum = (image > ceiling) & (mask < 1.0)
        mask = jnp.where(lum, jnp.maximum(mask, smooth), mask)

    coverage = jnp.sum((mask > 0.01).astype(jnp.float32)) / (h * w)
    return mask, coverage


def _star_arrays(detection, config: StarMaskConfig):
    """FWHM-filtered (xs, ys, radii, n_masked) host arrays for the
    paint kernel (star_mask.rs:61-70's per-star loop inputs)."""
    stars = [s for s in detection.stars
             if config.min_fwhm <= s.fwhm <= config.max_fwhm]
    k = max(len(stars), 1)
    xs = np.zeros(k, np.float32)
    ys = np.zeros(k, np.float32)
    radii = np.zeros(k, np.float32)
    for i, s in enumerate(stars):
        xs[i] = s.x
        ys[i] = s.y
        radii[i] = s.fwhm * config.growth_factor
    return xs, ys, radii, len(stars)


def generate_star_mask_from_detection(image, detection,
                                      config: StarMaskConfig) -> StarMaskResult:
    img = jnp.asarray(image)
    xs, ys, radii, n_masked = _star_arrays(detection, config)
    mask, coverage = _mask_kernel(
        img, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(radii),
        jnp.float32(config.softness), jnp.float32(config.luminance_ceiling),
        config.luminance_protect)
    return StarMaskResult(mask=mask, stars_masked=n_masked,
                          coverage_fraction=float(coverage))


def generate_star_mask(image, config: StarMaskConfig = StarMaskConfig()
                       ) -> StarMaskResult:
    detection = detect_stars(jnp.asarray(image), config.detection_sigma)
    return generate_star_mask_from_detection(image, detection, config)
