"""Iterative masked MTF stretch.

Reference: src-tauri/src/core/imaging/masked_stretch.rs — normalize to
[0,1], star mask once, then loop ≤N: masked-background median →
mtf_balance → blend dst = dst·(m·α) + stretched·(1−m·α); converge when
|bg − target| < 1e-5 or the background stagnates. RGB uses a shared
luminance-derived mask (masked_stretch.rs:157-190).

Design: the data-dependent convergence loop is a
lax.while_loop evaluated on the device's scalar core — converging in
4 iterations costs 4 iterations of device time, exactly reproducing
the reference's break conditions (masked_stretch.rs:79-103); the
masked background median is a compare-count rank query per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.imaging.star_mask import (StarMaskConfig, StarMaskResult,
                                              generate_star_mask)
from astroburst_tpu.ops.quantile import masked_rank_values


@dataclass
class MaskedStretchConfig:
    iterations: int = 10
    target_background: float = 0.25
    mask_growth: float = 2.5
    mask_softness: float = 4.0
    luminance_protect: bool = True
    luminance_ceiling: float = 0.85
    protection_amount: float = 0.85
    convergence_threshold: float = 1e-5


@dataclass
class MaskedStretchResult:
    image: jax.Array
    iterations_run: int
    final_background: float
    stars_masked: int
    mask_coverage: float
    converged: bool


def _masked_median(working, bg_mask):
    """select_nth(len/2) median of pixels where mask < 0.5, finite, > 0
    (masked_stretch.rs:211-228)."""
    flat = jnp.where(bg_mask, working, jnp.inf).reshape(-1)
    cnt = jnp.sum(bg_mask.astype(jnp.int32)).astype(jnp.float32)
    rank = jnp.floor(cnt / 2.0) + 1.0  # 0-based index len/2 → rank len/2+1
    val = masked_rank_values(flat, rank[None], jnp.float32(0.0),
                             jnp.float32(1.0))[0]
    return jnp.where(cnt > 0, val, 0.0)


def _mtf_guarded(x, m):
    """MTF with |denom| < 1e-10 → x guard (masked_stretch.rs:238-252)."""
    denom = (2.0 * m - 1.0) * x - m
    safe = jnp.where(jnp.abs(denom) < 1e-10, 1.0, denom)
    val = jnp.clip((m - 1.0) * x / safe, 0.0, 1.0)
    val = jnp.where(jnp.abs(denom) < 1e-10, x, val)
    return jnp.where(x <= 0.0, 0.0, jnp.where(x >= 1.0, 1.0, val))


def _stretch_core(image, mask, protection, target_bg, conv_threshold,
                  iterations: int):
    """Traced body shared by the standalone kernel and the fused
    mask+stretch program. Normalization bounds are the validity-masked
    min/max (stats.rs:11 semantics), computed in-trace — the host
    never fetches them."""
    from astroburst_tpu.ops.masking import validity_mask
    vm = validity_mask(image)
    dmin = jnp.min(jnp.where(vm, image, jnp.inf))
    dmax = jnp.max(jnp.where(vm, image, -jnp.inf))
    any_valid = jnp.any(vm)
    dmin = jnp.where(any_valid, dmin, 0.0)
    dmax = jnp.where(any_valid, dmax, 0.0)
    rng = dmax - dmin
    working = jnp.where(jnp.isfinite(image) & (image > 0.0),
                        jnp.clip((image - dmin) / jnp.maximum(rng, 1e-30),
                                 0.0, 1.0), 0.0)
    working = jnp.where(rng < 1e-10, jnp.zeros_like(image), working)
    blend = mask * protection

    # carry: (it, stopped, converged, iterations_run, prev_bg, working)
    # while_loop ends the moment a break condition fires — a run that
    # converges in 4 iterations pays for 4, not `iterations`
    def cond(c):
        it, stopped = c[0], c[1]
        return (it < iterations) & ~stopped

    def body(c):
        it, stopped, converged, iterations_run, prev_bg, working = c
        bg = _masked_median(
            working, (mask < 0.5) & jnp.isfinite(working) & (working > 0.0))
        at_target = jnp.abs(bg - target_bg) < conv_threshold
        stagnated = (it > 0) & (jnp.abs(bg - prev_bg) < conv_threshold * 0.1)
        # mtf_balance (masked_stretch.rs:230-236)
        denom = 2.0 * target_bg * bg - target_bg - bg
        midtone = jnp.where(jnp.abs(denom) < 1e-15, 0.5,
                            jnp.clip(bg * (target_bg - 1.0) /
                                     jnp.where(jnp.abs(denom) < 1e-15, 1.0,
                                               denom), 0.0001, 0.9999))
        stretched = _mtf_guarded(working, midtone)
        new_working = working * blend + stretched * (1.0 - blend)
        working = jnp.where(at_target | stagnated, working, new_working)
        return (it + 1, at_target | stagnated, converged | at_target,
                it + 1, bg, working)

    init = (jnp.int32(0), jnp.bool_(False), jnp.bool_(False), jnp.int32(0),
            jnp.float32(0.0), working)
    _, _, converged, iterations_run, _, working = jax.lax.while_loop(
        cond, body, init)

    final_bg = _masked_median(
        working, (mask < 0.5) & jnp.isfinite(working) & (working > 0.0))
    # one packed scalar row: host reads iterations/background/converged
    # in a SINGLE device fetch instead of three
    info = jnp.stack([iterations_run.astype(jnp.float32), final_bg,
                      converged.astype(jnp.float32)])
    return jnp.clip(working, 0.0, 1.0), info


@partial(jax.jit, static_argnames=("iterations",))
def _masked_stretch_kernel(image, mask, protection, target_bg,
                           conv_threshold, iterations: int):
    return _stretch_core(image, mask, protection, target_bg,
                         conv_threshold, iterations)


@partial(jax.jit, static_argnames=("iterations", "luminance_protect"))
def _mask_stretch_fused(image, xs, ys, radii, softness, luminance_ceiling,
                        protection, target_bg, conv_threshold,
                        iterations: int, luminance_protect: bool):
    """Star-mask paint + iterative stretch in ONE device program; the
    host pays exactly two fetches per masked_stretch call (the
    detection's packed array, then info+coverage here)."""
    from astroburst_tpu.imaging.star_mask import _mask_kernel
    mask, coverage = _mask_kernel(image, xs, ys, radii, softness,
                                  luminance_ceiling, luminance_protect)
    out, info = _stretch_core(image, mask, protection, target_bg,
                              conv_threshold, iterations)
    return out, jnp.concatenate([info, coverage[None]])


@partial(jax.jit, static_argnames=("iterations", "luminance_protect",
                                   "tile_size", "max_peaks"))
def _detect_mask_stretch_fused(image, detection_sigma, min_fwhm, max_fwhm,
                               growth, softness, luminance_ceiling,
                               protection, target_bg, conv_threshold,
                               iterations: int, luminance_protect: bool,
                               tile_size: int, max_peaks: int):
    """The WHOLE masked stretch — detection, device 3-px dedupe, FWHM
    filter, mask paint, iterative MTF solve — as ONE device program
    with ONE host fetch (the packed info row), no host round trip after
    detection; dedupe_packed_device reproduces the host accept set
    exactly (star_detection.rs:215 flux-desc greedy)."""
    from astroburst_tpu.analysis.star_detection import (_detect_fused,
                                                        dedupe_packed_device)
    from astroburst_tpu.imaging.star_mask import _mask_kernel

    packed = _detect_fused(image, tile_size, detection_sigma, max_peaks)
    accepted = dedupe_packed_device(packed)
    fwhms = packed[3]
    painted = accepted & (fwhms >= min_fwhm) & (fwhms <= max_fwhm)
    # sanitize unpainted slots: empty candidates can carry NaN
    # positions, and NaN→int casts in the paint's tile math are UB
    xs = jnp.where(painted, packed[1], 0.0)  # packed rows: [cys, cxs, …]
    ys = jnp.where(painted, packed[0], 0.0)
    radii = jnp.where(painted, fwhms * growth, 0.0)
    n_masked = jnp.sum(painted.astype(jnp.int32)).astype(jnp.float32)
    mask, coverage = _mask_kernel(image, xs, ys, radii, softness,
                                  luminance_ceiling, luminance_protect)
    out, info = _stretch_core(image, mask, protection, target_bg,
                              conv_threshold, iterations)
    return out, jnp.concatenate([info, coverage[None], n_masked[None]])


def masked_stretch_with_mask(image, mask_result: StarMaskResult,
                             config: MaskedStretchConfig) -> MaskedStretchResult:
    img = jnp.asarray(image)
    out, info = _masked_stretch_kernel(
        img, mask_result.mask,
        jnp.float32(config.protection_amount),
        jnp.float32(config.target_background),
        jnp.float32(config.convergence_threshold), config.iterations)
    info = np.asarray(info)
    return MaskedStretchResult(
        image=out, iterations_run=int(info[0]),
        final_background=float(info[1]),
        stars_masked=mask_result.stars_masked,
        mask_coverage=mask_result.coverage_fraction,
        converged=bool(info[2] > 0.5))


def masked_stretch(image, config: MaskedStretchConfig = MaskedStretchConfig(),
                   max_peaks: int = 4096) -> MaskedStretchResult:
    """Full masked stretch (masked_stretch.rs:42-123): ONE device
    program end to end — detection, device 3-px dedupe (exact
    `_postprocess_packed` accept set), FWHM filter, mask paint,
    while_loop MTF solve — and ONE host fetch for the scalar row."""
    img = jnp.asarray(image)
    rows, cols = img.shape
    mask_cfg = StarMaskConfig(
        growth_factor=config.mask_growth, softness=config.mask_softness,
        luminance_protect=config.luminance_protect,
        luminance_ceiling=config.luminance_ceiling)
    if rows < 3 or cols < 3:
        mask_result = generate_star_mask(image, mask_cfg)
        return masked_stretch_with_mask(image, mask_result, config)
    tile_size = min(max(min(rows, cols) // 8, 32), 256)
    out, info = _detect_mask_stretch_fused(
        img, jnp.float32(mask_cfg.detection_sigma),
        jnp.float32(mask_cfg.min_fwhm), jnp.float32(mask_cfg.max_fwhm),
        jnp.float32(mask_cfg.growth_factor),
        jnp.float32(mask_cfg.softness),
        jnp.float32(mask_cfg.luminance_ceiling),
        jnp.float32(config.protection_amount),
        jnp.float32(config.target_background),
        jnp.float32(config.convergence_threshold), config.iterations,
        mask_cfg.luminance_protect, tile_size, max_peaks)
    info = np.asarray(info)
    return MaskedStretchResult(
        image=out, iterations_run=int(info[0]),
        final_background=float(info[1]),
        stars_masked=int(info[4]),
        mask_coverage=float(info[3]),
        converged=bool(info[2] > 0.5))


def synthesize_luminance(r, g, b) -> jax.Array:
    """BT.709 luminance; non-finite → 0 (masked_stretch.rs:126-152)."""
    rs = jnp.where(jnp.isfinite(r), r, 0.0)
    gs = jnp.where(jnp.isfinite(g), g, 0.0)
    bs = jnp.where(jnp.isfinite(b), b, 0.0)
    return 0.2126 * rs + 0.7152 * gs + 0.0722 * bs


def masked_stretch_rgb_shared(r, g, b,
                              config: MaskedStretchConfig = MaskedStretchConfig()):
    """Shared luminance-derived mask drives all three channels."""
    lum = synthesize_luminance(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b))
    mask_cfg = StarMaskConfig(
        growth_factor=config.mask_growth, softness=config.mask_softness,
        luminance_protect=config.luminance_protect,
        luminance_ceiling=config.luminance_ceiling)
    shared = generate_star_mask(lum, mask_cfg)
    return {
        "r": masked_stretch_with_mask(r, shared, config),
        "g": masked_stretch_with_mask(g, shared, config),
        "b": masked_stretch_with_mask(b, shared, config),
        "shared_mask_coverage": shared.coverage_fraction,
        "shared_stars_masked": shared.stars_masked,
    }
