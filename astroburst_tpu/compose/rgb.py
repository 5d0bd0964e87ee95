"""Full RGB composition pipeline.

Reference: src-tauri/src/core/compose/rgb.rs — dimension harmonization
(resample to max, ratio cap 8×), missing-channel synthesis (mean of
the others), G/B alignment to the reference channel, white-balance
multipliers, linked STF from the (R+G+B)/3 merge, in-place STF, SCNR;
retains the pre-stretch linear planes + stats (the ORIG side of the
ORIG/KEY cache).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from astroburst_tpu.alignment.pair import align_pair_with_label
from astroburst_tpu.dtypes import AlignMethod
from astroburst_tpu.compose.white_balance import select_wb_reference
from astroburst_tpu.constants import MAX_DIMENSION_RATIO, PADDING_THRESHOLD
from astroburst_tpu.dtypes import (ImageStats,
                                   RgbComposeConfig, StfParams,
                                   WhiteBalanceMode)
from astroburst_tpu.errors import InvalidInput
from astroburst_tpu.imaging.resample import resample_image
from astroburst_tpu.imaging.scnr import apply_scnr
from astroburst_tpu.imaging.stf import auto_stf, _stf_core
from astroburst_tpu.ops.stats import compute_image_stats

log = logging.getLogger("astroburst.align")


@dataclass
class DimensionInfo:
    original_r: Optional[Tuple[int, int]]
    original_g: Optional[Tuple[int, int]]
    original_b: Optional[Tuple[int, int]]
    target: Tuple[int, int]
    resampled: bool

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class ProcessedRgb:
    r: jax.Array
    g: jax.Array
    b: jax.Array
    rows: int
    cols: int
    stf_r: StfParams
    stf_g: StfParams
    stf_b: StfParams
    stats_r: ImageStats
    stats_g: ImageStats
    stats_b: ImageStats
    offset_g: Tuple[float, float]
    offset_b: Tuple[float, float]
    scnr_applied: bool
    dimension_info: Optional[DimensionInfo]
    pre_stretch_r: Optional[jax.Array] = None
    pre_stretch_g: Optional[jax.Array] = None
    pre_stretch_b: Optional[jax.Array] = None
    stats_wb_r: Optional[ImageStats] = None
    stats_wb_g: Optional[ImageStats] = None
    stats_wb_b: Optional[ImageStats] = None


def harmonize_dimensions(r, g, b, max_ratio: float = MAX_DIMENSION_RATIO):
    """Resample mismatched channels to the max dims (rgb.rs:42-128)."""
    chans = [c for c in (r, g, b) if c is not None]
    if not chans:
        return r, g, b, 0, 0, None
    dims = [c.shape for c in chans]
    min_rows = min(d[0] for d in dims)
    min_cols = min(d[1] for d in dims)
    max_rows = max(d[0] for d in dims)
    max_cols = max(d[1] for d in dims)
    if (min_rows, min_cols) == (max_rows, max_cols):
        return r, g, b, max_rows, max_cols, None
    ratio = max(max_rows / max(min_rows, 1), max_cols / max(min_cols, 1))
    if ratio > max_ratio:
        raise InvalidInput(
            f"Channel dimension ratio {ratio:.1f}x exceeds "
            f"{max_ratio:.0f}x limit. Check channel assignments.")
    info = DimensionInfo(
        original_r=tuple(r.shape[::-1]) if r is not None else None,
        original_g=tuple(g.shape[::-1]) if g is not None else None,
        original_b=tuple(b.shape[::-1]) if b is not None else None,
        target=(max_cols, max_rows), resampled=True)

    def fix(c):
        if c is None or c.shape == (max_rows, max_cols):
            return c
        return resample_image(c, max_rows, max_cols)

    return fix(r), fix(g), fix(b), max_rows, max_cols, info


@jax.jit
def _channel_mean2(a, b):
    return (a + b) * 0.5


def channel_or_synth(primary, alt1, alt2, rows: int, cols: int):
    """Missing channel = mean of the others (rgb.rs:132-151)."""
    if primary is not None:
        return primary
    if alt1 is not None and alt2 is not None:
        return _channel_mean2(alt1, alt2)
    if alt1 is not None:
        return alt1
    if alt2 is not None:
        return alt2
    return jnp.zeros((rows, cols), jnp.float32)


def align_rgb_channels(r, g, b, rows: int, cols: int, method):
    """Align G and B to the reference channel (rgb.rs:165-189)."""
    ref = r if r is not None else (g if g is not None else b)
    r_img = channel_or_synth(r, g, b, rows, cols)
    g_img = channel_or_synth(g, r, b, rows, cols)
    b_img = channel_or_synth(b, r, g, rows, cols)
    off_g = (0.0, 0.0)
    off_b = (0.0, 0.0)
    n_aligns = (g is not None) + (b is not None)
    ref_stars = None
    if (n_aligns == 2 and method == AlignMethod.AFFINE
            and jnp.asarray(ref).shape == (rows, cols)
            and min(rows, cols) >= 16):
        # both aligns share the reference channel: detect its stars
        # once and run BOTH chains in one device program with one info
        # fetch (fused_chain.align_and_warp_many)
        from astroburst_tpu.alignment.fused_chain import (
            align_and_warp_many, detect_ref_stars)
        ref_stars = detect_ref_stars(ref)
        (g_img, res_g), (b_img, res_b) = align_and_warp_many(
            ref, [g_img, b_img], ref_stars=ref_stars)
        for label, res in (("G", res_g), ("B", res_b)):
            log.info("%s alignment: %s, offset=(%.2f, %.2f), "
                     "inliers=%d", label, res.method,
                     res.transform.ty, res.transform.tx, res.inliers)
        return (r_img, g_img, b_img,
                (res_g.transform.ty, res_g.transform.tx),
                (res_b.transform.ty, res_b.transform.tx))
    if g is not None:
        res = align_pair_with_label(ref, g_img, method, rows, cols, "G",
                                    ref_stars=ref_stars)
        g_img, off_g = res.aligned, res.offset
    if b is not None:
        res = align_pair_with_label(ref, b_img, method, rows, cols, "B",
                                    ref_stars=ref_stars)
        b_img, off_b = res.aligned, res.offset
    return r_img, g_img, b_img, off_g, off_b


@jax.jit
def _stf_composite_kernel(x, dmin, inv_range, shadow, inv_clip, midtone):
    """STF with the composite validity rule v ≤ 1e-7 → 0 (rgb.rs:195-208)."""
    out = _stf_core(x, dmin, inv_range, shadow, inv_clip, midtone)
    valid = jnp.isfinite(x) & (x > PADDING_THRESHOLD)
    return jnp.where(valid, out, 0.0).astype(jnp.float32)


def apply_stf_composite(x, params: StfParams, stats: ImageStats) -> jax.Array:
    rng = max(stats.max - stats.min, 1e-30)
    clip = max(params.highlight - params.shadow, 1e-15)
    return _stf_composite_kernel(
        x, jnp.float32(stats.min), jnp.float32(1.0 / rng),
        jnp.float32(params.shadow), jnp.float32(1.0 / clip),
        jnp.float32(params.midtone))


@jax.jit
def _merge_for_stf(r, g, b):
    return (r + g + b) * (1.0 / 3.0)


def process_rgb(r_channel, g_channel, b_channel,
                config: RgbComposeConfig = RgbComposeConfig()) -> ProcessedRgb:
    """The full compose pipeline (rgb.rs:209-322)."""
    present = [r_channel is not None, g_channel is not None,
               b_channel is not None]
    count = sum(present)
    if count < 2:
        raise InvalidInput(
            f"Need at least 2 channels for RGB compose (got {count})")

    r = jnp.asarray(r_channel) if r_channel is not None else None
    g = jnp.asarray(g_channel) if g_channel is not None else None
    b = jnp.asarray(b_channel) if b_channel is not None else None

    r, g, b, rows, cols, dim_info = harmonize_dimensions(r, g, b)

    if config.align and count >= 2:
        r_img, g_img, b_img, off_g, off_b = align_rgb_channels(
            r, g, b, rows, cols, config.align_method)
    else:
        r_img = channel_or_synth(r, g, b, rows, cols)
        g_img = channel_or_synth(g, r, b, rows, cols)
        b_img = channel_or_synth(b, r, g, rows, cols)
        off_g = off_b = (0.0, 0.0)

    stats_r = compute_image_stats(r_img)
    stats_g = compute_image_stats(g_img)
    stats_b = compute_image_stats(b_img)

    mode = config.white_balance.mode
    if mode == WhiteBalanceMode.AUTO:
        wb = select_wb_reference(stats_r, stats_g, stats_b)
    elif mode == WhiteBalanceMode.MANUAL:
        wb = (config.white_balance.r, config.white_balance.g,
              config.white_balance.b)
    else:
        wb = (1.0, 1.0, 1.0)

    def mul(img, m):
        return img if abs(m - 1.0) < 1e-7 else img * jnp.float32(m)

    r_img = mul(r_img, wb[0])
    g_img = mul(g_img, wb[1])
    b_img = mul(b_img, wb[2])

    stf_cfg = config.auto_stf
    if config.auto_stretch:
        sr = compute_image_stats(r_img)
        sg = compute_image_stats(g_img)
        sb = compute_image_stats(b_img)
        if config.linked_stf:
            merged = _merge_for_stf(r_img, g_img, b_img)
            st = compute_image_stats(merged)
            params = auto_stf(st, stf_cfg)
            pr = pg = pb = params
        else:
            pr = auto_stf(sr, stf_cfg)
            pg = auto_stf(sg, stf_cfg)
            pb = auto_stf(sb, stf_cfg)
    else:
        sr = compute_image_stats(r_img)
        sg = compute_image_stats(g_img)
        sb = compute_image_stats(b_img)
        ident = StfParams(shadow=0.0, midtone=0.5, highlight=1.0)
        pr = config.stf_r or ident
        pg = config.stf_g or ident
        pb = config.stf_b or ident

    pre_r, pre_g, pre_b = r_img, g_img, b_img

    r_img = apply_stf_composite(r_img, pr, sr)
    g_img = apply_stf_composite(g_img, pg, sg)
    b_img = apply_stf_composite(b_img, pb, sb)

    scnr_applied = False
    if config.scnr is not None and r_img.shape == g_img.shape == b_img.shape:
        r_img, g_img, b_img = apply_scnr(r_img, g_img, b_img, config.scnr)
        scnr_applied = True

    return ProcessedRgb(
        r=r_img, g=g_img, b=b_img, rows=rows, cols=cols,
        stf_r=pr, stf_g=pg, stf_b=pb,
        stats_r=stats_r, stats_g=stats_g, stats_b=stats_b,
        offset_g=off_g, offset_b=off_b, scnr_applied=scnr_applied,
        dimension_info=dim_info,
        pre_stretch_r=pre_r, pre_stretch_g=pre_g, pre_stretch_b=pre_b,
        stats_wb_r=sr, stats_wb_g=sg, stats_wb_b=sb)
