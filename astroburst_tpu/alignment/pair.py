"""Unified pairwise alignment (reference: src-tauri/src/core/alignment/pair.rs
and src-tauri/src/core/stacking/align.rs:84-170)."""

from __future__ import annotations

import logging
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from astroburst_tpu.alignment.affine import align_channel_affine, warp_image
from astroburst_tpu.alignment.phase_correlation import phase_correlate
from astroburst_tpu.dtypes import AlignMethod
from astroburst_tpu.ops.resample import shift_bicubic

log = logging.getLogger("astroburst.align")


@dataclass
class AlignPairResult:
    aligned: jax.Array
    offset: tuple           # (dy, dx)
    confidence: float
    method_used: str
    matched_stars: int = 0
    inliers: int = 0
    residual_px: float = 0.0


def shift_image_subpixel(image, dy: float, dx: float) -> jax.Array:
    """Bicubic global shift (core/stacking/align.rs:36-57)."""
    img = jnp.asarray(image)
    if abs(dy) < 1e-12 and abs(dx) < 1e-12:
        return img
    return shift_bicubic(img, dy, dx)


def estimate_offset(reference, target, method: AlignMethod):
    if method == AlignMethod.AFFINE:
        r = align_channel_affine(reference, target)
        return (r.transform.ty, r.transform.tx,
                1.0 if r.inliers > 0 else 0.0)
    pc = phase_correlate(reference, target)
    return pc.dy, pc.dx, pc.confidence


def align_pair(reference, target, method: AlignMethod, rows: int,
               cols: int, ref_stars=None) -> AlignPairResult:
    if method == AlignMethod.AFFINE:
        ref_shape = (reference.shape[0], reference.shape[1])
        if (rows, cols) == ref_shape:
            # one device program, one host fetch (fused_chain);
            # ref_stars (fused_chain.detect_ref_stars) skips
            # re-detecting a shared reference channel. The fused chain
            # warps onto the reference canvas, so it only honors the
            # (rows, cols) contract when they match — a different
            # canvas takes the host solve + explicit warp path.
            from astroburst_tpu.alignment.fused_chain import align_and_warp
            warped, result = align_and_warp(reference, target,
                                            ref_stars=ref_stars)
        else:
            result = align_channel_affine(reference, target)
            warped = warp_image(target, result.transform, rows, cols)
        return AlignPairResult(
            aligned=warped,
            offset=(result.transform.ty, result.transform.tx),
            confidence=1.0 if result.inliers > 0 else 0.0,
            method_used=result.method,
            matched_stars=result.matched_stars,
            inliers=result.inliers,
            residual_px=result.residual_px,
        )
    pc = phase_correlate(reference, target)
    shifted = shift_image_subpixel(target, pc.dy, pc.dx)
    return AlignPairResult(
        aligned=shifted, offset=(pc.dy, pc.dx), confidence=pc.confidence,
        method_used="phase_correlation")


def align_pair_with_label(reference, target, method: AlignMethod, rows: int,
                          cols: int, label: str,
                          ref_stars=None) -> AlignPairResult:
    result = align_pair(reference, target, method, rows, cols,
                        ref_stars=ref_stars)
    log.info("%s alignment: %s, offset=(%.2f, %.2f), confidence=%.4f, "
             "inliers=%d", label, result.method_used, result.offset[0],
             result.offset[1], result.confidence, result.inliers)
    return result
