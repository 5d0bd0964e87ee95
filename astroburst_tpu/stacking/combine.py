"""Sigma-clipped stacking over the frame axis.

Reference: src-tauri/src/core/stacking/combine.rs — per-pixel iterative
clip: iteration 0 uses median + MAD·1.4826 (Stetson 1987), iterations
≥1 use mean + sample std; asymmetric low/high bounds; stop when a pass
removes nothing; final estimate is the mean of survivors (fallback:
last center).

Frames live on a leading [N, H, W] axis; the reference's
data-dependent retain/compaction loop becomes fixed-iteration masked
updates with a per-pixel `stopped` flag reproducing the early-break
semantics exactly. The iteration-0 median/MAD use one sort along the
frame axis plus a one-hot rank select. ``shift_clip`` is the one
shift + clip entry of both the api and the fused pipeline: the one-pass
GPU kernel (stacking/onepass_kernel.py) where it compiles and the
stack fits its register budget, this module's XLA form otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.alignment.phase_correlation import (
    phase_correlate_stack_traced)
from astroburst_tpu.constants import MAD_TO_SIGMA
from astroburst_tpu.dtypes import AlignmentMethod, StackConfig
from astroburst_tpu.errors import InvalidInput
from astroburst_tpu.ops.resample import shift_bicubic
from astroburst_tpu.runtime.progress import ProgressHandle


def _rank_select(sorted_stack: jax.Array, rank: jax.Array) -> jax.Array:
    """sorted_stack [N, H, W] ascending; rank [H, W] i32 → values [H, W].

    One-hot multiply-accumulate over the tiny frame axis — XLA fuses
    this to a single pass; no gather.
    """
    n = sorted_stack.shape[0]
    out = jnp.zeros_like(sorted_stack[0])
    for k in range(n):
        out = out + jnp.where(rank == k, sorted_stack[k], 0.0)
    return out


def _masked_median_mad_axis0(stack, mask):
    """(median, mad, count) per pixel with select_nth semantics:
    element at index len/2, no even averaging (combine.rs:37-48)."""
    cnt = jnp.sum(mask.astype(jnp.int32), axis=0)
    svals = jnp.sort(jnp.where(mask, stack, jnp.inf), axis=0)
    med = _rank_select(svals, cnt // 2)
    devs = jnp.sort(jnp.where(mask, jnp.abs(stack - med), jnp.inf), axis=0)
    mad = _rank_select(devs, cnt // 2)
    return med, mad, cnt


def sigma_clip_core(stack: jax.Array, sigma_low: float = 3.0,
                    sigma_high: float = 3.0, max_iter: int = 5):
    """Per-pixel sigma clip over axis 0 of [N, H, W] (pure traced).

    Returns (combined [H, W] f32, rejected_pixels i32 scalar).
    Values participate iff finite (combine.rs:168-173 pushes only
    finite samples).
    """
    finite = jnp.isfinite(stack)
    count0 = jnp.sum(finite.astype(jnp.int32), axis=0)
    mask = finite
    stopped = jnp.zeros(stack.shape[1:], dtype=bool)
    last_center = jnp.full(stack.shape[1:], jnp.nan, jnp.float32)
    zero = jnp.zeros(stack.shape[1:], jnp.float32)

    for it in range(max_iter):
        cnt = jnp.sum(mask.astype(jnp.int32), axis=0)
        cntf = jnp.maximum(cnt.astype(jnp.float32), 1.0)
        if it == 0:
            med, mad, _ = _masked_median_mad_axis0(stack, mask)
            center = med
            sigma = jnp.maximum(mad * MAD_TO_SIGMA, 1e-10).astype(jnp.float32)
        else:
            mean = jnp.sum(jnp.where(mask, stack, 0.0), axis=0) / cntf
            var = jnp.sum(jnp.where(mask, (stack - mean) ** 2, 0.0),
                          axis=0) / jnp.maximum(cntf - 1.0, 1.0)
            center = mean
            sigma = jnp.maximum(jnp.sqrt(var), 1e-10)
        active = (cnt >= 2) & ~stopped
        dev = stack - center
        keep = (dev >= -sigma_low * sigma) & (dev <= sigma_high * sigma)
        new_mask = jnp.where(active[None], mask & keep, mask)
        removed = cnt - jnp.sum(new_mask.astype(jnp.int32), axis=0)
        last_center = jnp.where(active, center, last_center)
        stopped = stopped | (active & (removed == 0))
        mask = new_mask

    final_cnt = jnp.sum(mask.astype(jnp.int32), axis=0)
    mean_final = jnp.sum(jnp.where(mask, stack, 0.0), axis=0) / jnp.maximum(
        final_cnt.astype(jnp.float32), 1.0)
    fallback = jnp.where(jnp.isfinite(last_center), last_center, zero)
    combined = jnp.where(final_cnt > 0, mean_final, fallback)
    rejected = jnp.sum(count0 - final_cnt)
    return combined, rejected


sigma_clip_combine_stack = jax.jit(
    sigma_clip_core, static_argnames=("sigma_low", "sigma_high", "max_iter"))


def shift_clip_xla(stack: jax.Array, dys: jax.Array, dxs: jax.Array,
                   sigma_low: float = 3.0, sigma_high: float = 3.0,
                   max_iter: int = 5):
    """Plain XLA shift + clip: ``vmap(shift_bicubic)`` then
    ``sigma_clip_core``. The kernel's reference and the path for stacks
    past its frame budget."""
    full = jax.vmap(shift_bicubic)(stack, dys, dxs)
    return sigma_clip_core(full, sigma_low, sigma_high, max_iter)


def triton_available() -> bool:
    """Pallas kernels on the Triton route compile only for a CUDA
    device; elsewhere (the CPU) every operation takes its XLA form."""
    return jax.default_backend() == "gpu"


def use_onepass_kernel(n_frames: int) -> bool:
    """The one-pass kernel runs when it compiles here and a pixel's
    ``n_frames`` samples fit its register budget. Pallas is imported
    only where the kernel can run."""
    if not triton_available():
        return False
    from astroburst_tpu.stacking.onepass_kernel import MAX_FRAMES
    return n_frames <= MAX_FRAMES


def shift_clip(stack: jax.Array, dys: jax.Array, dxs: jax.Array,
               sigma_low: float = 3.0, sigma_high: float = 3.0,
               max_iter: int = 5):
    """Shift each frame by (dys[k], dxs[k]) and sigma-clip combine
    (align.rs:36-57 + combine.rs:14-91). Returns (combined [H, W] f32,
    rejected i32 scalar). Traceable."""
    if use_onepass_kernel(stack.shape[0]):
        from astroburst_tpu.stacking.onepass_kernel import (
            shift_clip_onepass)
        return shift_clip_onepass(stack, dys, dxs, sigma_low, sigma_high,
                                  max_iter)
    return shift_clip_xla(stack, dys, dxs, sigma_low, sigma_high,
                          max_iter)


_shift_clip_jit = jax.jit(
    shift_clip, static_argnames=("sigma_low", "sigma_high", "max_iter"))


@dataclass
class StackResult:
    image: jax.Array
    frame_count: int
    rejected_pixels: int
    offsets: List[Tuple[int, int]]
    confidences: List[float]


def stack_images(images: Sequence, config: StackConfig = StackConfig(),
                 progress: Optional[ProgressHandle] = None) -> StackResult:
    """Crop to common dims, align to frame 0, sigma-clip combine
    (combine.rs:94-192)."""
    if len(images) == 0:
        raise InvalidInput("No images to stack")
    min_rows = min(int(img.shape[0]) for img in images)
    min_cols = min(int(img.shape[1]) for img in images)
    cropped = [jnp.asarray(img)[:min_rows, :min_cols] for img in images]
    stack = jnp.stack(cropped)
    n = len(cropped)

    offsets: List[Tuple[int, int]] = [(0, 0)]
    confidences: List[float] = [0.0]
    if config.align and n > 1:
        # batched stack align; equality with the per-frame path is
        # asserted by
        # test_phase_correlation.py::test_stack_pc_matches_per_frame
        dys1, dxs1, confs = phase_correlate_stack_traced(
            stack[0], stack[1:])
        dys = jnp.concatenate([jnp.zeros(1, jnp.float32), dys1])
        dxs = jnp.concatenate([jnp.zeros(1, jnp.float32), dxs1])
        if progress is not None:
            progress.tick_with_stage("align", n - 1)
            progress.check_cancelled()
        offsets += [(int(round(float(dy))), int(round(float(dx))))
                    for dy, dx in zip(np.asarray(dys1), np.asarray(dxs1))]
        confidences += [float(c) for c in np.asarray(confs)]
    else:
        dys = jnp.zeros(n, jnp.float32)
        dxs = jnp.zeros(n, jnp.float32)
        offsets += [(0, 0)] * (n - 1)
        confidences += [0.0] * (n - 1)

    combined, rejected = _shift_clip_jit(
        stack, dys, dxs, config.sigma_low, config.sigma_high,
        config.max_iterations)
    if progress is not None:
        progress.tick_with_stage("combine")
    return StackResult(image=combined, frame_count=n,
                       rejected_pixels=int(rejected), offsets=offsets,
                       confidences=confidences)
