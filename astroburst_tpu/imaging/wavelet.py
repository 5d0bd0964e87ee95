"""À trous B3-spline wavelet denoising.

Reference: src-tauri/src/core/imaging/wavelet.rs — up to 8 scales with
2^k hole spacing, clamped-boundary separable 5-tap smooth, noise σ
from the finest scale (median |detail| · 1.4826), per-scale soft/hard
thresholds with the standard à trous noise-scaling table, reconstruct
with negative/non-finite clamp to 0.

Design: the dilated 5-tap smooth is 5 clamped axis-takes per axis;
the noise median is a compare-count rank
query.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.constants import MAD_TO_SIGMA
from astroburst_tpu.ops.quantile import masked_rank_values
from astroburst_tpu.runtime.progress import ProgressHandle

B3_KERNEL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_NOISE_TABLE = (0.8908, 0.2007, 0.0856, 0.0413, 0.0205, 0.0103, 0.0051)


def atrous_noise_scaling(scale: int) -> float:
    if scale < len(_NOISE_TABLE):
        return _NOISE_TABLE[scale]
    return _NOISE_TABLE[6] / (2.0 ** (scale - 6))


@dataclass
class WaveletConfig:
    num_scales: int = 5
    thresholds: Sequence[float] = (3.0, 2.5, 2.0, 1.5, 1.0)
    linear_denoise: bool = True  # True → soft threshold


@dataclass
class WaveletResult:
    denoised: jax.Array
    scales_processed: int
    noise_estimate: float


def _smooth_axis(x, step: int, axis: int):
    n = x.shape[axis]
    out = None
    for ki, kv in enumerate(B3_KERNEL):
        off = (ki - 2) * step
        idx = jnp.clip(jnp.arange(n) + off, 0, n - 1)
        term = kv * jnp.take(x, idx, axis=axis)
        out = term if out is None else out + term
    return out


def atrous_smooth(x, step: int):
    """Separable clamped-boundary B3 smooth at hole spacing `step`
    (wavelet.rs:135-186)."""
    return _smooth_axis(_smooth_axis(x, step, 1), step, 0)


def _median_abs(x):
    """median of |finite values| with even-averaging (median_f32_mut)."""
    a = jnp.where(jnp.isfinite(x), jnp.abs(x), jnp.inf).reshape(-1)
    cnt = jnp.sum(jnp.isfinite(x).astype(jnp.int32)).astype(jnp.float32)
    rank = jnp.floor(cnt / 2.0) + 1.0  # select_nth(len/2)
    mx = jnp.max(jnp.where(jnp.isfinite(a), a, -jnp.inf))
    val = masked_rank_values(a, rank[None], jnp.float32(0.0),
                             jnp.maximum(mx, 1e-30))[0]
    return jnp.where(cnt > 0, val, 0.0)


@partial(jax.jit, static_argnames=("num_scales", "linear"))
def _wavelet_kernel(image, thresholds, num_scales: int, linear: bool):
    current = image
    details = []
    for scale_idx in range(num_scales):
        step = 1 << scale_idx
        smooth = atrous_smooth(current, step)
        details.append(current - smooth)
        current = smooth

    noise_sigma = _median_abs(details[0]) * MAD_TO_SIGMA

    recon = current
    for scale_idx, detail in enumerate(details):
        threshold = (thresholds[scale_idx] * noise_sigma *
                     atrous_noise_scaling(scale_idx)).astype(jnp.float32)
        a = jnp.abs(detail)
        if linear:
            detail = jnp.where(a <= threshold, 0.0,
                               jnp.sign(detail) * (a - threshold))
        else:
            detail = jnp.where(a <= threshold, 0.0, detail)
        recon = recon + detail

    recon = jnp.where(jnp.isfinite(recon) & (recon >= 0.0), recon, 0.0)
    return recon, noise_sigma


def wavelet_denoise(image, config: WaveletConfig = WaveletConfig(),
                    progress: Optional[ProgressHandle] = None) -> WaveletResult:
    num_scales = min(max(config.num_scales, 1), 8)
    thr = list(config.thresholds) or [1.0]
    while len(thr) < num_scales:
        thr.append(thr[-1])
    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("wavelet decompose+threshold")
    out, noise = _wavelet_kernel(jnp.asarray(image),
                                 jnp.asarray(thr[:num_scales], jnp.float32),
                                 num_scales, config.linear_denoise)
    if progress is not None:
        progress.tick_with_stage("reconstructed")
    return WaveletResult(denoised=out, scales_processed=num_scales,
                         noise_estimate=float(noise))
