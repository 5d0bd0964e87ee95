"""Image statistics and histograms on device.

Re-design of the reference's stats core
(reference: src-tauri/src/core/imaging/stats.rs:15-210): one fused
masked reduction pass (min/max/sum/count), then compare-count rank
refinement for median/MAD (see ops.quantile). Matching the reference's
size switch, images ≤ 4M px use the exact even-averaging median,
larger ones the single-rank (histogram-path) median.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.constants import (HISTOGRAM_BINS_DISPLAY, MAD_TO_SIGMA,
                                      PADDING_THRESHOLD)
from astroburst_tpu.dtypes import Histogram, ImageStats
from astroburst_tpu.ops.masking import validity_mask
from astroburst_tpu.ops.quantile import _count_below_edges, masked_median_mad

EXACT_PATH_MAX_PIXELS = 4_000_000  # stats.rs:18


def stats_core(x: jax.Array, exact_pair: bool, flatten: bool = False):
    """Pure traced stats: (min, max, sum, count, median, mad).

    Composable inside larger jitted pipelines; `_stats_kernel` is the
    standalone jitted entry point.

    flatten=False (default) keeps x in its natural ND shape: the
    median's compare-count rounds run as ONE fused broadcast-compare-
    reduce each (the flat path's chunked scan serializes 3 chunk steps
    × 6 rounds; results are bit-identical) — and they stay
    GSPMD-shardable (the flat path's pad+reshape chunking all-gathers
    a sharded plane). flatten=True remains for callers that want the
    bounded-intermediate chunked form on very large planes.
    """
    flat = x.reshape(-1) if flatten else x
    mask = validity_mask(flat)
    count = jnp.sum(mask.astype(jnp.int32))
    total = jnp.sum(jnp.where(mask, flat, 0.0))
    xm = jnp.where(mask, flat, jnp.inf)
    mn = jnp.min(xm)
    mx = jnp.max(jnp.where(mask, flat, -jnp.inf))
    med, mad = masked_median_mad(xm, count, mn, mx, exact_pair=exact_pair)
    return mn, mx, total, count, med, mad


_stats_kernel = jax.jit(stats_core, static_argnames=("exact_pair",
                                                     "flatten"))


def compute_image_stats(x: jax.Array) -> ImageStats:
    """NaN-safe robust stats of a device array (any shape)."""
    exact_pair = int(np.prod(x.shape)) <= EXACT_PATH_MAX_PIXELS
    mn, mx, total, count, med, mad = _stats_kernel(x, exact_pair)
    n = int(count)
    if n == 0:
        return ImageStats()
    mad_f = float(mad)
    return ImageStats(
        min=float(mn),
        max=float(mx),
        mean=float(total) / n,
        median=float(med),
        mad=mad_f,
        sigma=max(mad_f * MAD_TO_SIGMA, 1e-30),
        valid_count=n,
    )


@partial(jax.jit, static_argnames=("bins",))
def _histogram_kernel(x: jax.Array, dmin: jax.Array, dmax: jax.Array,
                      bins: int):
    """Counts per bin via cumulative compare-count (no scatter).

    Bin assignment matches the reference's truncation semantics
    (stats.rs:393-403): idx = floor((v-min)*bins/range) clipped to the
    last bin, so bin j counts e_j <= v < e_{j+1} with the final bin
    also absorbing v == max.
    """
    flat = x.reshape(-1)
    mask = validity_mask(flat)
    xm = jnp.where(mask, flat, jnp.inf)
    rng = dmax - dmin
    step = rng / bins
    interior = dmin + step * jnp.arange(1, bins, dtype=jnp.float32)
    cnt_lt = _count_below_edges(xm, interior)  # [bins-1]
    total = jnp.sum(mask.astype(jnp.float32))
    cum = jnp.concatenate([jnp.zeros((1,), jnp.float32), cnt_lt,
                           total[None]])
    counts = jnp.diff(cum)
    # values below dmin (possible when a caller passes a custom range)
    # stay in bin 0: the reference's `as usize` cast saturates negative
    # bin indices to 0 (stats.rs:393-403)
    return counts


def compute_histogram(x: jax.Array, bins: int,
                      dmin: float | None = None,
                      dmax: float | None = None) -> Histogram:
    """Histogram over the valid range (stats.rs:355-421)."""
    if dmin is None or dmax is None:
        flat_stats = _stats_minmax(x)
        dmin = float(flat_stats[0]) if dmin is None else dmin
        dmax = float(flat_stats[1]) if dmax is None else dmax
    if not np.isfinite(dmin) or not np.isfinite(dmax) or (dmax - dmin) < 1e-10:
        return Histogram(bins=[0] * bins, bin_edges=[dmin] * (bins + 1),
                         min=dmin, max=dmax)
    counts = _histogram_kernel(x, jnp.float32(dmin), jnp.float32(dmax), bins)
    counts_np = np.asarray(counts).astype(np.int64)
    step = (dmax - dmin) / bins
    edges = [dmin + i * step for i in range(bins + 1)]
    return Histogram(bins=counts_np.tolist(), bin_edges=edges,
                     min=dmin, max=dmax)


@jax.jit
def _stats_minmax(x: jax.Array):
    flat = x.reshape(-1)
    mask = validity_mask(flat)
    return (jnp.min(jnp.where(mask, flat, jnp.inf)),
            jnp.max(jnp.where(mask, flat, -jnp.inf)))


def compute_histogram_with_stats(x: jax.Array, stats: ImageStats,
                                 bins: int = HISTOGRAM_BINS_DISPLAY) -> Histogram:
    return compute_histogram(x, bins, dmin=stats.min, dmax=stats.max)


def downsample_histogram(hist: Histogram, target_bins: int) -> list:
    """Sum-pool bins down to target_bins (stats.rs:423-444)."""
    src = hist.bins
    if target_bins >= len(src):
        return list(src)
    ratio = len(src) / target_bins
    out = []
    for i in range(target_bins):
        start = int(i * ratio)
        end = min(int((i + 1) * ratio), len(src))
        out.append(int(sum(src[start:end])))
    return out
