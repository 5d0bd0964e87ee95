"""Rank statistics via compare-count range refinement.

The reference computes exact medians by selection (≤4M px) or a
65536-bin histogram with bin refinement (>4M px)
(reference: src-tauri/src/core/imaging/stats.rs:85-210,
src-tauri/src/math/median.rs:27-63). Selection is sequential and a
histogram is a scatter-add; this module avoids both.

Instead we narrow a [lo, hi) value bracket holding the target rank by
counting `x < edge_j` for a small set of edges each round — a pure
compare+reduce. With BINS edges per round and R
rounds the bracket shrinks BINS^R-fold; the final value interpolates
rank position inside the bracket exactly like the reference's
`resolve_rank_in_hist` (stats.rs:334-353). Resolution: range / BINS^R
(default 64^3 ≈ 2.6e5 ⇒ ~4e-6 relative), inside the 1e-5 parity budget.

Invalid values must be mapped to +inf by the caller: they then fail
every `x < edge` compare and never enter any count, which reproduces
the reference's NaNs-sort-to-end / validity-filter semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# 8 edges-per-round x 6 rounds: SAME final bracket resolution as the
# previous 64-bin x 3-round config (8**6 == 64**3 == 262144, ~4e-6
# relative -- inside the 1e-5 parity budget) at 42 compares/element
# instead of 189. The compare-count is compute-bound at >10 Mpx --
# with K rank queries each round costs K*(BINS-1) compares per
# element, so fewer, narrower rounds win even though each round is one
# more (memory-cheap) pass over x.
BINS = 8
ROUNDS = 6
_CHUNK = 1 << 22  # 4M elements per scan step


def _count_below_edges(x: jax.Array, edges: jax.Array) -> jax.Array:
    """cnt[j] = #{i : x[i] < edges[j]} as f32. edges shape [E]; x has
    invalid mapped to +inf.

    1-D x: scan-chunked (4M elements per step, bounding the
    intermediate of the single-device flat path). ND x: one fused broadcast-
    compare-reduce over every axis — this form preserves the input's
    GSPMD sharding (local partial counts + one psum), where the 1-D
    path's pad+reshape to (rows, _CHUNK) forces a full all-gather of
    the plane on a sharded input. Sharded callers go through
    ``stats_core(..., flatten=False)``.
    """
    if x.ndim > 1:
        return jnp.sum(x[..., None] < edges,
                       axis=tuple(range(x.ndim)), dtype=jnp.float32)
    n = x.shape[0]
    rows = -(-n // _CHUNK)
    pad = rows * _CHUNK - n
    if pad:
        x = jnp.concatenate([x, jnp.full((pad,), jnp.inf, x.dtype)])
    xr = x.reshape(rows, _CHUNK)

    def body(acc, chunk):
        c = jnp.sum(chunk[:, None] < edges[None, :], axis=0, dtype=jnp.float32)
        return acc + c, None

    acc, _ = jax.lax.scan(body, jnp.zeros(edges.shape, jnp.float32), xr)
    return acc


def masked_rank_values(x: jax.Array, ranks: jax.Array, lo: jax.Array,
                       hi: jax.Array, bins: int = BINS,
                       rounds: int = ROUNDS) -> jax.Array:
    """Interpolated values of the `ranks`-th smallest elements (1-based).

    x: f32 of any shape (reduced over every axis; keep it ND when it is
    GSPMD-sharded — see _count_below_edges) with invalid mapped to
    +inf. ranks: f32 [K] (may share a
    bracket; each rank tracks its own). lo/hi: scalars bracketing all
    valid values (hi must be > max valid value is NOT required — the
    top edge is widened each round).

    Returns f32 [K]. For rank <= 0 returns lo.
    """
    k = ranks.shape[0]
    los = jnp.broadcast_to(lo, (k,)).astype(jnp.float32)
    his = jnp.broadcast_to(hi, (k,)).astype(jnp.float32)
    # widen so the max element falls strictly inside the last bin
    his = his + jnp.maximum(his - los, 1e-30) * 1e-6 + 1e-37
    below_lo = jnp.zeros((k,), jnp.float32)
    in_bin = jnp.zeros((k,), jnp.float32)

    frac = jnp.arange(1, bins, dtype=jnp.float32) / bins  # interior edges

    for _ in range(rounds):
        # interior edges for each rank's bracket: [K, bins-1]
        edges = los[:, None] + (his - los)[:, None] * frac[None, :]
        cnts = _count_below_edges(x, edges.reshape(-1)).reshape(k, bins - 1)
        # counts below each of bins+1 edges incl. lo (below_lo) and hi
        lo_cnt = below_lo[:, None]
        hi_cnt = (below_lo + jnp.where(in_bin > 0, in_bin,
                                       jnp.inf))[:, None]  # round 0: unknown
        # full cumulative: [K, bins+1]
        cum = jnp.concatenate([lo_cnt, cnts, hi_cnt], axis=1)
        # first edge index j where cum[j+1] >= rank  (bin j holds the rank)
        ge = cum[:, 1:] >= ranks[:, None]
        j = jnp.argmax(ge, axis=1)
        # if no bin satisfies (can't happen when rank <= valid count), last
        j = jnp.where(jnp.any(ge, axis=1), j, bins - 1)
        width = (his - los) / bins
        new_lo = los + j.astype(jnp.float32) * width
        new_hi = new_lo + width
        below_lo = jnp.take_along_axis(cum, j[:, None], axis=1)[:, 0]
        nxt = jnp.take_along_axis(cum, (j + 1)[:, None], axis=1)[:, 0]
        in_bin = nxt - below_lo  # inf ("count unknown") only in the top bin
        los, his = new_lo, new_hi

    # final interpolation: frac = (rank - below_lo) / in_bin (stats.rs:334)
    rank_in = ranks - below_lo
    f = jnp.where((in_bin > 0) & jnp.isfinite(in_bin),
                  rank_in / jnp.maximum(in_bin, 1.0), 0.5)
    f = jnp.clip(f, 0.0, 1.0)
    vals = los + f * (his - los)
    return jnp.where(ranks <= 0, jnp.broadcast_to(lo, (k,)), vals)


def masked_median(x: jax.Array, valid_count: jax.Array, lo: jax.Array,
                  hi: jax.Array, exact_pair: bool = True,
                  bins: int = BINS, rounds: int = ROUNDS) -> jax.Array:
    """Median of the valid (non-inf) elements of x (any shape).

    exact_pair=True mirrors the reference's exact path (median.rs:27-43):
    even counts average the two middle order statistics. False mirrors
    the histogram path (stats.rs:100: rank = ceil(n/2) only).
    """
    n = valid_count.astype(jnp.float32)
    if exact_pair:
        r1 = jnp.floor((n + 1.0) / 2.0)
        r2 = jnp.floor(n / 2.0) + 1.0
        vals = masked_rank_values(x, jnp.stack([r1, r2]), lo, hi, bins, rounds)
        return jnp.where(valid_count > 0, (vals[0] + vals[1]) * 0.5, 0.0)
    r = jnp.ceil(n * 0.5)
    vals = masked_rank_values(x, r[None], lo, hi, bins, rounds)
    return jnp.where(valid_count > 0, vals[0], 0.0)


def masked_median_mad(x: jax.Array, valid_count: jax.Array, lo: jax.Array,
                      hi: jax.Array, exact_pair: bool = True,
                      bins: int = BINS, rounds: int = ROUNDS):
    """(median, MAD) of valid elements; x has invalid mapped to +inf."""
    med = masked_median(x, valid_count, lo, hi, exact_pair, bins, rounds)
    dev = jnp.abs(x - med)  # inf stays inf for invalid
    dev_hi = hi - lo  # deviations bounded by the data range
    mad = masked_median(dev, valid_count, jnp.float32(0.0),
                        jnp.maximum(dev_hi, 1e-30), exact_pair, bins, rounds)
    return med, mad
