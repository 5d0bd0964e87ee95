"""Sharded IFU-cube reductions.

The reference collapses cubes on one host with rayon
(src-tauri/src/core/cube/eager.rs:24-28) and keeps 2 GB cubes
tractable by lazy-mmap frame caching (cube/lazy.rs). Here the
spectral axis shards over the mesh: each device holds a contiguous
band of frames, collapses locally, and a `psum` (mean) or a global
compare-count rank refinement (median) combines the bands — the cube
never materializes on one chip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_cube(cube: jax.Array, mesh: Mesh, axis_name: str = "frames"):
    """Place [B, H, W] with the spectral axis sharded over `axis_name`.

    B must divide by the mesh axis size (pad with NaN frames upstream
    if not; NaN frames are ignored by the collapses below)."""
    return jax.device_put(cube, NamedSharding(mesh, P(axis_name, None, None)))


def sharded_collapse_mean(cube: jax.Array, mesh: Mesh,
                          axis_name: str = "frames") -> jax.Array:
    """NaN-aware mean over the sharded spectral axis (eager.rs:24-26
    semantics): psum of local masked sums and counts."""
    spec = P(axis_name, None, None)
    out_spec = P(None, None)

    def body(local):
        finite = jnp.isfinite(local)
        s = jnp.sum(jnp.where(finite, local, 0.0), axis=0)
        c = jnp.sum(finite.astype(jnp.float32), axis=0)
        s = jax.lax.psum(s, axis_name)
        c = jax.lax.psum(c, axis_name)
        return jnp.where(c > 0, s / jnp.maximum(c, 1.0), 0.0)

    return shard_map(body, mesh=mesh, in_specs=(spec,),
                     out_specs=out_spec)(cube)


def sharded_collapse_median(cube: jax.Array, mesh: Mesh,
                            axis_name: str = "frames",
                            rounds: int = 5, bins: int = 16) -> jax.Array:
    """NaN-aware per-pixel median over the sharded spectral axis.

    Per-pixel compare-count bracket refinement (the ops.quantile
    scheme, vectorized over pixels): each round counts local values
    below per-pixel bin edges, psums the counts, and narrows the
    bracket holding rank ⌈n/2⌉. Resolution is range/bins^rounds
    (default range/10⁶, the same order as the reference's 65536-bin
    histogram refinement, stats.rs:85-210); frames never leave their
    shard.
    """
    spec = P(axis_name, None, None)
    out_spec = P(None, None)

    def body(local):
        finite = jnp.isfinite(local)
        vals = jnp.where(finite, local, jnp.inf)
        neg = jnp.where(finite, local, -jnp.inf)
        cnt = jax.lax.psum(jnp.sum(finite.astype(jnp.float32), axis=0),
                           axis_name)
        lo = jax.lax.pmin(jnp.min(vals, axis=0), axis_name)
        hi = jax.lax.pmax(jnp.max(neg, axis=0), axis_name)
        lo = jnp.where(cnt > 0, lo, 0.0)
        hi = jnp.where(cnt > 0, hi, 0.0)
        hi = hi + jnp.maximum(hi - lo, 1e-30) * 1e-6 + 1e-37
        rank = jnp.ceil(cnt * 0.5)
        below = jnp.zeros_like(cnt)
        for _ in range(rounds):
            width = (hi - lo) / bins
            # counts below each interior edge: [bins-1, H, W]
            edges = lo[None] + width[None] * jnp.arange(
                1, bins, dtype=jnp.float32)[:, None, None]
            c = jnp.sum(vals[None] < edges[:, None], axis=1,
                        dtype=jnp.float32)
            c = jax.lax.psum(c, axis_name)
            cum = jnp.concatenate([below[None], c,
                                   jnp.full_like(below, jnp.inf)[None]],
                                  axis=0)
            ge = cum[1:] >= rank[None]
            j = jnp.argmax(ge, axis=0)
            j = jnp.where(jnp.any(ge, axis=0), j, bins - 1)
            jf = j.astype(jnp.float32)
            below = jnp.take_along_axis(cum, j[None], axis=0)[0]
            lo, hi = lo + jf * width, lo + (jf + 1.0) * width
        mid = (lo + hi) * 0.5
        return jnp.where(cnt > 0, mid, 0.0)

    return shard_map(body, mesh=mesh, in_specs=(spec,),
                     out_specs=out_spec)(cube)
