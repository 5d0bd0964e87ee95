"""Row-sharded drizzle over a device mesh.

Drizzle's output rows are independent given the input frames (each
output band gathers from a bounded input-row window), so the exact
capped-push-list kernel data-parallelizes over output rows with ZERO
collectives beyond the input broadcast and one psum for the rejection
count: every device runs the banded kernel
(stacking/drizzle.py:_drizzle_kernel_exact) on its own row block,
offset into the global output grid via ``row0_offset``.

The input stack stays replicated — at drizzle scales (tens of frames ×
Mpx) the stack fits device memory comfortably and each shard's gather
window spans most input rows anyway, so sharding the input would buy
little and cost halo machinery. Completes the SURVEY §5 distributed
mapping for the drizzle stage.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from astroburst_tpu.dtypes import DrizzleKernel


def sharded_drizzle(mesh: Mesh, stack: jax.Array, d_ys: jax.Array,
                    d_xs: jax.Array, scale: float, pixfrac: float,
                    kernel: DrizzleKernel, out_rows: int, out_cols: int,
                    sigma_low: float, sigma_high: float,
                    sigma_iterations: int, axis_name: str = "rows",
                    band_rows: int = 64):
    """Exact-parity drizzle with output rows sharded over
    ``axis_name``. Returns (image [out_rows, out_cols], weight map,
    rejected scalar) — identical to _drizzle_kernel_exact.
    """
    from astroburst_tpu.stacking.drizzle import _drizzle_kernel_exact

    n_sh = mesh.shape[axis_name]
    rows_pad = -(-out_rows // (n_sh * band_rows)) * (n_sh * band_rows)
    local_rows = rows_pad // n_sh

    stack = jax.device_put(stack, NamedSharding(mesh, P()))
    d_ys = jnp.asarray(d_ys, jnp.float32)
    d_xs = jnp.asarray(d_xs, jnp.float32)

    def local(stack, d_ys, d_xs):
        idx = jax.lax.axis_index(axis_name)
        img, wgt, rej = _drizzle_kernel_exact(
            stack, d_ys, d_xs, scale, pixfrac, kernel, local_rows,
            out_cols, sigma_low, sigma_high, sigma_iterations,
            band_rows=band_rows, row0_offset=idx * local_rows)
        return img, wgt, jax.lax.psum(rej, axis_name)

    img, wgt, rej = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(axis_name, None), P(axis_name, None), P()),
        check_vma=False)(stack, d_ys, d_xs)
    return img[:out_rows], wgt[:out_rows], rej
