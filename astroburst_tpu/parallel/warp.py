"""Sharded affine warp.

The shear-decomposed warp (alignment/warp_shear.py) is naturally
spatially shardable without halo exchange: pass 1 (vertical resample —
per-column shear + row takes) touches each COLUMN independently, and
pass 2 (horizontal resample) touches each ROW independently. Sharding
pass 1 over columns and pass 2 over rows makes every roll/take/select
local to its shard; GSPMD inserts exactly one all-to-all between the
passes at the sharding-constraint boundary, plus the
final mask runs row-sharded.

Reference semantics: affine.rs:663-690 per-pixel bicubic with
clamp_index taps, outside -> 0 — identical to the single-chip
warp_shear (same code path, only layout constraints added).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from astroburst_tpu.alignment.warp_shear import (_bucket, _resample_axis,
                                                 warp_shear)


def make_sharded_warp(mesh: Mesh, transform, out_rows: int, out_cols: int,
                      axis_name: str = "rows"):
    """jit a sharded warp for a concrete AffineTransform.

    Returns a jitted fn(image [H, W]) -> warped [out_rows, out_cols]
    with pass 1 column-sharded and pass 2 row-sharded over
    ``axis_name``. Pad widths are static (from the concrete transform,
    like warp_shear). Raises ValueError outside the shear envelope.
    """
    t = transform
    if abs(t.a) < 1e-3:
        raise ValueError("degenerate a; use the exact sampler")
    q = t.c / t.a
    span_h = abs(t.b) * max(out_rows - 1, 1)

    cols_spec = NamedSharding(mesh, P(None, axis_name))
    rows_spec = NamedSharding(mesh, P(axis_name, None))

    def warp(image):
        src_rows, src_cols = image.shape
        span_v = abs(q) * max(src_cols - 1, 1)
        m_v = _bucket(int(span_v) + 4)
        m_h = _bucket(int(span_h) + 4)
        nbits_v = max(int(span_v) + 1, 1).bit_length()
        nbits_h = max(int(span_h) + 1, 1).bit_length()
        a, b, tx, c, d, ty = [jnp.float32(v) for v in t.as_tuple()]
        qq = c / a
        p = d - qq * b
        r = ty - qq * tx
        y = jnp.arange(out_rows, dtype=jnp.float32)
        u = jnp.arange(src_cols, dtype=jnp.float32)
        x = jnp.arange(out_cols, dtype=jnp.float32)

        # pass 1: column-sharded (vertical ops are per-column local)
        img = jax.lax.with_sharding_constraint(image, cols_spec)
        tmp = _resample_axis(img, p * y + r, qq * u, m_v, nbits_v, axis=0)
        # reshard: one all-to-all; pass 2 is per-row local
        tmp = jax.lax.with_sharding_constraint(tmp, rows_spec)
        out = _resample_axis(tmp, a * x + tx, b * y, m_h, nbits_h, axis=1)

        sx = a * x[None, :] + b * y[:, None] + tx
        sy = c * x[None, :] + d * y[:, None] + ty
        inside = ((sx >= 0.0) & (sy >= 0.0) & (sx < src_cols - 1) &
                  (sy < src_rows - 1))
        out = jnp.where(inside, out, 0.0)
        return jax.lax.with_sharding_constraint(out, rows_spec)

    return jax.jit(warp)


__all__ = ["make_sharded_warp", "warp_shear"]
