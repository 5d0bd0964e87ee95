"""N-channel × 3 weight-matrix blending.

Reference: src-tauri/src/core/compose/channel_blend.rs —
Out_c = Σ_k W[k,c] · Channel_k, one einsum contraction.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _blend_kernel(stack: jax.Array, weights: jax.Array):
    # stack [C, H, W], weights [C, 3] → [3, H, W]
    return jnp.einsum("chw,ck->khw", stack, weights,
                      precision=jax.lax.Precision.HIGHEST)


def blend_channels(channels: Sequence, weights: Sequence[dict]
                   ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """weights entries: {channel_idx, r_weight, g_weight, b_weight}
    (channel_blend.rs:13-70). Out-of-range channel indices ignored."""
    n = len(channels)
    w = np.zeros((n, 3), np.float32)
    for entry in weights:
        idx = int(entry["channel_idx"])
        if idx < n:
            w[idx, 0] += float(entry["r_weight"])
            w[idx, 1] += float(entry["g_weight"])
            w[idx, 2] += float(entry["b_weight"])
    stack = jnp.stack([jnp.asarray(c) for c in channels])
    out = _blend_kernel(stack, jnp.asarray(w))
    return out[0], out[1], out[2]
