"""Elementwise bitonic sorting networks along axis 0.

XLA's generic ``sort`` HLO on a short major axis lowers to a
comparator loop that fuses poorly. These networks express every
compare-exchange round as reshape + size-2-axis reverse + min/max —
pure elementwise data flow that XLA fuses, keeping rounds out of
device memory. Used by the drizzle
finalize (stacking/drizzle.py), whose per-pixel candidate axis is
short (≲64) while the batch (the output plane) is huge — exactly the
regime where the network form wins.

Key extra: :func:`bitonic_merge_axis0` sorts any *bitonic* input
(ascending-then-descending or any cyclic rotation, e.g. a V-shape) in
``log2(m)`` rounds instead of a full sort's ``log2(m)·(log2(m)+1)/2``.
The drizzle clip loop's deviation array ``|sorted_v − median|`` masked
to a contiguous window is V-shaped (decreasing to the median position,
then increasing, with +inf outside the window extending both
monotone branches), so each clip iteration needs only a merge.

All networks are exact permutations — results match ``jnp.sort``
bit-for-bit for any input without NaNs (±inf fine).
"""

from __future__ import annotations

import jax.numpy as jnp


def _swap_stride(x, stride: int):
    """x[i ^ stride] along axis 0 via reshape + reverse of a size-2 axis."""
    m = x.shape[0]
    rest = x.shape[1:]
    xr = x.reshape((m // (2 * stride), 2, stride) + rest)
    return xr[:, ::-1].reshape((m,) + rest)


def pad_pow2_inf(x, like=None):
    """Pad axis 0 to the next power of two with +inf (sorts to the
    tail; live entries keep their ranks)."""
    m = x.shape[0]
    m2 = 1 << (m - 1).bit_length()
    if m2 == m:
        return x
    pad = jnp.full((m2 - m,) + x.shape[1:], jnp.inf, x.dtype)
    return jnp.concatenate([x, pad], axis=0)


def bitonic_merge_axis0(x):
    """Sort a BITONIC sequence along axis 0, ascending.

    Input must be bitonic per batch element: at most one direction
    change when read cyclically (V-shapes and monotone sequences
    qualify). ``log2(m)`` compare-exchange rounds; axis length must be
    a power of two (use :func:`pad_pow2_inf`).
    """
    m = x.shape[0]
    assert m & (m - 1) == 0, "axis 0 must be a power of two"
    stride = m // 2
    while stride >= 1:
        p = _swap_stride(x, stride)
        mn = jnp.minimum(x, p)
        mx = jnp.maximum(x, p)
        take_min = (jnp.arange(m) & stride) == 0
        shape = (m,) + (1,) * (x.ndim - 1)
        x = jnp.where(take_min.reshape(shape), mn, mx)
        stride //= 2
    return x


def pad_pow2_inf_last(x):
    """Pad the LAST axis to the next power of two with +inf."""
    m = x.shape[-1]
    m2 = 1 << (m - 1).bit_length()
    if m2 == m:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m2 - m)]
    return jnp.pad(x, pad, constant_values=jnp.inf)


def bitonic_merge_last(x):
    """Sort a BITONIC sequence along the LAST axis, ascending
    (log2(m) rounds; m must be a power of two — use
    :func:`pad_pow2_inf_last`)."""
    m = x.shape[-1]
    assert m & (m - 1) == 0, "last axis must be a power of two"
    lead = x.shape[:-1]
    stride = m // 2
    while stride >= 1:
        xr = x.reshape(lead + (m // (2 * stride), 2, stride))
        p = xr[..., ::-1, :].reshape(lead + (m,))
        mn = jnp.minimum(x, p)
        mx = jnp.maximum(x, p)
        take_min = (jnp.arange(m) & stride) == 0
        x = jnp.where(take_min, mn, mx)
        stride //= 2
    return x


def bitonic_sort_axis0(x):
    """Full bitonic sort along axis 0, ascending. Axis length must be
    a power of two (use :func:`pad_pow2_inf`)."""
    m = x.shape[0]
    assert m & (m - 1) == 0, "axis 0 must be a power of two"
    k = m.bit_length() - 1
    idx = jnp.arange(m)
    for stage in range(1, k + 1):
        block = 1 << stage
        ascending = (idx // block) % 2 == 0
        for s in reversed(range(stage)):
            stride = 1 << s
            p = _swap_stride(x, stride)
            mn = jnp.minimum(x, p)
            mx = jnp.maximum(x, p)
            low_half = (idx & stride) == 0
            take_min = ascending == low_half
            shape = (m,) + (1,) * (x.ndim - 1)
            x = jnp.where(take_min.reshape(shape), mn, mx)
    return x
