"""Shear-decomposed affine warp without 2D gathers.

The reference warps with a per-pixel bicubic sampler
(src-tauri/src/core/alignment/affine.rs:663-690 +
src-tauri/src/core/imaging/sampling.rs:51-80 clamp_index).  A literal
translation is an elementwise 2D gather.  This module reaches the same
separable Catmull-Rom result with rolls, selects and axis takes only:

1. **Edge-replicate pad** along the resample axis (free-ish copy) —
   reproduces the reference's per-tap ``clamp_index`` semantics.
2. **Bit-decomposed integer shear**: the rotation cross-term makes the
   source index 2D (``p·y + q·u + r``).  Split the per-column integer
   part ``s(u) = round(q·u)`` into bits; each bit is one
   ``jnp.roll`` + masked select (one elementwise pass).
   ``ceil(log2(span))`` passes replace a 2D gather.
3. **Index-VECTOR takes**: after the shear the remaining integer index
   depends on the output row only — ``jnp.take`` along an axis with an
   index *vector* moves whole rows or columns.
   Five takes cover the Catmull-Rom support for a sample point in
   [-1, 1) around the rounded base.
4. **Dense weights**: the fractional position splits as
   ``alpha(y) + rho(u)`` (outer sum), so the 5 tap weights are plain
   elementwise math that XLA fuses into the tap accumulation.

Pass 1 resamples rows (vertical), pass 2 columns (horizontal), with the
same corrected coefficients as the two-pass sampler in
``alignment/affine.py`` — results match ``_warp_two_pass_kernel`` to
f32 rounding and the direct 2D sampler to interpolation-order
commutation (the same delta the two-pass form already carries).

Static shapes: the pad width ``m`` must bound the shear span and is
computed host-side from the *concrete* transform (bucketed to powers of
two to bound recompiles).  ``warp_image`` falls back to the gather
kernels when the transform is traced or the span is degenerate.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from astroburst_tpu.ops.resample import catmull_rom


def _bucket(m: int) -> int:
    """Round the pad width up to a power of two (min 8) so jit caches
    stay small across nearby transforms."""
    b = 8
    while b < m:
        b *= 2
    return b


def _bit_shear(img: jax.Array, shifts: jax.Array, nbits: int,
               axis: int, skip_empty_bits: bool = False) -> jax.Array:
    """sheared[.., v, ..] = img[.., v + shifts[..], ..] (circular).

    ``shifts`` is a non-negative int32 vector along the OTHER axis
    (per-column shifts for axis=0, per-row for axis=1), each
    < 2**nbits.  Each bit costs one roll (free) + one select pass.

    ``skip_empty_bits`` wraps each pass in a lax.cond that skips it
    when no row/column sets that bit — for ENVELOPE-sized nbits
    (the fused align chain: a 0.4° rotation uses 4 of 7 bits). Leave
    it off when nbits is sized to the actual transform (host
    warp_shear): every bit is then live and the conds are overhead.
    """
    mask_shape = (1, -1) if axis == 0 else (-1, 1)
    out = img
    for k in range(nbits):
        bit = ((shifts >> k) & 1).reshape(mask_shape)
        if skip_empty_bits:
            def _apply(o, bit=bit, k=k):
                return jnp.where(bit == 1,
                                 jnp.roll(o, -(1 << k), axis=axis), o)
            out = jax.lax.cond(jnp.any(bit == 1), _apply, lambda o: o, out)
        else:
            out = jnp.where(bit == 1, jnp.roll(out, -(1 << k), axis=axis),
                            out)
    return out


def _resample_axis(img: jax.Array, base_f: jax.Array, cross_f: jax.Array,
                   m: int, nbits: int, axis: int,
                   skip_empty_bits: bool = False) -> jax.Array:
    """Separable Catmull-Rom resample along ``axis``.

    Sample position for output index i (along axis) and cross index u:
    ``pos(i, u) = base_f[i] + cross_f[u]``.  Taps are clamped to the
    source extent (edge replication), matching sampling.rs clamp_index.
    ``m`` must be >= round(max cross) - round(min cross) + 3.
    """
    n_src = img.shape[axis]
    pad = ((m, m), (0, 0)) if axis == 0 else ((0, 0), (m, m))
    img_p = jnp.pad(img, pad, mode="edge")

    s_f = cross_f
    s_i = jnp.round(s_f).astype(jnp.int32)
    rho = s_f - s_i.astype(jnp.float32)            # [-0.5, 0.5]
    s_min = jnp.min(jnp.stack([s_i[0], s_i[-1]]))  # linear → ends extreme
    sheared = _bit_shear(img_p, s_i - s_min, nbits, axis,
                         skip_empty_bits)

    i0 = jnp.round(base_f).astype(jnp.int32)
    alpha = base_f - i0.astype(jnp.float32)        # [-0.5, 0.5]
    if axis == 0:
        t = alpha[:, None] + rho[None, :]
        idx_base = i0 + m + s_min
    else:
        t = alpha[None, :] + rho[:, None]
        idx_base = i0 + m + s_min
    hi = n_src + 2 * m - 1
    out = None
    for j in range(-2, 3):
        wj = catmull_rom(t - j)
        idx = jnp.clip(idx_base + j, 0, hi)
        tap = jnp.take(sheared, idx, axis=axis)
        term = wj * tap
        # the 5-tap window covers both 4-tap branches of t ∈ [-1, 1);
        # the branch-excluded tap has weight 0, but 0·NaN = NaN would
        # widen the NaN footprint past the reference's 4 taps — force
        # the excluded term to zero instead
        if j == -2:
            term = jnp.where(t >= 0.0, 0.0, term)
        elif j == 2:
            term = jnp.where(t < 0.0, 0.0, term)
        out = term if out is None else out + term
    return out


@partial(jax.jit, static_argnames=("out_rows", "out_cols", "m_v", "m_h",
                                   "nbits_v", "nbits_h",
                                   "skip_empty_bits"))
def _warp_shear_impl(image: jax.Array, params: jax.Array, out_rows: int,
                     out_cols: int, m_v: int, m_h: int, nbits_v: int,
                     nbits_h: int, skip_empty_bits: bool = False) -> jax.Array:
    src_rows, src_cols = image.shape
    a, b, tx, c, d, ty = [params[i] for i in range(6)]
    # pass 1 (vertical): tmp[y, u] = img[p·y + q·u + r, u]
    # coefficients corrected so pass 2 composes to (sx, sy) exactly
    # (see _warp_two_pass_kernel in alignment/affine.py)
    q = c / a
    p = d - q * b
    r = ty - q * tx
    y = jnp.arange(out_rows, dtype=jnp.float32)
    u = jnp.arange(src_cols, dtype=jnp.float32)
    tmp = _resample_axis(image, p * y + r, q * u, m_v, nbits_v,
                         axis=0, skip_empty_bits=skip_empty_bits)

    # pass 2 (horizontal): out[y, x] = tmp[y, a·x + b·y + tx]
    x = jnp.arange(out_cols, dtype=jnp.float32)
    out = _resample_axis(tmp, a * x + tx, b * y, m_h, nbits_h,
                         axis=1, skip_empty_bits=skip_empty_bits)

    sx = a * x[None, :] + b * y[:, None] + tx
    sy = c * x[None, :] + d * y[:, None] + ty
    inside = ((sx >= 0.0) & (sy >= 0.0) & (sx < src_cols - 1) &
              (sy < src_rows - 1))
    return jnp.where(inside, out, 0.0)


class ShearEnvelopeError(ValueError):
    """The transform is outside the shear decomposition's envelope
    (|a| tiny, or shear span over 4096 px); callers fall back to the
    gather kernels. A dedicated type so fallbacks don't swallow
    unexpected ValueErrors from inside the implementation."""


def warp_shear(image: jax.Array, transform, out_rows: int,
               out_cols: int) -> jax.Array:
    """Affine warp via shear decomposition; ``transform`` must be a
    concrete AffineTransform (host floats — pad widths become static).

    Raises ShearEnvelopeError when the transform is outside the shear
    form's envelope (|a| tiny, or shear span over 4096 px) — callers
    fall back to the gather kernels.
    """
    t = transform
    if abs(t.a) < 1e-3:
        raise ShearEnvelopeError("degenerate a; use the exact sampler")
    src_rows, src_cols = image.shape
    q = t.c / t.a
    span_v = abs(q) * max(src_cols - 1, 1)
    span_h = abs(t.b) * max(out_rows - 1, 1)
    if span_v > 4096 or span_h > 4096:
        raise ShearEnvelopeError(
            "shear span too large; use the exact sampler")
    m_v = _bucket(int(span_v) + 4)
    m_h = _bucket(int(span_h) + 4)
    nbits_v = max(int(span_v) + 1, 1).bit_length()
    nbits_h = max(int(span_h) + 1, 1).bit_length()
    params = jnp.asarray(t.as_tuple(), dtype=jnp.float32)
    return _warp_shear_impl(jnp.asarray(image, jnp.float32), params,
                            out_rows, out_cols, m_v, m_h, nbits_v, nbits_h)
