"""One-pass shift + sigma-clip kernel (Pallas, Triton route, GPU).

Each program owns one ``BLOCK_H × BLOCK_W`` output tile. For every
frame it loads its (dy, dx) from a small offsets array and reads the
4×4 Catmull-Rom taps straight from the raw [N, H, W] stack at clamped
row and column indices — the clamp IS the reference's edge replication
(src-tauri/src/core/imaging/sampling.rs:51-80 ``clamp_index``), so no
padded layout and no offset envelope exist. The shifted stack is never
written: a pixel's N samples stay in registers for the per-pixel clip
loop (``_clip_body``), and the raw stack is read from device memory
once (neighbouring taps hit in L1/L2).

Semantics are those of ``shift_bicubic`` + ``sigma_clip_core``
(src-tauri/src/core/stacking/combine.rs:14-91, align.rs:36-57): zero
outside the source, raw pixels on a frame whose offset is exactly zero,
NaN/inf excluded from the clip. ``rejected`` is written as one partial
count per program and summed outside the kernel — deterministic, no
atomics.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from astroburst_tpu.constants import MAD_TO_SIGMA
from astroburst_tpu.ops.resample import catmull_rom

# a block is BLOCK_H × BLOCK_W output pixels (powers of two); each
# thread holds one pixel's samples of every frame, so the per-pixel
# reductions over frames never leave the thread
# (BLOCK_H·BLOCK_W = 32·NUM_WARPS). Seven other shapes from 1×64 to
# 4×64 ran within 4% of this one on the H100 (PERF.md)
BLOCK_H = 8
BLOCK_W = 32
NUM_WARPS = 8
# a pixel's samples, their clip mask and temporaries live in registers
# (next power of two ≥ N slots each); past this many frames the tile
# would spill, and the caller takes the XLA path
# (stacking.combine.shift_clip)
MAX_FRAMES = 32


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _select_rank(vals, rank):
    """Per column of ``vals`` [F, P]: the element of sorted rank
    ``rank`` [P] (ascending, ties counted in place) — the value a sort
    along axis 0 would put at index ``rank``. Rank-``r`` element v_k
    has #(< v_k) ≤ r < #(≤ v_k); all such candidates are equal. +inf
    padding sorts last, as it would in a sort."""
    n = vals.shape[0]
    slot = jax.lax.broadcasted_iota(jnp.int32, vals.shape, 0)
    out = jnp.full(vals.shape[1:], -jnp.inf, vals.dtype)
    for k in range(n):
        # row k as a [P] vector (a masked sum: Triton has no slice)
        v = jnp.sum(jnp.where(slot == k, vals, 0.0), axis=0)
        less = jnp.sum(jnp.where(vals < v[None], 1, 0), axis=0)
        leq = jnp.sum(jnp.where(vals <= v[None], 1, 0), axis=0)
        hit = (less <= rank) & (rank < leq)
        out = jnp.maximum(out, jnp.where(hit, v, -jnp.inf))
    return out


def _clip_body(vals, sigma_low: float, sigma_high: float, max_iter: int):
    """The per-pixel clip loop over ``vals`` [F, P] (frames × pixels).

    Same decisions as ``sigma_clip_core``: a sample takes part iff it
    is finite; iteration 0 centers on the median with MAD·1.4826
    (select_nth semantics: the element at index count/2), later rounds
    on mean and sample std; a pixel stops when a round removes nothing;
    the result is the mean of the survivors, or the last center.
    Returns (combined [P] f32, rejected [P] i32).
    """
    finite = jnp.isfinite(vals)
    # NaN/inf must be REPLACED (0·NaN = NaN); later uses go through safe
    safe = jnp.where(finite, vals, 0.0)
    mask = finite.astype(jnp.float32)
    count0 = jnp.sum(mask, axis=0)
    zero = jnp.zeros_like(count0)

    def step(mask, stopped, last_center, have_center, center, sigma):
        """One clip round given (center, sigma) [P]; returns the new
        state."""
        cnt = jnp.sum(mask, axis=0)
        active = (cnt >= 2.0) & (stopped == 0.0)
        dev = safe - center[None]
        keep = (dev >= (-sigma_low * sigma)[None]) & (
            dev <= (sigma_high * sigma)[None])
        new_mask = jnp.where(active[None] & ~keep, 0.0, mask)
        new_cnt = jnp.sum(new_mask, axis=0)
        stopped = jnp.where(active & (new_cnt == cnt), 1.0, stopped)
        last_center = jnp.where(active, center, last_center)
        have_center = jnp.where(active, 1.0, have_center)
        return new_mask, stopped, last_center, have_center

    # iteration 0: median / MAD center
    rank = jnp.floor(count0 * 0.5)
    med = _select_rank(jnp.where(finite, safe, jnp.inf), rank)
    mad = _select_rank(jnp.where(finite, jnp.abs(safe - med[None]),
                                 jnp.inf), rank)
    sigma0 = jnp.maximum(mad * MAD_TO_SIGMA, 1e-10)
    mask, stopped, last_center, have_center = step(
        mask, zero, zero, zero, med, sigma0)

    # iterations 1..max_iter-1 (mean/σ center), unrolled: Triton's
    # compiler crashes on a while loop here. Once a round removes
    # nothing, every active pixel stops, so later rounds are exact
    # no-ops
    for _ in range(1, max_iter):
        cntf = jnp.maximum(jnp.sum(mask, axis=0), 1.0)
        mean = jnp.sum(safe * mask, axis=0) / cntf
        var = jnp.sum((safe - mean[None]) ** 2 * mask,
                      axis=0) / jnp.maximum(cntf - 1.0, 1.0)
        sigma = jnp.maximum(jnp.sqrt(var), 1e-10)
        mask, stopped, last_center, have_center = step(
            mask, stopped, last_center, have_center, mean, sigma)

    final_cnt = jnp.sum(mask, axis=0)
    mean_final = jnp.sum(safe * mask, axis=0) / jnp.maximum(final_cnt, 1.0)
    fallback = jnp.where((have_center > 0) & jnp.isfinite(last_center),
                         last_center, 0.0)
    combined = jnp.where(final_cnt > 0, mean_final, fallback)
    rejected = (count0 - final_cnt).astype(jnp.int32)
    return combined, rejected


def _make_kernel(n: int, src_h: int, w: int, out_off: int, out_h: int,
                 gh: int, sigma_low: float, sigma_high: float,
                 max_iter: int, block_h: int, block_w: int):
    """``src_h`` rows of source; output rows ``[out_off, out_off+out_h)``
    of it. ``gh`` and the traced ``grow0`` place the output rows in the
    global image for the outside-source test (row-sharded slabs); a
    single device has ``out_off = grow0 = 0`` and ``gh = src_h``."""
    n_slots = _next_pow2(n)
    n_px = block_h * block_w

    def kernel(dys_ref, dxs_ref, grow0_ref, stack_ref, out_ref, rej_ref):
        bi = pl.program_id(0)
        bj = pl.program_id(1)
        p = jax.lax.broadcasted_iota(jnp.int32, (n_px,), 0)
        r_out = bi * block_h + p // block_w            # [P]
        c_out = bj * block_w + p % block_w
        r_src = r_out[None, :] + out_off               # [1, P]
        c_src = c_out[None, :]
        frame = jax.lax.broadcasted_iota(jnp.int32, (n_slots,), 0)
        k_ld = jnp.minimum(frame, n - 1)               # [F]
        # per-frame offsets as [F, 1] columns (padded slots repeat the
        # last frame and are masked out below)
        dy = dys_ref[k_ld][:, None]
        dx = dxs_ref[k_ld][:, None]
        k_ld = k_ld[:, None]
        ky = jnp.floor(dy).astype(jnp.int32)
        kx = jnp.floor(dx).astype(jnp.int32)
        fy = dy - ky.astype(jnp.float32)
        fx = dx - kx.astype(jnp.float32)

        rows = [jnp.clip(r_src + ky + (j - 1), 0, src_h - 1)
                for j in range(4)]                     # [F, P] each
        cols = [jnp.clip(c_src + kx + (i - 1), 0, w - 1) for i in range(4)]
        out = None
        for i in range(4):
            tmp = None
            for j in range(4):
                term = catmull_rom(fy - (j - 1)) * stack_ref[k_ld, rows[j],
                                                             cols[i]]
                tmp = term if tmp is None else tmp + term
            term = catmull_rom(fx - (i - 1)) * tmp
            out = term if out is None else out + term
        # outside-source pixels are exactly 0 (align.rs:48-51), in
        # global image coordinates
        sy = (r_out[None, :] + grow0_ref[0]).astype(jnp.float32) + dy
        sx = c_src.astype(jnp.float32) + dx
        inside = ((sy >= -0.5) & (sy <= gh - 0.5) &
                  (sx >= -0.5) & (sx <= w - 0.5))
        shifted = jnp.where(inside, out, 0.0)
        # a true zero shift returns the raw pixels (align.rs:37-39):
        # zero-weight taps would otherwise bleed NaN around dead pixels
        exact_zero = (jnp.abs(dy) < 1e-12) & (jnp.abs(dx) < 1e-12)
        raw = stack_ref[k_ld, jnp.clip(r_src, 0, src_h - 1),
                        jnp.clip(c_src, 0, w - 1)]
        vals = jnp.where(exact_zero, raw, shifted)
        vals = jnp.where(frame[:, None] < n, vals, jnp.nan)  # padded slots

        combined, rejected = _clip_body(vals, sigma_low, sigma_high,
                                        max_iter)
        # the output is padded to whole blocks and cropped outside;
        # pixels past the image count no rejections
        out_ref[r_out, c_out] = combined
        valid = (r_out < out_h) & (c_out < w)
        rej_ref[0, 0] = jnp.sum(jnp.where(valid, rejected, 0))

    return kernel


@partial(jax.jit,
         static_argnames=("sigma_low", "sigma_high", "max_iter", "out_off",
                          "out_h", "gh", "interpret", "block_h", "block_w",
                          "num_warps"))
def _shift_clip_call(stack: jax.Array, dys: jax.Array, dxs: jax.Array,
                     grow0: jax.Array, sigma_low: float, sigma_high: float,
                     max_iter: int, out_off: int, out_h: int, gh: int,
                     interpret: bool, block_h: int = BLOCK_H,
                     block_w: int = BLOCK_W, num_warps: int = NUM_WARPS):
    """The pallas_call. The block geometry is a parameter only so the
    tests can show it never changes the result; callers use the
    defaults."""
    n, src_h, w = stack.shape
    dys = jnp.asarray(dys, jnp.float32)
    dxs = jnp.asarray(dxs, jnp.float32)
    grow0 = jnp.reshape(jnp.asarray(grow0, jnp.int32), (1,))
    grid = (pl.cdiv(out_h, block_h), pl.cdiv(w, block_w))
    kernel = _make_kernel(n, src_h, w, out_off, out_h, gh, sigma_low,
                          sigma_high, max_iter, block_h, block_w)
    whole = pl.BlockSpec(memory_space=pl.ANY)
    combined, partials = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[whole, whole, whole, whole],
        out_specs=[whole, pl.BlockSpec((1, 1), lambda i, j: (i, j))],
        out_shape=[jax.ShapeDtypeStruct((grid[0] * block_h,
                                         grid[1] * block_w), jnp.float32),
                   jax.ShapeDtypeStruct(grid, jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="shift_clip_onepass",
    )(dys, dxs, grow0, stack.astype(jnp.float32))
    return combined[:out_h, :w], jnp.sum(partials)


def shift_clip_onepass(stack: jax.Array, dys: jax.Array, dxs: jax.Array,
                       sigma_low: float = 3.0, sigma_high: float = 3.0,
                       max_iter: int = 5, interpret: bool = False):
    """Shift each frame of [N, H, W] by (dys[k], dxs[k]) bicubically,
    then sigma-clip combine, in one pass over the stack. Returns
    (combined [H, W] f32, rejected scalar i32). Any offset is exact.
    ``interpret`` runs the Pallas interpreter (CPU tests)."""
    n, h, w = stack.shape
    if n > MAX_FRAMES:
        raise ValueError(f"{n} frames exceed the kernel's register "
                         f"budget of {MAX_FRAMES}")
    return _shift_clip_call(stack, dys, dxs, jnp.int32(0), sigma_low,
                            sigma_high, max_iter, 0, h, h, interpret)


def shift_clip_onepass_slab(slab: jax.Array, dys: jax.Array,
                            dxs: jax.Array, halo: int, grow0: jax.Array,
                            gh: int, sigma_low: float = 3.0,
                            sigma_high: float = 3.0, max_iter: int = 5,
                            interpret: bool = False):
    """Row-sharded slab variant for use inside ``shard_map``.

    ``slab`` is [N, local_h + 2·halo, W]: the shard's output rows plus
    ``halo`` pre-filled rows above and below (neighbour rows via
    ppermute; edge replicas of the global first/last row at the global
    boundaries). Offsets are clamped to ±(halo − 2) so no tap reaches
    off the slab. ``grow0`` is the shard's first output row in GLOBAL
    coords (traced i32) and ``gh`` the global image height — the
    outside-source zero mask (align.rs:48-51) is evaluated globally.
    Returns (combined [local_h, W], rejected scalar i32).
    """
    n, slab_h, w = slab.shape
    if n > MAX_FRAMES:
        raise ValueError(f"{n} frames exceed the kernel's register "
                         f"budget of {MAX_FRAMES}")
    if halo < 3:
        raise ValueError("halo must be >= 3 rows")
    off_max = float(halo - 2)
    dys = jnp.clip(jnp.asarray(dys, jnp.float32), -off_max, off_max)
    dxs = jnp.clip(jnp.asarray(dxs, jnp.float32), -off_max, off_max)
    return _shift_clip_call(slab, dys, dxs, grow0, sigma_low, sigma_high,
                            max_iter, halo, slab_h - 2 * halo, gh,
                            interpret)
