"""Fused align + stack + stretch pipeline, single-chip and sharded.

This is the BASELINE.json headline path: N raw frames [N, H, W] →
phase-correlation alignment to frame 0 → bicubic subpixel shift →
per-pixel sigma-clip combine → robust stats → auto-STF stretch, all
one XLA program (no host syncs).

Sharded version: frames axis carries the alignment fan-out
(data-parallel over exposures); a sharding constraint re-lays the
aligned stack out over spatial rows for the per-pixel combine and the
stretch, letting GSPMD insert the all-to-all / psum collectives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from astroburst_tpu.alignment.phase_correlation import (
    _phase_correlate_traced, phase_correlate_stack_traced)
from astroburst_tpu.imaging.stf import apply_stf_traced, auto_stf_traced
from astroburst_tpu.ops.resample import shift_bicubic
from astroburst_tpu.ops.stats import stats_core
from astroburst_tpu.stacking.combine import (shift_clip, sigma_clip_core,
                                             use_onepass_kernel)


def align_stack_stretch(stack: jax.Array, sigma_low: float = 3.0,
                        sigma_high: float = 3.0, max_iter: int = 5,
                        align: bool = True, exact_pair: bool = False):
    """Pure traced pipeline over [N, H, W]; returns a dict of arrays:
    combined f32 [H,W], preview u8 [H,W], offsets [N,2] f32,
    confidences [N] f32, rejected i32, stf (shadow, midtone) f32.

    The shift + sigma-clip stage is ``stacking.combine.shift_clip``,
    the same entry ``api.stack`` uses: the one-pass kernel on the GPU,
    the XLA form elsewhere or past the kernel's frame budget."""
    n = stack.shape[0]
    if align and n > 1:
        dys1, dxs1, confs1 = phase_correlate_stack_traced(stack[0],
                                                          stack[1:])
        dys = jnp.concatenate([jnp.zeros(1, jnp.float32), dys1])
        dxs = jnp.concatenate([jnp.zeros(1, jnp.float32), dxs1])
        confs = jnp.concatenate([jnp.zeros(1, jnp.float32), confs1])
    else:
        dys = jnp.zeros(n, jnp.float32)
        dxs = jnp.zeros(n, jnp.float32)
        confs = jnp.zeros(n, jnp.float32)

    combined, rejected = shift_clip(stack, dys, dxs, sigma_low,
                                    sigma_high, max_iter)
    mn, mx, _total, count, med, mad = stats_core(combined, exact_pair)
    sigma = jnp.maximum(mad * 1.4826, 1e-30)
    shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count)
    preview = apply_stf_traced(combined, mn, mx, shadow, midtone, as_u8=True)
    return {
        "combined": combined,
        "preview": preview,
        "offsets": jnp.stack([dys, dxs], axis=1),
        "confidences": confs,
        "rejected": rejected,
        "stf": jnp.stack([shadow, midtone]),
        "data_range": jnp.stack([mn, mx]),
    }


def _halo_clip_local(slab, dys, dxs, ax_names, n_sh: int, local_h: int,
                     h: int, halo: int, sigma_low: float,
                     sigma_high: float, max_iter: int, interpret: bool):
    """Per-shard body shared by the reshard variants: ppermute halo
    exchange (edge replicas at the global boundaries), then the
    one-pass shift+clip kernel on the extended slab."""
    from astroburst_tpu.stacking.onepass_kernel import (
        shift_clip_onepass_slab)

    n = slab.shape[0]
    idx = jax.lax.axis_index(ax_names)
    fwd = [(i, (i + 1) % n_sh) for i in range(n_sh)]
    bwd = [(i, (i - 1) % n_sh) for i in range(n_sh)]
    from_prev = jax.lax.ppermute(slab[:, -halo:], ax_names, fwd)
    from_next = jax.lax.ppermute(slab[:, :halo], ax_names, bwd)
    edge_top = jnp.broadcast_to(slab[:, :1], (n, halo, slab.shape[2]))
    edge_bot = jnp.broadcast_to(slab[:, -1:], (n, halo, slab.shape[2]))
    top = jnp.where(idx == 0, edge_top, from_prev)
    bot = jnp.where(idx == n_sh - 1, edge_bot, from_next)
    ext = jnp.concatenate([top, slab, bot], axis=1)
    grow0 = (idx * local_h).astype(jnp.int32)
    combined, rejected = shift_clip_onepass_slab(
        ext, dys, dxs, halo, grow0, h, sigma_low, sigma_high,
        max_iter, interpret=interpret)
    return combined, jax.lax.psum(rejected, ax_names)


def sharded_shift_clip_a2a(mesh: Mesh, stack: jax.Array, dys: jax.Array,
                           dxs: jax.Array, frames_axis: str,
                           rows_axis: str, sigma_low: float,
                           sigma_high: float, max_iter: int,
                           off_max: int = 16, interpret: bool = False):
    """Row-sharded one-pass shift+clip taking a FRAMES-sharded stack,
    with the frames→rows reshard done as one explicit ``all_to_all``
    over the frames mesh axis (the implicit sharding-constraint
    reshard compiled to GSPMD's full-rematerialization fallback,
    replicating the whole aligned stack to every device).

    Layout walkthrough (F = |frames axis|, R = |rows axis|,
    n_sh = F·R): device (f, r) enters holding its n/F frames at full
    height (replicated over r). It reshapes H = n_sh·local_h into
    (F, R, local_h), takes its r-slice — free, the data is replicated
    over r — and all_to_all's the F axis: split piece j goes to device
    (j, r), so (f, r) ends with ALL n frames over row block
    g = f·R + r. Only the truly-moving bytes cross the interconnect,
    in one collective; the result shard order matches
    P((frames_axis, rows_axis)).
    """
    from jax import shard_map

    F = mesh.shape[frames_axis]
    R = mesh.shape[rows_axis]
    n_sh = F * R
    n, h, w = stack.shape
    if n % F:
        raise ValueError(
            f"{n} frames not divisible by the {F}-way '{frames_axis}' "
            "axis; use sharded_shift_clip")
    h_pad = -(-h // n_sh) * n_sh
    if h_pad != h:
        stack = jnp.pad(stack, ((0, 0), (0, h_pad - h), (0, 0)),
                        mode="edge")
    local_h = h_pad // n_sh
    halo = off_max + 2
    if local_h < halo:
        raise ValueError(
            f"row shards of {local_h} rows are smaller than the "
            f"{halo}-row halo (off_max={off_max}); use fewer shards, "
            f"taller images, or a smaller off_max")
    ax_names = (frames_axis, rows_axis)

    def local_fn(fslab, dys, dxs):
        # fslab: [n/F, h_pad, w] — this device's frame block
        r = jax.lax.axis_index(rows_axis)
        n_loc = fslab.shape[0]
        x = fslab.reshape(n_loc, F, R, local_h, w)
        x = jax.lax.dynamic_index_in_dim(x, r, axis=2, keepdims=False)
        x = jax.lax.all_to_all(x, frames_axis, split_axis=1,
                               concat_axis=0, tiled=True)
        slab = x.reshape(n, local_h, w)
        return _halo_clip_local(slab, dys, dxs, ax_names, n_sh, local_h,
                                h, halo, sigma_low, sigma_high, max_iter,
                                interpret)

    combined, rejected = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(frames_axis, None, None), P(None), P(None)),
        out_specs=(P(ax_names, None), P()),
        check_vma=False)(stack, dys, dxs)
    return combined[:h], rejected


def reshard_frames_to_rows(mesh: Mesh, x: jax.Array, frames_axis: str,
                           rows_axis: str) -> jax.Array:
    """Explicitly reshard [n, H, W] from P(frames, None, None) to
    P(None, (frames, rows), None) with one ``all_to_all`` over the
    frames axis (each device's rows-axis share is a free local slice of
    data already replicated over the rows axis). Requires n divisible
    by |frames| and H by |frames|·|rows|."""
    from jax import shard_map

    F = mesh.shape[frames_axis]
    R = mesh.shape[rows_axis]
    n_sh = F * R
    n, h, w = x.shape
    if n % F or h % n_sh:
        raise ValueError(
            f"reshard needs n % {F} == 0 and h % {n_sh} == 0; "
            f"got n={n}, h={h}")
    local_h = h // n_sh

    def local(fx):
        r = jax.lax.axis_index(rows_axis)
        n_loc = fx.shape[0]
        y = fx.reshape(n_loc, F, R, local_h, w)
        y = jax.lax.dynamic_index_in_dim(y, r, axis=2, keepdims=False)
        y = jax.lax.all_to_all(y, frames_axis, split_axis=1,
                               concat_axis=0, tiled=True)
        return y.reshape(n, local_h, w)

    return shard_map(
        local, mesh=mesh, in_specs=P(frames_axis, None, None),
        out_specs=P(None, (frames_axis, rows_axis), None),
        check_vma=False)(x)


def sharded_shift_clip(mesh: Mesh, stack: jax.Array, dys: jax.Array,
                       dxs: jax.Array, row_axes, sigma_low: float,
                       sigma_high: float, max_iter: int,
                       off_max: int = 16, interpret: bool = False):
    """Row-sharded one-pass shift+clip kernel via shard_map.

    Each shard holds a horizontal band of every frame; ``off_max + 2``
    halo rows move between neighbours via two ppermutes, offsets are
    clamped to ±off_max, the global top/bottom halos
    are edge replicas (align.rs clamp semantics), and the fused kernel
    runs per shard with the outside-source zero mask evaluated in
    global coordinates. ``row_axes`` is a mesh axis name or tuple —
    pass all axes (e.g. ('frames', 'rows')) to split rows across the
    whole mesh for this stage.
    """
    from jax import shard_map

    if isinstance(row_axes, str):
        row_axes = (row_axes,)
    n_sh = 1
    for ax in row_axes:
        n_sh *= mesh.shape[ax]
    n, h, w = stack.shape
    h_pad = -(-h // n_sh) * n_sh
    if h_pad != h:
        stack = jnp.pad(stack, ((0, 0), (0, h_pad - h), (0, 0)),
                        mode="edge")
    local_h = h_pad // n_sh
    halo = off_max + 2
    if local_h < halo:
        raise ValueError(
            f"row shards of {local_h} rows are smaller than the "
            f"{halo}-row halo (off_max={off_max}); use fewer shards, "
            f"taller images, or a smaller off_max")
    ax_names = row_axes if len(row_axes) > 1 else row_axes[0]

    def local_fn(slab, dys, dxs):
        return _halo_clip_local(slab, dys, dxs, ax_names, n_sh, local_h,
                                h, halo, sigma_low, sigma_high, max_iter,
                                interpret)

    combined, rejected = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(None, row_axes, None), P(None), P(None)),
        out_specs=(P(row_axes, None), P()),
        check_vma=False)(stack, dys, dxs)
    return combined[:h], rejected


def make_sharded_stack_step(mesh: Mesh, sigma_low: float = 3.0,
                            sigma_high: float = 3.0, max_iter: int = 5,
                            align: bool = True,
                            use_pallas: bool | None = None,
                            interpret: bool = False,
                            off_max: int = 16):
    """jit the pipeline over a (frames, rows) mesh.

    Alignment runs frame-sharded; the combine/stretch run row-sharded
    — the constraint between them is where GSPMD places the reshard
    collective (all-to-all). ``use_pallas`` (default: where the
    one-pass kernel compiles and the frames fit its budget, as
    ``stacking.combine.shift_clip`` decides) runs the kernel per
    row-shard (sharded_shift_clip) with rows split across ALL mesh
    axes so no device idles; otherwise the unfused XLA path.
    ``interpret`` runs the kernel in the Pallas interpreter (CPU
    tests only).
    """
    all_axes = tuple(ax for ax in ("frames", "rows")
                     if ax in mesh.axis_names)
    two_axes = len(all_axes) == 2
    row_sh = all_axes if len(all_axes) > 1 else all_axes[0]
    frames_spec = NamedSharding(mesh, P("frames", None, None))
    stack_rows_spec = NamedSharding(mesh, P(None, row_sh, None))
    rows_spec = NamedSharding(mesh, P(row_sh, None))
    n_sh_total = 1
    for ax in all_axes:
        n_sh_total *= mesh.shape[ax]

    def step(stack):
        stack = jax.lax.with_sharding_constraint(stack, frames_spec)
        n = stack.shape[0]
        # the explicit all_to_all reshard needs whole frame blocks per
        # device; otherwise fall back to the GSPMD constraint reshard
        can_a2a = two_axes and n % mesh.shape["frames"] == 0
        use_kernel = (use_onepass_kernel(n) if use_pallas is None
                      else use_pallas)
        ref = stack[0]
        if align and n > 1:
            def est(frame):
                dy, dx, conf = _phase_correlate_traced(ref, frame)
                return dy, dx, conf

            dys1, dxs1, confs1 = jax.vmap(est)(stack[1:])
            dys = jnp.concatenate([jnp.zeros(1, jnp.float32), dys1])
            dxs = jnp.concatenate([jnp.zeros(1, jnp.float32), dxs1])
            confs = jnp.concatenate([jnp.zeros(1, jnp.float32), confs1])
        else:
            dys = jnp.zeros(n, jnp.float32)
            dxs = jnp.zeros(n, jnp.float32)
            confs = jnp.zeros(n, jnp.float32)

        if use_kernel:
            if can_a2a:
                # explicit frames→rows all_to_all inside the shard_map
                # — ONE collective moving only the bytes that move (the
                # implicit constraint reshard compiled to GSPMD's
                # replicate-then-slice fallback)
                combined, rejected = sharded_shift_clip_a2a(
                    mesh, stack, dys, dxs, "frames", "rows", sigma_low,
                    sigma_high, max_iter, off_max=off_max,
                    interpret=interpret)
            else:
                combined, rejected = sharded_shift_clip(
                    mesh, stack, dys, dxs, all_axes, sigma_low,
                    sigma_high, max_iter, off_max=off_max,
                    interpret=interpret)
        else:
            full = jax.vmap(shift_bicubic)(stack, dys, dxs)
            # reshard: frame-parallel → row-parallel for the reduction
            if can_a2a and stack.shape[1] % n_sh_total == 0:
                full = reshard_frames_to_rows(mesh, full, "frames",
                                              "rows")
            else:
                full = jax.lax.with_sharding_constraint(
                    full, stack_rows_spec)
            combined, rejected = sigma_clip_core(full, sigma_low,
                                                 sigma_high, max_iter)
        combined = jax.lax.with_sharding_constraint(combined, rows_spec)
        # flatten=False: the flat median path's chunk reshape would
        # all-gather the row-sharded plane (8 full-plane gathers/step)
        mn, mx, _t, count, med, mad = stats_core(combined, False,
                                                 flatten=False)
        sigma = jnp.maximum(mad * 1.4826, 1e-30)
        shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count)
        preview = apply_stf_traced(combined, mn, mx, shadow, midtone,
                                   as_u8=True)
        return {
            "combined": combined,
            "preview": preview,
            "offsets": jnp.stack([dys, dxs], axis=1),
            "confidences": confs,
            "rejected": rejected,
            "stf": jnp.stack([shadow, midtone]),
        }

    return jax.jit(step)
