"""Sharded four-step FFT stages: distributed fft2, RL deconvolution,
and power spectrum over a device mesh (BASELINE config #5's
"per-slice calibration + FFT power spectrum + deconvolution sharded
over mesh"; reference single-core semantics:
src-tauri/src/core/analysis/deconvolution.rs:141-213, analysis/fft.rs).

Design — the classic distributed-FFT transpose form:
rows-sharded input; the row-axis transform (ops.fft four-step matmuls)
is entirely LOCAL; one ``all_to_all`` re-lays the plane out
cols-sharded; the column-axis transform is then local too. The inverse
retraces the same path, so a full convolution round trip costs exactly
two all_to_alls — the only bytes that cross chips are the one
resharding each way, and every matmul stays on-shard.

The sharded paths run full complex transforms (the single-device RL
uses the rfft2 half-spectrum packing; its row-half pairing would span
shard boundaries, so the distributed form trades those matmuls for
zero extra collectives). Numerics match the single-device results to
f32 rounding; parity is pinned by tests/test_parallel.py.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from astroburst_tpu.dtypes import RLConfig
from astroburst_tpu.ops import fft as F

CONVERGENCE_THRESHOLD = 1e-6
EPSILON = 1e-6


def _fft2_local_to_cols(lr, li, axis_name, inverse: bool):
    """Local rows-shard [R/Pp, C] → local cols-shard [R, C/P] with the
    row-axis transform before and the column-axis transform after the
    all_to_all."""
    yr, yi = F._fft_core(lr, li, inverse, axis=-1)
    yr = jax.lax.all_to_all(yr, axis_name, split_axis=1, concat_axis=0,
                            tiled=True)
    yi = jax.lax.all_to_all(yi, axis_name, split_axis=1, concat_axis=0,
                            tiled=True)
    return F._fft_core(yr, yi, inverse, axis=-2)


def _ifft2_cols_to_rows(lr, li, axis_name, inverse: bool = True):
    """Local cols-shard [R, C/P] → local rows-shard [R/P, C]; the
    reverse path (column transform local, all_to_all, row transform
    local). Unnormalized — callers apply 1/(R·C)."""
    yr, yi = F._fft_core(lr, li, inverse, axis=-2)
    yr = jax.lax.all_to_all(yr, axis_name, split_axis=0, concat_axis=1,
                            tiled=True)
    yi = jax.lax.all_to_all(yi, axis_name, split_axis=0, concat_axis=1,
                            tiled=True)
    return F._fft_core(yr, yi, inverse, axis=-1)


def sharded_fft2(mesh: Mesh, xr: jax.Array, xi: jax.Array,
                 axis_name: str = "rows"):
    """Forward 2D FFT of a P(axis, None) rows-sharded plane; returns
    the spectrum P(None, axis) cols-sharded (unnormalized, matching
    ops.fft.fft2)."""
    n_sh = mesh.shape[axis_name]
    r, c = xr.shape
    if r % n_sh or c % n_sh:
        raise ValueError(f"plane {r}x{c} not divisible by the "
                         f"{n_sh}-way '{axis_name}' axis")

    def local(lr, li):
        return _fft2_local_to_cols(lr, li, axis_name, inverse=False)

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=(P(None, axis_name), P(None, axis_name)),
        check_vma=False)(xr, xi)


def sharded_ifft2(mesh: Mesh, xr: jax.Array, xi: jax.Array,
                  axis_name: str = "rows"):
    """Inverse of :func:`sharded_fft2`: cols-sharded spectrum in,
    rows-sharded plane out, scaled by 1/(R·C) (matching ops.fft.ifft2).
    """
    r, c = xr.shape
    inv = 1.0 / (r * c)

    def local(lr, li):
        yr, yi = _ifft2_cols_to_rows(lr, li, axis_name)
        return yr * inv, yi * inv

    return shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis_name), P(None, axis_name)),
        out_specs=(P(axis_name, None), P(axis_name, None)),
        check_vma=False)(xr, xi)


def _psf_spectrum_local(psf, fft_rows: int, fft_cols: int):
    """Center-origin wraparound PSF spectrum (deconvolution.rs:62-80),
    built replicated (the PSF is tiny); returns full complex planes."""
    psf = jnp.asarray(psf, jnp.float32)
    cy, cx = psf.shape[0] // 2, psf.shape[1] // 2
    buf = jnp.zeros((fft_rows, fft_cols), jnp.float32)
    buf = jax.lax.dynamic_update_slice(buf, psf, (0, 0))
    buf = jnp.roll(buf, (-cy, -cx), axis=(0, 1))
    return F.fft2_real(buf)


def sharded_deconvolve(mesh: Mesh, image: jax.Array, psf,
                       config: RLConfig = RLConfig(),
                       axis_name: str = "rows"):
    """Richardson-Lucy deconvolution with every FFT stage sharded over
    ``axis_name`` (deconvolution.rs:141-213 semantics: Tikhonov
    1/(1+λ), bidirectional deringing clamp, convergence freeze after
    ≥3 iterations below 1e-6).

    The iteration state (estimate, ratio) lives rows-sharded; each of
    the two convolutions per iteration runs rows→cols→rows with two
    all_to_alls and local matmuls. Returns (image [rows-sharded],
    iterations_run, convergence).
    """
    img = jnp.asarray(image, jnp.float32)
    rows, cols = img.shape
    psf_np = np.asarray(psf, np.float32)
    n_sh = mesh.shape[axis_name]
    fft_rows = max(F.next_power_of_two(rows + psf_np.shape[0] - 1), n_sh)
    fft_cols = max(F.next_power_of_two(cols + psf_np.shape[1] - 1),
                   n_sh * 128)
    if fft_rows % n_sh or fft_cols % n_sh:
        raise ValueError(
            f"'{axis_name}' axis size {n_sh} must divide the pow2 FFT "
            f"dims ({fft_rows}, {fft_cols}) — use a power-of-two axis")
    kr, ki = _psf_spectrum_local(psf_np, fft_rows, fft_cols)
    # slice the replicated PSF spectrum into each shard's column block
    kr = jax.device_put(kr, NamedSharding(mesh, P(None, axis_name)))
    ki = jax.device_put(ki, NamedSharding(mesh, P(None, axis_name)))
    lam = jnp.float32(config.regularization)
    thr = jnp.float32(config.dering_threshold)
    img_sh = jax.device_put(img, NamedSharding(mesh, P(axis_name, None)))
    run = _deconvolve_jit(mesh, axis_name, rows, cols, fft_rows, fft_cols,
                          config.iterations, config.dering)
    est, iters, conv = run(img_sh, kr, ki, lam, thr)
    return est, int(iters), float(conv)


@lru_cache(maxsize=None)
def _deconvolve_jit(mesh: Mesh, axis_name: str, rows: int, cols: int,
                    fft_rows: int, fft_cols: int, iterations: int,
                    dering: bool):
    """Cached per (mesh, axis, shape, iters): the per-call jit closure
    re-compiled the whole sharded RL program on every call."""

    @jax.jit
    def run(img, kr, ki, lam, thr):
        pad = jnp.pad(img, ((0, fft_rows - rows), (0, fft_cols - cols)))

        def local(lim, lkr, lki, lam, thr):
            # lim: this shard's padded image rows [fft_rows/P, fft_cols].
            # The pad region is zero and stays zero through every RL
            # update, so iterating on the padded plane matches the
            # single-device kernel's slice-then-repad exactly.
            inv = 1.0 / (fft_rows * fft_cols)

            def convolve(x, conj):
                xr, xi = _fft2_local_to_cols(x, jnp.zeros_like(x),
                                             axis_name, inverse=False)
                sign = -1.0 if conj else 1.0
                pr = xr * lkr - xi * (sign * lki)
                pi = xr * (sign * lki) + xi * lkr
                yr, _ = _ifft2_cols_to_rows(pr, pi, axis_name)
                return yr * inv

            inv_reg = jnp.where(lam > 0.0, 1.0 / (1.0 + lam), 1.0)
            estimate = lim
            stopped = jnp.bool_(False)
            iters_run = jnp.int32(0)
            convergence = jnp.float32(np.finfo(np.float32).max)
            # the padded region is zero and stays zero through RL
            for it in range(iterations):
                convolved = convolve(estimate, conj=False)
                ratio = lim / (convolved + EPSILON)
                correction = convolve(ratio, conj=True)
                new_est = jnp.maximum(estimate * correction * inv_reg,
                                      0.0)
                if dering:
                    upper = lim * (1.0 + thr)
                    lower = jnp.maximum(lim * (1.0 - thr), 0.0)
                    new_est = jnp.clip(new_est, lower, upper)
                sq = jax.lax.psum(jnp.sum((new_est - estimate) ** 2),
                                  axis_name)
                # mean over the TRUE image area (the pad region
                # contributes zero to the sum), matching _rl_kernel
                delta = jnp.sqrt(sq / (rows * cols))
                active = ~stopped
                estimate = jnp.where(active, new_est, estimate)
                iters_run = jnp.where(active, it + 1, iters_run)
                convergence = jnp.where(active, delta, convergence)
                stopped = stopped | (
                    active & (delta < CONVERGENCE_THRESHOLD) &
                    jnp.bool_(it + 1 >= 3))
            return estimate, iters_run, convergence

        est, it, conv = shard_map(
            local, mesh=mesh,
            in_specs=(P(axis_name, None), P(None, axis_name),
                      P(None, axis_name), P(), P()),
            out_specs=(P(axis_name, None), P(), P()),
            check_vma=False)(pad, kr, ki, lam, thr)
        return est[:rows, :cols], it, conv

    return run


def sharded_power_spectrum(mesh: Mesh, data: jax.Array,
                           apply_window: bool = True,
                           axis_name: str = "rows"):
    """Shifted log1p power spectrum with the FFT sharded over
    ``axis_name`` (analysis/fft.rs semantics: NaN→0, symmetric Hann,
    pow2 pad, log1p magnitude, fftshift). Returns the [S, S] spectrum
    rows-sharded; the caller downsamples for display."""
    from astroburst_tpu.ops.window import hann_symmetric

    data = jnp.asarray(data, jnp.float32)
    rows, cols = data.shape
    n_sh = mesh.shape[axis_name]
    size = max(F.next_power_of_two(max(rows, cols)), n_sh * 128)
    vals = jnp.where(jnp.isfinite(data), data, 0.0)
    if apply_window:
        wy = jnp.asarray(hann_symmetric(rows))
        wx = jnp.asarray(hann_symmetric(cols))
        vals = vals * wy[:, None] * wx[None, :]
    buf = jnp.pad(vals, ((0, size - rows), (0, size - cols)))
    buf = jax.device_put(buf, NamedSharding(mesh, P(axis_name, None)))
    return _power_spectrum_jit(mesh, axis_name)(buf)


@lru_cache(maxsize=None)
def _power_spectrum_jit(mesh: Mesh, axis_name: str):
    """Cached per (mesh, axis): the per-call jit closure re-compiled
    the whole sharded FFT on every power-spectrum call."""
    @jax.jit
    def run(b):
        def local(lb):
            zr, zi = _fft2_local_to_cols(lb, jnp.zeros_like(lb),
                                         axis_name, inverse=False)
            return jnp.log1p(jnp.sqrt(zr * zr + zi * zi))

        mag = shard_map(
            local, mesh=mesh, in_specs=P(axis_name, None),
            out_specs=P(None, axis_name), check_vma=False)(b)
        # fftshift on the sharded plane: GSPMD lowers the rolls to
        # collective-permutes of whole shard blocks
        shifted = F.fftshift2(mag)
        return jax.lax.with_sharding_constraint(
            shifted, NamedSharding(mesh, P(axis_name, None)))

    return run
