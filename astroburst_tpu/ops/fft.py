"""Matmul FFT engine — complex as (re, im) float32 pairs.

The FFT is built from dense DFT matmuls on real (re, im) pairs: a
recursive four-step factorization n = n1·n2 (DFT-n1 along the major
digit → twiddle → DFT-n2 along the minor digit → digit-reverse),
bottoming out in a direct [n, n] DFT matmul for n ≤ 512. All matmuls
run at HIGHEST precision: true f32 on the H100, where DEFAULT would
run them in TF32 (~1e-3 relative error). Whether jnp.fft (cuFFT)
should replace this engine on the GPU is open (ROADMAP D3).

Replaces the reference's rustfft engine
(reference: src-tauri/src/math/fft.rs:96-199) with the same contract:
unnormalized forward, 1/n-scaled inverse, power-of-two sizes via
padding (fft.rs:64 next_power_of_two).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import threading

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST
# Trace-time matmul precision for every DFT stage in this module.
# HIGHEST (true f32) is the default contract; matmul_precision("default")
# is what RL deconvolution's fast_precision uses — TF32 tensor-core
# products on the H100, whose error through 20 RL iterations
# bench_ops.py reports (max_rel_err_vs_f32). The value is
# read when a caller is TRACED, so callers
# that expose the choice MUST split their jit cache on it (a static
# arg — see analysis/deconvolution._rl_kernel); thread-local storage
# keeps a trace on another thread (prefetch workers etc.) at the
# HIGHEST default.
_PREC_STATE = threading.local()


def _prec():
    return getattr(_PREC_STATE, "value", _HIGHEST)


class matmul_precision:
    """Context manager: override the DFT matmul precision for code
    traced inside. Accepts exactly "highest" or "default"."""

    def __init__(self, p: str):
        if p not in ("highest", "default"):
            raise ValueError(
                f"matmul_precision: {p!r} (want 'highest' or 'default')")
        self._p = {"highest": _HIGHEST,
                   "default": jax.lax.Precision.DEFAULT}[p]

    def __enter__(self):
        self._old = _prec()
        _PREC_STATE.value = self._p
        return self

    def __exit__(self, *exc):
        _PREC_STATE.value = self._old
        return False
# largest direct DFT matmul; 512 also works but costs ~10x the FLOPs
# of one more four-step level for the same measured accuracy (1.7e-7
# rel vs f64 numpy at n=512)
_DIRECT_MAX = 256


def next_power_of_two(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def next_fast_size(n: int) -> int:
    """Smallest m ≥ n the four-step engine handles efficiently: even,
    a multiple of 128, m = n1·n2 with n1 the largest power of two
    ≤ √m and n2 ≤ _DIRECT_MAX (one direct matmul per stage, no
    recursion). Linear convolution only needs m ≥ rows + taps − 1;
    padding to this instead of next_power_of_two (fft.rs:64) cuts the
    FFT work up to ~4× (e.g. 2111 → 2176 instead of 4096)."""
    if n <= _DIRECT_MAX:
        return max(8, -(-n // 8) * 8)
    m = -(-n // 128) * 128
    while True:
        n1, n2 = _split(m)
        if n1 * n2 == m and n2 <= _DIRECT_MAX:
            return m
        m += 128


@lru_cache(maxsize=None)
def _dft_matrix(n: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Dense DFT matrix W[j,k] = exp(∓2πi jk/n), host f64 → f32 parts."""
    k = np.arange(n)
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    sign = 2.0 if inverse else -2.0
    ang = sign * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2)
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _split(n: int) -> Tuple[int, int]:
    """n = n1·n2 with n1 the largest power of two ≤ sqrt(n)."""
    n1 = 1
    while n1 * n1 <= n:
        n1 <<= 1
    n1 >>= 1
    return n1, n // n1


def _dft_along(xr, xi, inverse: bool, axis: int):
    """Direct DFT matmul along ``axis`` ∈ {-1, -2, -3} — expressed as
    dot_general contractions so NO transpose ops are emitted (the
    contraction takes any dimension order)."""
    n = xr.shape[axis]
    wr_np, wi_np = _dft_matrix(n, inverse)
    wr = jnp.asarray(wr_np)
    wi = jnp.asarray(wi_np)
    if axis == -1:
        def f(a, w):
            return jnp.matmul(a, w, precision=_prec())
    elif axis == -2:
        def f(a, w):
            return jnp.einsum("jk,...jc->...kc", w, a,
                              precision=_prec())
    elif axis == -3:
        def f(a, w):
            return jnp.einsum("jk,...jcd->...kcd", w, a,
                              precision=_prec())
    else:
        raise ValueError(f"unsupported DFT axis {axis}")
    yr = f(xr, wr) - f(xi, wi)
    yi = f(xr, wi) + f(xi, wr)
    return yr, yi


def _dft_swapped(xr, xi, inverse: bool, mid: bool):
    """DFT over the minor digit with the output digit emitted BEFORE
    the major digit — the four-step's digit-reversed order falls out
    of the dot_general output layout (batch, lhs-free, rhs-free), so
    the final reshape is a free row-major view.

    mid=False: t[..., k1, j2]    -> z[..., k2, k1]
    mid=True:  t[..., k1, j2, c] -> z[..., k2, k1, c]
    """
    n = xr.shape[-2 if mid else -1]
    wr_np, wi_np = _dft_matrix(n, inverse)
    wr = jnp.asarray(wr_np)
    wi = jnp.asarray(wi_np)
    eq = "jm,...ajc->...mac" if mid else "jm,...aj->...ma"

    def f(a, w):
        return jnp.einsum(eq, w, a, precision=_prec())

    yr = f(xr, wr) - f(xi, wi)
    yi = f(xr, wi) + f(xi, wr)
    return yr, yi


def _fft_core(xr, xi, inverse: bool, axis: int = -1):
    """Four-step FFT along ``axis`` ∈ {-1, -2} (unnormalized), any
    batch dims. Zero transposes for n ≤ _DIRECT_MAX² (65536): both
    DFT stages are dot_generals with natural output ordering, and the
    reshapes are contiguous views."""
    n = xr.shape[axis]
    if n <= _DIRECT_MAX:
        return _dft_along(xr, xi, inverse, axis)
    n1, n2 = _split(n)
    if n1 * n2 != n:
        raise ValueError(f"FFT size {n} must be a power of two")
    shp = xr.shape
    twr_np, twi_np = _twiddle(n1, n2, inverse)
    twr = jnp.asarray(twr_np)
    twi = jnp.asarray(twi_np)
    if axis == -1:
        xr = xr.reshape(*shp[:-1], n1, n2)
        xi = xi.reshape(*shp[:-1], n1, n2)
        yr, yi = _fft_core(xr, xi, inverse, axis=-2)  # over j1
        tr = yr * twr - yi * twi
        ti = yr * twi + yi * twr
        if n2 <= _DIRECT_MAX:
            zr, zi = _dft_swapped(tr, ti, inverse, mid=False)
        else:  # huge-n fallback (n > 65536): recurse + one swap
            zr, zi = _fft_core(tr, ti, inverse, axis=-1)
            zr = zr.swapaxes(-1, -2)
            zi = zi.swapaxes(-1, -2)
        return zr.reshape(shp), zi.reshape(shp)
    if axis == -2:
        c = shp[-1]
        lead = shp[:-2]
        xr = xr.reshape(*lead, n1, n2, c)
        xi = xi.reshape(*lead, n1, n2, c)
        if n1 <= _DIRECT_MAX:
            yr, yi = _dft_along(xr, xi, inverse, -3)  # over j1
        else:
            raise ValueError(f"FFT size {n} too large for axis=-2")
        tw_r = twr[:, :, None]
        tw_i = twi[:, :, None]
        tr = yr * tw_r - yi * tw_i
        ti = yr * tw_i + yi * tw_r
        if n2 <= _DIRECT_MAX:
            zr, zi = _dft_swapped(tr, ti, inverse, mid=True)
        else:
            raise ValueError(f"FFT size {n} too large for axis=-2")
        return zr.reshape(shp), zi.reshape(shp)
    raise ValueError(f"unsupported FFT axis {axis}")


def fft(xr, xi):
    """Forward FFT along the last axis (unnormalized)."""
    return _fft_core(xr, xi, inverse=False)


def ifft(xr, xi):
    """Inverse FFT along the last axis, scaled by 1/n."""
    yr, yi = _fft_core(xr, xi, inverse=True)
    inv = 1.0 / xr.shape[-1]
    return yr * inv, yi * inv


def _dft_along_real(x, inverse: bool, axis: int):
    """_dft_along for a REAL input: half the matmuls."""
    n = x.shape[axis]
    wr_np, wi_np = _dft_matrix(n, inverse)
    wr = jnp.asarray(wr_np)
    wi = jnp.asarray(wi_np)
    if axis == -1:
        def f(a, w):
            return jnp.matmul(a, w, precision=_prec())
    elif axis == -2:
        def f(a, w):
            return jnp.einsum("jk,...jc->...kc", w, a,
                              precision=_prec())
    else:
        raise ValueError(f"unsupported DFT axis {axis}")
    return f(x, wr), f(x, wi)


def _dft_swapped_real_out(xr, xi, inverse: bool, mid: bool):
    """_dft_swapped computing only the REAL output component."""
    n = xr.shape[-2 if mid else -1]
    wr_np, wi_np = _dft_matrix(n, inverse)
    wr = jnp.asarray(wr_np)
    wi = jnp.asarray(wi_np)
    eq = "jm,...ajc->...mac" if mid else "jm,...aj->...ma"

    def f(a, w):
        return jnp.einsum(eq, w, a, precision=_prec())

    return f(xr, wr) - f(xi, wi)


def fft2_real(x):
    """fft2 of a REAL plane: the first stage's imaginary-input matmuls
    are elided (the rest of the pipeline is complex). ~12% fewer
    matmuls than fft2(x, zeros) — XLA cannot prove the zeros away."""
    n = x.shape[-1]
    if n <= _DIRECT_MAX:
        yr, yi = _dft_along_real(x, False, -1)
    else:
        n1, n2 = _split(n)
        if n1 * n2 != n:
            raise ValueError(f"FFT size {n} must be a power of two")
        shp = x.shape
        xs = x.reshape(*shp[:-1], n1, n2)
        if n1 <= _DIRECT_MAX and n2 <= _DIRECT_MAX:
            ar, ai = _dft_along_real(xs, False, -2)
            twr_np, twi_np = _twiddle(n1, n2, False)
            twr = jnp.asarray(twr_np)
            twi = jnp.asarray(twi_np)
            tr = ar * twr - ai * twi
            ti = ar * twi + ai * twr
            zr, zi = _dft_swapped(tr, ti, False, mid=False)
            yr = zr.reshape(shp)
            yi = zi.reshape(shp)
        else:
            yr, yi = _fft_core(x, jnp.zeros_like(x), False, axis=-1)
    return _fft_core(yr, yi, inverse=False, axis=-2)


def ifft2_real(xr, xi):
    """Real part of the inverse 2D FFT, scaled like ifft2 — for
    known-real results (correlation surfaces, convolution outputs).
    The final stage's imaginary-output matmuls are elided."""
    yr, yi = _fft_core(xr, xi, inverse=True, axis=-1)
    n = yr.shape[-2]
    inv = 1.0 / (xr.shape[-1] * xr.shape[-2])
    if n <= _DIRECT_MAX:
        wr_np, wi_np = _dft_matrix(n, True)
        wr = jnp.asarray(wr_np)
        wi = jnp.asarray(wi_np)
        zr = (jnp.einsum("jk,...jc->...kc", wr, yr, precision=_prec())
              - jnp.einsum("jk,...jc->...kc", wi, yi, precision=_prec()))
        return zr * inv
    n1, n2 = _split(n)
    if n1 > _DIRECT_MAX or n2 > _DIRECT_MAX or n1 * n2 != n:
        zr, _ = _fft_core(yr, yi, True, axis=-2)
        return zr * inv
    shp = yr.shape
    c = shp[-1]
    lead = shp[:-2]
    yr = yr.reshape(*lead, n1, n2, c)
    yi = yi.reshape(*lead, n1, n2, c)
    ar, ai = _dft_along(yr, yi, True, -3)
    twr_np, twi_np = _twiddle(n1, n2, True)
    twr = jnp.asarray(twr_np)[:, :, None]
    twi = jnp.asarray(twi_np)[:, :, None]
    tr = ar * twr - ai * twi
    ti = ar * twi + ai * twr
    zr = _dft_swapped_real_out(tr, ti, True, mid=True)
    return zr.reshape(shp) * inv


def _reverse_freq1(x):
    """x[..., (-k) % n] along the last axis."""
    return jnp.roll(jnp.flip(x, axis=-1), 1, axis=-1)


def rfft2(x):
    """Half-spectrum forward 2D FFT of a REAL plane: returns
    (yr, yi) of shape [..., R, C//2 + 1] — the full spectrum's
    non-redundant columns (conjugate symmetry supplies the rest).

    Two savings over :func:`fft2_real`, ~2× total:
    - Row stage runs on R/2 complex rows: the top and bottom halves
      pack as real/imag of one transform (contiguous half-slices,
      no strided slice) and untangle by
      conjugate symmetry afterwards.
    - Column stage runs on C/2 + 1 columns only.
    """
    r = x.shape[-2]
    c = x.shape[-1]
    if r % 2 or c % 2:
        raise ValueError(
            f"rfft2 requires even dims (got {r}×{c}): the row stage "
            "packs top/bottom halves and the column stage stores "
            "c//2 + 1 columns — pad with next_fast_size (always even)")
    ch = c // 2 + 1
    zr = x[..., : r // 2, :]
    zi = x[..., r // 2:, :]
    wr, wi = _fft_core(zr, zi, inverse=False, axis=-1)
    wrr = _reverse_freq1(wr)
    wir = _reverse_freq1(wi)
    top_r = 0.5 * (wr + wrr)
    top_i = 0.5 * (wi - wir)
    bot_r = 0.5 * (wi + wir)
    bot_i = 0.5 * (wrr - wr)
    yr = jnp.concatenate([top_r, bot_r], axis=-2)[..., :ch]
    yi = jnp.concatenate([top_i, bot_i], axis=-2)[..., :ch]
    return _fft_core(yr, yi, inverse=False, axis=-2)


def irfft2(xr, xi, cols: int):
    """Real inverse of :func:`rfft2`: input [..., R, C//2 + 1] half
    spectrum, output the real [..., R, C] plane (``cols`` = C).

    Column stage inverts the C/2 + 1 stored columns; the remaining
    columns follow from per-row conjugate symmetry of the
    post-column-stage array (A[u, C−v] = conj(A[u, v]) — a column
    flip, no row reversal). The row stage then packs output row j with
    row j + R/2 as one complex inverse transform (both results are
    real), halving it too.
    """
    if cols % 2:
        raise ValueError(
            f"irfft2 requires even cols (got {cols}): the conjugate "
            "extension supplies cols//2 - 1 mirrored columns, which "
            "only reconstructs even widths")
    r = xr.shape[-2]
    ch = xr.shape[-1]
    if cols // 2 + 1 != ch:
        raise ValueError(f"half spectrum has {ch} columns; expected "
                         f"{cols // 2 + 1} for cols={cols}")
    ar, ai = _fft_core(xr, xi, inverse=True, axis=-2)
    ext_r = jnp.flip(ar[..., 1:ch - 1], axis=-1)
    ext_i = -jnp.flip(ai[..., 1:ch - 1], axis=-1)
    fr = jnp.concatenate([ar, ext_r], axis=-1)
    fi = jnp.concatenate([ai, ext_i], axis=-1)
    er = fr[..., : r // 2, :] - fi[..., r // 2:, :]
    ei = fi[..., : r // 2, :] + fr[..., r // 2:, :]
    br, bi = _fft_core(er, ei, inverse=True, axis=-1)
    inv = 1.0 / (r * cols)
    return jnp.concatenate([br, bi], axis=-2) * inv


def fft2(xr, xi):
    """Forward 2D FFT over the last two axes (unnormalized), matching
    FftEngine2D::forward_2d (fft.rs:137-150). Both axes run in place
    (axis=-2 via dot_general) — no full-plane transposes."""
    yr, yi = _fft_core(xr, xi, inverse=False, axis=-1)
    return _fft_core(yr, yi, inverse=False, axis=-2)


def ifft2(xr, xi):
    """Inverse 2D FFT scaled by 1/(rows·cols) (fft.rs:152-168)."""
    yr, yi = _fft_core(xr, xi, inverse=True, axis=-1)
    yr, yi = _fft_core(yr, yi, inverse=True, axis=-2)
    inv = 1.0 / (xr.shape[-1] * xr.shape[-2])
    return yr * inv, yi * inv


def _reverse_freq2(x):
    """x[(-ky) % R, (-kx) % C] over the last two axes."""
    return jnp.roll(jnp.flip(x, axis=(-2, -1)), shift=(1, 1), axis=(-2, -1))


def fft2_two_real(x1, x2):
    """Spectra of TWO real planes from ONE complex FFT2 (rfft packing).

    With Z = FFT2(x1 + i·x2), conjugate symmetry of real inputs
    separates the spectra: F1 = (Z + conj(Z(-k)))/2 and
    F2 = (Z - conj(Z(-k)))/(2i). Halves the matmul count vs two
    fft2 calls (reference contract: math/fft.rs:137-167 runs one full
    FFT per plane). Returns (f1r, f1i, f2r, f2i).
    """
    zr, zi = fft2(x1, x2)
    zrr = _reverse_freq2(zr)
    zir = _reverse_freq2(zi)
    f1r = 0.5 * (zr + zrr)
    f1i = 0.5 * (zi - zir)
    f2r = 0.5 * (zi + zir)
    f2i = 0.5 * (zrr - zr)
    return f1r, f1i, f2r, f2i


def ifft2_two_real(c1r, c1i, c2r, c2i):
    """Two real-valued inverse FFT2s via ONE complex inverse FFT2.

    Valid when both exact results are real (phase-correlation
    surfaces): IFFT2(C1 + i·C2) = corr1 + i·corr2. Returns
    (corr1, corr2); each carries the other's f32 rounding (~1e-7
    relative), irrelevant for peak finding.
    """
    re, im = ifft2(c1r - c2i, c1i + c2r)
    return re, im


def cross_power(ar, ai, br, bi, epsilon: float = 1e-15):
    """Normalized cross-power a·conj(b)/|a·conj(b)|, ε-guarded
    (reference: src-tauri/src/math/complex.rs:27-44)."""
    pr = ar * br + ai * bi
    pi = ai * br - ar * bi
    mag = jnp.sqrt(pr * pr + pi * pi)
    inv = 1.0 / jnp.maximum(mag, epsilon)
    return pr * inv, pi * inv


def fftshift2(x):
    """Center the zero frequency (fft.rs:251-269 shift semantics)."""
    r, c = x.shape[-2], x.shape[-1]
    return jnp.roll(x, (r // 2, c // 2), axis=(-2, -1))


def shifted_log_magnitude(xr, xi):
    """log1p(|X|) with the spectrum centered (fft.rs:251)."""
    mag = jnp.sqrt(xr * xr + xi * xi)
    return fftshift2(jnp.log1p(mag))


def find_peak(surface):
    """(peak_y, peak_x, peak_val) of a 2D (or batched) surface."""
    r, c = surface.shape[-2], surface.shape[-1]
    flat = surface.reshape(*surface.shape[:-2], r * c)
    idx = jnp.argmax(flat, axis=-1)
    val = jnp.take_along_axis(flat, idx[..., None], axis=-1)[..., 0]
    return idx // c, idx % c, val
