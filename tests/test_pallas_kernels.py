"""Shift + clip semantics of the one-pass kernel (Pallas interpreter on
the CPU backend) against the unfused XLA path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from astroburst_tpu.ops.resample import shift_bicubic
from astroburst_tpu.stacking.combine import sigma_clip_core
from astroburst_tpu.stacking.onepass_kernel import shift_clip_onepass


def _stack(rng, n=8, h=100, w=150, nan_frac=0.03, outlier_frac=0.03):
    s = rng.normal(100, 5, (n, h, w)).astype(np.float32)
    s[rng.random(s.shape) < nan_frac] = np.nan
    s[rng.random(s.shape) < outlier_frac] = 4000.0
    return s


def _shift_then_clip(s, dys, dxs, lo, hi, iters):
    shifted = jnp.stack([shift_bicubic(s[k], float(dys[k]), float(dxs[k]))
                         for k in range(s.shape[0])])
    return jax.jit(lambda x: sigma_clip_core(x, lo, hi, iters))(shifted)


def test_clip_kernel_matches_xla(rng):
    # zero offsets: the kernel is a pure sigma clip
    s = jnp.asarray(_stack(rng))
    z = jnp.zeros(s.shape[0], jnp.float32)
    ref, ref_rej = jax.jit(lambda x: sigma_clip_core(x, 2.5, 3.0, 5))(s)
    got, got_rej = shift_clip_onepass(s, z, z, 2.5, 3.0, 5, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)
    assert int(got_rej) == int(ref_rej)


def test_clip_kernel_single_iteration(rng):
    s = jnp.asarray(_stack(rng, n=5))
    z = jnp.zeros(5, jnp.float32)
    ref, _ = jax.jit(lambda x: sigma_clip_core(x, 3.0, 3.0, 1))(s)
    got, _ = shift_clip_onepass(s, z, z, 3.0, 3.0, 1, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)


@pytest.mark.slow
def test_fused_kernel_matches_shift_plus_clip(rng):
    n = 6
    s = jnp.asarray(_stack(rng, n=n, h=130, w=170))
    dys = rng.uniform(-12, 12, n).astype(np.float32)
    dxs = rng.uniform(-12, 12, n).astype(np.float32)
    ref, ref_rej = _shift_then_clip(s, dys, dxs, 2.5, 3.0, 5)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      2.5, 3.0, 5, interpret=True)
    # summation order differs: f32 means differ ~1e-5 relative, and
    # borderline clip decisions may rarely flip
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert (d < 5e-3).mean() > 0.999
    assert d.max() < 0.1
    assert abs(int(got_rej) - int(ref_rej)) <= int(ref_rej) * 0.02 + 50


# (n, h, w, dys, dxs, iters): the semantics cases of the shift+clip
# kernel — zero offsets, offsets far past the image, one frame,
# integer shifts of tens of pixels, fractional-only shifts, ragged
# planes wider than one block
_CASES = {
    "zero_offsets_is_plain_clip": (4, 80, 90, [0, 0, 0, 0], [0, 0, 0, 0], 3),
    "large_offsets": (3, 64, 64, [0.0, 500.0, -500.0], [0, 0, 0], 2),
    "single_frame_identity_shift": (1, 70, 300, [0.0], [0.0], 5),
    "moderately_large_integer_shifts": (4, 120, 200, [0, 37, -40, 13],
                                        [0, -33, 25, -7], 3),
    "fractional_only_shifts": (3, 90, 140, [0.25, -0.5, 0.75],
                               [-0.33, 0.9, 0.0], 2),
    "ragged_nonmultiple_shape": (5, 67, 515, [0.5, -4.2, 3.3, 1.1, -2.6],
                                 [2.2, 0.4, -3.9, 4.4, -0.7], 3),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_kernel_semantics(rng, case):
    n, h, w, dys, dxs, iters = _CASES[case]
    s = jnp.asarray(_stack(rng, n=n, h=h, w=w, nan_frac=0.0,
                           outlier_frac=0.0))
    dys = np.asarray(dys, np.float32)
    dxs = np.asarray(dxs, np.float32)
    ref, ref_rej = _shift_then_clip(s, dys, dxs, 3.0, 3.0, iters)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      3.0, 3.0, iters, interpret=True)
    g = np.asarray(got)
    assert g.shape == (h, w) and np.isfinite(g).all()
    d = np.abs(g - np.asarray(ref))
    assert (d < 5e-3).mean() > 0.999
    assert abs(int(got_rej) - int(ref_rej)) <= 3
