"""Checks that need the card: the one-pass kernel compiled by Triton
(no interpreter) against the XLA path, alone and inside the pipeline
and the sharded step. They skip on the CPU; ``python chip_smoke.py``
calls the same bodies (``GPU_CHECKS``) in its process on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest


def _stack(seed=0, n=16, h=300, w=500):
    rng = np.random.default_rng(seed)
    s = rng.normal(100, 5, (n, h, w)).astype(np.float32)
    s[rng.random(s.shape) < 0.01] = np.nan
    s[rng.random(s.shape) < 0.01] = 4000.0
    dys = np.r_[0.0, rng.uniform(-9, 9, n - 1)].astype(np.float32)
    dxs = np.r_[0.0, rng.uniform(-9, 9, n - 1)].astype(np.float32)
    return jnp.asarray(s), jnp.asarray(dys), jnp.asarray(dxs)


def check_compiled_kernel_matches_xla():
    """Compiled Triton kernel == the XLA shift+clip (same f32 taps,
    same clip decisions), at two frame counts and a ragged plane."""
    from astroburst_tpu.stacking.combine import shift_clip_xla
    from astroburst_tpu.stacking.onepass_kernel import shift_clip_onepass
    for n in (16, 7):
        s, dys, dxs = _stack(n=n)
        got, grej = jax.jit(lambda a, b, c: shift_clip_onepass(
            a, b, c, 2.5, 3.0, 5))(s, dys, dxs)
        want, wrej = jax.jit(lambda a, b, c: shift_clip_xla(
            a, b, c, 2.5, 3.0, 5))(s, dys, dxs)
        d = np.abs(np.asarray(got) - np.asarray(want))
        assert (d > 5e-3).sum() <= 3, f"n={n}: max |d|={d.max()}"
        assert abs(int(grej) - int(wrej)) <= 3


def check_main_path_takes_kernel():
    """On the card, the one shift+clip entry picks the kernel for the
    headline's 16 frames and XLA past the register budget."""
    from astroburst_tpu.stacking.combine import use_onepass_kernel
    from astroburst_tpu.stacking.onepass_kernel import MAX_FRAMES
    assert use_onepass_kernel(16)
    assert not use_onepass_kernel(MAX_FRAMES + 1)


def _star_stack(seed=3, n=8, h=256, w=384, max_shift=5):
    """One star field rolled by small known shifts, with noise:
    alignment recovers offsets inside the sharded halo."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.zeros((h, w), np.float32)
    for sy, sx in rng.uniform(20, [h - 20, w - 20], (120, 2)):
        base += 800.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 8.0)
    shifts = rng.integers(-max_shift, max_shift + 1, (n, 2))
    shifts[0] = 0
    s = np.stack([np.roll(base, tuple(d), (0, 1)) for d in shifts])
    s += rng.normal(100, 3, s.shape).astype(np.float32)
    return jnp.asarray(s)


def check_sharded_step_on_one_device_mesh(interpret=False):
    """The row-sharded step on a 1×1 mesh runs the slab kernel (compiled
    on the card) under shard_map and matches the single-device
    pipeline. The frames' offsets lie inside ±off_max, where the slab
    kernel's clamp does not bite."""
    from jax.sharding import Mesh

    from astroburst_tpu.parallel.pipeline import (align_stack_stretch,
                                                  make_sharded_stack_step)
    s = _star_stack()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("frames", "rows"))
    got = make_sharded_stack_step(mesh, max_iter=3, off_max=8,
                                  use_pallas=True, interpret=interpret)(s)
    want = jax.jit(lambda x: align_stack_stretch(x, max_iter=3))(s)
    offsets = np.asarray(got["offsets"])
    np.testing.assert_allclose(offsets, np.asarray(want["offsets"]),
                               atol=1e-3)
    assert np.abs(offsets).max() < 8
    d = np.abs(np.asarray(got["combined"]) - np.asarray(want["combined"]))
    assert (d > 5e-3).sum() <= 3, f"max |d|={d.max()}"


GPU_CHECKS = ("check_compiled_kernel_matches_xla",
              "check_main_path_takes_kernel",
              "check_sharded_step_on_one_device_mesh")


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu):
    check_compiled_kernel_matches_xla()


@pytest.mark.gpu
def test_main_path_takes_kernel(gpu):
    check_main_path_takes_kernel()


@pytest.mark.gpu
def test_sharded_step_on_one_device_mesh(gpu):
    check_sharded_step_on_one_device_mesh()
