"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from astroburst_tpu.imaging.wavelet import atrous_smooth
from astroburst_tpu.parallel import make_mesh
from astroburst_tpu.parallel.halo import (sharded_atrous_smooth,
                                          sharded_stencil_map)
from astroburst_tpu.parallel.pipeline import (align_stack_stretch,
                                              make_sharded_stack_step)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_sharded_stack_step_matches_single_device(rng):
    frames = rng.normal(100, 3, (8, 128, 64)).astype(np.float32)
    yy, xx = np.mgrid[0:128, 0:64]
    frames += 500.0 * np.exp(-((yy - 64) ** 2 + (xx - 32) ** 2) / 8.0)
    stack = jnp.asarray(frames)

    single = jax.jit(lambda s: align_stack_stretch(s, max_iter=2))(stack)

    mesh = make_mesh(8, ("frames", "rows"), (4, 2))
    sharded_in = jax.device_put(
        stack, NamedSharding(mesh, P("frames", None, None)))
    step = make_sharded_stack_step(mesh, max_iter=2)
    out = step(sharded_in)

    np.testing.assert_allclose(np.asarray(out["combined"]),
                               np.asarray(single["combined"]), atol=1e-3)
    np.testing.assert_allclose(np.asarray(out["offsets"]),
                               np.asarray(single["offsets"]), atol=0.05)
    assert int(out["rejected"]) == int(single["rejected"])


@pytest.mark.slow
def test_sharded_onepass_matches_single_device(rng):
    """The hot path: one-pass shift+clip kernel per row-shard
    (shard_map + ppermute halos) vs the single-device kernel (Pallas
    interpreter on the CPU mesh)."""
    from astroburst_tpu.stacking.onepass_kernel import shift_clip_onepass
    from astroburst_tpu.parallel.pipeline import sharded_shift_clip

    frames = rng.normal(100, 3, (6, 96, 64)).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:64]
    frames += 400.0 * np.exp(-((yy - 48) ** 2 + (xx - 32) ** 2) / 8.0)
    stack = jnp.asarray(frames)
    dys = jnp.asarray([0.0, 3.5, -2.25, 7.0, -6.5, 1.0], jnp.float32)
    dxs = jnp.asarray([0.0, -1.5, 2.75, -4.0, 5.5, 0.25], jnp.float32)

    single_c, single_r = shift_clip_onepass(stack, dys, dxs, 3.0, 3.0, 3,
                                            interpret=True)

    for shape, axes in [((4, 2), ("frames", "rows")), ((8,), ("rows",))]:
        mesh = make_mesh(8, axes, shape)
        fn = jax.jit(lambda s, m=mesh, a=axes: sharded_shift_clip(
            m, s, dys, dxs, a, 3.0, 3.0, 3, off_max=8, interpret=True))
        got_c, got_r = fn(stack)
        np.testing.assert_allclose(np.asarray(got_c),
                                   np.asarray(single_c), atol=2e-4,
                                   err_msg=f"mesh={shape}")
        assert int(got_r) == int(single_r)


@pytest.mark.slow
def test_sharded_stack_step_pallas_path(rng):
    """Full sharded step with the one-pass kernel as combine stage."""
    frames = rng.normal(100, 3, (8, 128, 64)).astype(np.float32)
    yy, xx = np.mgrid[0:128, 0:64]
    frames += 500.0 * np.exp(-((yy - 64) ** 2 + (xx - 32) ** 2) / 8.0)
    stack = jnp.asarray(frames)

    single = jax.jit(lambda s: align_stack_stretch(s, max_iter=2))(stack)

    mesh = make_mesh(8, ("frames", "rows"), (4, 2))
    sharded_in = jax.device_put(
        stack, NamedSharding(mesh, P("frames", None, None)))
    step = make_sharded_stack_step(mesh, max_iter=2, use_pallas=True,
                                   interpret=True, off_max=8)
    out = step(sharded_in)
    np.testing.assert_allclose(np.asarray(out["combined"]),
                               np.asarray(single["combined"]), atol=2e-3)
    np.testing.assert_allclose(np.asarray(out["offsets"]),
                               np.asarray(single["offsets"]), atol=0.05)


@pytest.mark.slow
def test_sharded_atrous_matches_local(rng):
    x = rng.random((256, 96)).astype(np.float32)
    mesh = make_mesh(8, ("rows",), (8,))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("rows", None)))
    for step in (1, 2, 4):
        ref = np.asarray(atrous_smooth(jnp.asarray(x), step))
        got = np.asarray(sharded_atrous_smooth(xs, mesh, "rows", step))
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=f"step={step}")


def test_sharded_stencil_map_halo_identity(rng):
    x = rng.random((64, 32)).astype(np.float32)
    mesh = make_mesh(4, ("rows",), (4,))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("rows", None)))

    def fn(ext, halo):
        return ext[halo:-halo]  # identity through the halo

    got = np.asarray(sharded_stencil_map(xs, mesh, "rows", fn, halo=2))
    np.testing.assert_array_equal(got, x)


def test_linked_stf_stats_reduce_over_shards(rng):
    """Masked reductions over a sharded plane equal the single-device
    result (GSPMD inserts the psums)."""
    from astroburst_tpu.ops.masking import masked_scan_stats
    x = rng.random((128, 64)).astype(np.float32)
    x[:10] = 0.0
    mesh = make_mesh(8, ("rows",), (8,))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("rows", None)))
    got = jax.jit(masked_scan_stats)(xs)
    ref = jax.jit(masked_scan_stats)(jnp.asarray(x))
    for g, r in zip(got, ref):
        assert float(g) == pytest.approx(float(r), rel=1e-6)


@pytest.mark.slow
def test_sharded_warp_matches_single_device(rng):
    """Column-sharded pass 1 + row-sharded pass 2 equals the
    single-chip shear warp (one all-to-all between passes)."""
    import math
    from astroburst_tpu.alignment.affine import AffineTransform
    from astroburst_tpu.alignment.warp_shear import warp_shear
    from astroburst_tpu.parallel.warp import make_sharded_warp

    img = rng.normal(100, 5, (96, 128)).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:128]
    img += 300.0 * np.exp(-((yy - 48) ** 2 + (xx - 64) ** 2) / 9.0)
    th = math.radians(3.0)
    ct, st = math.cos(th), math.sin(th)
    cx, cy = 64.0, 48.0
    t = AffineTransform(a=ct, b=-st, tx=cx - ct * cx + st * cy,
                        c=st, d=ct, ty=cy - st * cx - ct * cy)

    single = np.asarray(warp_shear(jnp.asarray(img), t, 96, 128))
    mesh = make_mesh(8, ("rows",), (8,))
    fn = make_sharded_warp(mesh, t, 96, 128, "rows")
    sharded_in = jax.device_put(jnp.asarray(img),
                                NamedSharding(mesh, P(None, "rows")))
    got = np.asarray(fn(sharded_in))
    np.testing.assert_allclose(got, single, atol=1e-4)


@pytest.mark.slow
def test_sharded_warp_uneven_rows(rng):
    """GSPMD handles non-divisible shard sizes for the sharded warp."""
    import math
    from astroburst_tpu.alignment.affine import AffineTransform
    from astroburst_tpu.alignment.warp_shear import warp_shear
    from astroburst_tpu.parallel.warp import make_sharded_warp

    img = rng.normal(100, 5, (90, 100)).astype(np.float32)  # 90 % 8 != 0
    th = math.radians(-2.0)
    ct, st = math.cos(th), math.sin(th)
    t = AffineTransform(a=ct, b=-st, tx=50 - ct * 50 + st * 45,
                        c=st, d=ct, ty=45 - st * 50 - ct * 45)
    single = np.asarray(warp_shear(jnp.asarray(img), t, 90, 100))
    mesh = make_mesh(8, ("rows",), (8,))
    got = np.asarray(make_sharded_warp(mesh, t, 90, 100)(jnp.asarray(img)))
    np.testing.assert_allclose(got, single, atol=1e-4)


@pytest.mark.slow
def test_onepass_slab_mode_directly(rng):
    """shift_clip_onepass_slab with hand-built halos equals the
    full-image kernel on the interior band (covers the out_off /
    grow0 / gh coordinate math without shard_map)."""
    from astroburst_tpu.stacking.onepass_kernel import (shift_clip_onepass,
                                                        shift_clip_onepass_slab)
    n, h, w = 4, 64, 64
    halo = 10
    frames = rng.normal(100, 3, (n, h, w)).astype(np.float32)
    stack = jnp.asarray(frames)
    dys = jnp.asarray([0.0, 2.5, -3.0, 1.25], jnp.float32)
    dxs = jnp.asarray([0.0, -1.5, 4.0, -2.25], jnp.float32)
    full, full_rej = shift_clip_onepass(stack, dys, dxs, 3.0, 3.0, 3,
                                        interpret=True)
    # middle band rows [24, 40) with real neighbor halos
    r0, r1 = 24, 40
    slab = stack[:, r0 - halo:r1 + halo]
    got, _ = shift_clip_onepass_slab(slab, dys, dxs, halo,
                                     jnp.int32(r0), h, 3.0, 3.0, 3,
                                     interpret=True)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(full)[r0:r1], atol=2e-4)


def test_reshard_frames_to_rows_all_to_all(rng):
    """The explicit frames→rows reshard: correct layout AND the
    compiled HLO contains a real all-to-all (no GSPMD
    replicate-then-slice fallback)."""
    from astroburst_tpu.parallel.pipeline import reshard_frames_to_rows

    mesh = make_mesh(8, ("frames", "rows"), (4, 2))
    x = rng.normal(size=(8, 64, 32)).astype(np.float32)
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("frames", None, None)))
    fn = jax.jit(lambda a: reshard_frames_to_rows(mesh, a, "frames",
                                                  "rows"))
    out = fn(xd)
    np.testing.assert_array_equal(np.asarray(out), x)
    hlo = fn.lower(xd).compile().as_text()
    assert "all-to-all" in hlo, "reshard must compile to all-to-all"


@pytest.mark.slow
def test_sharded_a2a_clip_matches_plain(rng):
    """sharded_shift_clip_a2a (frames-sharded input, explicit
    all_to_all) == sharded_shift_clip (rows-sharded input) ==
    single-device onepass, and its HLO carries an all-to-all."""
    from astroburst_tpu.parallel.pipeline import (sharded_shift_clip,
                                                  sharded_shift_clip_a2a)
    from astroburst_tpu.stacking.onepass_kernel import shift_clip_onepass

    frames = rng.normal(100, 3, (8, 96, 64)).astype(np.float32)
    frames[2, 40, 30] = 5000.0
    stack = jnp.asarray(frames)
    dys = jnp.asarray(rng.uniform(-3, 3, 8), jnp.float32)
    dxs = jnp.asarray(rng.uniform(-3, 3, 8), jnp.float32)

    ref, ref_rej = shift_clip_onepass(stack, dys, dxs, 3.0, 3.0, 2,
                                      interpret=True)

    mesh = make_mesh(8, ("frames", "rows"), (4, 2))
    sharded_in = jax.device_put(
        stack, NamedSharding(mesh, P("frames", None, None)))
    fn = jax.jit(lambda s, a, b: sharded_shift_clip_a2a(
        mesh, s, a, b, "frames", "rows", 3.0, 3.0, 2, off_max=4,
        interpret=True))
    got, rej = fn(sharded_in, dys, dxs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-4)
    assert int(rej) == int(ref_rej)
    hlo = fn.lower(sharded_in, dys, dxs).compile().as_text()
    assert "all-to-all" in hlo


def test_sharded_fft2_matches_local(rng):
    """Distributed transpose-form fft2 (local row FFT → all_to_all →
    local col FFT) == single-device fft2, and the HLO carries the
    all-to-all."""
    from astroburst_tpu.ops import fft as F
    from astroburst_tpu.parallel.fft import sharded_fft2, sharded_ifft2

    mesh = make_mesh(8, ("rows",), (8,))
    x = rng.normal(size=(128, 256)).astype(np.float32)
    ref_r, ref_i = F.fft2(jnp.asarray(x), jnp.zeros((128, 256), jnp.float32))
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("rows", None)))
    zd = jax.device_put(jnp.zeros((128, 256), jnp.float32),
                        NamedSharding(mesh, P("rows", None)))
    fn = jax.jit(lambda a, b: sharded_fft2(mesh, a, b))
    gr, gi = fn(xd, zd)
    scale = float(np.abs(np.asarray(ref_r)).max())
    np.testing.assert_allclose(np.asarray(gr), np.asarray(ref_r),
                               atol=3e-6 * scale)
    np.testing.assert_allclose(np.asarray(gi), np.asarray(ref_i),
                               atol=3e-6 * scale)
    assert "all-to-all" in fn.lower(xd, zd).compile().as_text()
    br, bi = sharded_ifft2(mesh, gr, gi)
    np.testing.assert_allclose(np.asarray(br), x, atol=1e-4)
    np.testing.assert_allclose(np.asarray(bi), 0.0, atol=1e-4)


@pytest.mark.slow
def test_sharded_deconvolve_matches_single(rng):
    """Mesh-sharded RL == single-device RL (deconvolution.rs:141-213
    semantics) to f32 tolerance — BASELINE config #5's promise."""
    from astroburst_tpu.analysis.deconvolution import (
        generate_gaussian_psf, richardson_lucy)
    from astroburst_tpu.dtypes import RLConfig
    from astroburst_tpu.parallel.fft import sharded_deconvolve

    img = rng.normal(50, 4, (96, 112)).astype(np.float32)
    img[40:43, 30:33] += 400.0
    img[60, 80] += 900.0
    psf = generate_gaussian_psf(11, 1.8)
    cfg = RLConfig(iterations=5, dering=True)
    ref = richardson_lucy(jnp.asarray(img), psf, cfg)

    mesh = make_mesh(8, ("rows",), (8,))
    est, iters, conv = sharded_deconvolve(mesh, jnp.asarray(img), psf,
                                          cfg)
    assert iters == ref.iterations_run
    np.testing.assert_allclose(np.asarray(est), np.asarray(ref.image),
                               rtol=2e-3, atol=2e-2)


def test_sharded_power_spectrum_matches_single(rng):
    from astroburst_tpu.analysis.fft import _spectrum_kernel
    from astroburst_tpu.parallel.fft import sharded_power_spectrum

    mesh = make_mesh(8, ("rows",), (8,))
    img = rng.normal(10, 2, (200, 180)).astype(np.float32)
    img[13, 17] = np.nan
    ref = _spectrum_kernel(jnp.asarray(img), 1024, True)
    got = sharded_power_spectrum(mesh, jnp.asarray(img), True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=2e-3)


def test_sharded_drizzle_matches_single(rng):
    """Row-sharded exact drizzle == the single-device kernel
    (SURVEY §5 distributed mapping for the drizzle stage)."""
    from astroburst_tpu.dtypes import DrizzleKernel
    from astroburst_tpu.parallel.drizzle import sharded_drizzle
    from astroburst_tpu.stacking.drizzle import _drizzle_kernel_exact

    frames = [rng.normal(10, 1, (32, 36)).astype(np.float32)
              for _ in range(4)]
    frames[1][8, 9] = 500.0
    stack = jnp.stack([jnp.asarray(f) for f in frames])
    d_ys = jnp.asarray([0.0, 0.35, -0.6, 0.15], jnp.float32)
    d_xs = jnp.asarray([0.0, -0.2, 0.45, 0.7], jnp.float32)
    args = (2.0, 1.0, DrizzleKernel.SQUARE, 64, 72, 3.0, 3.0, 3)
    ref_img, ref_wgt, ref_rej = _drizzle_kernel_exact(
        stack, d_ys, d_xs, *args, band_rows=8)

    mesh = make_mesh(8, ("rows",), (8,))
    img, wgt, rej = sharded_drizzle(mesh, stack, d_ys, d_xs, *args,
                                    band_rows=8)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref_img),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(wgt), np.asarray(ref_wgt),
                               atol=1e-5)
    assert int(rej) == int(ref_rej)


def test_pipeline_recovers_offsets_wide_plane(rng):
    """align_stack_stretch past the coarse cap on both axes: offsets of
    the shifted frames (a zero-offset one among them), the combined
    plane against the shift + clip at the recovered offsets, and the
    u8 preview."""
    from astroburst_tpu.stacking.combine import shift_clip_xla

    h, w = 640, 1152
    base = rng.normal(100, 3, (h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sy, sx in [(100, 200), (400, 800), (300, 500), (520, 950)]:
        base += 900.0 * np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / 8.0)
    shifts = [(0, 0), (3, -5), (-7, 11), (0, 0)]
    # independent noise per frame: duplicate frames would put the MAD
    # at its 1e-10 floor, where clip decisions hang on the last ulp
    stack = jnp.asarray(np.stack([
        np.roll(np.roll(base, dy, 0), dx, 1)
        + rng.normal(0, 1, (h, w)).astype(np.float32)
        for dy, dx in shifts]))
    out = jax.jit(lambda s: align_stack_stretch(s, max_iter=2))(stack)
    np.testing.assert_allclose(np.asarray(out["offsets"]),
                               np.asarray(shifts, np.float32), atol=0.05)
    want, want_rej = shift_clip_xla(stack, out["offsets"][:, 0],
                                    out["offsets"][:, 1], 3.0, 3.0, 2)
    # one fused program vs two: f32 rounding differs in the last bits,
    # and borderline clip decisions of a 4-frame stack may flip
    d = np.abs(np.asarray(out["combined"]) - np.asarray(want))
    assert (d > 5e-3).mean() < 1e-4, f"max |d|={d.max()}"
    assert abs(int(out["rejected"]) - int(want_rej)) <= 50
    assert out["preview"].dtype == jnp.uint8
    assert out["preview"].shape == (h, w)
