"""Smoke check of the main path on one GPU, at the sizes users work at.

    python chip_smoke.py [--seed N]

Runs in one process on one card. Each phase prints one JSON line: its
name, its wall time after a warm-up call (every device result waited
for), its checks, ``peak_bytes_in_use`` and the device (platform,
device_kind, count, the card's name and power limit from nvidia-smi).
The last line is ``{"ok": true, "device": {...}}``. Any failed check or
error ends the run with a non-zero exit code before that line; so does
a machine where JAX finds no GPU, or a directory without the package.

Phases:
- device: what JAX and nvidia-smi report.
- stack_api: 16 frames of 5655×2206 with known shifts written as FITS,
  ``api.stack`` on them; offsets, a band of the combined plane against
  the numpy oracles in tests/reference_impl, FITS and PNG read back.
- headline: ``jax.jit(align_stack_stretch)`` on the device-resident
  stack; the one-pass Triton kernel and the XLA shift+clip timed one
  after the other at the pipeline's offsets.
- preview: ``api.process_fits_full`` on a 4096² frame.
- compose: three 5655×2206 channels through affine ``align_channels_cmd``,
  blend, auto white balance, SCNR, masked stretch and RGB FITS export.
- drizzle: ``drizzle_stack_cmd``, 10 frames of 4096² to 2×, square
  kernel (the XLA exact path); a corner against the scatter oracle.
- gpu_tests: the bodies of the gpu-marked tests (tests/test_gpu.py).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


@dataclass(frozen=True)
class Sizes:
    """The card's sizes by default; the CPU tests shrink them."""
    stack_n: int = 16
    stack_h: int = 5655
    stack_w: int = 2206
    band_rows: int = 6
    preview: int = 4096
    compose_h: int = 5655
    compose_w: int = 2206
    compose_stars: int = 90
    drizzle_n: int = 10
    drizzle_side: int = 4096
    runs: int = 3


def _block(x):
    import jax
    return jax.block_until_ready(x)


def median_ms(call, runs: int) -> float:
    """Median wall time (ms) of ``call()`` over ``runs`` calls after one
    warm-up call; every returned device array is waited for."""
    _block(call())
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _block(call())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def star_field(rng, h, w, n_stars, amp=2000.0, sigma=1.6, halos=False):
    """Gaussian stars on a noisy sky. ``halos`` adds broad faint wings,
    so the bright-pixel share resembles a real exposure: the affine
    chain normalizes by the 99.9th percentile, which a sparse field of
    bare cores leaves at the sky level."""
    img = rng.normal(120.0, 6.0, (h, w)).astype(np.float32)
    r = 14 if halos else int(4 * sigma) + 2
    m = min(20, h // 4, w // 4)
    s2 = 2 * sigma * sigma
    for sy, sx, a in zip(rng.uniform(m, h - m, n_stars),
                         rng.uniform(m, w - m, n_stars),
                         amp * (0.2 + rng.random(n_stars))):
        y0, y1 = max(int(sy) - r, 0), min(int(sy) + r + 1, h)
        x0, x1 = max(int(sx) - r, 0), min(int(sx) + r + 1, w)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        d2 = (yy - sy) ** 2 + (xx - sx) ** 2
        spot = a * np.exp(-d2 / s2)
        if halos:
            spot = spot + 0.06 * a * np.exp(-d2 / (25.0 * s2))
        img[y0:y1, x0:x1] += spot.astype(np.float32)
    return img


def shifted_frames(rng, n, h, w, max_shift=12):
    """n frames of one star field rolled by known integer shifts (frame
    0 unshifted), each with its own noise. Returns (frames, shifts)."""
    base = star_field(rng, h, w, max(40, h * w // 40000))
    shifts = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
    shifts[0] = 0
    frames = np.empty((n, h, w), np.float32)
    for k, (dy, dx) in enumerate(shifts):
        frames[k] = np.roll(base, (int(dy), int(dx)), axis=(0, 1))
        frames[k] += rng.normal(0.0, 2.0, (h, w)).astype(np.float32)
    return frames, shifts


def write_frames(frames, directory):
    from astroburst_tpu.io.fits_writer import write_fits_mono
    os.makedirs(directory, exist_ok=True)
    paths = []
    for k, f in enumerate(frames):
        p = os.path.join(directory, f"f{k:02d}.fits")
        write_fits_mono(p, f, None, bitpix=-32)
        paths.append(p)
    return paths


def read_png(path):
    from tests.reference_impl import ref_decode_png
    with open(path, "rb") as f:
        return ref_decode_png(f.read())


def _uncached(call):
    """Run a command with an empty image cache, so file decode counts."""
    from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE

    def run():
        GLOBAL_IMAGE_CACHE.clear()
        return call()
    return run


def phase_stack_api(sz: Sizes, rng, workdir):
    """api.stack end to end, checked against known shifts and the
    numpy shift + clip oracles."""
    import jax
    import jax.numpy as jnp

    import astroburst_tpu.api as api
    from astroburst_tpu import constants as C
    from astroburst_tpu.alignment.phase_correlation import (
        phase_correlate_stack_traced)
    from astroburst_tpu.io.fits_reader import load_fits_image
    from tests.reference_impl import ref_shift_rows, ref_sigma_clip_combine

    frames, shifts = shifted_frames(rng, sz.stack_n, sz.stack_h,
                                    sz.stack_w)
    paths = write_frames(frames, os.path.join(workdir, "stack_in"))
    out_dir = os.path.join(workdir, "stack_out")
    ms = median_ms(_uncached(lambda: api.stack(paths, out_dir)), sz.runs)
    res = api.stack(paths, out_dir)

    got_offsets = np.asarray(res[C.RES_OFFSETS])
    check(np.array_equal(got_offsets, shifts),
          f"offsets {got_offsets.tolist()} != shifts {shifts.tolist()}")
    combined = load_fits_image(res[C.RES_FITS_PATH])
    check(combined.shape == (sz.stack_h, sz.stack_w)
          and np.isfinite(combined).all(), "stacked FITS does not decode")
    png = read_png(res[C.RES_PNG_PATH])
    check(png.dtype == np.uint8 and png.ndim == 2, "preview PNG")

    # the exact float offsets api.stack used: the same jitted align on
    # the same decoded frames
    stack = jnp.asarray(frames)
    dys, dxs, _ = phase_correlate_stack_traced(stack[0], stack[1:])
    dys = np.r_[0.0, np.asarray(dys, np.float64)]
    dxs = np.r_[0.0, np.asarray(dxs, np.float64)]
    r0 = sz.stack_h // 2
    r1 = r0 + sz.band_rows
    band = np.stack([ref_shift_rows(frames[k], float(np.float32(dys[k])),
                                    float(np.float32(dxs[k])), r0, r1)
                     for k in range(sz.stack_n)])
    want = np.array([[ref_sigma_clip_combine(band[:, i, j], 3.0, 3.0, 5)[0]
                      for j in range(sz.stack_w)]
                     for i in range(sz.band_rows)], np.float32)
    diff = np.abs(combined[r0:r1] - want)
    tol = 1e-3 * np.maximum(np.abs(want), 1.0)
    off = int((diff > tol).sum())
    # f32 summation order may flip a borderline clip decision
    check(off <= max(1, diff.size // 1000),
          f"{off} band pixels off the oracle, max |d|={diff.max()}")
    jax.block_until_ready(stack)
    return {"ms": ms, "offsets_exact": True,
            "band": [r0, r1], "band_max_abs_diff": float(diff.max()),
            "band_pixels_off": off,
            "band_tolerance": "1e-3 relative (f32 order of the tap and "
                              "mean sums vs the f64 oracle)",
            "rejected_pixels": res[C.RES_REJECTED_PIXELS]}, (frames, shifts)


def phase_headline(sz: Sizes, frames, shifts, interpret: bool = False):
    """The fused align + stack + stretch program, and the one-pass
    kernel against the XLA shift+clip at the pipeline's offsets."""
    import jax

    from astroburst_tpu.parallel.pipeline import align_stack_stretch
    from astroburst_tpu.stacking.combine import (shift_clip_xla,
                                                 use_onepass_kernel)
    from astroburst_tpu.stacking.onepass_kernel import shift_clip_onepass

    stack = jax.device_put(frames)
    fn = jax.jit(lambda s: align_stack_stretch(s, 3.0, 3.0, 5))
    t0 = time.perf_counter()
    compiled = fn.lower(stack).compile()
    compile_s = time.perf_counter() - t0
    ms = median_ms(lambda: compiled(stack), sz.runs)
    out = compiled(stack)
    offsets = np.asarray(out["offsets"])
    check(np.abs(offsets - shifts).max() < 0.1,
          f"pipeline offsets {offsets.tolist()}")
    check(np.isfinite(np.asarray(out["combined"])).all(), "combined finite")
    check(out["preview"].dtype == np.uint8, "u8 preview")

    dys, dxs = out["offsets"][:, 0], out["offsets"][:, 1]
    kernel = jax.jit(lambda s, a, b: shift_clip_onepass(
        s, a, b, 3.0, 3.0, 5, interpret=interpret))
    xla = jax.jit(lambda s, a, b: shift_clip_xla(s, a, b, 3.0, 3.0, 5))
    times = {"xla_ms": [], "kernel_ms": []}
    for name, f in (("xla_ms", xla), ("kernel_ms", kernel),
                    ("kernel_ms", kernel), ("xla_ms", xla)):
        times[name].append(median_ms(lambda: f(stack, dys, dxs), sz.runs))
    kc, kr = kernel(stack, dys, dxs)
    xc, xr = xla(stack, dys, dxs)
    max_diff = float(np.max(np.abs(np.asarray(kc) - np.asarray(xc))))
    rej_diff = int(kr) - int(xr)
    check(max_diff < 1e-2 and abs(rej_diff) <= 16,
          f"kernel vs XLA: max |d|={max_diff}, rejected diff {rej_diff}")
    return {"ms": ms, "compile_s": compile_s,
            "kernel_on_main_path": use_onepass_kernel(frames.shape[0]),
            "shift_clip": {k: float(np.median(v)) for k, v in times.items()},
            "shift_clip_runs_ms": times,
            "kernel_vs_xla_max_abs_diff": max_diff,
            "kernel_vs_xla_rejected_diff": rej_diff}


def phase_preview(sz: Sizes, rng, workdir):
    """api.process_fits_full: decode → stats → auto-STF → PNG."""
    import astroburst_tpu.api as api
    from astroburst_tpu import constants as C
    from tests.reference_impl import ref_stats

    plane = star_field(rng, sz.preview, sz.preview,
                       max(40, sz.preview ** 2 // 40000))
    plane[7, 9] = np.nan
    path = write_frames([plane], os.path.join(workdir, "preview_in"))[0]
    out_dir = os.path.join(workdir, "preview_out")
    ms = median_ms(_uncached(lambda: api.process_fits_full(path, out_dir)),
                   sz.runs)
    res = api.process_fits_full(path, out_dir)
    png = read_png(res[C.RES_PNG_PATH])
    check(png.dtype == np.uint8 and png.size > 0, "preview PNG")
    want = ref_stats(plane)
    got = res[C.RES_STATS]
    for key in ("min", "max", "median"):
        check(abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])),
              f"stats {key}: {got[key]} vs oracle {want[key]}")
    return {"ms": ms, "png_shape": list(png.shape),
            "stats_vs_oracle": "min/max/median within 1e-4 relative"}


def phase_compose(sz: Sizes, rng, workdir):
    """Affine channel alignment, then the compose chain to RGB FITS."""
    import astroburst_tpu.api as api
    from astroburst_tpu import constants as C
    from astroburst_tpu.io.fits_reader import extract_image

    h, w = sz.compose_h, sz.compose_w
    base = star_field(rng, h, w, sz.compose_stars, amp=5000.0, sigma=1.3,
                      halos=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    channels = []
    for rot, tx, ty in [(0.0, 0.0, 0.0), (0.4, 3.2, -2.1),
                        (-0.3, -1.7, 2.6)]:
        th = math.radians(rot)
        ct, st = math.cos(th), math.sin(th)
        sx = ct * (xx - w / 2) - st * (yy - h / 2) + w / 2 + tx
        sy = st * (xx - w / 2) + ct * (yy - h / 2) + h / 2 + ty
        img = base[np.clip(np.rint(sy).astype(np.int32), 0, h - 1),
                   np.clip(np.rint(sx).astype(np.int32), 0, w - 1)]
        channels.append(img + rng.normal(0, 1.5, (h, w)).astype(np.float32))
    paths = write_frames(channels, os.path.join(workdir, "compose_in"))
    out_dir = os.path.join(workdir, "compose_out")

    def chain():
        aligned = api.align_channels_cmd(paths, out_dir, "affine")
        keys = aligned[C.RES_CACHE_KEYS]
        api.blend_channels_cmd(
            keys, [{"channelIdx": i, "r": float(i == 0), "g": float(i == 1),
                    "b": float(i == 2)} for i in range(3)], out_dir,
            preset="rgb")
        wb = api.compute_auto_wb_cmd()
        api.calibrate_and_scnr_cmd(out_dir, wb[C.RES_R_FACTOR],
                                   wb[C.RES_G_FACTOR], wb[C.RES_B_FACTOR],
                                   scnr_enabled=True)
        stretch = api.masked_stretch_composite_cmd(out_dir)
        exported = api.export_fits_rgb(os.path.join(out_dir, "rgb.fits"))
        return aligned, stretch, exported

    ms = median_ms(_uncached(chain), sz.runs)
    aligned, stretch, exported = _uncached(chain)()
    methods = [c["method"] for c in aligned[C.CHANNELS]]
    check(set(methods[1:]) <= {"affine", "rigid"},
          f"alignment methods {methods}")
    from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE
    ref = channels[0][h // 4:3 * h // 4, w // 4:3 * w // 4]
    ncc = []
    for key in aligned[C.RES_CACHE_KEYS][1:]:
        got = np.asarray(GLOBAL_IMAGE_CACHE.get(key).image)[
            h // 4:3 * h // 4, w // 4:3 * w // 4]
        ncc.append(float(np.corrcoef(ref.ravel(), got.ravel())[0, 1]))
    check(min(ncc) > 0.9, f"aligned channels correlate {ncc} with ref")
    png = read_png(stretch[C.RES_PNG_PATH])
    check(png.ndim == 3 and png.shape[2] == 3, "composite preview PNG")
    rgb = extract_image(exported[C.RES_OUTPUT_PATH]).image
    check(np.isfinite(rgb).all() and rgb.shape[-2:] == (h, w),
          f"RGB FITS shape {rgb.shape}")
    return {"ms": ms, "methods": methods, "aligned_ncc": ncc,
            "stars_masked": stretch[C.RES_STARS_MASKED],
            "export_bytes": exported[C.RES_FILE_SIZE_BYTES]}


def phase_drizzle(sz: Sizes, rng, workdir):
    """drizzle_stack_cmd at 2×, square kernel, pixfrac 0.7 (the exact
    capped-list path); the top-left corner against the scatter oracle."""
    import astroburst_tpu.api as api
    from astroburst_tpu import constants as C
    from astroburst_tpu.io.fits_reader import load_fits_image
    from tests.reference_impl import ref_drizzle

    side = sz.drizzle_side
    frames, _ = shifted_frames(rng, sz.drizzle_n, side, side, max_shift=2)
    paths = write_frames(frames, os.path.join(workdir, "drizzle_in"))
    out_dir = os.path.join(workdir, "drizzle_out")
    call = _uncached(lambda: api.drizzle_stack_cmd(
        paths, out_dir, scale=2.0, kernel="square"))
    ms = median_ms(call, max(1, sz.runs - 1))
    res = call()
    img = load_fits_image(res[C.RES_FITS_PATH])
    check(img.shape == (2 * side, 2 * side) and np.isfinite(img).all(),
          f"drizzled FITS {img.shape}")
    # the oracle's (dx, dy) offsets move input pixels like d_x = -dx
    # of the response (stacking/drizzle.py drizzle_stack)
    offs = [(-dx, -dy) for dx, dy in res[C.RES_OFFSETS]]
    crop = 24
    want, _, _ = ref_drizzle([f[:crop, :crop] for f in frames], offs, 2.0,
                             0.7, "square", 3.0, 3.0, 5)
    # output pixels the crop's far edge cannot reach (dithers ≤ 3 px)
    edge = 2 * (crop - 4)
    got = img[:edge, :edge]
    diff = np.abs(got - want[:edge, :edge])
    check(np.allclose(got, want[:edge, :edge], rtol=2e-5, atol=2e-3),
          f"drizzle corner vs oracle: max |d|={diff.max()}")
    png = read_png(res[C.RES_PNG_PATH])
    check(png.dtype == np.uint8, "drizzle preview PNG")
    return {"ms": ms, "output_dims": res[C.RES_OUTPUT_DIMS],
            "corner_max_abs_diff": float(diff.max())}


def phase_gpu_tests():
    """The bodies of the gpu-marked tests, in this process."""
    from tests import test_gpu
    names = []
    for name in test_gpu.GPU_CHECKS:
        getattr(test_gpu, name)()
        names.append(name)
    return {"passed": names}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        from astroburst_tpu.runtime.compile_cache import enable_compile_cache
        from astroburst_tpu.runtime.device import (NoGpuError, device_info,
                                                   require_gpu)
    except ImportError as e:
        print(f"chip_smoke: the astroburst_tpu package is missing ({e})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    info = device_info()
    try:
        require_gpu(info)
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 3

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        os.environ.setdefault("ASTROBURST_CONFIG_DIR",
                              os.path.join(workdir, "config"))
        os.environ.setdefault("ASTROBURST_DATA_DIR",
                              os.path.join(workdir, "data"))
        rng = np.random.default_rng(args.seed)
        sz = Sizes()

        def emit(phase, t0, result):
            print(json.dumps({"phase": phase,
                              "wall_s": time.perf_counter() - t0,
                              **result, "peak_bytes_in_use": peak_bytes(),
                              **info}), flush=True)

        t0 = time.perf_counter()
        emit("device", t0, {})
        t0 = time.perf_counter()
        stack_res, (frames, shifts) = phase_stack_api(sz, rng, workdir)
        emit("stack_api", t0, stack_res)
        t0 = time.perf_counter()
        emit("headline", t0, phase_headline(sz, frames, shifts))
        del frames
        for name, phase in (("preview", phase_preview),
                            ("compose", phase_compose),
                            ("drizzle", phase_drizzle)):
            t0 = time.perf_counter()
            emit(name, t0, phase(sz, rng, workdir))
        t0 = time.perf_counter()
        emit("gpu_tests", t0, phase_gpu_tests())

    print(info["card"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["device_kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
