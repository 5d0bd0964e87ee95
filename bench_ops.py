"""Per-op benchmarks on the GPU for every published reference number.

One row per figure in the reference's benchmark table
(docs/code/astroburst_technical_document.tex:609-619 + README in-app
timings; see BASELINE.md). Each entry reports {ms, ref_ms} — ours vs
the reference's Ryzen 9 7950X / consumer-GPU figure.

Measurement rules: device-side ops are timed per call with
``block_until_ready`` after a warm-up call, and the median of the runs
is reported. Ops with host-side stages (star detection's dedupe pass,
the affine chain's RANSAC drive, FITS I/O) are timed end to end on the
wall clock, device fetches included. Every row carries the device it
ran on (platform, device_kind, count, the card's name and power limit).

Run standalone (``python bench_ops.py``): one JSON line per row on
stdout. It fails, printing no row, when JAX finds no GPU.
"""

import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _jx():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _device_time_ms(make_call, runs=7):
    """Median per-call latency (ms) over ``runs`` calls, each waited
    for with ``block_until_ready``, after one warm-up/compile call."""
    jax, _ = _jx()
    jax.block_until_ready(make_call(0))
    times = []
    for i in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(make_call(i + 1))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _star_field(h, w, n_stars, seed=0, fwhm=2.2, amp=3000.0,
                halos=False):
    """Synthetic field; ``halos`` adds broad faint wings so the bright
    pixel fraction resembles a real exposure (the affine chain's
    percentile normalization needs the 99.9th percentile to sit above
    the background — a field of pure 2-px points is unrealistically
    sparse and clips every star to a flat 1.0)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(100.0, 5.0, (h, w)).astype(np.float32)
    ys = rng.random(n_stars) * (h - 40) + 20
    xs = rng.random(n_stars) * (w - 40) + 20
    amps = amp * (0.1 + rng.pareto(2.0, n_stars).clip(max=9.0))
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    s2 = (fwhm / 2.3548) ** 2 * 2.0
    r = 14 if halos else 6
    for sy, sx, a in zip(ys, xs, amps):
        y0, y1 = max(int(sy) - r, 0), min(int(sy) + r + 1, h)
        x0, x1 = max(int(sx) - r, 0), min(int(sx) + r + 1, w)
        d2 = (yy[y0:y1] - sy) ** 2 + (xx[:, x0:x1] - sx) ** 2
        spot = a * np.exp(-d2 / s2)
        if halos:
            spot = spot + 0.06 * a * np.exp(-d2 / (s2 * 25.0))
        base[y0:y1, x0:x1] += spot.astype(np.float32)
    return base


def bench_hist_autostf():
    """Histogram stats + auto-STF, 4096² (ref 35 ms, tex:611)."""
    jax, jnp = _jx()
    from astroburst_tpu.imaging.stf import auto_stf_traced
    from astroburst_tpu.ops.stats import stats_core

    x = jnp.asarray(_star_field(4096, 4096, 300, seed=1))
    x.block_until_ready()

    @jax.jit
    def run(img):
        mn, mx, _t, count, med, mad = stats_core(img, False)
        sigma = jnp.maximum(mad * 1.4826, 1e-30)
        sh, mt = auto_stf_traced(mn, mx, med, sigma, count)
        return sh + mt + med

    return _device_time_ms(lambda i: run(x))


def bench_star_detection(h, w, n_stars, seed=2, max_peaks=1024):
    """detect_stars σ=5: wall end-to-end (device kernels + the host
    dedupe pass + its fetch) plus device_ms of the fused
    background+detect program alone."""
    jax, jnp = _jx()
    from astroburst_tpu.analysis.star_detection import (_detect_fused,
                                                        detect_stars)

    x = jnp.asarray(_star_field(h, w, n_stars, seed=seed))
    x.block_until_ready()
    res = detect_stars(x, 5.0, max_peaks=max_peaks)  # compile
    n_found = len(res.stars)
    best = 1e9
    for i in range(3):
        xi = x
        xi.block_until_ready()
        t0 = time.perf_counter()
        res = detect_stars(xi, 5.0, max_peaks=max_peaks)
        best = min(best, time.perf_counter() - t0)

    tile_size = min(max(min(h, w) // 8, 32), 256)

    def dev_call(i):
        packed = _detect_fused(x, tile_size, 5.0, max_peaks)
        return jnp.sum(packed[:, :8])

    dev_ms = _device_time_ms(dev_call)
    return best * 1e3, dev_ms, n_found


def bench_masked_stretch(converged: bool = False):
    """Masked stretch at 4096²: star detection + mask paint + iterative
    MTF solve. Two configurations:

    - fixed ×10 (ref 1.2 s, tex:617): convergence_threshold=0 pins the
      while_loop to all 10 iterations, matching the reference row.
    - converged (ref 0.7 s "converged after 4 iterations", README:106):
      default threshold, device-side early stop — reports the actual
      iteration count alongside the time.

    Wall time per call INCLUDES the two host fetches the real command
    pays (detection's packed array + the packed info row)."""
    jax, jnp = _jx()
    from astroburst_tpu.imaging.masked_stretch import (MaskedStretchConfig,
                                                       masked_stretch)

    x = jnp.asarray(_star_field(4096, 4096, 3000, seed=3))
    x.block_until_ready()
    cfg = (MaskedStretchConfig(iterations=10) if converged else
           MaskedStretchConfig(iterations=10, convergence_threshold=0.0))

    iters_seen = [0]

    def call(i):
        res = masked_stretch(x, cfg)
        iters_seen[0] = res.iterations_run
        return res.image[0, 0] + res.image[-1, -1]

    ms = _device_time_ms(call)
    return ms, iters_seen[0]


def bench_tone_curves():
    """Spline tone curves on a 5655×2206 3-channel composite
    (ref 2425 ms in-app, README:53)."""
    jax, jnp = _jx()
    from astroburst_tpu.imaging.curves import SplineCurve, apply_curve_rgb

    h, w = 5655, 2206
    rng = np.random.default_rng(4)
    r = jnp.asarray(rng.random((h, w)).astype(np.float32))
    g = jnp.asarray(rng.random((h, w)).astype(np.float32))
    b = jnp.asarray(rng.random((h, w)).astype(np.float32))
    jax.block_until_ready((r, g, b))
    curve = SplineCurve([(0.0, 0.0), (0.3, 0.45), (0.7, 0.8), (1.0, 1.0)])

    @jax.jit
    def run(r, g, b):
        rr, gg, bb = apply_curve_rgb(r, g, b, curve, curve, curve)
        return rr[0, 0] + gg[100, 100] + bb[-1, -1]

    return _device_time_ms(lambda i: run(r, g, b))


def bench_blend_stf_lum():
    """3-channel blend + linked auto-STF stretch + luminance synth,
    4096²×3 on device (ref 0.4 s incl. its FITS write, tex:615 —
    the host FITS write is benched separately as fits_rgb_export)."""
    jax, jnp = _jx()
    from astroburst_tpu.compose.channel_blend import blend_channels
    from astroburst_tpu.imaging.masked_stretch import synthesize_luminance
    from astroburst_tpu.imaging.stf import apply_stf_traced, auto_stf_traced
    from astroburst_tpu.ops.stats import stats_core

    rng = np.random.default_rng(5)
    chans = [jnp.asarray(rng.normal(100, 10, (4096, 4096)).astype(np.float32))
             for _ in range(3)]
    import jax as _j
    _j.block_until_ready(chans)
    weights = [
        {"channel_idx": 0, "r_weight": 1.0, "g_weight": 0.1, "b_weight": 0.0},
        {"channel_idx": 1, "r_weight": 0.1, "g_weight": 0.8, "b_weight": 0.1},
        {"channel_idx": 2, "r_weight": 0.0, "g_weight": 0.1, "b_weight": 1.0},
    ]

    @jax.jit
    def run(c0, c1, c2):
        r, g, b = blend_channels([c0, c1, c2], weights)
        lum = synthesize_luminance(r, g, b)
        mn, mx, _t, count, med, mad = stats_core(lum, False)
        sh, mt = auto_stf_traced(mn, mx, med,
                                 jnp.maximum(mad * 1.4826, 1e-30), count)
        outs = [apply_stf_traced(c, mn, mx, sh, mt, as_u8=False)
                for c in (r, g, b)]
        return outs[0][0, 0] + outs[1][100, 100] + outs[2][-1, -1] + lum[5, 5]

    return _device_time_ms(
        lambda i: run(chans[0], chans[1], chans[2]))


def bench_sho_blend():
    """SHO blend, 3×1600×1600 (ref 345 ms in-app, README:48)."""
    jax, jnp = _jx()
    from astroburst_tpu.compose.channel_blend import blend_channels

    rng = np.random.default_rng(6)
    chans = [jnp.asarray(rng.normal(80, 9, (1600, 1600)).astype(np.float32))
             for _ in range(3)]
    jax.block_until_ready(chans)
    weights = [
        {"channel_idx": 0, "r_weight": 0.4, "g_weight": 0.6, "b_weight": 0.0},
        {"channel_idx": 1, "r_weight": 0.6, "g_weight": 0.3, "b_weight": 0.1},
        {"channel_idx": 2, "r_weight": 0.0, "g_weight": 0.1, "b_weight": 0.9},
    ]

    @jax.jit
    def run(c0, c1, c2):
        r, g, b = blend_channels([c0, c1, c2], weights)
        return r[0, 0] + g[100, 100] + b[-1, -1]

    return _device_time_ms(
        lambda i: run(chans[0], chans[1], chans[2]))


def bench_white_balance():
    """Auto WB: per-channel robust stats → stability reference →
    ORIG×factor apply, 4096²×3 (ref 45 ms, tex:619)."""
    jax, jnp = _jx()
    from astroburst_tpu.ops.stats import stats_core

    rng = np.random.default_rng(7)
    chans = [jnp.asarray(
        rng.normal(90 + 10 * i, 8, (4096, 4096)).astype(np.float32))
        for i in range(3)]
    jax.block_until_ready(chans)

    @jax.jit
    def run(c0, c1, c2):
        meds = []
        mads = []
        for c in (c0, c1, c2):
            _mn, _mx, _t, _n, med, mad = stats_core(c, False)
            meds.append(med)
            mads.append(mad)
        meds = jnp.stack(meds)
        mads = jnp.stack(mads)
        stab = mads / jnp.maximum(meds, 1e-10)
        ref = jnp.argmin(stab)
        ref_med = jnp.maximum(meds[ref], 1e-10)
        fac = ref_med / jnp.maximum(meds, 1e-10)
        fac = fac.at[ref].set(1.0)
        outs = [c0 * fac[0], c1 * fac[1], c2 * fac[2]]
        return outs[0][0, 0] + outs[1][1, 1] + outs[2][2, 2] + fac.sum()

    return _device_time_ms(
        lambda i: run(chans[0], chans[1], chans[2]))


def bench_affine_align(h=5655, w=2206, n_stars=90):
    """Star-based affine channel alignment end-to-end: detect ×2 →
    triangles → vote → RANSAC → shear warp (ref 0.8 s at 4096²/80
    stars, tex:616; BASELINE config #3 runs it at 5655×2206).
    Wall-clock including host stages and fetches."""
    import math

    jax, jnp = _jx()
    from astroburst_tpu.alignment.fused_chain import align_and_warp

    base = _star_field(h, w, n_stars, seed=8, amp=5000.0, fwhm=3.0,
                       halos=True)
    th = math.radians(0.4)
    ct, st = math.cos(th), math.sin(th)
    cy, cx = h / 2.0, w / 2.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = ct * (xx - cx) - st * (yy - cy) + cx + 3.2
    sy = st * (xx - cx) + ct * (yy - cy) + cy - 2.1
    xi = np.clip(sx.astype(np.int32), 0, w - 1)
    yi = np.clip(sy.astype(np.int32), 0, h - 1)
    target = base[yi, xi] + np.random.default_rng(9).normal(
        0, 1.5, (h, w)).astype(np.float32)

    ref_d = jnp.asarray(base)
    tgt_d = jnp.asarray(target)
    jax.block_until_ready((ref_d, tgt_d))

    def run():
        warped, res = align_and_warp(ref_d, tgt_d)
        warped.block_until_ready()
        return res

    res = run()  # compile
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        best = min(best, time.perf_counter() - t0)
    rot = res.transform.rotation_deg()
    # the recovered transform maps target→reference (inverse sense)
    ok = res.method in ("affine", "rigid") and abs(abs(rot) - 0.4) < 0.1

    # device-only latency of the fused program
    from astroburst_tpu.alignment import fused_chain as FC
    from astroburst_tpu.analysis import star_detection as SD
    from astroburst_tpu.alignment.warp_shear import _bucket
    tile = min(max(min(h, w) // 8, 32), 256)
    env = 0.035
    span_v = env * (w - 1)
    span_h = env * (h - 1)
    m_v = _bucket(int(span_v) + 4)
    m_h = _bucket(int(span_h) + 4)
    nb_v = max(int(span_v) + 1, 1).bit_length()
    nb_h = max(int(span_h) + 1, 1).bit_length()

    def dev_call(i):
        warped, info = FC._fused_align_warp(
            ref_d, tgt_d, tile, SD.MAX_PEAKS,
            m_v, m_h, nb_v, nb_h)
        return jnp.sum(info) + warped[0, 0]

    dev_ms = _device_time_ms(dev_call)
    return best * 1e3, dev_ms, res.method, ok


def bench_drizzle(kernel_name: str = "square", band_rows: int = 1024):
    """Exact-parity drizzle on the XLA path, 10×4096² → 2×, 5 clip
    iterations (ref 4.2 s for the default square kernel, tex:614; the
    reference publishes no gaussian/lanczos3 numbers — those rows
    record ours). Candidate memory at 1024 band rows is
    40×1024×8192×4 B ≈ 1.3 GB."""
    jax, jnp = _jx()
    from astroburst_tpu.dtypes import DrizzleKernel
    from astroburst_tpu.stacking.drizzle import _drizzle_kernel_exact

    kern = {"square": DrizzleKernel.SQUARE,
            "gaussian": DrizzleKernel.GAUSSIAN,
            "lanczos3": DrizzleKernel.LANCZOS3}[kernel_name]
    rng = np.random.default_rng(10)
    stack = jnp.asarray(rng.normal(100, 8, (10, 4096, 4096))
                        .astype(np.float32))
    d_ys = jnp.asarray(rng.uniform(-2, 2, 10), jnp.float32)
    d_xs = jnp.asarray(rng.uniform(-2, 2, 10), jnp.float32)
    stack.block_until_ready()

    def call(i):
        return _drizzle_kernel_exact(
            stack, d_ys, d_xs, 2.0, 0.7, kern, 8192, 8192, 3.0, 3.0, 5,
            band_rows=band_rows)

    return _device_time_ms(call, runs=3)


def bench_rl_deconv(fast: bool = False):
    """Richardson-Lucy 20 iterations, 2048², 15×15 PSF (no published
    reference row). Pads to the engine-fast size the production path
    uses (2176, not 4096). fast=True measures the opt-in DEFAULT
    precision matmul variant (RLConfig.fast_precision: TF32 on the
    H100)."""
    jax, jnp = _jx()
    from astroburst_tpu.analysis.deconvolution import (
        _psf_spectrum, _rl_kernel, generate_gaussian_psf)
    from astroburst_tpu.ops import fft as F

    rng = np.random.default_rng(11)
    img = jnp.asarray(rng.normal(100, 10, (2048, 2048)).astype(np.float32))
    img.block_until_ready()
    psf = generate_gaussian_psf(15, 2.0)
    fr = F.next_fast_size(2048 + 14)
    kr, ki = _psf_spectrum(psf, fr, fr, fast=fast)

    def call(i):
        est, iters, conv = _rl_kernel(
            img, kr, ki, jnp.float32(0.0),
            jnp.float32(0.1), fr, 20, False, fast=fast)
        return est[0, 0] + est[-1, -1] + conv

    ms = _device_time_ms(call)
    if not fast:
        return ms
    # accuracy gate for the opt-in precision mode: max rel error of the
    # fast-precision estimate vs the f32 path on the same input
    kr32, ki32 = _psf_spectrum(psf, fr, fr, fast=False)
    e_fast, _, _ = _rl_kernel(img, kr, ki, jnp.float32(0.0),
                              jnp.float32(0.1), fr, 20, False, fast=True)
    e_f32, _, _ = _rl_kernel(img, kr32, ki32, jnp.float32(0.0),
                             jnp.float32(0.1), fr, 20, False, fast=False)
    scale = jnp.maximum(jnp.max(jnp.abs(e_f32)), 1e-30)
    rel = float(jnp.max(jnp.abs(e_fast - e_f32)) / scale)
    return ms, rel


def bench_single_fits():
    """Single FITS processing, 4096² (ref 120 ms = 533 MB/s, tex:609):
    host big-endian decode of a 64 MB plane + device stats + auto-STF
    + MTF stretch + u8 quantize — the process_fits_full hot path with
    the file already in page cache (as the reference measures it).

    Reported ms = host decode + H2D upload + device compute, each timed
    on its own (median of the runs)."""
    import os
    import tempfile

    jax, jnp = _jx()
    from astroburst_tpu.imaging.stf import apply_stf_traced, auto_stf_traced
    from astroburst_tpu.io.fits_reader import load_fits_image
    from astroburst_tpu.io.fits_writer import write_fits_mono
    from astroburst_tpu.ops.stats import stats_core

    rng = np.random.default_rng(7)
    plane = rng.normal(100, 10, (4096, 4096)).astype(np.float32)
    d = tempfile.mkdtemp(prefix="bench_single_")
    p = os.path.join(d, "one.fits")
    write_fits_mono(p, plane, None, bitpix=-32)

    @jax.jit
    def device_part(img):
        mn, mx, _t, count, med, mad = stats_core(img, False)
        sigma = jnp.maximum(mad * 1.4826, 1e-30)
        sh, mt = auto_stf_traced(mn, mx, med, sigma, count)
        u8 = apply_stf_traced(img, mn, mx, sh, mt, as_u8=True)
        return u8

    # warm page cache + decode path, then time host decode alone
    img = load_fits_image(p)
    decode_best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        img = load_fits_image(p)
        decode_best = min(decode_best, time.perf_counter() - t0)

    host = np.asarray(img)
    h2d_ms = _device_time_ms(lambda i: jax.device_put(host))
    img_d = jax.device_put(host)

    dev_ms = _device_time_ms(lambda i: device_part(img_d))
    os.unlink(p)
    os.rmdir(d)
    return (decode_best * 1e3 + h2d_ms + dev_ms, decode_best * 1e3,
            dev_ms, h2d_ms)


def bench_sigma_clip_stack():
    """Sigma-clip stack, 10×64 MB, 5 iterations (ref 2.1 s, tex:613):
    the reference's zero-offset raw path through the one shift + clip
    entry (stacking.combine.shift_clip)."""
    jax, jnp = _jx()
    from astroburst_tpu.stacking.combine import shift_clip

    rng = np.random.default_rng(5)
    stack = jnp.asarray(rng.normal(100, 8, (10, 4096, 4096))
                        .astype(np.float32))
    stack.block_until_ready()
    zeros = jnp.zeros(10, jnp.float32)
    run = jax.jit(lambda s: shift_clip(s, zeros, zeros, 3.0, 3.0, 5))
    return _device_time_ms(lambda i: run(stack))


def bench_fits_rgb_export():
    """FITS RGB export, 618 MB (ref 617 ms in-app, README:116) —
    host-side encode+write of three f32 planes into the temporary
    directory. The reference's figure is an in-app write into a page
    cache (no fsync), so the disk behind the temporary directory shapes
    this row."""
    import os
    import tempfile

    from astroburst_tpu.io.fits_writer import write_fits_rgb

    side = 7180  # 3 × 7180² × 4 B ≈ 618 MB
    rng = np.random.default_rng(12)
    r = rng.normal(100, 10, (side, side)).astype(np.float32)
    g = r * 0.9
    b = r * 1.1
    d = tempfile.mkdtemp(prefix="bench_export_")
    p = os.path.join(d, "rgb.fits")
    best = 1e9
    for _ in range(4):
        t0 = time.perf_counter()
        write_fits_rgb(p, r, g, b, None, bitpix=-32)
        best = min(best, time.perf_counter() - t0)
    sz = os.path.getsize(p) / 1e6
    os.unlink(p)
    os.rmdir(d)
    return best * 1e3, sz


def bench_batch_ingest():
    """Batch processing, 10 frames × 64 MB: decode → per-frame stats
    (ref 450 ms = 1.4 GB/s on 16 cores, tex:610 + README:37). Host
    decode timed per file (page-cache warm, as the reference measures);
    per-frame device stats timed on the device-resident batch."""
    import tempfile

    jax, jnp = _jx()
    from astroburst_tpu.io.fits_reader import load_fits_image
    from astroburst_tpu.io.fits_writer import write_fits_mono
    from astroburst_tpu.ops.stats import stats_core

    rng = np.random.default_rng(13)
    d = tempfile.mkdtemp(prefix="bench_batch_")
    paths = []
    for k in range(10):
        plane = rng.normal(100, 10, (4096, 4096)).astype(np.float32)
        p = os.path.join(d, f"f{k}.fits")
        write_fits_mono(p, plane, None, bitpix=-32)
        paths.append(p)

    planes = [load_fits_image(p) for p in paths]  # warm cache + path
    decode_best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        planes = [load_fits_image(p) for p in paths]
        decode_best = min(decode_best, time.perf_counter() - t0)

    stack = jnp.asarray(np.stack([np.asarray(pl) for pl in planes]))
    stack.block_until_ready()

    @jax.jit
    def stats10(s):
        acc = jnp.float32(0.0)
        for k in range(10):
            mn, mx, _t, cnt, med, mad = stats_core(s[k], False)
            acc = acc + mn + mx + med + mad + cnt.astype(jnp.float32)
        return acc

    dev_ms = _device_time_ms(lambda i: stats10(stack))
    for p in paths:
        os.unlink(p)
    os.rmdir(d)
    gb = 10 * 64.0 / 1000.0
    total_ms = decode_best * 1e3 + dev_ms
    return total_ms, decode_best * 1e3, dev_ms, gb / (total_ms / 1e3)


def bench_cube_open():
    """Open a 2 GB IFU datacube + fetch one frame (ref 300 ms,
    README:37, lazy.rs:125). Builds a real 500×1000×1000 BITPIX=-32
    file on disk once (skipped when the volume lacks ~2.5 GB free),
    then times LazyCube construction (mmap + header scan) and a
    mid-cube get_frame (4 MB read + byteswap)."""
    import tempfile

    from astroburst_tpu.cube.lazy import LazyCube

    d = tempfile.mkdtemp(prefix="bench_cube_")
    st = os.statvfs(d)
    if st.f_bavail * st.f_frsize < 2_600_000_000:
        os.rmdir(d)
        raise RuntimeError("needs ~2.5 GB free disk for the 2 GB cube")
    p = os.path.join(d, "cube.fits")
    b_, h_, w_ = 500, 1000, 1000

    def card(k, v):
        return f"{k:<8}= {v:>20}".ljust(80).encode()

    hdr = (card("SIMPLE", "T") + card("BITPIX", "-32") + card("NAXIS", "3")
           + card("NAXIS1", str(w_)) + card("NAXIS2", str(h_))
           + card("NAXIS3", str(b_)) + "END".ljust(80).encode())
    hdr += b" " * (2880 - len(hdr) % 2880)
    rng = np.random.default_rng(14)
    with open(p, "wb") as f:
        f.write(hdr)
        plane = (100.0 + rng.standard_normal((h_, w_))).astype(">f4")
        raw = plane.tobytes()
        for _ in range(b_):
            f.write(raw)
        pad = (2880 - (f.tell() % 2880)) % 2880
        f.write(b"\0" * pad)

    open_best = 1e9
    fetch_best = 1e9
    for k in range(3):
        t0 = time.perf_counter()
        cube = LazyCube(p)
        open_best = min(open_best, time.perf_counter() - t0)
        t0 = time.perf_counter()
        fr = cube.get_frame(250 + k)  # distinct → no LRU hit
        fetch_best = min(fetch_best, time.perf_counter() - t0)
        assert fr.shape == (h_, w_)
        cube.close()
    os.unlink(p)
    os.rmdir(d)
    return open_best * 1e3, fetch_best * 1e3


def bench_wavelet_denoise():
    """À-trous wavelet denoise, 4096², 5 scales (pipeline stage —
    wavelet.rs:41; the reference publishes no standalone figure)."""
    jax, jnp = _jx()
    from astroburst_tpu.imaging.wavelet import (WaveletConfig,
                                                _wavelet_kernel)

    cfg = WaveletConfig()
    num_scales = min(max(cfg.num_scales, 1), 8)
    thr = list(cfg.thresholds) or [1.0]
    while len(thr) < num_scales:
        thr.append(thr[-1])
    thr_d = jnp.asarray(thr[:num_scales], jnp.float32)

    x = jnp.asarray(_star_field(4096, 4096, 300, seed=15))
    x.block_until_ready()

    def call(i):
        out, noise = _wavelet_kernel(x, thr_d, num_scales,
                                     cfg.linear_denoise)
        return out[0, 0] + out[-1, -1] + noise

    return _device_time_ms(call), num_scales


def bench_background_extraction():
    """Polynomial background extraction, 4096² (pipeline stage —
    background.rs:55; no published standalone figure). End-to-end wall
    including the cell-median fetch + host polyfit, like the real
    command."""
    jax, jnp = _jx()
    from astroburst_tpu.imaging.background import (BackgroundConfig,
                                                   extract_background)

    x = jnp.asarray(_star_field(4096, 4096, 300, seed=16))
    x.block_until_ready()
    cfg = BackgroundConfig()
    res = extract_background(x, cfg)  # compile
    best = 1e9
    for i in range(3):
        xi = x
        xi.block_until_ready()
        t0 = time.perf_counter()
        res = extract_background(xi, cfg)
        res.corrected.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def bench_affine_per_target(h=5655, w=2206, n_stars=90):
    """The real compose workload: align G and B to R with ONE reference
    detection (RefStars reuse — blend.rs:226 aligns every channel to
    the same reference). Reports per-target wall; the round-3 row only
    ever aligned a single target, so the amortization was unmeasured."""
    import math

    jax, jnp = _jx()
    from astroburst_tpu.alignment.fused_chain import (align_and_warp_many,
                                                      detect_ref_stars)

    base = _star_field(h, w, n_stars, seed=8, amp=5000.0, fwhm=3.0,
                       halos=True)
    targets = []
    for k, (rot_deg, tx, ty) in enumerate([(0.4, 3.2, -2.1),
                                           (-0.3, -1.7, 2.6)]):
        th = math.radians(rot_deg)
        ct, st = math.cos(th), math.sin(th)
        cy, cx = h / 2.0, w / 2.0
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        sx = ct * (xx - cx) - st * (yy - cy) + cx + tx
        sy = st * (xx - cx) + ct * (yy - cy) + cy + ty
        xi = np.clip(sx.astype(np.int32), 0, w - 1)
        yi = np.clip(sy.astype(np.int32), 0, h - 1)
        targets.append(base[yi, xi] + np.random.default_rng(20 + k)
                       .normal(0, 1.5, (h, w)).astype(np.float32))

    ref_d = jnp.asarray(base)
    tgt_ds = [jnp.asarray(t) for t in targets]
    jax.block_until_ready((ref_d, *tgt_ds))

    def run():
        rs = detect_ref_stars(ref_d)
        outs = align_and_warp_many(ref_d, tgt_ds, ref_stars=rs)
        outs[-1][0].block_until_ready()
        return all(r.method in ("affine", "rigid") for _, r in outs)

    ok = run()  # compile
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        ok = run()
        best = min(best, time.perf_counter() - t0)

    # device-only latency of the batched two-target program
    from astroburst_tpu.alignment import fused_chain as FC
    from astroburst_tpu.alignment.warp_shear import _bucket
    rs = detect_ref_stars(ref_d)
    tile = min(max(min(h, w) // 8, 32), 256)
    env = 0.035
    span_v = env * (w - 1)
    span_h = env * (h - 1)
    m_v = _bucket(int(span_v) + 4)
    m_h = _bucket(int(span_h) + 4)
    nb_v = max(int(span_v) + 1, 1).bit_length()
    nb_h = max(int(span_h) + 1, 1).bit_length()
    tgts_stacked = jnp.stack(tgt_ds)

    def dev_call(i):
        warped, infos = FC._fused_align_warp_many(
            rs.xs, rs.ys, rs.n, rs.ratios_t, rs.verts_t,
            tgts_stacked, tile, rs.max_peaks,
            m_v, m_h, nb_v, nb_h)
        return jnp.sum(infos) + warped[0, 0, 0] + warped[1, 0, 0]

    dev_ms = _device_time_ms(dev_call)
    n = len(tgt_ds)
    return best * 1e3 / n, dev_ms / n, ok


def run_all(device: dict, emit=None):
    """Every published reference row, in order. ``device`` (from
    ``runtime.device.device_info``) is attached to every row; ``emit``
    receives each finished row. A failing row raises."""
    ops = {}

    def row(name, label, fn):
        log(f"ops: {label} …")
        ops[name] = dict(fn(), **device)
        log(f"  {ops[name]}")
        if emit is not None:
            emit(name, ops[name])

    row("hist_autostf_4096", "hist+auto-STF 4096²", lambda: {
        "ms": round(bench_hist_autostf(), 2), "ref_ms": 35.0})

    def _star_4096():
        ms, dev_ms, n = bench_star_detection(4096, 4096, 3000, seed=2,
                                             max_peaks=4096)
        return {"ms": round(ms, 1), "device_ms": round(dev_ms, 1),
                "ref_ms": 80.0, "stars": n}
    row("star_detect_4096", "star detection 4096² (~3000 stars)",
        _star_4096)

    def _star_5655():
        ms, dev_ms, n = bench_star_detection(5655, 2206, 200, seed=3)
        return {"ms": round(ms, 1), "device_ms": round(dev_ms, 1),
                "ref_ms": 97.0, "stars": n}
    row("star_detect_5655", "star detection 5655×2206 (200 stars)",
        _star_5655)

    def _masked10():
        ms, iters = bench_masked_stretch(converged=False)
        return {"ms": round(ms, 1), "ref_ms": 1200.0, "iterations": iters}
    row("masked_stretch_4096_x10", "masked stretch ×10 4096²", _masked10)

    def _masked_conv():
        ms, iters = bench_masked_stretch(converged=True)
        return {"ms": round(ms, 1), "ref_ms": 700.0, "iterations": iters,
                "ref_note": "in-app converged-4-iter run, README:106"}
    row("masked_stretch_converged", "masked stretch converged 4096²",
        _masked_conv)

    row("tone_curves_5655x3", "tone curves 5655×2206×3", lambda: {
        "ms": round(bench_tone_curves(), 2), "ref_ms": 2425.0})

    row("blend_stf_lum_4096x3", "blend + linked STF + lum 4096²×3",
        lambda: {"ms": round(bench_blend_stf_lum(), 2), "ref_ms": 400.0})

    row("sho_blend_1600x3", "SHO blend 1600²×3", lambda: {
        "ms": round(bench_sho_blend(), 2), "ref_ms": 345.0})

    row("white_balance_4096x3", "white balance 4096²×3", lambda: {
        "ms": round(bench_white_balance(), 2), "ref_ms": 45.0})

    def _affine():
        ms, dev_ms, method, ok = bench_affine_align()
        return {"ms": round(ms, 1), "device_ms": round(dev_ms, 1),
                "ref_ms": 800.0, "method": method, "recovered": ok}
    row("affine_align_5655", "affine channel alignment 5655×2206",
        _affine)

    def _affine_per_target():
        ms, dev_ms, ok = bench_affine_per_target()
        return {"ms": round(ms, 1), "device_ms": round(dev_ms, 1),
                "ref_ms": 800.0, "recovered": ok,
                "note": "G,B→R in ONE device program with one shared "
                        "RefStars detection and one info fetch"}
    row("affine_align_per_target", "affine align per target (RefStars ×2)",
        _affine_per_target)

    def _single():
        ms, dec_ms, dev_ms, h2d = bench_single_fits()
        return {"ms": ms, "decode_ms": dec_ms, "device_ms": dev_ms,
                "h2d_ms": h2d, "ref_ms": 120.0}
    row("single_fits_4096", "single FITS processing 4096²", _single)

    def _batch():
        ms, dec_ms, dev_ms, gbs = bench_batch_ingest()
        return {"ms": round(ms, 1), "decode_ms": round(dec_ms, 1),
                "device_ms": round(dev_ms, 1),
                "gb_s": round(gbs, 2), "ref_ms": 450.0,
                "ref_gb_s": 1.4}
    row("batch_ingest_10x64mb", "batch ingest+stats 10×64 MB", _batch)

    def _cube():
        open_ms, fetch_ms = bench_cube_open()
        return {"ms": round(open_ms + fetch_ms, 1),
                "open_ms": round(open_ms, 2),
                "frame_fetch_ms": round(fetch_ms, 1), "ref_ms": 300.0}
    row("cube_2gb_open", "2 GB IFU cube lazy open + frame", _cube)

    row("sigma_clip_stack_10x4096", "sigma-clip stack 10×4096² ×5 iters",
        lambda: {"ms": round(bench_sigma_clip_stack(), 1),
                 "ref_ms": 2100.0})

    def _drizzle_sq():
        return {"ms": bench_drizzle(), "ref_ms": 4200.0}
    row("drizzle_10x4096_2x", "drizzle 10×4096² 2×", _drizzle_sq)
    row("drizzle_gaussian_10x4096_2x", "drizzle gaussian 10×4096² 2×",
        lambda: {"ms": bench_drizzle("gaussian"),
                 "ref_ms": None})
    row("drizzle_lanczos3_10x4096_2x", "drizzle lanczos3 10×4096² 2×",
        lambda: {"ms": bench_drizzle("lanczos3"),
                 "ref_ms": None})

    def _wavelet():
        ms, scales = bench_wavelet_denoise()
        return {"ms": round(ms, 2), "ref_ms": None, "scales": scales}
    row("wavelet_denoise_4096", "wavelet denoise 4096² (5 scales)",
        _wavelet)

    row("background_extract_4096", "background extraction 4096²",
        lambda: {"ms": round(bench_background_extraction(), 1),
                 "ref_ms": None})

    row("rl_deconv_2048_x20", "RL deconvolution 2048²×20", lambda: {
        "ms": round(bench_rl_deconv(), 1), "ref_ms": None})

    def _rl_fast():
        ms, rel = bench_rl_deconv(fast=True)
        return {"ms": round(ms, 1), "ref_ms": None,
                "max_rel_err_vs_f32": float(f"{rel:.2e}")}
    row("rl_deconv_2048_x20_fast",
        "RL deconvolution 2048²×20 fast_precision", _rl_fast)

    def _export():
        ms, mb = bench_fits_rgb_export()
        return {"ms": round(ms, 0), "ref_ms": 617.0, "mb": round(mb, 0)}
    row("fits_rgb_export_618mb", "FITS RGB export 618 MB", _export)

    return ops


if __name__ == "__main__":
    import json

    from astroburst_tpu.runtime.compile_cache import enable_compile_cache
    from astroburst_tpu.runtime.device import device_info, require_gpu

    enable_compile_cache()
    info = device_info()
    require_gpu(info)
    run_all(info, lambda name, r: print(json.dumps({"op": name, **r}),
                                        flush=True))
