"""Headline benchmark: align + sigma-clip stack + auto-STF stretch.

Workload (BASELINE.json): 16 synthetic JWST-NIRCam-like frames at
5655×2206 float32, shifted star fields with noise. One jitted program
(parallel/pipeline.align_stack_stretch): phase-correlation alignment to
frame 0 (coarse-to-fine), the shift + sigma-clip entry (one-pass GPU
kernel, 5 iterations), robust stats, auto-STF, u8 stretch.

Baseline: the reference stacks 10×64 MB (167.8 Mpx) with 5 clip
iterations in 2.1 s on a Ryzen 9 7950X → 79.9 Mpx/s
(docs/code/astroburst_technical_document.tex:613). vs_baseline is
this pipeline's Mpx/s per card over that number.

Every time is the median of several calls, each waited for with
``block_until_ready`` after a warm-up call; compile time is reported on
its own. Secondary metrics in the same JSON line:
- h2d_ms: host → device upload of the 0.80 GB stack.
- stage_ms: align, shift+clip and stats+STF each on its own.
- stf_device_ms: STF apply + u8 quantize + 2048² NN downsample of a
  4096² plane (the preview slider path). Reference WebGPU comparable:
  8 ms (tex:618).
- ipc_encode_ms: the 16-byte-header binary preview encode
  (ops/ipc.py) on the host from the fetched downsample.
- ingest_decode_gb_s: host-side FITS decode throughput (C++ OpenMP
  byteswap path) for a 10×64 MB batch via io/prefetch.py.

Every stdout line is one JSON object naming the device (platform,
device_kind, count, the card's name and power limit); the headline is
the last. It fails, printing no result, when JAX finds no GPU.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 16
H, W = 5655, 2206
BASELINE_MPX_S = 167.8 / 2.1  # 79.9 Mpx/s
RUNS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_frames(n, h, w, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.normal(120.0, 6.0, (h, w)).astype(np.float32)
    ys = rng.random(300) * (h - 40) + 20
    xs = rng.random(300) * (w - 40) + 20
    amps = 300.0 + rng.random(300) * 2000.0
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    for sy, sx, amp in zip(ys, xs, amps):
        y0, y1 = max(int(sy) - 8, 0), min(int(sy) + 8, h)
        x0, x1 = max(int(sx) - 8, 0), min(int(sx) + 8, w)
        base[y0:y1, x0:x1] += (
            amp * np.exp(-((yy[y0:y1] - sy) ** 2 + (xx[:, x0:x1] - sx) ** 2)
                         / 5.0)).astype(np.float32)
    frames = []
    shifts = rng.integers(-12, 12, size=(n, 2))
    shifts[0] = 0
    for i in range(n):
        f = np.roll(base, tuple(shifts[i]), axis=(0, 1))
        f = f + rng.normal(0, 2.0, (h, w)).astype(np.float32)
        frames.append(f.astype(np.float32))
    return np.stack(frames)


def bench_ingest_decode():
    """Host decode (GB/s, cores): 10×64 MB BITPIX=-32 frames through
    the dispatcher + native byteswap, pipelined by io/prefetch.py.

    Thread depth matches the available cores (up to 4): on a box with
    fewer cores extra worker threads only thrash. The core count is
    recorded alongside so the number is interpretable (reference
    comparable: 1.4 GB/s on 16 Rayon cores, tex:610)."""
    from astroburst_tpu.io.fits_writer import write_fits_mono
    from astroburst_tpu.io.prefetch import prefetch_images

    cores = os.cpu_count() or 1
    depth = max(1, min(4, cores))
    d = tempfile.mkdtemp(prefix="bench_ingest_")
    rng = np.random.default_rng(7)
    plane = rng.normal(100.0, 8.0, (4096, 4096)).astype(np.float32)
    paths = []
    for i in range(10):
        p = os.path.join(d, f"f{i:02d}.fits")
        write_fits_mono(p, plane, bitpix=-32)
        paths.append(p)
    total_gb = 10 * plane.nbytes / 1e9
    # warm the page cache + the thread pool + the native lib once
    for img in prefetch_images(paths[:2], depth=depth, to_device=False):
        pass
    best = 1e9
    for _ in range(5):
        t0 = time.perf_counter()
        n = 0
        for img in prefetch_images(paths, depth=depth, to_device=False):
            n += img.image.shape[0]
        best = min(best, time.perf_counter() - t0)
    for p in paths:
        os.unlink(p)
    os.rmdir(d)
    return total_gb / best, cores


def median_ms(call, runs=RUNS):
    """Median latency (ms) of ``call()`` over ``runs`` calls, each
    waited for with ``block_until_ready``, after one warm-up call."""
    import jax

    jax.block_until_ready(call())
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main():
    from astroburst_tpu.runtime.compile_cache import enable_compile_cache
    from astroburst_tpu.runtime.device import device_info, require_gpu

    enable_compile_cache()
    info = device_info()
    require_gpu(info)

    import jax
    import jax.numpy as jnp

    from astroburst_tpu.alignment.phase_correlation import (
        phase_correlate_stack_traced)
    from astroburst_tpu.imaging.stf import apply_stf_traced, auto_stf_traced
    from astroburst_tpu.ops.ipc import frame_preview_host, nearest_downsample
    from astroburst_tpu.ops.stats import stats_core
    from astroburst_tpu.parallel.pipeline import align_stack_stretch
    from astroburst_tpu.stacking.combine import shift_clip

    log(f"devices: {jax.devices()} card: {info['card']}")
    log("generating frames…")
    frames = make_frames(N_FRAMES, H, W)
    h2d_ms = median_ms(lambda: jax.device_put(frames), runs=3)
    stack = jax.device_put(frames)
    jax.block_until_ready(stack)

    fn = jax.jit(lambda s: align_stack_stretch(
        s, sigma_low=3.0, sigma_high=3.0, max_iter=5, align=True))
    t0 = time.perf_counter()
    compiled = fn.lower(stack).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(stack)
    jax.block_until_ready(out)
    log(f"compile: {compile_s:.1f}s")
    log(f"offsets: {np.asarray(out['offsets'])[:4].tolist()}")
    log(f"rejected: {int(out['rejected'])}, stf: {np.asarray(out['stf'])}")

    total_ms = median_ms(lambda: compiled(stack))
    mpx_s = N_FRAMES * H * W / 1e6 / (total_ms / 1e3)

    # stage split: each stage jitted on its own, on the real inputs
    dys, dxs = out["offsets"][:, 0], out["offsets"][:, 1]
    combined = out["combined"]
    align = jax.jit(lambda s: phase_correlate_stack_traced(s[0], s[1:]))
    clip = jax.jit(lambda s, a, b: shift_clip(s, a, b, 3.0, 3.0, 5))

    @jax.jit
    def stats_stf(c):
        mn, mx, _t, count, med, mad = stats_core(c, False)
        sh, mt = auto_stf_traced(mn, mx, med,
                                 jnp.maximum(mad * 1.4826, 1e-30), count)
        return apply_stf_traced(c, mn, mx, sh, mt, as_u8=True)

    stage_ms = {
        "align": median_ms(lambda: align(stack)),
        "shift_clip": median_ms(lambda: clip(stack, dys, dxs)),
        "stats_stf": median_ms(lambda: stats_stf(combined)),
        "fused_total": total_ms,
    }
    log(f"stage split: {stage_ms}")

    # device-side STF preview: 2048² NN downsample + apply + u8 on a
    # 4096² plane (the slider path). Downsample first, in f32 —
    # pointwise STF commutes with subsampling.
    plane = jnp.pad(combined[:4096, :2048], ((0, 0), (0, 2048)),
                    mode="reflect")

    @jax.jit
    def render(x, sh, mt):
        small = nearest_downsample(x, 2048)
        return apply_stf_traced(small, jnp.float32(0.0),
                                jnp.float32(4000.0), sh, mt, as_u8=True)

    stf_device_ms = median_ms(
        lambda: render(plane, jnp.float32(0.01), jnp.float32(0.3)))

    # host-side binary preview framing (ops/ipc.py) on the fetched
    # 2048² downsample: (header, zero-copy pixel view), the
    # reference's clean path (infra/ipc.rs:63-73)
    small_host = np.ascontiguousarray(
        np.asarray(nearest_downsample(combined, 2048)), dtype="<f4")
    smn, smx = float(small_host.min()), float(small_host.max())
    t0 = time.perf_counter()
    for _ in range(50):
        frame_preview_host(small_host, smn, smx)
    ipc_encode_ms = (time.perf_counter() - t0) / 50 * 1e3

    log("ingest decode bench…")
    ingest_gb_s, ingest_cores = bench_ingest_decode()
    log(f"ingest decode: {ingest_gb_s:.2f} GB/s on {ingest_cores} core(s)")

    # per-op table, one line per row (bench_ops.py); skippable via
    # ASTROBURST_BENCH_HEADLINE_ONLY=1 for quick runs. A failing row
    # fails the run.
    if os.environ.get("ASTROBURST_BENCH_HEADLINE_ONLY", "0") != "1":
        import bench_ops
        bench_ops.run_all(info, lambda name, r: print(
            json.dumps({"op": name, **r}), flush=True))

    print(json.dumps({
        "metric": "align+stack+stretch megapixels/sec/card "
                  f"({N_FRAMES}x{H}x{W} f32, 5 clip iters)",
        "value": mpx_s,
        "unit": "Mpx/s",
        "vs_baseline": mpx_s / BASELINE_MPX_S,
        "total_ms": total_ms,
        "compile_s": compile_s,
        "h2d_ms": h2d_ms,
        "stage_ms": stage_ms,
        "stf_device_ms": stf_device_ms,
        "ipc_encode_ms": ipc_encode_ms,
        "ingest_decode_gb_s": ingest_gb_s,
        "ingest_cores": ingest_cores,
        "peak_bytes_in_use": jax.devices()[0].memory_stats().get(
            "peak_bytes_in_use"),
        **info,
    }))


if __name__ == "__main__":
    main()
