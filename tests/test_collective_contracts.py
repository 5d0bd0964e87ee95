"""Collective contracts for every sharded path.

Each test compiles the sharded program on an 8-virtual-device CPU mesh
and asserts the HLO contains exactly the INTENDED collectives — and no
large all-gather / replicate-then-slice fallback. GSPMD may emit tiny
all-gathers/all-reduces for scalars and stats; the contract is about
plane-sized traffic, so assertions distinguish by element count
(BIG = anything the size of a shard or more).

The shapes are chosen so a full test plane (>= 64k elements) is far
above BIG while every legitimate scalar/stat collective stays far
below it. NOTE: shard_map-lowered HLO records PER-SHARD operand
shapes, so an intended a2a moving one shard shows ~plane/n_devices
elements (SHARD_BIG), while a replicate-then-slice fallback
materializes the GLOBAL plane (BIG) — the two thresholds differ.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from astroburst_tpu.parallel import make_mesh

BIG = 32768       # global-plane scale: planes here are >= 65536
# a TILED a2a's per-line operand is one peer-chunk of one shard —
# plane / n_devices² = 65536/64 — so the "intended collective exists"
# threshold sits at chunk scale while fallback detection stays at BIG
SHARD_BIG = 1024

_COLLECTIVES = ("all-gather", "all-to-all", "all-reduce",
                "collective-permute", "reduce-scatter")

_SHAPE_RE = re.compile(
    r"(?:f32|bf16|f64|s32|u32|s8|u8|pred)\[([0-9,]*)\]")


def collective_sizes(hlo: str) -> dict:
    """op name → list of max-operand element counts, one per HLO line
    mentioning that collective (async -start/-done forms included)."""
    found: dict = {}
    for line in hlo.splitlines():
        if "=" not in line:
            continue
        for op in _COLLECTIVES:
            if f"{op}(" in line or f"{op}-start(" in line:
                sizes = [int(np.prod([int(d) for d in dims.split(",")
                                      if d])) if dims else 1
                         for dims in _SHAPE_RE.findall(line)]
                found.setdefault(op, []).append(max(sizes) if sizes else 0)
    return found


def assert_no_big(coll: dict, op: str, context: str):
    big = [s for s in coll.get(op, []) if s > BIG]
    assert not big, f"{context}: unexpected large {op} ({big} elements)"


def has_big(coll: dict, op: str) -> bool:
    return any(s >= SHARD_BIG for s in coll.get(op, []))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


# --- 1. stacking pipeline: frames→rows a2a + halo permutes ------------------


def test_contract_sharded_shift_clip_a2a(rng):
    from astroburst_tpu.parallel.pipeline import sharded_shift_clip_a2a

    mesh = make_mesh(8, ("frames", "rows"), (4, 2))
    stack = jnp.asarray(rng.normal(100, 3, (8, 256, 256))
                        .astype(np.float32))
    sharded_in = jax.device_put(
        stack, NamedSharding(mesh, P("frames", None, None)))
    dys = jnp.asarray(rng.uniform(-3, 3, 8), jnp.float32)
    dxs = jnp.asarray(rng.uniform(-3, 3, 8), jnp.float32)
    fn = jax.jit(lambda s, a, b: sharded_shift_clip_a2a(
        mesh, s, a, b, "frames", "rows", 3.0, 3.0, 2, off_max=4,
        interpret=True))
    hlo = fn.lower(sharded_in, dys, dxs).compile().as_text()
    coll = collective_sizes(hlo)
    assert has_big(coll, "all-to-all"), "frames→rows reshard must be a2a"
    assert has_big(coll, "collective-permute"), "halo exchange missing"
    assert_no_big(coll, "all-gather", "shift_clip_a2a")


# --- 2. distributed FFT: two a2a transposes, nothing gathered ---------------


def test_contract_sharded_fft2(rng):
    from astroburst_tpu.parallel.fft import sharded_fft2

    mesh = make_mesh(8, ("rows",), (8,))
    xr = jnp.asarray(rng.normal(size=(512, 512)).astype(np.float32))
    xi = jnp.zeros((512, 512), jnp.float32)
    fn = jax.jit(lambda a, b: sharded_fft2(mesh, a, b))
    hlo = fn.lower(xr, xi).compile().as_text()
    coll = collective_sizes(hlo)
    assert has_big(coll, "all-to-all"), "fft row→col stage must be a2a"
    assert_no_big(coll, "all-gather", "sharded_fft2")


def test_contract_sharded_deconvolve(rng):
    from astroburst_tpu.parallel.fft import _deconvolve_jit

    mesh = make_mesh(8, ("rows",), (8,))
    # mirror sharded_deconvolve's sizing for a 256² image + 9² PSF:
    # fft_rows = nextpow2(264) = 512, fft_cols = max(512, 8·128) = 1024
    run = _deconvolve_jit(mesh, "rows", 256, 256, 512, 1024, 2, True)
    img_s = jax.ShapeDtypeStruct(
        (256, 256), jnp.float32,
        sharding=NamedSharding(mesh, P("rows", None)))
    spec_s = jax.ShapeDtypeStruct(
        (512, 1024), jnp.float32,
        sharding=NamedSharding(mesh, P(None, "rows")))
    scal = jax.ShapeDtypeStruct((), jnp.float32)
    hlo = run.lower(img_s, spec_s, spec_s, scal, scal).compile().as_text()
    coll = collective_sizes(hlo)
    assert has_big(coll, "all-to-all"), "RL FFT stages must ride a2a"
    assert_no_big(coll, "all-gather", "sharded_deconvolve")


# --- 3. drizzle: per-shard local compute, one scalar psum -------------------


def test_contract_sharded_drizzle(rng):
    from astroburst_tpu.dtypes import DrizzleKernel
    from astroburst_tpu.parallel.drizzle import sharded_drizzle

    mesh = make_mesh(8, ("rows",), (8,))
    stack = jnp.asarray(rng.normal(100, 3, (4, 256, 256))
                        .astype(np.float32))
    dys = jnp.asarray(rng.uniform(-1, 1, 4), jnp.float32)
    dxs = jnp.asarray(rng.uniform(-1, 1, 4), jnp.float32)
    fn = jax.jit(lambda s, a, b: sharded_drizzle(
        mesh, s, a, b, 2.0, 0.8, DrizzleKernel.SQUARE, 512, 512,
        3.0, 3.0, 2, band_rows=8))
    hlo = fn.lower(stack, dys, dxs).compile().as_text()
    coll = collective_sizes(hlo)
    # the input stack is deliberately replicated (every shard drizzles
    # its own output rows from all frames); outputs are row-sharded; the
    # only cross-shard value is the rejected-count psum
    assert coll.get("all-reduce"), "rejected psum missing"
    assert_no_big(coll, "all-gather", "sharded_drizzle")
    assert_no_big(coll, "all-to-all", "sharded_drizzle")


# --- 4. compose: reshard-free (stats psums only) ----------------------------


def test_contract_sharded_compose(rng):
    from astroburst_tpu.parallel.compose import make_sharded_compose

    mesh = make_mesh(8, ("rows",), (8,))
    compose = make_sharded_compose(mesh)
    chans = jnp.asarray(rng.normal(100, 10, (3, 256, 256))
                        .astype(np.float32))
    weights = jnp.asarray(np.eye(3), jnp.float32)
    wb = jnp.ones(3, jnp.float32)
    hlo = compose.lower(chans, weights, wb).compile().as_text()
    coll = collective_sizes(hlo)
    assert coll.get("all-reduce"), "stats psums missing"
    assert_no_big(coll, "all-gather", "sharded_compose")
    assert_no_big(coll, "all-to-all", "sharded_compose")
    assert_no_big(coll, "collective-permute", "sharded_compose")


# --- 5. warp: exactly one plane-sized a2a between the two passes ------------


def test_contract_sharded_warp(rng):
    import math

    from astroburst_tpu.alignment.affine import AffineTransform
    from astroburst_tpu.parallel.warp import make_sharded_warp

    mesh = make_mesh(8, ("rows",), (8,))
    th = math.radians(0.5)
    ct, st = math.cos(th), math.sin(th)
    t = AffineTransform(a=ct, b=-st, tx=2.0, c=st, d=ct, ty=-1.0)
    warp = make_sharded_warp(mesh, t, 512, 512)
    img = jnp.asarray(rng.normal(100, 5, (512, 512)).astype(np.float32))
    hlo = warp.lower(img).compile().as_text()
    coll = collective_sizes(hlo)
    assert has_big(coll, "all-to-all"), "cols→rows reshard must be a2a"
    assert_no_big(coll, "all-gather", "sharded_warp")


# --- 6. halo stencil: permutes only ------------------------------------------


def test_contract_sharded_atrous(rng):
    from astroburst_tpu.parallel.halo import sharded_atrous_smooth

    mesh = make_mesh(8, ("rows",), (8,))
    x = jnp.asarray(rng.normal(size=(512, 512)).astype(np.float32))
    fn = jax.jit(lambda a: sharded_atrous_smooth(a, mesh, "rows", step=2))
    hlo = fn.lower(x).compile().as_text()
    coll = collective_sizes(hlo)
    assert coll.get("collective-permute"), "halo exchange missing"
    assert_no_big(coll, "all-gather", "sharded_atrous")
    assert_no_big(coll, "all-to-all", "sharded_atrous")


# --- 7. cube collapses: all-reduce over frames, no gathers ------------------


def test_contract_sharded_cube_collapse(rng):
    from astroburst_tpu.parallel.cube import (shard_cube,
                                              sharded_collapse_mean)

    mesh = make_mesh(8, ("frames",), (8,))
    cube = jnp.asarray(rng.normal(100, 5, (16, 256, 256))
                       .astype(np.float32))
    sharded = shard_cube(cube, mesh, "frames")
    fn = jax.jit(lambda c: sharded_collapse_mean(c, mesh, "frames"))
    hlo = fn.lower(sharded).compile().as_text()
    coll = collective_sizes(hlo)
    assert coll.get("all-reduce") or coll.get("reduce-scatter"), \
        "frame-axis reduction collective missing"
    assert_no_big(coll, "all-gather", "sharded_collapse_mean")
