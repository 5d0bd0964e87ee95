"""One-pass shift+clip kernel parity (Pallas interpreter, CPU backend).

Oracle: shift_bicubic + sigma_clip_core, the XLA forms already
parity-tested against the reference semantics
(src-tauri/src/core/stacking/combine.rs:14-91, align.rs:36-57).
Borderline clip decisions may flip on the last f32 ulp when the
kernel's summation order differs from the oracle's — tolerated as a
bounded count of differing pixels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from astroburst_tpu.ops.resample import shift_bicubic
from astroburst_tpu.stacking import combine
from astroburst_tpu.stacking.combine import sigma_clip_core
from astroburst_tpu.stacking.onepass_kernel import (MAX_FRAMES, _clip_body,
                                                    _select_rank,
                                                    _shift_clip_call,
                                                    shift_clip_onepass)


def _stack(rng, n=6, h=130, w=170, nan_frac=0.02):
    s = rng.normal(100, 5, (n, h, w)).astype(np.float32)
    s[rng.random(s.shape) < nan_frac] = np.nan
    return s


def _oracle(s, dys, dxs, lo, hi, iters):
    shifted = jnp.stack([
        shift_bicubic(s[k], float(dys[k]), float(dxs[k]))
        for k in range(s.shape[0])])
    return jax.jit(lambda x: sigma_clip_core(x, lo, hi, iters))(shifted)


def _assert_close(got, ref, got_rej, ref_rej, max_flips=3):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    flips = int((d > 5e-3).sum())
    assert flips <= max_flips, f"{flips} pixels differ, max |d|={d.max()}"
    assert abs(int(got_rej) - int(ref_rej)) <= max_flips


def test_onepass_matches_shift_plus_clip(rng):
    s = jnp.asarray(_stack(rng))
    dys = rng.uniform(-12, 12, 6).astype(np.float32)
    dxs = rng.uniform(-12, 12, 6).astype(np.float32)
    ref, ref_rej = _oracle(s, dys, dxs, 2.5, 3.0, 5)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      2.5, 3.0, 5, interpret=True)
    _assert_close(got, ref, got_rej, ref_rej)


def test_onepass_zero_offsets_is_plain_clip(rng):
    s = jnp.asarray(_stack(rng, n=4, h=80, w=90, nan_frac=0.0))
    z = jnp.zeros(4, jnp.float32)
    ref, _ = jax.jit(lambda x: sigma_clip_core(x, 3.0, 3.0, 3))(s)
    got, _ = shift_clip_onepass(s, z, z, 3.0, 3.0, 3, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)


def test_onepass_extreme_offsets_at_clamp(rng):
    # every edge-replication path (top/bottom/left/right + corners)
    s = jnp.asarray(_stack(rng, n=4, h=200, w=300, nan_frac=0.0))
    dys = np.float32([0, 16, -16, 15])
    dxs = np.float32([0, -16, 16, -15])
    ref, ref_rej = _oracle(s, dys, dxs, 3.0, 3.0, 3)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      3.0, 3.0, 3, interpret=True)
    _assert_close(got, ref, got_rej, ref_rej)


def test_onepass_fractional_near_clamp(rng):
    s = jnp.asarray(_stack(rng, n=4, h=200, w=300, nan_frac=0.0))
    dys = np.float32([0, 15.75, -15.75, 0.5])
    dxs = np.float32([0, -15.3, 15.9, -0.25])
    ref, ref_rej = _oracle(s, dys, dxs, 3.0, 3.0, 3)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      3.0, 3.0, 3, interpret=True)
    _assert_close(got, ref, got_rej, ref_rej)


def test_onepass_offsets_beyond_image(rng):
    # no offset envelope: a frame shifted past the image contributes
    # zeros (outside-source), exactly like the unfused path
    s = jnp.asarray(_stack(rng, n=3, h=64, w=64, nan_frac=0.0))
    dys = np.float32([0, 500, -500])
    dxs = np.float32([0, 0, 3.5])
    ref, ref_rej = _oracle(s, dys, dxs, 3.0, 3.0, 2)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      3.0, 3.0, 2, interpret=True)
    _assert_close(got, ref, got_rej, ref_rej, max_flips=0)


def test_onepass_single_frame_identity(rng):
    s = jnp.asarray(_stack(rng, n=1, h=70, w=300, nan_frac=0.0))
    got, rej = shift_clip_onepass(s, jnp.zeros(1), jnp.zeros(1), 3.0, 3.0, 5,
                                  interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(s[0]), atol=1e-4)
    assert int(rej) == 0


def test_onepass_ragged_multiblock(rng):
    # h, w far from block multiples, > 1 block in each direction
    s = jnp.asarray(_stack(rng, n=5, h=131, w=515, nan_frac=0.0))
    dys = rng.uniform(-5, 5, 5).astype(np.float32)
    dxs = rng.uniform(-5, 5, 5).astype(np.float32)
    ref, ref_rej = _oracle(s, dys, dxs, 3.0, 3.0, 3)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      3.0, 3.0, 3, interpret=True)
    assert got.shape == (131, 515)
    _assert_close(got, ref, got_rej, ref_rej)


def test_onepass_tiny_image(rng):
    s = jnp.asarray(_stack(rng, n=3, h=40, w=90, nan_frac=0.0))
    dys = jnp.asarray([1.5, -2.0, 0.0], jnp.float32)
    dxs = jnp.asarray([0.5, 1.0, -1.5], jnp.float32)
    ref, ref_rej = _oracle(s, np.float32([1.5, -2, 0]),
                           np.float32([0.5, 1, -1.5]), 3.0, 3.0, 3)
    got, got_rej = shift_clip_onepass(s, dys, dxs, 3.0, 3.0, 3,
                                      interpret=True)
    _assert_close(got, ref, got_rej, ref_rej)


def test_onepass_nan_inf_matches_unfused(rng):
    """Dead/hot pixels (NaN, inf) flow through the one-pass kernel
    exactly like the unfused shift+clip path (combine.rs NaN-safety)."""
    s = rng.normal(100, 3, (4, 64, 64)).astype(np.float32)
    s[1, 20:23, 30:33] = np.nan
    s[3, 5, 5] = np.inf
    stack = jnp.asarray(s)
    dys = jnp.asarray([0.0, 1.5, -2.0, 0.5], jnp.float32)
    dxs = jnp.asarray([0.0, -0.5, 1.0, 2.5], jnp.float32)

    got, grej = shift_clip_onepass(stack, dys, dxs, 3.0, 3.0, 3,
                                   interpret=True)
    full = jax.vmap(shift_bicubic)(stack, dys, dxs)
    want, wrej = sigma_clip_core(full, 3.0, 3.0, 3)
    g, w = np.asarray(got), np.asarray(want)
    assert np.isnan(g).sum() == 0 and np.isnan(w).sum() == 0
    np.testing.assert_allclose(g, w, atol=2e-4)
    assert int(grej) == int(wrej)


def test_zero_shift_preserves_raw_pixels(rng):
    """The reference skips resampling at |shift| < 1e-12
    (align.rs:37-39): zero-shift frames contribute RAW pixels — dead
    pixels must not bleed NaN into their bicubic neighborhood, and the
    zero-shift stack must clip exactly like the unshifted stack."""
    s = rng.normal(100, 3, (4, 64, 64)).astype(np.float32)
    s[0, 40, 40] = np.nan  # dead pixel on the reference frame
    stack = jnp.asarray(s)
    z = jnp.zeros(4, jnp.float32)
    got, _ = shift_clip_onepass(stack, z, z, 3.0, 3.0, 3, interpret=True)
    want, _ = sigma_clip_core(stack, 3.0, 3.0, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-4)
    # shift_bicubic itself: zero shift == identity (even at NaN)
    sb = np.asarray(shift_bicubic(stack[0], jnp.float32(0.0),
                                  jnp.float32(0.0)))
    np.testing.assert_array_equal(np.isnan(sb), np.isnan(s[0]))
    m = ~np.isnan(s[0])
    np.testing.assert_array_equal(sb[m], s[0][m])


def test_runtime_zero_offset_on_non_reference_frame(rng):
    """A frame other than the reference whose measured offset is
    exactly zero also takes the raw-pixel path (align.rs:37-39): a dead
    pixel on a duplicate frame must not NaN-bleed."""
    s = rng.normal(100, 3, (4, 64, 64)).astype(np.float32)
    s[1, 40, 40] = np.nan  # dead pixel on a NON-reference frame
    stack = jnp.asarray(s)
    dys = jnp.asarray([0.0, 0.0, 0.5, 0.0], jnp.float32)
    dxs = jnp.asarray([0.0, 0.0, -0.25, 0.0], jnp.float32)
    got, _ = shift_clip_onepass(stack, dys, dxs, 3.0, 3.0, 3,
                                interpret=True)
    full = jax.vmap(shift_bicubic)(stack, dys, dxs)
    want, _ = sigma_clip_core(full, 3.0, 3.0, 3)
    g = np.asarray(got)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("n", [2, 5, 9])
def test_onepass_frame_counts_off_power_of_two(rng, n):
    # the kernel holds next_pow2(n) sample slots per pixel; the unused
    # slots must take no part in the clip
    s = jnp.asarray(_stack(rng, n=n, h=40, w=70, nan_frac=0.01))
    dys = rng.uniform(-3, 3, n).astype(np.float32)
    dxs = rng.uniform(-3, 3, n).astype(np.float32)
    ref, ref_rej = _oracle(s, dys, dxs, 3.0, 3.0, 4)
    got, got_rej = shift_clip_onepass(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      3.0, 3.0, 4, interpret=True)
    _assert_close(got, ref, got_rej, ref_rej)


@pytest.mark.parametrize("bh,bw,warps", [(1, 128, 4), (2, 64, 4),
                                         (4, 32, 4)])
def test_wide_short_block_geometries_match(rng, bh, bw, warps):
    """The block split never changes tap or clip semantics: every
    geometry is bit-exact with the default one."""
    s = jnp.asarray(_stack(rng, n=4, h=50, w=150, nan_frac=0.01))
    dys = jnp.asarray(rng.uniform(-6, 6, 4), jnp.float32)
    dxs = jnp.asarray(rng.uniform(-6, 6, 4), jnp.float32)
    ref, ref_rej = shift_clip_onepass(s, dys, dxs, 3.0, 3.0, 3,
                                      interpret=True)
    got, got_rej = _shift_clip_call(s, dys, dxs, jnp.int32(0), 3.0, 3.0,
                                    3, 0, 50, 50, True, block_h=bh,
                                    block_w=bw, num_warps=warps)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert int(got_rej) == int(ref_rej)


def test_onepass_rejects_more_frames_than_budget():
    s = jnp.zeros((MAX_FRAMES + 1, 8, 8), jnp.float32)
    z = jnp.zeros(MAX_FRAMES + 1, jnp.float32)
    with pytest.raises(ValueError, match="register"):
        shift_clip_onepass(s, z, z, interpret=True)


@pytest.mark.parametrize("case", ["ties", "inf_padding", "all_equal"])
def test_select_rank_matches_sort(rng, case):
    """The kernel's sort-free rank select returns what a sort along
    the frame axis puts at each rank."""
    vals = rng.normal(0, 1, (8, 33)).astype(np.float32)
    if case == "ties":
        vals = np.round(vals * 2) / 2
    elif case == "inf_padding":
        vals[rng.random(vals.shape) < 0.3] = np.inf
    else:
        vals[:] = 1.25
    srt = np.sort(vals, axis=0)
    for r in range(8):
        rank = np.full(33, r, np.float32)
        got = np.asarray(_select_rank(jnp.asarray(vals), jnp.asarray(rank)))
        np.testing.assert_array_equal(got, srt[r])


@pytest.mark.parametrize("max_iter", [1, 5])
def test_clip_body_matches_sigma_clip_core(rng, max_iter):
    """The kernel's per-pixel clip loop, evaluated as plain jnp on a
    [frames, pixels] block, against the XLA combine."""
    s = rng.normal(100, 5, (7, 24, 16)).astype(np.float32)
    s[rng.random(s.shape) < 0.05] = 4000.0
    s[rng.random(s.shape) < 0.05] = np.nan
    want, want_rej = sigma_clip_core(jnp.asarray(s), 2.5, 3.0, max_iter)
    # one "block" per row of the image
    got = []
    got_rej = 0
    for r in range(s.shape[1]):
        c, rej = _clip_body(jnp.asarray(s[:, r, :]), 2.5, 3.0, max_iter)
        got.append(np.asarray(c))
        got_rej += int(jnp.sum(rej))
    np.testing.assert_allclose(np.stack(got), np.asarray(want), atol=2e-4)
    assert got_rej == int(want_rej)


def test_shift_clip_takes_kernel_only_where_it_compiles(monkeypatch):
    """One entry for the api and the pipeline: the kernel where the
    Triton route compiles and the frames fit its budget, XLA otherwise.
    The CPU has no Triton compiler."""
    assert not combine.use_onepass_kernel(4)
    monkeypatch.setattr(combine, "triton_available", lambda: True)
    assert combine.use_onepass_kernel(4)
    assert combine.use_onepass_kernel(MAX_FRAMES)
    assert not combine.use_onepass_kernel(MAX_FRAMES + 1)


def test_shift_clip_xla_path_matches_oracle(rng):
    s = jnp.asarray(_stack(rng, n=5, h=48, w=60))
    dys = rng.uniform(-4, 4, 5).astype(np.float32)
    dxs = rng.uniform(-4, 4, 5).astype(np.float32)
    ref, ref_rej = _oracle(s, dys, dxs, 3.0, 3.0, 3)
    got, got_rej = combine.shift_clip(s, jnp.asarray(dys), jnp.asarray(dxs),
                                      3.0, 3.0, 3)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert int(got_rej) == int(ref_rej)
