"""Row-sharded N-channel compose: blend → white balance → (linked) STF.

Reference semantics: ``compose/channel_blend.rs`` (Out_c = Σ_k W[k,c]·Ch_k),
``compose/white_balance.rs:3-20`` (stability-reference WB — the channel
with the lowest MAD/median anchors the gains), and
``compose/rgb.rs:209-322`` (pre-WB stats drive the WB selection, post-WB
stats drive the stretch; linked STF derives one (shadow, midtone) pair
from the merged plane but normalizes each channel by its OWN stats;
composite validity v ≤ 1e-7 → black).

Mapping: every stage is either elementwise (blend einsum, WB gains,
MTF) or a global reduction (histogram-refinement median/MAD in
``ops/stats.py``), so under a rows-sharded layout GSPMD only has to
insert psum-family collectives — there is no resharding anywhere and
therefore no replicate-then-slice risk (the sharded-pipeline
failure mode). One jit covers the whole compose; scalars never leave
the device between stages.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from astroburst_tpu.constants import MAD_TO_SIGMA
from astroburst_tpu.dtypes import AutoStfConfig
from astroburst_tpu.imaging.stf import apply_stf_traced, auto_stf_traced
from astroburst_tpu.ops.stats import stats_core


def _traced_wb_auto(meds: jax.Array, mads: jax.Array) -> jax.Array:
    """Traced stability-reference gains (white_balance.rs:3-20).

    meds/mads: [3]. Returns [3] factors with the reference channel at
    exactly 1.0. Branch order matches the host `select_wb_reference`:
    R wins ties, then B over G.
    """
    stab = jnp.where(meds > 1e-10,
                     mads / jnp.maximum(meds, 1e-30), jnp.inf)
    cond_r = (stab[0] <= stab[1]) & (stab[0] <= stab[2])
    ref_idx = jnp.where(cond_r, 0, jnp.where(stab[2] <= stab[1], 2, 1))
    m = jnp.maximum(meds[ref_idx], 1e-10)
    factors = m / jnp.maximum(meds, 1e-10)
    return jnp.where(jnp.arange(3) == ref_idx, 1.0, factors)


def make_sharded_compose(mesh: Mesh, rows_axis: str = "rows", *,
                         wb_mode: str = "auto", linked_stf: bool = True,
                         stf_config: AutoStfConfig = AutoStfConfig(),
                         exact_pair: bool = False):
    """jit the blend + WB + auto-STF compose over a rows-sharded mesh.

    Returns ``compose(channels, weights, wb_manual)``:
      channels  [C, H, W] f32 (already harmonized/aligned planes)
      weights   [C, 3] f32 blend matrix (channel_blend.rs:13-70)
      wb_manual [3] f32 gains, used only when wb_mode == "manual"
    → dict with rgb [3, H, W] f32 (stretched), preview [3, H, W] u8,
      stf [3, 2] (shadow, midtone per channel; identical rows when
      linked), wb [3] gains.

    `exact_pair` selects the exact even-count median averaging in the
    stats kernel (a second rank target through the same compare-count
    refinement — ~2× the rank passes; the single-rank histogram
    semantics is the reference's own >4 Mpx path and the scale
    default here).
    """
    if wb_mode not in ("auto", "manual", "none"):
        raise ValueError(f"wb_mode {wb_mode!r}")
    chan_spec = NamedSharding(mesh, P(None, rows_axis, None))

    def compose(channels: jax.Array, weights: jax.Array,
                wb_manual: jax.Array):
        channels = jax.lax.with_sharding_constraint(channels, chan_spec)
        rgb = jnp.einsum("chw,ck->khw", channels, weights,
                         precision=jax.lax.Precision.HIGHEST)
        rgb = jax.lax.with_sharding_constraint(rgb, chan_spec)

        def chan_stats(x):
            # flatten=False keeps the median's compare-count passes
            # row-sharded (the flat path would all-gather the plane)
            mn, mx, _total, count, med, mad = stats_core(x, exact_pair,
                                                         flatten=False)
            return mn, mx, count, med, mad

        if wb_mode == "auto":
            # pre-WB stats drive the reference-channel pick (rgb.rs:233)
            pre = [chan_stats(rgb[k]) for k in range(3)]
            meds = jnp.stack([s[3] for s in pre])
            mads = jnp.stack([s[4] for s in pre])
            wb = _traced_wb_auto(meds, mads)
        elif wb_mode == "manual":
            wb = wb_manual.astype(jnp.float32)
        else:
            wb = jnp.ones(3, jnp.float32)
        rgb = rgb * wb[:, None, None]

        # post-WB per-channel stats normalize the stretch (rgb.rs:246)
        post = [chan_stats(rgb[k]) for k in range(3)]
        if linked_stf:
            merged = (rgb[0] + rgb[1] + rgb[2]) * (1.0 / 3.0)
            mn, mx, count, med, mad = chan_stats(merged)
            sigma = jnp.maximum(mad * MAD_TO_SIGMA, 1e-30)
            shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count,
                                              stf_config.target_bg,
                                              stf_config.shadow_k)
            params = [(shadow, midtone)] * 3
        else:
            params = []
            for mn, mx, count, med, mad in post:
                sigma = jnp.maximum(mad * MAD_TO_SIGMA, 1e-30)
                params.append(auto_stf_traced(mn, mx, med, sigma, count,
                                              stf_config.target_bg,
                                              stf_config.shadow_k))

        # apply_stf_traced implements the composite validity rule
        # (rgb.rs:195-208) verbatim: validity_mask == isfinite & >1e-7
        out = jnp.stack([
            apply_stf_traced(rgb[k], post[k][0], post[k][1],
                             params[k][0], params[k][1])
            for k in range(3)])
        out = jax.lax.with_sharding_constraint(out, chan_spec)
        preview = jnp.clip(jnp.round(out * 255.0), 0.0, 255.0
                           ).astype(jnp.uint8)
        return {
            "rgb": out,
            "preview": preview,
            "stf": jnp.stack([jnp.stack(p) for p in params]),
            "wb": wb,
        }

    return jax.jit(compose)
