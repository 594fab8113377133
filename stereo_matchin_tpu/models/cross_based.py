"""Cross-based OII stereo pipeline (Zhang/Lu/Lafruit 2009), end to end.

Reference driver: `stereo_matching/main.cpp:219-411` — the kernel chain
Median(L,R) -> Cross(L,R) -> Aggregation -> Integral_h -> Oii_hcross ->
Integral_v -> Oii_vcross -> Init_disparity -> Disparity(vote) -> Median.

Here the whole chain is ONE jitted function: XLA program order replaces the
reference's OpenCL event DAG (SURVEY.md §3.2), and the per-(row,disparity)
sequential integral kernels become `cumsum` scans.  All stage outputs the
reference persists (initial map, voted+median final map, median-filtered
left image) are returned so golden tests can pin each artifact.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax

from .. import ops
from ..config import StereoConfig


class CrossResult(NamedTuple):
    initial: jax.Array       # (H, W) stored image value in [0,1]  (cross_based_initial.png)
    final: jax.Array         # (H, W) stored image value in [0,1]  (cross_based_disparity.png)
    median_left: jax.Array   # (H, W, 3) median-filtered left      (median.png)


def cross_pipeline_impl(left: jax.Array, right: jax.Array,
                        cfg: StereoConfig) -> CrossResult:
    """left/right: (H, W, 3) float32 in [0,1] on the UNORM8 grid."""
    ml = ops.median3x3(left)
    mr = ops.median3x3(right)
    if cfg.median_dispatch_quirk:
        # The reference's truncated Median dispatch leaves the bottom
        # H mod 3 rows (and right W mod 3 columns) of the uninitialized
        # median images unwritten — zero on the golden device
        # (main.cpp:193,245-246; ops/median.py docstring).
        ml = ops.median_dispatch_truncate(ml)
        mr = ops.median_dispatch_truncate(mr)
    arms_l = ops.cross_arms(ml, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk)
    arms_r = ops.cross_arms(mr, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk)
    cost = ops.sad_cost_volume(ml, mr, cfg.num_disp)                # [0,1] scale
    aggr = ops.cross_aggregate(cost, arms_l, arms_r, arm_len=cfg.arm_len,
                               impl=cfg.oii_impl)
    d0 = ops.wta_argmin(aggr)                                       # (H, W)
    initial = ops.disparity_to_image(d0, cfg.d_max, cfg.quantize_maps)  # UNORM8 image round-trip
    voted = ops.histogram_vote(initial, arms_l, cfg.d_max,
                               quantize=cfg.quantize_maps,
                               arm_len=cfg.arm_len, impl=cfg.oii_impl)
    final = ops.median3x3(voted)
    if cfg.median_dispatch_quirk:
        # The final cross median (main.cpp:354) runs on the same
        # truncated globalSize into another uninitialized image.
        final = ops.median_dispatch_truncate(final)
    return CrossResult(initial=initial, final=final, median_left=ml)


def cross_aggregated_cost(left, right, cfg: StereoConfig) -> jax.Array:
    """The (D, H, W) aggregated cost volume the initial WTA takes the
    argmin of (median -> arms -> SAD -> OII), for tie adjudication."""
    ml, mr = ops.median3x3(left), ops.median3x3(right)
    arms = [ops.cross_arms(m, cfg.arm_len, cfg.tau,
                           cfg.legacy_cross_arm_quirk) for m in (ml, mr)]
    return ops.cross_aggregate(ops.sad_cost_volume(ml, mr, cfg.num_disp),
                               *arms, arm_len=cfg.arm_len, impl=cfg.oii_impl)


@partial(jax.jit, static_argnums=2)
def cross_pipeline_fused(left, right, cfg: StereoConfig) -> CrossResult:
    """Whole chain in one XLA program."""
    return cross_pipeline_impl(left, right, cfg)


# --- staged variant -----------------------------------------------------
# One jit per stage, for the per-stage benchmark harness
# (bench/harness.py), which times each stage separately to fill the
# reference's TSV columns.  cross_pipeline runs the fused program.

@partial(jax.jit, static_argnums=(1, 2, 3))
def _arms_stage(img, arm_len, tau, quirk):
    return ops.cross_arms(img, arm_len, tau, quirk)


@partial(jax.jit, static_argnums=2)
def _sad_stage(ml, mr, num_disp):
    return ops.sad_cost_volume(ml, mr, num_disp)


@partial(jax.jit, static_argnums=(3, 4))
def _aggr_stage(cost, arms_l, arms_r, arm_len, impl):
    return ops.cross_aggregate(cost, arms_l, arms_r, arm_len=arm_len,
                               impl=impl)


@partial(jax.jit, static_argnums=(1, 2))
def _init_stage(aggr, d_max, quantize):
    return ops.disparity_to_image(ops.wta_argmin(aggr), d_max, quantize)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _vote_stage(initial, arms_l, d_max, quantize, arm_len, impl):
    voted = ops.histogram_vote(initial, arms_l, d_max, quantize=quantize,
                               arm_len=arm_len, impl=impl)
    return ops.median3x3(voted)


_median_stage = jax.jit(ops.median3x3)
_trunc_stage = jax.jit(ops.median_dispatch_truncate)


def cross_pipeline_staged(left, right, cfg: StereoConfig) -> CrossResult:
    ml = _median_stage(left)
    mr = _median_stage(right)
    if cfg.median_dispatch_quirk:
        ml, mr = _trunc_stage(ml), _trunc_stage(mr)
    arms_l = _arms_stage(ml, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk)
    arms_r = _arms_stage(mr, cfg.arm_len, cfg.tau, cfg.legacy_cross_arm_quirk)
    cost = _sad_stage(ml, mr, cfg.num_disp)
    aggr = _aggr_stage(cost, arms_l, arms_r, cfg.arm_len,
                       cfg.oii_impl)
    initial = _init_stage(aggr, cfg.d_max, cfg.quantize_maps)
    final = _vote_stage(initial, arms_l, cfg.d_max, cfg.quantize_maps,
                        cfg.arm_len, cfg.oii_impl)
    if cfg.median_dispatch_quirk:
        final = _trunc_stage(final)
    return CrossResult(initial=initial, final=final, median_left=ml)


def cross_pipeline(left, right, cfg: StereoConfig) -> CrossResult:
    """Entry point: the fused single-program path (see note above)."""
    return cross_pipeline_fused(left, right, cfg)
