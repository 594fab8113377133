"""Iterative ASW stereo pipeline (Kowalczuk/Psota/Pérez 2013), end to end.

Reference driver: `stereo_matching/main.cpp:412-758` — asw_Aggr ->
asw_{v,h}Support×2 -> r×[asw_vCostAggregation -> asw_hCostAggregation] ->
asw_WTA -> Constistency -> k×[asw_ref_v(L,R) -> asw_ref_h(L,R) ->
asw_WTA_REF -> Constistency] -> Median.

One jitted function; the r- and k-loops are `lax.scan`s over functional
state (SURVEY.md §7.2).  The aggregated cost volume is a loop constant of
the refinement scan, exactly as the reference re-reads `asw_cost_buffer[1]`
in every `asw_WTA_REF` launch.

Faithful dataflow details (main.cpp:531-614):
  * refinement reads the *occlusion-filled* image for the left view and the
    current right-WTA image for the right view, both through UNORM8 images;
  * `asw_WTA_REF` rewrites both WTA images and — bug, replicated behind
    `cfg.wta_ref_conf_bug` — overwrites the reference confidence with the
    target-view confidence while never writing the target buffer
    (asw_wta_ref.cl:63-66);
  * the support/refinement weights depend only on the raw input images, so
    they are hoisted out of both loops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .. import kernels, ops
from ..config import StereoConfig


def asw_support_weights(left, right, cfg: StereoConfig):
    """The four aggregation weight strips (wv_l, wv_r, wh_l, wh_r), each
    (T, H, W): vertical and horizontal taps of both views."""
    R = cfg.radius
    return tuple(ops.support_weights(img, R, cfg.gamma_c, cfg.gamma_p,
                                     axis=axis)
                 for axis, img in ((0, left), (0, right), (1, left),
                                   (1, right)))


def _aggregate(left, right, cfg: StereoConfig, crop: tuple):
    """SAD cost + r_iters aggregation passes; returns the (D, H', W)
    aggregated volume with `crop` rows already shed.  The Triton kernel
    runs on the GPU (kernels.on_gpu), ops.asw_aggregate elsewhere."""
    H = left.shape[0]
    c_top, c_bot = crop
    weights = asw_support_weights(left, right, cfg)
    cost0 = ops.sad_cost_volume(left, right, cfg.num_disp, scale=255.0)
    args = (cfg.radius, cfg.r_iters, cfg.eps)
    aggr = kernels.on_gpu(
        cost0, *weights,
        gpu=lambda *vols: kernels.asw_aggregate(*vols, *args),
        default=lambda *vols: ops.asw_aggregate(*vols, *args))
    if c_top or c_bot:
        aggr = lax.slice_in_dim(aggr, c_top, H - c_bot, axis=1)
    return aggr


class ASWResult(NamedTuple):
    disparity: jax.Array          # (H, W) [0,1] image — asw_disparity.png (median-filtered)
    filled: jax.Array             # (H, W) [0,1] image — occlusion-filled, pre-median
    consistency_pre: jax.Array    # (H, W, 3) red diagnostic after initial WTA
    consistency_post: jax.Array   # (H, W, 3) red diagnostic after last refinement
    wta_left: jax.Array           # (H, W) [0,1] initial left WTA image
    wta_right: jax.Array          # (H, W) [0,1] initial derived right WTA image
    aggregated_cost: jax.Array    # (D, H, W) final aggregated volume


def _to_image(d, cfg: StereoConfig):
    """Store an integer-valued [0, d_max] disparity as a [0,1] image value
    (UNORM8 grid) — division-free golden semantics (ops.common)."""
    return ops.disparity_to_image(d, cfg.d_max, cfg.quantize_maps)


def asw_pipeline_impl(left: jax.Array, right: jax.Array,
                      cfg: StereoConfig,
                      crop: tuple = (0, 0)) -> ASWResult:
    """left/right: (H, W, 3) float32 in [0,1] on the UNORM8 grid (raw pair —
    the ASW method never median-filters its inputs, main.cpp:463-484).

    crop=(top, bottom): drop that many rows right AFTER aggregation, for
    the band-tiled driver (models/tiled.py).  Aggregation consumes
    (r_iters + 1) * radius rows of band-halo validity; everything after it
    (WTA + k refinement passes + median) reaches only k*radius + 1 rows,
    so an interior band can shed reach - (k*radius + 1) halo rows per side
    once the aggregated volume exists — shrinking the aggregated volume,
    the WTA's volume-sized temporaries and all post-aggregation compute
    by the same fraction.  Rows within
    k*radius + 1 of a cropped edge see clamped refinement reads and may
    diverge from the full-image run; callers must crop those margin rows
    from the result (exactly the band driver's own influence-radius
    argument, applied mid-pipeline).  The refinement support weights are
    computed from the PRE-crop images: computed post-crop they would be
    wrong within radius of the cut, widening the contaminated margin past
    k*radius + 1 into the kept rows."""
    aggr = _aggregate(left, right, cfg, crop)
    return asw_postaggregate_impl(aggr, left, right, cfg, crop)


def asw_postaggregate_impl(aggr: jax.Array, left: jax.Array,
                           right: jax.Array, cfg: StereoConfig,
                           crop: tuple = (0, 0)) -> ASWResult:
    """Everything after aggregation: WTA -> consistency -> k refinement
    iterations -> median (main.cpp:516-614).  `aggr` is the (D, H', W)
    aggregated volume with `crop` rows already shed relative to the
    (H, W, 3) images."""
    R = cfg.radius
    c_top, c_bot = crop

    # Refinement support weights from the RAW images, refinement gammas —
    # computed before any crop (see docstring), cropped alongside it.
    rv_l, rh_l = ops.refinement_weights(left, R, cfg.ref_gamma_c, cfg.ref_gamma_p)
    rv_r, rh_r = ops.refinement_weights(right, R, cfg.ref_gamma_c, cfg.ref_gamma_p)

    if c_top or c_bot:
        hi = left.shape[0] - c_bot
        rv_l, rh_l, rv_r, rh_r = (
            jax.lax.slice_in_dim(w, c_top, hi, axis=1)
            for w in (rv_l, rh_l, rv_r, rh_r))

    res = ops.wta_fast(aggr, big=cfg.big)
    wta_left_img = _to_image(res.disp_ref, cfg)
    wta_right_img = _to_image(res.disp_target, cfg)

    # Consistency reads the images back *d_max (consist.cl:24-25).
    cons = ops.consistency(wta_left_img * cfg.d_max, wta_right_img * cfg.d_max,
                           res.conf_ref, res.conf_target)
    red_pre = ops.red_diagnostic(wta_left_img, cons.consistent)

    def body(state, _):
        filled_q, right_q, conf_ref, conf_tar = state
        val_l, den_l = ops.refine_view(rv_l, rh_l, filled_q, conf_ref, R, cfg.eps)
        val_r, den_r = ops.refine_view(rv_r, rh_r, right_q, conf_tar, R, cfg.eps)
        r = ops.wta_refined_fast(aggr, val_l, den_l, val_r, den_r,
                                 cfg.penalty, big=cfg.big)
        if cfg.wta_ref_conf_bug:
            # asw_wta_ref.cl:63-66: reference confidence gets the TARGET
            # confidence; the target buffer keeps its previous value.
            new_conf_ref, new_conf_tar = r.conf_target, conf_tar
        else:
            new_conf_ref, new_conf_tar = r.conf_ref, r.conf_target
        left_img = _to_image(r.disp_ref, cfg)
        left_q = left_img * cfg.d_max
        right_q_new = _to_image(r.disp_target, cfg) * cfg.d_max
        c = ops.consistency(left_q, right_q_new, new_conf_ref, new_conf_tar)
        red = ops.red_diagnostic(left_img, c.consistent)
        return (c.filled, right_q_new, c.conf_ref, c.conf_target), red

    init = (cons.filled, wta_right_img * cfg.d_max, cons.conf_ref,
            cons.conf_target)
    (filled_q, _, _, _), reds = jax.lax.scan(body, init, None,
                                             length=cfg.k_iters)
    red_post = reds[-1] if cfg.k_iters > 0 else red_pre

    filled_img = (ops.image_from_q(filled_q, cfg.d_max)
                  if cfg.quantize_maps else ops.to_unit(filled_q, cfg.d_max))
    disparity = ops.median3x3(filled_img)
    return ASWResult(
        disparity=disparity,
        filled=filled_img,
        consistency_pre=red_pre,
        consistency_post=red_post,
        wta_left=wta_left_img,
        wta_right=wta_right_img,
        aggregated_cost=aggr,
    )


@partial(jax.jit, static_argnums=(2, 3))
def asw_pipeline(left, right, cfg: StereoConfig,
                 crop: tuple = (0, 0)) -> ASWResult:
    return asw_pipeline_impl(left, right, cfg, crop)


class ASWDebug(NamedTuple):
    """Per-stage captures mirroring the reference debug build's dumps
    under `stereo_matching/sukub/` (SURVEY.md §4.2): WTA maps after every
    aggregation iteration (`aggregation/{reference,target}/aggregation_i`),
    after every refinement iteration (`refinement/.../refinement_i`), the
    raw-cost WTA (`asw_raw_d.png`) and consistency diagnostics."""
    raw_wta_left: jax.Array       # (H, W) [0,1] WTA on the raw cost volume
    raw_wta_right: jax.Array
    aggr_wta_left: jax.Array      # (r, H, W) WTA after each v+h pass
    aggr_wta_right: jax.Array
    refine_wta_left: jax.Array    # (k, H, W) WTA_REF after each iteration
    refine_wta_right: jax.Array
    consistency_red_pre: jax.Array    # (H, W, 3) after initial WTA
    refine_reds: jax.Array            # (k, H, W, 3) per refinement iter
    result: ASWResult


def asw_pipeline_debug_impl(left, right, cfg: StereoConfig) -> ASWDebug:
    """asw_pipeline_impl with per-iteration state captured via the scans'
    stacked outputs — the analogue of the reference debug build's
    per-iteration clEnqueueReadImage dumps.  Aggregation runs the plain
    ops passes (the per-iteration WTA needs every intermediate volume)."""
    R, D = cfg.radius, cfg.num_disp

    cost0 = ops.sad_cost_volume(left, right, D, scale=255.0)
    wv_l, wv_r, wh_l, wh_r = asw_support_weights(left, right, cfg)

    raw = ops.wta_fast(cost0, big=cfg.big)

    vpass = lambda c: ops.asw_aggregate_pass(c, wv_l, wv_r, axis=1,
                                             radius=R, eps=cfg.eps)[0]
    hpass = lambda c: ops.asw_aggregate_pass(c, wh_l, wh_r, axis=2,
                                             radius=R, eps=cfg.eps)[0]

    def rbody(c, _):
        c2 = hpass(vpass(c))
        r_ = ops.wta_fast(c2, big=cfg.big)
        return c2, (_to_image(r_.disp_ref, cfg), _to_image(r_.disp_target, cfg))

    aggr, (agg_l, agg_r) = jax.lax.scan(rbody, cost0, None,
                                        length=cfg.r_iters)

    res = ops.wta_fast(aggr, big=cfg.big)
    wta_left_img = _to_image(res.disp_ref, cfg)
    wta_right_img = _to_image(res.disp_target, cfg)
    cons = ops.consistency(wta_left_img * cfg.d_max,
                           wta_right_img * cfg.d_max,
                           res.conf_ref, res.conf_target)
    red_pre = ops.red_diagnostic(wta_left_img, cons.consistent)

    rv_l, rh_l = ops.refinement_weights(left, R, cfg.ref_gamma_c,
                                        cfg.ref_gamma_p)
    rv_r, rh_r = ops.refinement_weights(right, R, cfg.ref_gamma_c,
                                        cfg.ref_gamma_p)

    def kbody(state, _):
        filled_q, right_q, conf_ref, conf_tar = state
        val_l, den_l = ops.refine_view(rv_l, rh_l, filled_q, conf_ref, R,
                                       cfg.eps)
        val_r, den_r = ops.refine_view(rv_r, rh_r, right_q, conf_tar, R,
                                       cfg.eps)
        r = ops.wta_refined_fast(aggr, val_l, den_l, val_r, den_r,
                                 cfg.penalty, big=cfg.big)
        if cfg.wta_ref_conf_bug:
            new_conf_ref, new_conf_tar = r.conf_target, conf_tar
        else:
            new_conf_ref, new_conf_tar = r.conf_ref, r.conf_target
        left_img = _to_image(r.disp_ref, cfg)
        right_img = _to_image(r.disp_target, cfg)
        c = ops.consistency(left_img * cfg.d_max, right_img * cfg.d_max,
                            new_conf_ref, new_conf_tar)
        red = ops.red_diagnostic(left_img, c.consistent)
        new_state = (c.filled, right_img * cfg.d_max, c.conf_ref,
                     c.conf_target)
        return new_state, (left_img, right_img, red)

    init = (cons.filled, wta_right_img * cfg.d_max, cons.conf_ref,
            cons.conf_target)
    (filled_q, _, _, _), (ref_l, ref_r, reds) = jax.lax.scan(
        kbody, init, None, length=cfg.k_iters)

    filled_img = (ops.image_from_q(filled_q, cfg.d_max)
                  if cfg.quantize_maps else ops.to_unit(filled_q, cfg.d_max))
    disparity = ops.median3x3(filled_img)
    result = ASWResult(
        disparity=disparity, filled=filled_img, consistency_pre=red_pre,
        consistency_post=reds[-1] if cfg.k_iters > 0 else red_pre,
        wta_left=wta_left_img, wta_right=wta_right_img,
        aggregated_cost=aggr,
    )
    return ASWDebug(
        raw_wta_left=_to_image(raw.disp_ref, cfg),
        raw_wta_right=_to_image(raw.disp_target, cfg),
        aggr_wta_left=agg_l, aggr_wta_right=agg_r,
        refine_wta_left=ref_l, refine_wta_right=ref_r,
        consistency_red_pre=red_pre, refine_reds=reds, result=result,
    )


@partial(jax.jit, static_argnums=2)
def asw_pipeline_debug(left, right, cfg: StereoConfig) -> ASWDebug:
    return asw_pipeline_debug_impl(left, right, cfg)


@partial(jax.jit, static_argnums=2)
def asw_pipeline_batched(left, right, cfg: StereoConfig) -> ASWResult:
    """Batched over frames: (B, H, W, 3) pairs -> (B, ...) results.

    The video-stream configuration (BASELINE configs[4]) on one chip;
    combine with parallel.make_asw_sharded's batch axis across chips.

    Frames run one after another via lax.map, each through the
    single-frame program, so a batch needs one frame's working memory.
    """
    return jax.lax.map(lambda lr: asw_pipeline_impl(lr[0], lr[1], cfg),
                       (left, right))
