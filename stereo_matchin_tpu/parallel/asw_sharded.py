"""Fully sharded iterative-ASW pipeline over a (batch, row, disp) mesh.

The scaling story for the flagship model (SURVEY.md §2.3):

  batch — each device group owns whole frames (data parallel);
  row   — image rows are tiled; every vertically-reaching stage exchanges
          a `radius`-row halo ring via `lax.ppermute` (one exchange per
          aggregation iteration, per refinement iteration, plus one for
          the final median) — the sequence-parallel analogue;
  disp  — cost-volume planes are sharded; WTA/WTA_REF reduce per-shard
          two-min summaries with `lax.all_gather` + tie-exact combines
          (parallel.wta_sharded) — the tensor-parallel analogue.

The disparity count is padded up to a multiple of the disp-axis size with
`big`-cost planes; `big` planes never win the sequential trackers, and the
pad planes are re-pinned to `big` after aggregation (weighted means of
`big` drift when support sums underflow eps).

Semantics match models.asw.asw_pipeline_impl exactly (tests pin
tiled-vs-untiled equality); only the schedule is distributed.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .. import kernels, ops
from ..config import StereoConfig
from .halo import exchange_halo
from .mesh import AXIS_BATCH, AXIS_DISP, AXIS_ROW
from . import ops_tiled
from .wta_sharded import wta_refined_sharded, wta_sharded


class ShardedASWResult(NamedTuple):
    disparity: jax.Array          # (B, H, W) [0,1] final median-filtered map
    filled: jax.Array             # (B, H, W) [0,1] occlusion-filled map
    consistency_pre: jax.Array    # (B, H, W, 3)
    consistency_post: jax.Array   # (B, H, W, 3)
    wta_left: jax.Array           # (B, H, W)
    wta_right: jax.Array          # (B, H, W)


def _to_image(d, cfg: StereoConfig):
    return ops.disparity_to_image(d, cfg.d_max, cfg.quantize_maps)


def _local_halo(x, halo: int, axis_name: str, axis: int = 0):
    """Edge-pad stand-in for exchange_halo — DIAGNOSTIC ONLY.

    Same shapes and same per-shard compute as the real exchange, but the
    halo rows are the shard's own replicated edges instead of the
    neighbour's data, so seam values are WRONG on multi-shard rows.
    Timing a pipeline built with halo_mode="local" against the real one
    isolates the communication + synchronisation share of the row axis
    (bench.py's weak-scaling comm-overhead line)."""
    if halo <= 0:
        return x, 0
    pad = [(0, 0)] * x.ndim
    pad[axis] = (halo, halo)
    return jnp.pad(x, pad, mode="edge"), halo


def _asw_tile(left, right, cfg: StereoConfig, d_local: int, d_pad: int,
              n_row: int, halo_mode: str = "exchange"):
    """Per-(row, disp)-shard ASW pipeline for one stereo pair.

    left/right: (H_loc, W, 3) local row strips (replicated over disp).
    Returns per-shard row strips of every output map.
    """
    exchange = exchange_halo if halo_mode == "exchange" else _local_halo
    R = cfg.radius
    H_loc, W = left.shape[0], left.shape[1]
    H_glob = H_loc * n_row
    row0 = (lax.axis_index(AXIS_ROW) * H_loc).astype(jnp.int32)
    d0 = (lax.axis_index(AXIS_DISP) * d_local).astype(jnp.int32)

    halo_img = max(R, 1)
    left_pad, _ = exchange(left, halo_img, AXIS_ROW)
    right_pad, _ = exchange(right, halo_img, AXIS_ROW)

    # Support strips (centre rows only; global-coordinate distance term).
    sw = partial(ops_tiled.support_weights_tiled, radius=R,
                 gamma_c=cfg.gamma_c, gamma_p=cfg.gamma_p)
    wv_l = sw(left_pad, axis=0, row_start=row0, h_global=H_glob, halo=halo_img)
    wv_r = sw(right_pad, axis=0, row_start=row0, h_global=H_glob, halo=halo_img)
    wh_l = sw(left, axis=1)
    wh_r = sw(right, axis=1)

    # Raw cost shard, pad planes pinned to `big`.
    cost0 = ops_tiled.sad_cost_volume_shard(left, right, d0, d_local,
                                            scale=255.0)
    pad_plane = (d0 + jnp.arange(d_local, dtype=jnp.int32)) > cfg.d_max
    pad_mask = pad_plane[:, None, None]
    cost0 = jnp.where(pad_mask, cfg.big, cost0)

    def kernel_scan(c):
        den_v = kernels.asw_den(wv_l, wv_r, d_local, R, cfg.eps, d0=d0)
        den_h = kernels.asw_den(wh_l, wh_r, d_local, R, cfg.eps, d0=d0)
        pass_ = partial(kernels.asw_pass, radius=R, eps=cfg.eps, d0=d0,
                        num_disp=d_local)

        def body(c, _):
            # The vertical pass reads the exchanged halo rows directly
            # (row_halo); outputs stay tile-padded until the crop.
            c_pad, _ = exchange(c, R, AXIS_ROW, axis=1)
            cv = pass_(c_pad, wv_l, wv_r, den_v, 1, row_halo=R)
            ch = pass_(cv, wh_l, wh_r, den_h, 2)
            return ch[:d_local, :H_loc, :W], None

        return lax.scan(body, c, None, length=cfg.r_iters)[0]

    def xla_scan(c):
        def body(c, _):
            c_pad, _ = exchange(c, R, AXIS_ROW, axis=1)
            cv, _den = ops_tiled.asw_vpass_tiled(c_pad, wv_l, wv_r, d0,
                                                 d_local, R, cfg.eps)
            ch, _ = ops_tiled.asw_hpass(cv, wh_l, wh_r, d0, d_local, R,
                                        cfg.eps)
            return ch, None

        return lax.scan(body, c, None, length=cfg.r_iters)[0]

    aggr = kernels.on_gpu(cost0, gpu=kernel_scan, default=xla_scan)
    aggr = jnp.where(pad_mask, cfg.big, aggr)

    res = wta_sharded(aggr, d0, d_local, d_pad, AXIS_DISP, big=cfg.big)
    wta_left_img = _to_image(res.disp_ref, cfg)
    wta_right_img = _to_image(res.disp_target, cfg)
    cons = ops.consistency(wta_left_img * cfg.d_max, wta_right_img * cfg.d_max,
                           res.conf_ref, res.conf_target)
    red_pre = ops.red_diagnostic(wta_left_img, cons.consistent)

    rsw = partial(ops_tiled.support_weights_tiled, radius=R,
                  gamma_c=cfg.ref_gamma_c, gamma_p=cfg.ref_gamma_p)
    rv_l = rsw(left_pad, axis=0, row_start=row0, h_global=H_glob, halo=halo_img)
    rv_r = rsw(right_pad, axis=0, row_start=row0, h_global=H_glob, halo=halo_img)
    rh_l = rsw(left, axis=1)
    rh_r = rsw(right, axis=1)

    def ref_body(state, _):
        filled_q, right_q, conf_ref, conf_tar = state
        # One ppermute for all four same-shape maps (stacked on a leading
        # axis) instead of four: the exchanged bytes are identical but
        # latency-bound rings pay per collective, and the row-axis
        # ablation (halo_mode="local") measured the exchange at ~20% of
        # the row-sharded runtime with most of it in the k-loop's four
        # per-iteration exchanges.
        stacked = jnp.stack([filled_q, right_q, conf_ref, conf_tar])
        st_pad, _ = exchange(stacked, R, AXIS_ROW, axis=1)
        fq_pad, rq_pad, cr_pad, ct_pad = (st_pad[i] for i in range(4))
        vv_l, dv_l = ops_tiled.refine_vpass_tiled(rv_l, fq_pad, cr_pad, R,
                                                  cfg.eps)
        val_l, den_l = ops.refine_pass_h(rh_l, vv_l, dv_l, conf_ref, R, cfg.eps)
        vv_r, dv_r = ops_tiled.refine_vpass_tiled(rv_r, rq_pad, ct_pad, R,
                                                  cfg.eps)
        val_r, den_r = ops.refine_pass_h(rh_r, vv_r, dv_r, conf_tar, R, cfg.eps)
        r = wta_refined_sharded(aggr, d0, d_local, d_pad, AXIS_DISP,
                                val_l, den_l, val_r, den_r, cfg.penalty,
                                big=cfg.big)
        if cfg.wta_ref_conf_bug:
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
    (filled_q, _, _, _), reds = lax.scan(ref_body, init, None,
                                         length=cfg.k_iters)
    red_post = reds[-1] if cfg.k_iters > 0 else red_pre

    filled_img = (ops.image_from_q(filled_q, cfg.d_max)
                  if cfg.quantize_maps else ops.to_unit(filled_q, cfg.d_max))
    fi_pad, _ = exchange(filled_img, 1, AXIS_ROW)
    disparity = ops_tiled.median3x3_tiled(fi_pad)
    return ShardedASWResult(
        disparity=disparity,
        filled=filled_img,
        consistency_pre=red_pre,
        consistency_post=red_post,
        wta_left=wta_left_img,
        wta_right=wta_right_img,
    )


def make_asw_sharded(cfg: StereoConfig, mesh: Mesh,
                     halo_mode: str = "exchange"):
    """Build the jitted sharded ASW pipeline over `mesh`.

    Returns f(left, right) for global (B, H, W, 3) arrays with
    B % mesh.batch == 0 and H % mesh.row == 0.  Output maps are
    (B, H, W[, 3]) sharded over (batch, row).

    halo_mode: "exchange" (default) ppermutes real neighbour halos;
    "local" edge-pads instead — same compute, NO communication, wrong
    seam values — for isolating the row axis's comm share in scaling
    diagnostics (see _local_halo).
    """
    n_row = mesh.shape[AXIS_ROW]
    n_disp = mesh.shape[AXIS_DISP]
    d_pad = math.ceil(cfg.num_disp / n_disp) * n_disp
    d_local = d_pad // n_disp

    def local_fn(left, right):  # (B_loc, H_loc, W, 3)
        tile = partial(_asw_tile, cfg=cfg, d_local=d_local, d_pad=d_pad,
                       n_row=n_row, halo_mode=halo_mode)
        return jax.vmap(tile)(left, right)

    img_spec = P(AXIS_BATCH, AXIS_ROW, None, None)
    map_spec = P(AXIS_BATCH, AXIS_ROW, None)
    rgb_spec = P(AXIS_BATCH, AXIS_ROW, None, None)
    out_specs = ShardedASWResult(
        disparity=map_spec, filled=map_spec,
        consistency_pre=rgb_spec, consistency_post=rgb_spec,
        wta_left=map_spec, wta_right=map_spec,
    )
    f = jax.shard_map(local_fn, mesh=mesh, in_specs=(img_spec, img_spec),
                      out_specs=out_specs, check_vma=False)
    return jax.jit(f)
