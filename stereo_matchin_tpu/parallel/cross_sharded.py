"""Sharded cross-based pipeline over the (batch, row, disp) mesh.

Same scaling story as asw_sharded: frames over `batch`, image rows over
`row` with ppermute halo exchange, cost-volume planes over `disp`.  The
taps OII/vote implementations are translation-invariant, so the tiled
pipeline is bit-identical to the single-device `cross_pipeline` with
`oii_impl="taps"` (pinned by tests).

Vertical reaches served by the halo: cross arms walk to distance
arm_len+1; the OII vertical window and the vote's vertical taps reach
arm_len; everything else is row-local.  One image halo of arm_len+1
covers arm construction AND provides the rows whose *horizontal* arms the
vote re-reads (h arms are row-local in the image).

Global-coordinate subtleties (all pinned by the equality tests):
  * the arm walk's in-bounds test uses GLOBAL row indices — a padded
    tile's replicated halo must not look "in bounds" at the true border;
  * the OII taps mask drops global row/column 0 (the reference's
    max(0, i-1) prefix quirk) — evaluated in global coordinates;
  * the vote clamp RE-COUNTS the border row — the replicated halo rows of
    the border shard reproduce that exactly, no mask needed.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .. import ops
from ..config import StereoConfig
from ..ops.common import stack_shift_x
from ..ops.vote import _clamped_window_taps
from .halo import exchange_halo
from .mesh import AXIS_BATCH, AXIS_DISP, AXIS_ROW
from .ops_tiled import median3x3_tiled, sad_cost_volume_shard


class ShardedCrossResult(NamedTuple):
    initial: jax.Array       # (B, H, W) [0,1]
    final: jax.Array         # (B, H, W) [0,1]
    median_left: jax.Array   # (B, H, W, 3)


def _cross_arms_tiled(img_padded, halo: int, row_start, h_global: int,
                      arm_len: int, tau: float, legacy_quirk: bool):
    """ops.cross_arms for every PADDED row of a tile, with the in-bounds
    test in global coordinates.  Returns (4, H_pad, W) int32."""
    Hp, W = img_padded.shape[0], img_padded.shape[1]
    p = jnp.moveaxis(img_padded, -1, 0)
    M = arm_len + 1
    ext = jnp.pad(p, [(0, 0), (M, M), (M, M)], mode="edge")
    # Global row index of each padded-tile row, CLAMPED at the frame
    # borders: a border shard's halo rows are edge replicas of the border
    # row, and the vote samples the arms image with the same
    # CLAMP_TO_EDGE as the disparity map (disparity.cl; oracle reads
    # arms_l[·, clamp(y+i), x]) — so those rows must carry the border
    # row's arms, not a virtual row's collapsed walk.  Round-4 fix: the
    # unclamped index zeroed the ny in-bounds test for H arms on every
    # frame-border halo row, flipping vote modes on frame rows 0/H-1
    # (caught by the dryrun's new bit-equality assertion; same bug class
    # as the wavefront frame-bottom vote-arms fix).  Interior halos have
    # in-range indices — clamping is a no-op there.
    ys = jnp.clip(row_start - halo + jnp.arange(Hp, dtype=jnp.int32),
                  0, h_global - 1)[:, None]
    xs = jnp.arange(W, dtype=jnp.int32)[None, :]
    first_dist = 3 if legacy_quirk else 2
    dirs = ((0, -1), (0, 1), (-1, 0), (1, 0))

    def body(k, state):
        arm, alive = state
        dist = k + first_dist
        new_arm, new_alive = [], []
        for i, (dy, dx) in enumerate(dirs):
            nb = lax.dynamic_slice(ext, (0, M + dy * dist, M + dx * dist),
                                   (3, Hp, W))
            sim = jnp.all(jnp.abs(nb - p) < tau, axis=0)
            ny = ys + dy * dist
            nx = xs + dx * dist
            inb = ((ny >= 0) & (ny <= h_global - 1) &
                   (nx >= 0) & (nx <= W - 1))
            a = alive[i] & sim & inb
            new_alive.append(a)
            new_arm.append(arm[i] + a.astype(jnp.int32))
        return jnp.stack(new_arm), jnp.stack(new_alive)

    init = (jnp.ones((4, Hp, W), jnp.int32), jnp.ones((4, Hp, W), jnp.bool_))
    arm, _ = lax.fori_loop(0, arm_len - 1, body, init)
    sign = jnp.array([-1, 1, -1, 1], jnp.int32)[:, None, None]
    return sign * arm


def _oii_vtaps_tiled(temp_padded, minus, plus, arm_len: int, halo: int,
                     row_start, h_global: int):
    """Vertical taps pass of the OII mean over a row-padded volume, with
    the global-row validity mask (drop global row 0; stay <= H-1)."""
    Dl, Hp, W = temp_padded.shape
    H_loc = Hp - 2 * halo
    ys = (row_start + jnp.arange(H_loc, dtype=jnp.int32))[None, :, None]
    total = None
    for j in range(-arm_len, arm_len + 1):
        tap = lax.slice_in_dim(temp_padded, halo + j, halo + j + H_loc,
                               axis=1)
        r = ys + j
        m = (j >= minus) & (j <= plus) & (r >= 1) & (r <= h_global - 1)
        term = jnp.where(m, tap, 0.0)
        total = term if total is None else total + term
    delta = (plus - minus).astype(temp_padded.dtype)
    return total / delta


def _oii_htaps(cost, minus, plus, arm_len: int):
    """Horizontal taps pass (x untiled; same mask as ops.oii taps impl)."""
    Dl, H, W = cost.shape
    xs = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    ext = jnp.pad(cost, [(0, 0), (0, 0), (arm_len, arm_len)])
    total = None
    for j in range(-arm_len, arm_len + 1):
        tap = lax.slice_in_dim(ext, arm_len + j, arm_len + j + W, axis=2)
        c = xs + j
        m = (j >= minus) & (j <= plus) & (c >= 1) & (c <= W - 1)
        term = jnp.where(m, tap, 0.0)
        total = term if total is None else total + term
    delta = (plus - minus).astype(cost.dtype)
    return total / delta


def _vote_coltaps_tiled(row_counts_padded, vm, vp, arm_len: int, halo: int):
    """Vertical vote taps over a row-padded counts volume.  The reference
    CLAMPS row reads; border shards' replicated halo rows reproduce the
    re-count, so no mask beyond the arm bounds is needed."""
    Dl, Hp, W = row_counts_padded.shape
    H_loc = Hp - 2 * halo
    total = None
    for i in range(-arm_len, arm_len + 1):
        tap = lax.slice_in_dim(row_counts_padded, halo + i, halo + i + H_loc,
                               axis=1)
        term = jnp.where((i >= vm) & (i <= vp), tap, 0)
        total = term if total is None else total + term
    return total


def _argmin_disp_sharded(aggr, d0, axis_name):
    """Global argmin over disp shards, ties to the lowest global d."""
    c_loc = jnp.min(aggr, axis=0)
    d_loc = (d0 + jnp.argmin(aggr, axis=0)).astype(jnp.int32)
    cs = lax.all_gather(c_loc, axis_name)          # (n, H, W)
    dss = lax.all_gather(d_loc, axis_name)
    n = cs.shape[0]
    c, d = cs[0], dss[0]
    for s in range(1, n):                           # ascending d = tie order
        take = cs[s] < c
        c = jnp.where(take, cs[s], c)
        d = jnp.where(take, dss[s], d)
    return d


def _cross_tile(left, right, cfg: StereoConfig, d_local: int, n_row: int):
    """Per-(row, disp)-shard cross pipeline for one pair."""
    L = cfg.arm_len
    H_loc, W = left.shape[0], left.shape[1]
    H_glob = H_loc * n_row
    row0 = (lax.axis_index(AXIS_ROW) * H_loc).astype(jnp.int32)
    d0 = (lax.axis_index(AXIS_DISP) * d_local).astype(jnp.int32)
    halo = L + 1

    # Median-filtered pair on the padded tile (median reach 1 <= halo).
    lp, _ = exchange_halo(left, halo + 1, AXIS_ROW)
    rp, _ = exchange_halo(right, halo + 1, AXIS_ROW)
    ml_pad = ops.median3x3(lp)[1:-1]                 # (H_loc + 2*halo, W, 3)
    mr_pad = ops.median3x3(rp)[1:-1]
    ml = ml_pad[halo:halo + H_loc]

    arms_l_pad = _cross_arms_tiled(ml_pad, halo, row0, H_glob, L, cfg.tau,
                                   cfg.legacy_cross_arm_quirk)
    arms_r_pad = _cross_arms_tiled(mr_pad, halo, row0, H_glob, L, cfg.tau,
                                   cfg.legacy_cross_arm_quirk)
    arms_l = arms_l_pad[:, halo:halo + H_loc]
    arms_r = arms_r_pad[:, halo:halo + H_loc]

    # Cost shard over the PADDED rows (the OII vertical pass reads them).
    cost_pad = sad_cost_volume_shard(ml_pad, mr_pad, d0, d_local)
    pad_plane = (d0 + jnp.arange(d_local, dtype=jnp.int32)) > cfg.d_max
    pad_mask = pad_plane[:, None, None]
    cost_pad = jnp.where(pad_mask, cfg.big, cost_pad)

    # Combined arms per local plane (right arms at max(x - d, 0)).
    hm_pad = jnp.maximum(
        stack_shift_x(arms_r_pad[0], d_local, d0=d0),
        arms_l_pad[0][None])
    hp_pad = jnp.minimum(
        stack_shift_x(arms_r_pad[1], d_local, d0=d0),
        arms_l_pad[1][None])
    vm = jnp.maximum(
        stack_shift_x(arms_r[2], d_local, d0=d0),
        arms_l[2][None])
    vp = jnp.minimum(
        stack_shift_x(arms_r[3], d_local, d0=d0),
        arms_l[3][None])
    # Horizontal OII pass at every padded row, then the vertical pass with
    # centre-row arms and global-row masking.
    temp_pad = _oii_htaps(cost_pad, hm_pad, hp_pad, L)
    aggr = _oii_vtaps_tiled(temp_pad, vm, vp, L, halo, row0, H_glob)
    aggr = jnp.where(pad_mask, cfg.big, aggr)

    d_win = _argmin_disp_sharded(aggr, d0, AXIS_DISP)
    initial = ops.disparity_to_image(d_win, cfg.d_max, cfg.quantize_maps)

    # Vote: indicator over padded rows (halo of the initial map), per-row
    # horizontal counts with each padded row's own h arms, then vertical
    # taps with centre v arms.
    init_pad, _ = exchange_halo(initial, halo, AXIS_ROW)
    idx = ops.vote_indices(init_pad, cfg.d_max)
    ds = jnp.arange(cfg.num_disp, dtype=jnp.int32)[:, None, None]
    indicator = (idx[None] == ds).astype(jnp.int32)      # (D, H_pad, W)
    row_counts = _clamped_window_taps(indicator, arms_l_pad[0][None],
                                      arms_l_pad[1][None], L, axis=2)
    tab = _vote_coltaps_tiled(row_counts, arms_l[2][None], arms_l[3][None],
                              L, halo)
    mode = (cfg.num_disp - 1) - jnp.argmax(tab[::-1], axis=0).astype(
        jnp.int32)
    voted = ops.disparity_to_image(mode, cfg.d_max, cfg.quantize_maps)

    voted_pad, _ = exchange_halo(voted, 1, AXIS_ROW)
    final = median3x3_tiled(voted_pad)
    return ShardedCrossResult(initial=initial, final=final, median_left=ml)


def make_cross_sharded(cfg: StereoConfig, mesh: Mesh):
    """Jitted sharded cross pipeline: (B, H, W, 3) pairs -> row/batch-
    sharded maps.  Matches cross_pipeline with oii_impl='taps' bit-exactly
    (tests).  Note: the histogram vote runs with the full disparity count
    on every disp shard (its input is a map, not the cost volume)."""
    if cfg.median_dispatch_quirk:
        raise ValueError(
            "median_dispatch_quirk models the reference's truncated "
            "full-frame Median dispatches (golden comparisons only) and "
            "is not implemented by the sharded driver; use cross_pipeline")
    n_row = mesh.shape[AXIS_ROW]
    n_disp = mesh.shape[AXIS_DISP]
    d_pad = math.ceil(cfg.num_disp / n_disp) * n_disp
    d_local = d_pad // n_disp

    def local_fn(left, right):
        tile = partial(_cross_tile, cfg=cfg, d_local=d_local, n_row=n_row)
        return jax.vmap(tile)(left, right)

    img_spec = P(AXIS_BATCH, AXIS_ROW, None, None)
    out_specs = ShardedCrossResult(
        initial=P(AXIS_BATCH, AXIS_ROW, None),
        final=P(AXIS_BATCH, AXIS_ROW, None),
        median_left=img_spec,
    )
    f = jax.shard_map(local_fn, mesh=mesh, in_specs=(img_spec, img_spec),
                      out_specs=out_specs, check_vma=False)
    return jax.jit(f)
