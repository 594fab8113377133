"""Tile-aware op variants for the sharded pipelines.

These reproduce the exact semantics of `stereo_matchin_tpu.ops` when an
image is row-tiled across the `row` mesh axis (with halo padding from
`parallel.halo`) and/or the disparity axis is sharded across the `disp`
mesh axis (with traced global offsets from `lax.axis_index`).

Differences from the plain ops:
  * vertical neighbour reads become static slices into the halo-padded
    tile (no clamping — the padding already encodes global clamp-to-edge);
  * the support-weight distance term uses *global* row coordinates, so
    the reference's clamped-distance quirk lands on the global border,
    not the tile border;
  * disparity shifts `max(x - d, 0)` take a traced disparity offset
    (`d0 = disp_shard_index * d_local`) in the gather index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.common import stack_shift_x


def sad_cost_volume_shard(left, right, d0, n_local: int,
                          scale: float = 1.0):
    """Local disparity shard of the SAD cost volume (aggregation.cl /
    asw_aggr.cl semantics): (Dl, H, W) for global d in [d0, d0+Dl)."""
    right_planes = stack_shift_x(right, n_local, x_axis=1,
                                 d0=d0)                   # (Dl, H, W, 3)
    diff = jnp.abs(left[None] * scale - right_planes * scale)
    return diff.sum(axis=-1)


def support_weights_tiled(img_padded, radius: int, gamma_c: float,
                          gamma_p: float, axis: int, row_start=None,
                          h_global: int | None = None, halo: int = 0):
    """Support weights for the CENTRE rows of a halo-padded tile.

    img_padded: (H_loc + 2*halo, W, 3) for axis=0 tiles (halo >= radius), or
    (H_loc, W, 3) for the horizontal axis (x never tiled).  For axis=0 the
    spatial distance uses global coordinates (row_start = global index of
    the first centre row) so the reference's clamped-distance edge quirk
    applies at the global border (asw_vsupport.cl distance((x,y),(x,clamped))).
    Returns (T, H_loc, W).
    """
    Hp, W = img_padded.shape[0], img_padded.shape[1]
    H_loc = Hp - 2 * halo
    p255 = img_padded * 255.0
    center = lax.slice_in_dim(p255, halo, halo + H_loc, axis=0)
    weights = []
    for t in range(2 * radius + 1):
        off = t - radius
        if axis == 0:
            # Neighbour rows via static slice of the padded tile.
            q = lax.slice_in_dim(p255, halo + off, halo + off + H_loc, axis=0)
            coords = row_start + jnp.arange(H_loc, dtype=jnp.int32)
            clamped = jnp.clip(coords + off, 0, h_global - 1)
            dist = jnp.abs(coords - clamped).astype(jnp.float32)[:, None]
        else:
            # Horizontal: clamp inside the (untiled) row.
            shift = off
            padspec = [(0, 0)] * center.ndim
            padspec[1] = (max(-shift, 0), max(shift, 0))
            ext = jnp.pad(center, padspec, mode="edge")
            lo = shift + max(-shift, 0)
            q = lax.slice_in_dim(ext, lo, lo + W, axis=1)
            coords = jnp.arange(W, dtype=jnp.int32)
            clamped = jnp.clip(coords + off, 0, W - 1)
            dist = jnp.abs(coords - clamped).astype(jnp.float32)[None, :]
        c_diff = jnp.abs(center - q).sum(axis=-1) / gamma_c
        weights.append(jnp.exp(-c_diff - dist / gamma_p))
    return jnp.stack(weights, axis=0)


def asw_vpass_tiled(cost_padded, w_left, w_right, d0, n_local: int,
                    radius: int, eps: float = 1e-5):
    """Vertical ASW aggregation pass on a halo-padded cost tile.

    cost_padded: (Dl, H_loc + 2*radius, W); w_left/w_right: (T, H_loc, W)
    support strips.  The joint weight wL(p,t)*wR(p-d,t)
    (asw_vcost_aggregation.cl ww) is formed per tap with the traced
    disparity offset — the (T, Dl, H, W) tensor is never materialised.
    Returns (out, den) for the centre rows, each (Dl, H_loc, W).
    """
    Hp = cost_padded.shape[1]
    H_loc = Hp - 2 * radius
    shape = (cost_padded.shape[0], H_loc, cost_padded.shape[2])
    # Accumulate starting AT eps, in tap order, exactly like
    # ops.asw_aggregate_pass — keeps tiled vs untiled bit-identical.
    num = jnp.full(shape, eps, cost_padded.dtype)
    den = jnp.full(shape, eps, cost_padded.dtype)
    for t in range(2 * radius + 1):
        wr = stack_shift_x(w_right[t], n_local, d0=d0)          # (Dl, H, W)
        ww = w_left[t][None] * wr
        c_nb = lax.slice_in_dim(cost_padded, t, t + H_loc, axis=1)
        num = num + ww * c_nb
        den = den + ww
    return num / den, den


def asw_hpass(cost, w_left, w_right, d0, n_local: int, radius: int,
              eps: float = 1e-5):
    """Horizontal ASW aggregation pass (row-local; x clamp-to-edge)."""
    W = cost.shape[2]
    num = jnp.full(cost.shape, eps, cost.dtype)
    den = jnp.full(cost.shape, eps, cost.dtype)
    for t in range(2 * radius + 1):
        off = t - radius
        wr = stack_shift_x(w_right[t], n_local, d0=d0)
        ww = w_left[t][None] * wr
        padspec = [(0, 0), (0, 0), (max(-off, 0), max(off, 0))]
        ext = jnp.pad(cost, padspec, mode="edge")
        lo = off + max(-off, 0)
        c_nb = lax.slice_in_dim(ext, lo, lo + W, axis=2)
        num = num + ww * c_nb
        den = den + ww
    return num / den, den


def refine_vpass_tiled(w, d_padded, conf_padded, radius: int,
                       eps: float = 1e-5):
    """Vertical refinement pass on halo-padded disparity/confidence tiles.

    w: (T, H_loc, W) centre-row refinement weights; d_padded/conf_padded:
    (H_loc + 2*radius, W).  asw_refinement_v.cl semantics.
    """
    Hp = d_padded.shape[0]
    H_loc = Hp - 2 * radius
    num = jnp.full((H_loc, d_padded.shape[1]), eps, d_padded.dtype)
    den = jnp.full((H_loc, d_padded.shape[1]), eps, d_padded.dtype)
    for t in range(2 * radius + 1):
        F = lax.slice_in_dim(conf_padded, t, t + H_loc, axis=0)
        D = lax.slice_in_dim(d_padded, t, t + H_loc, axis=0)
        num = num + w[t] * F * D
        den = den + w[t] * F
    return num / den, den


def median3x3_tiled(img_padded):
    """3x3 median of the centre rows of a 1-row halo-padded tile."""
    H_loc = img_padded.shape[0] - 2
    W = img_padded.shape[1]
    taps = []
    for dy in (0, 1, 2):
        rows = lax.slice_in_dim(img_padded, dy, dy + H_loc, axis=0)
        for dx in (-1, 0, 1):
            padspec = [(0, 0)] * rows.ndim
            padspec[1] = (max(-dx, 0), max(dx, 0))
            ext = jnp.pad(rows, padspec, mode="edge")
            lo = dx + max(-dx, 0)
            taps.append(lax.slice_in_dim(ext, lo, lo + W, axis=1))
    return jnp.sort(jnp.stack(taps, axis=0), axis=0)[4]
