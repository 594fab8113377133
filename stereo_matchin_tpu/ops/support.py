"""ASW support weights (Yoon–Kweon joint colour+proximity bilateral weights).

Reference: kernels/asw_vsupport.cl (`asw_vSupport`, gammas 30.91/28.21) and
kernels/asw_hsupport.cl (`asw_hSupport`).  One weight per (pixel, tap):

    w[t, y, x] = exp( -SAD255(p(y,x), p(nb)) / gamma_c  -  dist(p, nb) / gamma_p )

where nb is the clamped neighbour at offset t-R along the axis, SAD255 is
the RGB absolute-difference sum on the 0-255 scale, and dist is the
Euclidean distance to the *clamped* coordinate (so edge taps get smaller
spatial penalties, matching `distance((x,y),(x,clamped))`).

Refinement reuses the same form with gammas 10.94/118.78
(asw_refinement_v.cl supp_v / asw_refinement_h.cl supp_h).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _clamped_offset_distance(n: int, length: int, axis_coords):
    """|i - clamp(i + n, 0, length-1)| for each coordinate i along the axis."""
    clamped = jnp.clip(axis_coords + n, 0, length - 1)
    return jnp.abs(axis_coords - clamped).astype(jnp.float32)


def support_weights(img, radius: int, gamma_c: float, gamma_p: float, axis: int):
    """img: (H, W, 3) in [0,1].  axis=0 -> vertical taps, axis=1 -> horizontal.

    Returns (T, H, W) float32 with T = 2*radius + 1 taps ordered t=0..T-1
    (offset = t - radius), matching the reference's z-indexed support
    volumes (asw_vsupport.cl:396 layout).

    Computed channels-first with ONE edge pad + static slices (one pad
    for all taps rather than one per tap); values are identical.
    """
    p = jnp.moveaxis(img, -1, 0) * 255.0          # (3, H, W)
    n = p.shape[1 + axis]
    pad = [(0, 0)] * 3
    pad[1 + axis] = (radius, radius)
    ext = jnp.pad(p, pad, mode="edge")
    coords = jnp.arange(n, dtype=jnp.int32)
    weights = []
    for t in range(2 * radius + 1):
        off = t - radius
        q = jax.lax.slice_in_dim(ext, t, t + n, axis=1 + axis)
        c_diff = jnp.abs(p - q).sum(axis=0) / gamma_c
        dist = _clamped_offset_distance(off, n, coords) / gamma_p
        dist2d = dist[:, None] if axis == 0 else dist[None, :]
        weights.append(jnp.exp(-c_diff - dist2d))
    return jnp.stack(weights, axis=0)
