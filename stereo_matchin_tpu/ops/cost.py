"""Raw matching-cost volume: RGB sum-of-absolute-differences.

Reference: kernels/aggregation.cl:3-22 (cross method, [0,1] scale, on the
median-filtered pair) and kernels/asw_aggr.cl:41-61 (ASW method, 0-255
scale, on the raw pair).  Both read the right pixel at (x-d, y) through a
clamp-to-edge sampler; cost layout is one (H, W) plane per disparity.
"""

from __future__ import annotations

import jax.numpy as jnp

from .common import stack_shift_x


def sad_cost_volume(left, right, num_disp: int, scale: float = 1.0):
    """left/right: (H, W, 3) floats in [0, 1]. Returns (D, H, W) costs.

    cost[d, y, x] = sum_c |scale*left[y, x, c] - scale*right[y, max(x-d, 0), c]|

    Channel at a time, each channel's shifted planes one gather; the
    channel sum order c0+c1+c2 matches the reference's .x+.y+.z.
    """
    l = jnp.moveaxis(left, -1, 0) * scale          # (3, H, W)
    r = jnp.moveaxis(right, -1, 0) * scale
    cost = None
    for c in range(3):
        planes = stack_shift_x(r[c], num_disp, x_axis=1)    # (D, H, W)
        term = jnp.abs(l[c][None] - planes)
        cost = term if cost is None else cost + term
    return cost
