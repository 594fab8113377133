"""The vestigial non-separable 2-D ASW aggregation (design-history parity).

Reference: `kernels/asw_vcost.cl` / `kernels/asw_cost.cl` — the naive
O(T^2)-per-pixel aggregation the thesis author wrote first, created by the
host (main.cpp:232-233) but NEVER enqueued; it was superseded by the
separable v/h pass pair (SURVEY.md §2.2 "dead/vestigial kernels"; thesis
PDF p.17-18 discusses the separable approximation's accuracy tradeoff).
Ported for inventory completeness and as a quality-comparison tool; the
production path is ops.asw_aggregate / kernels.asw_aggregation.

Faithful to the .cl's idiosyncrasies (both files compute the same thing):
the vertical term sums the cost UNWEIGHTED and divides by T; the 2-D term
weights cost by ww_h*ww_v but normalises by sum(ww_h) alone; the result is
their sum.  Support strips and the disparity shift max(x-d, 0) match the
separable path.
"""

from __future__ import annotations

import jax.numpy as jnp

from .common import shift_axis
from .common import stack_shift_x


def asw_aggregate_2d(cost, wv_l, wv_r, wh_l, wh_r, radius: int):
    """cost: (D, H, W); w*: (T, H, W) support strips.  Returns (D, H, W).

    out[d,y,x] = (sum_i C[d, y+i, x]) / T
               + (sum_{i,j} wwv(i) * wwh(i,j) * C[d, y+i, x+j])
                 / (sum_{i,j} wwh(i,j))
    with clamp-to-edge neighbour reads and wwv/wwh the joint L*R weights
    (right strip read at max(x-d, 0)).
    """
    D = cost.shape[0]
    T = 2 * radius + 1
    wv_r_d = jnp.stack([stack_shift_x(wv_r[t], D) for t in range(T)])
    wh_r_d = jnp.stack([stack_shift_x(wh_r[t], D) for t in range(T)])

    num_v = jnp.zeros_like(cost)
    num_h = jnp.zeros_like(cost)
    den_h = jnp.zeros_like(cost)
    for i in range(T):
        c_row = shift_axis(cost, i - radius, axis=1)        # C[d, y+i, x]
        num_v = num_v + c_row
        wwv = wv_l[i][None] * wv_r_d[i]                      # (D, H, W)
        for j in range(T):
            # h supports read at the VISITED row y+i (asw_vcost.cl inner).
            whl_n = shift_axis(wh_l[j], i - radius, axis=0)[None]
            whr_n = shift_axis(wh_r_d[j], i - radius, axis=1)
            wwh = whl_n * whr_n
            c_2d = shift_axis(c_row, j - radius, axis=2)     # C[d, y+i, x+j]
            num_h = num_h + wwh * wwv * c_2d
            den_h = den_h + wwh
    return num_v / T + num_h / den_h
