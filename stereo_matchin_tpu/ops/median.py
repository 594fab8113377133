"""3x3 median filter (clamp-to-edge), per channel.

The reference implements the McGuire–Whitson sorting network
(kernels/median.cl:783-861) on float4 pixels; OpenCL min/max on float4
is componentwise, so the result equals an independent per-channel 3x3
median, which is what we compute here (exactly, via a length-9 sort).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# The classic 19-exchange 9-element median selection network (Smith 1996 /
# the standard 3x3 median-filter network): after these ordered min/max
# exchanges, slot 4 holds the median.  Equivalent to sort-then-take-middle
# for every input, and compiles in milliseconds where a variadic sort
# can take minutes.
_MED9_NET = [
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8),
    (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
    (4, 2),
]


def median3x3(img):
    """img: (H, W) or (H, W, C) float. Returns same shape.

    Channels-first internally, one edge pad, nine static slices,
    min/max selection network (no sort).
    """
    chan = img.ndim == 3
    x = jnp.moveaxis(img, -1, 0) if chan else img[None]   # (C, H, W)
    H, W = x.shape[1], x.shape[2]
    ext = jnp.pad(x, [(0, 0), (1, 1), (1, 1)], mode="edge")
    taps = [
        jax.lax.slice(ext, (0, dy, dx), (x.shape[0], dy + H, dx + W))
        for dy in (0, 1, 2)
        for dx in (0, 1, 2)
    ]
    for i, j in _MED9_NET:
        taps[i], taps[j] = jnp.minimum(taps[i], taps[j]), jnp.maximum(
            taps[i], taps[j])
    med = taps[4]                                          # (C, H, W)
    return jnp.moveaxis(med, 0, -1) if chan else med[0]


def median_dispatch_truncate(out):
    """Zero the rows/columns the reference's Median dispatches never write.

    main.cpp:193 builds the median work-group count with INTEGER division
    inside ceil() — floor — so globalSize = (3*(W//3), 3*(H//3)) and the
    bottom H mod 3 rows / right W mod 3 columns of the Median kernels'
    UNINITIALIZED output images (main.cpp:245-246, 255) are never
    written; they read back as zero on the golden-producing device.
    Gated by StereoConfig.median_dispatch_quirk; a shape-level no-op when
    both dimensions divide by 3 (every reference pair except art).
    """
    H, W = out.shape[0], out.shape[1]
    Hq, Wq = (H // 3) * 3, (W // 3) * 3
    if Hq == H and Wq == W:
        return out
    row_ok = jnp.arange(H) < Hq
    col_ok = jnp.arange(W) < Wq
    keep = row_ok[:, None] & col_ok[None, :]
    return jnp.where(keep[(...,) + (None,) * (out.ndim - 2)], out, 0.0)
