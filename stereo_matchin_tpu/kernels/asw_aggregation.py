"""ASW cost-aggregation passes as one Pallas kernel on the Triton route.

Semantics are those of `ops.asw_aggregate_pass` with the denominator
hoisted: for every (d, y, x) of the pass,

    ww(t)  = wL[t, y, x] * wR[t, y, max(x - (d0 + d), 0)]
    num    = eps + sum_t ww(t) * C[d, nb(t)]
    out    = num / den[d, y, x]

with nb(t) the clamped neighbour at offset t - R along the pass axis.
`den = eps + sum_t ww(t)` depends on the weights only, so it is computed
once per direction (the same kernel in `den` mode, same tap order) and
read by all r_iters passes of that direction.

Schedule, per program: one (BY, BX) tile of rows and columns and BD
disparity planes.  The taps run in an scf.for loop; inside it the left
weight strip is loaded once and shared by the BD planes, whose running
sums stay in registers.  Edge clamping is done on the load indices, so
no operand is padded or copied in XLA and every load is in bounds.  The
output is allocated at whole tiles, (D, H, W) rounded up to (BD, BY,
BX), so the store needs no mask; the next pass reads that padded volume
directly (its loads clamp to the real extent, which the weights' shape
gives) and `asw_aggregate` crops once at the end.  Everything is float32
and there is no dot, so TF32 never arises.

`d0` is the global index of local plane 0 (a traced scalar under
`shard_map`), and `row_halo` lets the vertical pass read a cost tile
that already carries `row_halo` exchanged rows above and below the
output rows — the row-sharded pipeline's layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile: BD planes x BY rows x BX columns per program.  Of the tiles
# measured on an H100 (PERF.md), 8 x 8 x 128 with 4 warps was fastest at
# KITTI geometry and within 15% of the best at tsukuba's.
_BD, _BY, _BX = 8, 8, 128
_NUM_WARPS, _NUM_STAGES = 4, 2


def _pass_kernel(d0_ref, *refs, mode: str, radius: int, eps: float,
                 row_halo: int, dims: tuple):
    """mode: "den" (eps + sum ww), "v" or "h" (weighted cost mean)."""
    if mode == "den":
        wl_ref, wr_ref, o_ref = refs
    else:
        c_ref, wl_ref, wr_ref, den_ref, o_ref = refs
    D, H, W, Hc = dims
    T = 2 * radius + 1
    bx, by, bd = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    xs = bx * _BX + jnp.arange(_BX, dtype=jnp.int32)
    ys = by * _BY + jnp.arange(_BY, dtype=jnp.int32)
    xc = jnp.minimum(xs, W - 1)[None, :]            # in-bounds columns
    yc = jnp.minimum(ys, H - 1)[:, None]            # in-bounds rows
    d0 = plgpu.load(d0_ref.at[0])
    planes = [jnp.minimum(bd * _BD + j, D - 1) for j in range(_BD)]
    # Right-weight column per plane: max(x - d_global, 0).
    wr_cols = [jnp.maximum(xc - (d0 + p), 0) for p in planes]

    def tap(t, accs):
        wl = plgpu.load(wl_ref.at[t, yc, xc])
        if mode == "v":
            rows = jnp.clip(yc + (row_halo + t - radius), 0, Hc - 1)
        elif mode == "h":
            cols = jnp.clip(xc + (t - radius), 0, W - 1)
        out = []
        for j, p in enumerate(planes):
            ww = wl * plgpu.load(wr_ref.at[t, yc, wr_cols[j]])
            if mode == "den":
                out.append(accs[j] + ww)
            elif mode == "v":
                out.append(accs[j] + ww * plgpu.load(c_ref.at[p, rows, xc]))
            else:
                out.append(accs[j] + ww * plgpu.load(c_ref.at[p, yc, cols]))
        return tuple(out)

    init = tuple(jnp.full((_BY, _BX), eps, jnp.float32) for _ in range(_BD))
    accs = lax.fori_loop(0, T, tap, init)
    for j, p in enumerate(planes):
        val = accs[j]
        if mode != "den":
            val = val / plgpu.load(den_ref.at[p, yc, xc])
        plgpu.store(o_ref.at[bd * _BD + j, pl.ds(by * _BY, _BY),
                             pl.ds(bx * _BX, _BX)], val)


def _call(mode, args, out_shape, radius, eps, row_halo, Hc, d0, interpret):
    D, H, W = out_shape
    kernel = functools.partial(_pass_kernel, mode=mode, radius=radius,
                               eps=float(eps), row_halo=row_halo,
                               dims=(D, H, W, Hc))
    grid = (pl.cdiv(W, _BX), pl.cdiv(H, _BY), pl.cdiv(D, _BD))
    padded = (grid[2] * _BD, grid[1] * _BY, grid[0] * _BX)
    d0_arr = jnp.reshape(jnp.asarray(d0, jnp.int32), (1,))
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(padded, jnp.float32),
        grid=grid,
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name=f"asw_{mode}pass" if mode != "den" else "asw_den",
    )(d0_arr, *args)


def tile_padded(shape) -> tuple:
    """(D, H, W) rounded up to whole tiles: the kernels' output shape."""
    D, H, W = shape
    return (-(-D // _BD) * _BD, -(-H // _BY) * _BY, -(-W // _BX) * _BX)


def asw_den(w_left, w_right, num_disp: int, radius: int, eps: float = 1e-5,
            d0=0, interpret: bool = False):
    """eps + sum_t wL[t] * wR_shifted[t] for planes d0 .. d0 + num_disp - 1.

    w_left/w_right: (T, H, W) strips -> (num_disp, H, W) rounded up to
    whole tiles."""
    _, H, W = w_left.shape
    return _call("den", (w_left, w_right), (num_disp, H, W), radius, eps,
                 0, H, d0, interpret)


def asw_pass(cost, w_left, w_right, den, axis: int, radius: int,
             eps: float = 1e-5, d0=0, row_halo: int = 0,
             num_disp: int | None = None, interpret: bool = False):
    """One aggregation pass along `axis` (1 vertical, 2 horizontal).

    w_left/w_right: (T, H, W) strips, whose shape gives the real extent;
    cost: (D, H + 2*row_halo, W) — row_halo only for the vertical pass —
    or a tile-padded output of this module, with num_disp = D given;
    den: `asw_den`'s output.  Returns the weighted means, (D, H, W)
    rounded up to whole tiles."""
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 or 2, got {axis}")
    if axis == 2 and row_halo:
        raise ValueError("row_halo applies to the vertical pass only")
    _, H, W = w_left.shape
    D = cost.shape[0] if num_disp is None else num_disp
    Hc = H + 2 * row_halo
    return _call("v" if axis == 1 else "h", (cost, w_left, w_right, den),
                 (D, H, W), radius, eps, row_halo, Hc, d0, interpret)


def asw_aggregate(cost, wv_left, wv_right, wh_left, wh_right, radius: int,
                  r_iters: int, eps: float = 1e-5, interpret: bool = False):
    """r_iters x (vertical -> horizontal), as ops.asw_aggregate.

    The volume stays tile-padded between passes (the padding is never
    read) and is cropped back to cost.shape once at the end."""
    D, H, W = cost.shape
    den_v = asw_den(wv_left, wv_right, D, radius, eps, interpret=interpret)
    den_h = asw_den(wh_left, wh_right, D, radius, eps, interpret=interpret)
    pass_ = functools.partial(asw_pass, radius=radius, eps=eps, num_disp=D,
                              interpret=interpret)

    def body(c, _):
        cv = pass_(c, wv_left, wv_right, den_v, 1)
        return pass_(cv, wh_left, wh_right, den_h, 2), None

    Dp, Hp, Wp = tile_padded(cost.shape)
    init = jnp.pad(cost, [(0, Dp - D), (0, Hp - H), (0, Wp - W)])
    out, _ = lax.scan(body, init, None, length=r_iters)
    return out[:D, :H, :W]
