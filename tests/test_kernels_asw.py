"""The Triton aggregation kernel (kernels/asw_aggregation.py) against the
plain ops reference, in interpret mode on the CPU; the kernel choice
(kernels.on_gpu); and, where a GPU is present, the compiled kernel."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stereo_matchin_tpu import kernels, ops
from stereo_matchin_tpu.parallel import ops_tiled

GC, GP = 30.91, 28.21


def _strips(seed, R, H, W):
    r = np.random.default_rng(seed)
    imgs = [jnp.asarray(r.random((H, W, 3), dtype=np.float32))
            for _ in range(2)]
    return [ops.support_weights(img, R, GC, GP, axis=a)
            for a in (0, 1) for img in imgs]          # wv_l wv_r wh_l wh_r


def _cost(seed, D, H, W):
    r = np.random.default_rng(seed + 1)
    return jnp.asarray(r.uniform(0, 300, (D, H, W)).astype(np.float32))


def _shifted_right(w_right, D, d0):
    """w_right[t, y, max(x - (d0 + d), 0)] as the reference builds it."""
    return jnp.stack([ops.stack_shift_x(w_right[t], D, d0=d0)
                      for t in range(w_right.shape[0])])


def _ref_pass(cost, wl, wr, axis, R, d0=0, eps=1e-5):
    """ops.asw_aggregate_pass with the right strip shifted by d0 + d."""
    if d0 == 0:
        return ops.asw_aggregate_pass(cost, wl, wr, axis=axis, radius=R,
                                      eps=eps)
    D = cost.shape[0]
    wr_d = _shifted_right(wr, D, d0)                  # (T, D, H, W)
    num = jnp.full_like(cost, eps)
    den = jnp.full_like(cost, eps)
    for t in range(wl.shape[0]):
        ww = wl[t][None] * wr_d[t]
        num = num + ww * ops.shift_axis(cost, t - R, axis=axis)
        den = den + ww
    return num / den, den


# axis x radius x planes x odd shapes x plane offset.
CASES = [
    (axis, R, D, H, W, d0)
    for axis in (1, 2)
    for (R, D, H, W, d0) in [
        (1, 3, 5, 7, 0),
        (2, 9, 13, 21, 0),
        (3, 6, 11, 130, 0),       # > one 128-column tile
        (4, 17, 9, 37, 0),        # D not a multiple of the plane block
        (2, 5, 17, 19, 7),        # d0 offset (disp-sharded layout)
        (3, 11, 10, 29, 40),      # d0 beyond the width: clamped column 0
    ]
]


@pytest.mark.parametrize("axis,R,D,H,W,d0", CASES,
                         ids=lambda v: str(v))
def test_pass_matches_ops(axis, R, D, H, W, d0):
    wv_l, wv_r, wh_l, wh_r = _strips(R * 31 + W, R, H, W)
    wl, wr = (wv_l, wv_r) if axis == 1 else (wh_l, wh_r)
    cost = _cost(D + H, D, H, W)
    want, want_den = _ref_pass(cost, wl, wr, axis, R, d0)
    den = kernels.asw_den(wl, wr, D, R, d0=d0, interpret=True)
    got = kernels.asw_pass(cost, wl, wr, den, axis, R, d0=d0,
                           interpret=True)
    assert den.shape == got.shape == kernels.tile_padded((D, H, W))
    np.testing.assert_allclose(np.asarray(den[:D, :H, :W]),
                               np.asarray(want_den), rtol=2e-7)
    np.testing.assert_allclose(np.asarray(got[:D, :H, :W]),
                               np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("d0", [0, 4], ids=["d0=0", "d0=4"])
def test_vertical_pass_row_halo_matches_tiled(d0):
    """row_halo: the vertical pass reads a cost tile carrying R exchanged
    rows on each side — the row-sharded layout of ops_tiled."""
    R, D, H, W = 2, 6, 9, 23
    wv_l, wv_r, _, _ = _strips(5, R, H, W)
    cost_pad = _cost(3, D, H + 2 * R, W)
    want, _ = ops_tiled.asw_vpass_tiled(cost_pad, wv_l, wv_r, d0, D, R)
    den = kernels.asw_den(wv_l, wv_r, D, R, d0=d0, interpret=True)
    got = kernels.asw_pass(cost_pad, wv_l, wv_r, den, 1, R, d0=d0,
                           row_halo=R, interpret=True)
    np.testing.assert_allclose(np.asarray(got[:D, :H, :W]),
                               np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7, 12, 20), (13, 9, 140)],
                         ids=lambda s: "x".join(map(str, s)))
def test_aggregate_matches_ops(shape):
    """r_iters passes on the tile-padded carry, cropped at the end."""
    D, H, W = shape
    R = 2
    strips = _strips(D, R, H, W)
    cost = _cost(W, D, H, W)
    want = ops.asw_aggregate(cost, *strips, R, 3)
    got = kernels.asw_aggregate(cost, *strips, R, 3, interpret=True)
    assert got.shape == cost.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_pass_rejects_bad_arguments():
    wv_l, wv_r, _, _ = _strips(0, 1, 4, 8)
    cost = _cost(0, 2, 4, 8)
    den = kernels.asw_den(wv_l, wv_r, 2, 1, interpret=True)
    with pytest.raises(ValueError, match="axis"):
        kernels.asw_pass(cost, wv_l, wv_r, den, 0, 1, interpret=True)
    with pytest.raises(ValueError, match="row_halo"):
        kernels.asw_pass(cost, wv_l, wv_r, den, 2, 1, row_halo=1,
                         interpret=True)


def test_compiled_kernel_raises_off_gpu():
    """Without interpret mode the kernel compiles for the GPU only; on the
    CPU it raises instead of silently interpreting."""
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    wv_l, wv_r, _, _ = _strips(0, 1, 4, 8)
    with pytest.raises(Exception, match="interpret"):
        kernels.asw_den(wv_l, wv_r, 2, 1)


def _choice(cost, *strips):
    return kernels.on_gpu(
        cost, *strips,
        gpu=lambda *v: kernels.asw_aggregate(*v, 1, 1),
        default=lambda *v: ops.asw_aggregate(*v, 1, 1))


def test_choice_takes_plain_path_on_cpu():
    strips = _strips(1, 1, 6, 10)
    cost = _cost(1, 3, 6, 10)
    got = jax.jit(_choice)(cost, *strips)
    want = ops.asw_aggregate(cost, *strips, 1, 1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("platform,triton", [("cuda", True), ("cpu", False)])
def test_choice_lowers_kernel_for_cuda_only(platform, triton):
    """The choice is made at lowering: a CUDA lowering holds the Triton
    call and none of the plain path; any other lowering the reverse."""
    strips = _strips(2, 1, 6, 10)
    cost = _cost(2, 3, 6, 10)
    text = jax.jit(_choice).trace(cost, *strips).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("__gpu$xla.gpu.triton" in text) == triton
    assert ("stablehlo.divide" in text) == (not triton)


@pytest.mark.gpu
def test_compiled_kernel_matches_ops(gpu):
    """On a GPU: the compiled kernel against ops.asw_aggregate at a
    tsukuba-like width, both on the card."""
    D, H, W, R = 61, 64, 384, 16
    strips = _strips(3, R, H, W)
    cost = _cost(3, D, H, W)
    want = jax.jit(lambda c, *s: ops.asw_aggregate(c, *s, R, 2))(cost,
                                                                 *strips)
    got = jax.jit(lambda c, *s: kernels.asw_aggregate(c, *s, R, 2))(cost,
                                                                    *strips)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)
