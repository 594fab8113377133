"""Sharded-vs-single-device equality tests on the virtual 8-CPU mesh.

SURVEY.md §4's strategy: tiling + halo logic is validated by tiled-vs-
untiled equality against the jitted single-device pipeline.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stereo_matchin_tpu import MeshConfig, StereoConfig
from stereo_matchin_tpu.models import asw
from stereo_matchin_tpu.parallel import build_mesh, make_asw_sharded

CFG = StereoConfig(d_max=10, radius=3, arm_len=4, r_iters=2, k_iters=2)
H, W, B = 24, 20, 2


@pytest.fixture(scope="module")
def pair(request):
    rng = np.random.default_rng(7)
    left = (rng.integers(0, 256, (B, H, W, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -3, axis=2)
    noise = rng.integers(-10, 11, right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(
        np.float32)
    return jnp.asarray(left), jnp.asarray(right)


@pytest.fixture(scope="module")
def reference(pair):
    left, right = pair
    ref = jax.vmap(lambda l, r: asw.asw_pipeline(l, r, CFG))(left, right)
    return jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize(
    "mesh_cfg",
    [
        MeshConfig(batch=1, row=4, disp=1),
        MeshConfig(batch=2, row=1, disp=1),
        MeshConfig(batch=1, row=1, disp=4),
        MeshConfig(batch=2, row=2, disp=2),
        MeshConfig(batch=1, row=2, disp=4),
        MeshConfig(batch=1, row=2, disp=1),
        MeshConfig(batch=2, row=1, disp=2),
        MeshConfig(batch=1, row=1, disp=8),
    ],
    ids=lambda m: f"b{m.batch}r{m.row}d{m.disp}",
)
def test_sharded_asw_matches_single_device(pair, reference, mesh_cfg):
    left, right = pair
    mesh = build_mesh(mesh_cfg)
    f = make_asw_sharded(CFG, mesh)
    got = jax.tree.map(np.asarray, f(left, right))

    np.testing.assert_array_equal(got.wta_left, reference.wta_left)
    np.testing.assert_array_equal(got.wta_right, reference.wta_right)
    np.testing.assert_array_equal(got.filled, reference.filled)
    np.testing.assert_array_equal(got.disparity, reference.disparity)
    np.testing.assert_array_equal(got.consistency_pre,
                                  reference.consistency_pre)
    np.testing.assert_array_equal(got.consistency_post,
                                  reference.consistency_post)


def test_stopwatch_and_device_sync():
    import jax.numpy as jnp

    from stereo_matchin_tpu.utils import Stopwatch

    sw = Stopwatch()
    x = sw.timed("mul", lambda a: a * 2.0, jnp.ones((8, 8)))
    jax.block_until_ready(x)
    assert sw.ms["mul"] >= 0.0
    assert "mul" in sw.report()


def test_build_pod_mesh_virtual_devices():
    from stereo_matchin_tpu.parallel import build_pod_mesh

    mesh = build_pod_mesh(row=2, disp=2)
    assert mesh.devices.size == 8
    assert mesh.shape["batch"] == 2


def test_scaling_report(pair):
    import jax

    from stereo_matchin_tpu import MeshConfig, StereoConfig
    from stereo_matchin_tpu.parallel import (build_mesh, make_asw_sharded,
                                             scaling_report)

    left, right = pair
    mesh = build_mesh(MeshConfig(batch=2, row=2, disp=2))
    f = make_asw_sharded(CFG, mesh)
    rep = scaling_report(lambda l, r: f(l, r), left, right, mesh, runs=2)
    assert rep["devices"] == 8
    assert rep["mpix_s"] > 0


@pytest.mark.parametrize(
    "mesh_cfg",
    [
        MeshConfig(batch=1, row=4, disp=1),
        MeshConfig(batch=2, row=2, disp=2),
        MeshConfig(batch=1, row=2, disp=4),
        MeshConfig(batch=2, row=1, disp=1),
        MeshConfig(batch=1, row=1, disp=4),
        MeshConfig(batch=2, row=4, disp=1),
    ],
    ids=lambda m: f"cross-b{m.batch}r{m.row}d{m.disp}",
)
def test_sharded_cross_matches_single_device(pair, mesh_cfg):
    from stereo_matchin_tpu.models import cross_based
    from stereo_matchin_tpu.parallel.cross_sharded import make_cross_sharded

    left, right = pair
    cfg = CFG.replace(oii_impl="taps")
    ref = jax.vmap(lambda l, r: cross_based.cross_pipeline_fused(l, r, cfg))(
        left, right)
    mesh = build_mesh(mesh_cfg)
    f = make_cross_sharded(cfg, mesh)
    got = jax.tree.map(np.asarray, f(left, right))
    np.testing.assert_array_equal(got.initial, np.asarray(ref.initial))
    np.testing.assert_array_equal(got.final, np.asarray(ref.final))
    np.testing.assert_array_equal(got.median_left, np.asarray(ref.median_left))


def test_sharded_asw_local_halo_mode(pair, reference):
    """halo_mode="local" (the scaling diagnostic: edge pads instead of
    ppermute) runs the same compute with zero communication.  It must be
    exact on a 1-row-shard mesh (no seams to fake) and must DIFFER at
    multi-shard seams — proof it actually removed the exchange."""
    left, right = pair
    f1 = make_asw_sharded(CFG, build_mesh(MeshConfig(batch=2, row=1, disp=1)),
                          halo_mode="local")
    got1 = jax.tree.map(np.asarray, f1(left, right))
    np.testing.assert_array_equal(got1.disparity, reference.disparity)

    f4 = make_asw_sharded(CFG, build_mesh(MeshConfig(batch=1, row=4, disp=1)),
                          halo_mode="local")
    got4 = jax.tree.map(np.asarray, f4(left, right))
    assert not np.array_equal(got4.disparity, reference.disparity)
