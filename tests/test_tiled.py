"""Banded-vs-full equality for the big-image tiling driver."""

import numpy as np
import pytest

import jax.numpy as jnp

from stereo_matchin_tpu import StereoConfig
from stereo_matchin_tpu.models import asw, cross_based
from stereo_matchin_tpu.models.tiled import (asw_pipeline_tiled,
                                             cross_pipeline_tiled)

CFG = StereoConfig(d_max=7, radius=2, arm_len=3, r_iters=2, k_iters=2)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(21)
    left = (rng.integers(0, 256, (96, 40, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -2, axis=1)
    noise = rng.integers(-10, 11, right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(
        np.float32)
    return jnp.asarray(left), jnp.asarray(right)


@pytest.mark.parametrize("bands", [2, 3, 4, 5, 7])
def test_asw_tiled_matches_full(pair, bands):
    left, right = pair
    full = asw.asw_pipeline(left, right, CFG)
    disp, filled = asw_pipeline_tiled(left, right, CFG, num_bands=bands)
    np.testing.assert_array_equal(np.asarray(disp), np.asarray(full.disparity))
    np.testing.assert_array_equal(np.asarray(filled), np.asarray(full.filled))


@pytest.mark.parametrize("bands", [2, 3, 4, 6])
def test_cross_tiled_matches_full(pair, bands):
    left, right = pair
    # The tiled driver forces the translation-invariant taps OII impl;
    # compare against the full-image run with the same impl (the prefix
    # impl differs from taps only at float argmin ties).
    cfg = CFG.replace(oii_impl="taps")
    full = cross_based.cross_pipeline(left, right, cfg)
    initial, final = cross_pipeline_tiled(left, right, cfg, num_bands=bands)
    np.testing.assert_array_equal(np.asarray(initial),
                                  np.asarray(full.initial))
    np.testing.assert_array_equal(np.asarray(final), np.asarray(full.final))


def test_auto_bands_matches_measured_boundary():
    """The memory-fit estimate against the measured plan: a BASELINE
    config-3 frame (1988x2880, 280 disparities) fits whole in the 63.8 GB
    an H100 process may allocate (its band program planned 5.03 volumes
    per row); a quarter of that memory needs bands, each carrying
    2 * asw_reach halo rows; the standard pairs never need banding."""
    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.models.tiled import asw_reach, auto_bands

    h100 = 63_763_120_128
    c3 = REFERENCE_CONFIG.replace(d_max=279)
    assert auto_bands((1988, 2880, 3), c3, memory_bytes=h100) == 1
    quarter = auto_bands((1988, 2880, 3), c3, memory_bytes=h100 // 4)
    assert quarter > 1
    per_row = 5.1 * 280 * 2880 * 4
    rows_fit = int(0.85 * (h100 // 4) / per_row)
    assert -(-1988 // quarter) + 2 * asw_reach(c3) <= rows_fit
    assert auto_bands((288, 384, 3), REFERENCE_CONFIG, memory_bytes=h100) == 1
    assert auto_bands((375, 450, 3), REFERENCE_CONFIG, memory_bytes=h100) == 1
    # Monotone in every workload dimension.
    assert auto_bands((3976, 2880, 3), c3, memory_bytes=h100) >= 2
    assert auto_bands((1988, 5760, 3), c3, memory_bytes=h100 // 2) >= quarter


def test_auto_bands_rejects_memory_below_the_halo():
    """A budget that cannot hold even the 2 * asw_reach halo rows of one
    band raises instead of planning bands that cannot fit."""
    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.models.tiled import auto_bands

    with pytest.raises(ValueError, match="halo"):
        auto_bands((1988, 2880, 3), REFERENCE_CONFIG.replace(d_max=279),
                   memory_bytes=1 << 30)


def test_device_memory_bytes_reads_the_device_limit():
    """The budget comes from the device's own memory_stats()["bytes_limit"];
    a device that reports none (the CPU) raises rather than assuming a
    size."""
    from stereo_matchin_tpu.models.tiled import device_memory_bytes

    class Dev:
        platform = "gpu"

        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    assert device_memory_bytes(Dev({"bytes_limit": 123})) == 123
    with pytest.raises(ValueError, match="memory limit"):
        device_memory_bytes(Dev(None))
