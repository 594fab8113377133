"""Device-mesh construction for the sharded stereo pipelines.

The reference has no multi-device story (SURVEY.md §2.3: devices are
benchmarked serially, one context each, `main.cpp:158-172`).  This
design scales along three orthogonal axes:

  batch — data parallelism over independent stereo pairs (frames);
  row   — spatial tiling of image height with ring halo exchange
          (the sequence-parallel analogue for the 33-tap support windows
          and cross arms);
  disp  — disparity-axis sharding of the cost volume with a two-min
          argmin reduction at WTA (the tensor-parallel analogue).

Collectives ride the mesh axes: `ppermute` for halos on `row`,
`all_gather` of per-shard two-min summaries on `disp`.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from ..config import MeshConfig

AXIS_BATCH = "batch"
AXIS_ROW = "row"
AXIS_DISP = "disp"


def build_mesh(cfg: MeshConfig, devices=None) -> Mesh:
    """Arrange `cfg.num_devices` devices as (batch, row, disp).

    The cards of one host reach each other all to all at one rate
    (NVLink), so the layout follows the algorithm alone: devices are
    taken in order, disp innermost.
    """
    if devices is None:
        devices = jax.devices()
    n = cfg.num_devices
    if len(devices) < n:
        raise ValueError(
            f"mesh {cfg} needs {n} devices, have {len(devices)}"
        )
    arr = np.asarray(devices[:n]).reshape(cfg.batch, cfg.row, cfg.disp)
    return Mesh(arr, (AXIS_BATCH, AXIS_ROW, AXIS_DISP))
