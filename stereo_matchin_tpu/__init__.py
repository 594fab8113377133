"""stereo_matchin_tpu — a dense stereo-matching engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
`manixq/stereo_matchin` OpenCL reference (see SURVEY.md): two complete local
stereo pipelines (Zhang/Lu/Lafruit cross-based OII aggregation and
Kowalczuk/Psota/Perez iterative adaptive-support-weight matching), with
winner-take-all selection, left/right consistency, occlusion filling,
iterative refinement, a per-stage benchmark harness, golden-image evaluation,
and multi-chip scaling via `jax.sharding` (spatial tiling with halo exchange
and disparity-axis sharding).

Layering:
  config    — StereoConfig / MeshConfig (every reference constant, promoted)
  ops       — pure-jnp reference ops (semantic ground truth)
  kernels   — GPU kernels (Pallas, Triton route) and the one kernel choice
  models    — end-to-end jitted pipelines (cross_based, asw)
  parallel  — meshes, halo exchange, sharded pipelines
  io        — PNG/PFM codecs, Middlebury dataset registry
  eval      — bad-pixel metrics, golden-image regression
  bench     — per-stage timing harness (reference TSV format)
"""

from .config import MeshConfig, REFERENCE_CONFIG, StereoConfig, TINY_CONFIG

__version__ = "0.1.0"

__all__ = [
    "MeshConfig",
    "REFERENCE_CONFIG",
    "StereoConfig",
    "TINY_CONFIG",
    "__version__",
]
