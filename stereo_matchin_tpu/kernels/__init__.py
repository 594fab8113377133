"""Hand-written GPU kernels, and the one place that decides when they run.

The kernels compile for NVIDIA GPUs through Pallas' Triton route.
`on_gpu` is the only kernel choice in the package: it picks the kernel
path where the program is lowered for a CUDA GPU and the plain `ops/`
path everywhere else, at lowering time — so a computation placed on the
CPU backend of a GPU process takes the plain path too.  Called directly
on another backend, a kernel raises unless the caller asks for
interpret mode (tests do).
"""

from jax import lax

from .asw_aggregation import asw_aggregate, asw_den, asw_pass, tile_padded


def on_gpu(*operands, gpu, default):
    """`gpu(*operands)` where the program is lowered for a CUDA GPU,
    `default(*operands)` elsewhere."""
    return lax.platform_dependent(*operands, cuda=gpu, default=default)


__all__ = ["asw_aggregate", "asw_den", "asw_pass", "on_gpu", "tile_padded"]
