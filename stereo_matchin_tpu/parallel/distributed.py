"""Multi-host initialisation and mesh construction.

The reference is strictly single-device (SURVEY.md §2.3).  Multi-host
scaling here rides jax.distributed + the same (batch, row, disp) mesh:
each host contributes its local cards; the mesh's batch axis is laid out
across hosts (frame parallelism: one image transfer per frame crosses
the network) while row/disp stay within a host, so the halo ppermutes
and the WTA all_gather stay on the host's own card-to-card links.

Launch (same invocation on every host, its own process_id each):

    from stereo_matchin_tpu.parallel import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=0)
    mesh = distributed.build_pod_mesh(row=2, disp=2)
    step = make_asw_sharded(cfg, mesh)       # global-array API under jit
"""

from __future__ import annotations

from typing import Optional


import jax
from jax.sharding import Mesh

from ..config import MeshConfig
from .mesh import build_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize.  Pass the coordinator address, process
    count and this process's id; without them JAX looks for a cluster
    environment it can read them from.  Call once per process, before
    any jax computation.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def build_pod_mesh(row: int = 1, disp: int = 1,
                   batch: Optional[int] = None) -> Mesh:
    """Global mesh over all devices of all hosts.

    batch defaults to num_devices // (row * disp) — every host's cards
    split between the row/disp axes locally, and the frame axis spans
    hosts (no ppermute/all_gather crosses hosts as long as row*disp
    divides the per-host card count).
    """
    n = len(jax.devices())
    if batch is None:
        if n % (row * disp):
            raise ValueError(f"{n} devices not divisible by row*disp="
                             f"{row * disp}")
        batch = n // (row * disp)
    return build_mesh(MeshConfig(batch=batch, row=row, disp=disp))


def scaling_report(step_fn, left, right, mesh: Mesh, runs: int = 5,
                   repeats: int = 3):
    """Throughput + per-device efficiency for a sharded step on `mesh`.

    Returns dict with wall ms, Mpix/s, and Mpix/s per device.  The wall
    time is the MIN over `repeats` timed blocks of `runs` steps — a
    single mean block is easily poisoned by transient host load, and
    min-of-blocks is the standard defence.
    """
    import time

    sync = jax.block_until_ready

    sync(step_fn(left, right))          # warmup/compile

    def block():
        t0 = time.perf_counter()
        out = None
        for _ in range(runs):
            out = step_fn(left, right)
        sync(out)
        return time.perf_counter() - t0

    # Host-contention detection: keep timing blocks until the two fastest
    # agree within 10%, up to 2x the requested repeats; a line that cannot
    # converge is marked unstable so a swing under concurrent host load
    # reads as noise, not as a scaling regression.  repeats=1 is the
    # single-block fast path: one timed block, stability unassessed
    # (stable=None).
    if repeats == 1:
        t = block()
        ms = t / runs * 1000.0
        n_dev = mesh.devices.size
        B, H, W = left.shape[0], left.shape[1], left.shape[2]
        mpix_s = B * H * W / (ms / 1000.0) / 1e6
        return {"ms": ms, "mpix_s": mpix_s,
                "mpix_s_per_device": mpix_s / n_dev,
                "devices": n_dev, "stable": None}
    times = [block() for _ in range(max(repeats, 2))]
    stable = False
    for _ in range(max(repeats, 2)):
        two = sorted(times)[:2]
        if two[1] - two[0] <= 0.10 * two[0]:
            stable = True
            break
        times.append(block())
    ms = min(times) / runs * 1000.0
    n_dev = mesh.devices.size
    B, H, W = left.shape[0], left.shape[1], left.shape[2]
    # Mdisp/s needs the disparity count from the caller's cfg; report
    # pixel throughput and let callers scale.
    mpix_s = B * H * W / (ms / 1000.0) / 1e6
    return {"ms": ms, "mpix_s": mpix_s, "mpix_s_per_device": mpix_s / n_dev,
            "devices": n_dev, "stable": stable}
