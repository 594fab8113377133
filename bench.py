"""Benchmark entry point — prints one JSON line per metric for the driver.

Headline metric (always the LAST line — the driver parses the final JSON
line): ASW-pipeline disparity throughput on tsukuba at the full reference
configuration (61 disparities, r=7, k=6, 33-tap window), in millions of
disparity hypotheses per second (W*H*D / wall time — the same derived
metric as BASELINE.md).  It is measured first (so a mid-suite crash can't
lose it to an early failure — the driver still sees partial lines) but
emitted last.  vs_baseline is against the GTX 860M running the identical
workload (per-pair anchors derived from the committed timing file,
BASELINE.md).  Per-pair rows carry spread_pct: the half-range of the
per-run times, as % of the median.

The default full suite then adds: both methods on all five pairs, the
batched video mode, BASELINE configs 1-2 at their real geometry, the
config-4 stream and latency, and a CPU-mesh scaling report (subprocess,
8 virtual devices: halo-comm ablation, collective footprints,
ref-geometry strong-scaling anchor — see bench_scaling_subprocess).
Configs 1-2 have no
per-workload reference measurement, so their vs_baseline uses the ASW
anchor throughput (the 860M's Mdisp/s is nearly workload-independent:
16.8-17.5 across the five pairs).

Usage:
  python bench.py                 # full suite
  python bench.py --suite headline
  python bench.py --method cross --pair teddy [--batch 8]   # one metric
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# GTX 860M mean totals in ms (BASELINE.md measured table, 10-run means).
ANCHOR_MS = {
    ("asw", "tsukuba"): 385.1, ("asw", "teddy"): 613.5,
    ("asw", "cones"): 613.8, ("asw", "art"): 583.6,
    ("asw", "laundry"): 607.2,
    ("cross", "tsukuba"): 73.7, ("cross", "teddy"): 113.8,
    ("cross", "cones"): 112.5, ("cross", "art"): 110.6,
    ("cross", "laundry"): 112.9,
}
SIZES = {"tsukuba": (288, 384), "teddy": (375, 450), "cones": (375, 450),
         "art": (359, 450), "laundry": (372, 450)}
NUM_DISP_REF = 61


def anchor_mdisp(method: str, pair: str) -> float:
    H, W = SIZES[pair]
    return H * W * NUM_DISP_REF / ANCHOR_MS[(method, pair)] / 1e3


# Every emitted (or failed) metric is also recorded here and re-printed as
# ONE compact `summary_all` JSON line right before the final headline line,
# so that the last ~2000 chars of output carry every number.
SUMMARY: dict = {}

# Dropped affixes for the summary's compact keys (full names stay on the
# per-metric lines above it).
_SHORTEN = (
    ("_throughput", ""), ("_2880x1988_280d", ""), ("_ps_per_tapelem", "_ps"),
    ("config0_tsukuba_cpu_16d_9x9", "config0_cpu"),
    ("config1_teddy_64d_35w", "config1_teddy"),
    ("config2_art_230d", "config2_art"),
    ("config4_kitti_stream_b4", "config4_b4"),
    ("config4_kitti_latency", "config4_lat"),
    ("weak_scaling_8dev_", "ws8_"), ("strong_scaling_", "ss_"),
    ("_mesh_speedup", ""), ("_ref_geom_efficiency", "_eff"),
    ("scaling_row8_", "row8_"), ("scaling_disp8_", "disp8_"),
    ("_collective_mb_per_frame", "_mb"), ("_halo_comm_pct", "_comm_pct"),
)


def _short(metric: str) -> str:
    for a, b in _SHORTEN:
        metric = metric.replace(a, b)
    return metric


def emit(metric: str, value: float, vs_baseline: float | None,
         unit: str = "Mdisp/s", **extra) -> None:
    rec = {"metric": metric, "value": round(value, 2), "unit": unit}
    if vs_baseline is not None:  # None: no meaningful reference ratio
        rec["vs_baseline"] = round(vs_baseline, 3)
    rec.update(extra)
    SUMMARY[_short(metric)] = rec["value"]
    print(json.dumps(rec), flush=True)


def emit_error(metric: str, err: str, unit: str = "Mdisp/s") -> None:
    SUMMARY[_short(metric)] = None
    print(json.dumps({"metric": metric, "value": None, "unit": unit,
                      "error": err[:200]}), flush=True)


def emit_summary() -> None:
    """One compact line carrying every metric of the run (value only;
    vs_baseline ratios are value/anchor with the anchors fixed in this
    file + BASELINE.md).  Printed second-to-last so the driver's
    2000-char tail always contains the full picture; the headline line
    still comes last (the driver parses the final JSON line)."""
    print(json.dumps({"metric": "summary_all", "values": SUMMARY},
                     separators=(",", ":")), flush=True)


def measure(fn, left, right, runs: int):
    """Median and spread of `runs` timed calls after one warm-up call,
    each waited for with block_until_ready.  Returns (median_s, mean_s,
    spread) with spread = half the range over the median."""
    import jax

    jax.block_until_ready(fn(left, right))          # warm-up / compile
    times = []
    for _ in range(max(runs, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(left, right))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return med, float(np.mean(times)), (max(times) - min(times)) / (2 * med)


def bench_pair(method: str, pair: str, cfg, runs: int, batch: int = 0):
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu.io import load_pair
    from stereo_matchin_tpu.models import asw, cross_based

    left_np, right_np = load_pair(pair)
    left, right = jnp.asarray(left_np), jnp.asarray(right_np)
    H, W = left_np.shape[:2]
    if batch and method != "asw":
        raise ValueError("--batch is only implemented for the ASW "
                         "(video-stream) pipeline")
    if batch:
        left = jnp.broadcast_to(left, (batch,) + left.shape)
        right = jnp.broadcast_to(right, (batch,) + right.shape)
        fn = jax.jit(lambda l, r: asw.asw_pipeline_batched(l, r, cfg).disparity)
    elif method == "asw":
        fn = jax.jit(lambda l, r: asw.asw_pipeline_impl(l, r, cfg).disparity)
    else:
        fn = lambda l, r: cross_based.cross_pipeline(l, r, cfg).final  # noqa: E731
    best, mean, spread = measure(fn, left, right, runs)
    frames = batch or 1
    return (frames * W * H * cfg.num_disp / best / 1e6,
            frames * W * H * cfg.num_disp / mean / 1e6,
            spread)


def bench_config4_stream(runs: int = 3, batch: int = 4, W: int = 1242,
                         H: int = 375, cfg=None):
    """BASELINE config 4 (batched video-rate stream at KITTI resolution,
    1242x375, 64 disparities) with a fallback ladder: a stream's
    steady-state rate is identical whether frames are batched into one
    program or jitted per frame and looped on the host — so on a compile
    failure fall back to batch-2, then to the single-frame program looped
    `batch` times per dispatch block.  Returns (Mdisp/s, frames/s, mode).
    The N-host sharded form of the same workload is exercised by
    `__graft_entry__.dryrun_multichip` (batch mesh axis) and the
    weak-scaling metric below."""
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.models import asw

    if cfg is None:
        cfg = REFERENCE_CONFIG.replace(d_max=63)
    rng = np.random.default_rng(0)
    base = rng.random((batch, H, W, 3), dtype=np.float32)

    def batched(b):
        left = jnp.asarray(base[:b])
        right = jnp.asarray(np.roll(base[:b], 9, axis=2))
        fn = jax.jit(
            lambda l, r: asw.asw_pipeline_batched(l, r, cfg).disparity)
        best, _, _ = measure(fn, left, right, runs)
        return b * W * H * cfg.num_disp / best / 1e6, b / best

    def host_loop():
        # Single-frame program; each measured "run" pushes the whole
        # `batch`-frame stream through it (async dispatch pipelines the
        # frames exactly as the lax.map body would).
        frames = [(jnp.asarray(base[i]),
                   jnp.asarray(np.roll(base[i], 9, axis=2)))
                  for i in range(batch)]
        fn1 = jax.jit(lambda l, r: asw.asw_pipeline_impl(l, r, cfg).disparity)

        def fn(l, r):
            out = None
            for fl, fr in frames:
                out = fn1(fl, fr)
            return out

        best, _, _ = measure(fn, frames[0][0], frames[0][1], runs)
        return batch * W * H * cfg.num_disp / best / 1e6, batch / best

    attempts = [(f"batched_b{batch}", lambda: batched(batch)),
                (f"batched_b{max(batch // 2, 1)}",
                 lambda: batched(max(batch // 2, 1))),
                ("host_loop_b1", host_loop)]
    last_err = None
    for mode, attempt in attempts:
        try:
            mdisp, fps = attempt()
            return mdisp, fps, mode
        except Exception as e:  # noqa: BLE001 — try the next rung
            last_err = e
            print(f"bench: config4 {mode} failed ({repr(e)[:160]}); "
                  "falling back", file=sys.stderr, flush=True)
    raise last_err


def bench_config4_latency(runs: int = 20, W: int = 1242, H: int = 375,
                          cfg=None):
    """Config-4 single-frame latency (b=1): the user-facing number for a
    video stream is the time from one frame in to its disparity map out,
    so measure the single-frame program with a block after EVERY call —
    no cross-frame pipelining, unlike the throughput line above.
    Returns (median ms, fps at that latency)."""
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.models import asw

    if cfg is None:
        cfg = REFERENCE_CONFIG.replace(d_max=63)
    rng = np.random.default_rng(0)
    base = rng.random((H, W, 3), dtype=np.float32)
    left = jnp.asarray(base)
    right = jnp.asarray(np.roll(base, 9, axis=1))
    fn = jax.jit(lambda l, r: asw.asw_pipeline_impl(l, r, cfg).disparity)
    jax.block_until_ready(fn(left, right))        # compile
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(left, right))    # block per frame: latency
        times.append(time.perf_counter() - t0)
    ms = sorted(times)[len(times) // 2] * 1e3
    return ms, 1e3 / ms


# The reference's own CPU OpenCL rate: i7-4710HQ tsukuba ASW total
# 1935 ms (BASELINE.md measured table) -> 384*288*61 / 1.935 s.  Config 0
# is the CPU-runnable config, so a CPU anchor is the comparable baseline.
ANCHOR_CPU_MDISP = 384 * 288 * 61 / 1.935 / 1e6


def bench_config0_cpu():
    """BASELINE config 0: tsukuba at 16 disparities with a 9x9 support
    window, CPU-runnable — measured in a CPU subprocess (the parent owns
    the device backend; backends are per-process).  Returns Mdisp/s."""
    code = r"""
import os, json, time
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
from stereo_matchin_tpu import StereoConfig
from stereo_matchin_tpu.io import load_pair
from stereo_matchin_tpu.models import asw
cfg = StereoConfig(d_max=15, radius=4)
left, right = map(jnp.asarray, load_pair("tsukuba"))
H, W = left.shape[:2]
fn = jax.jit(lambda l, r: asw.asw_pipeline_impl(l, r, cfg).disparity)
fn(left, right).block_until_ready()
t0 = time.perf_counter()
n = 3
for _ in range(n):
    out = fn(left, right)
out.block_until_ready()
dt = (time.perf_counter() - t0) / n
print(json.dumps({"mdisp_s": H * W * cfg.num_disp / dt / 1e6}))
"""
    env = dict(**__import__("os").environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-300:])
    return json.loads(r.stdout.strip().splitlines()[-1])["mdisp_s"]


def bench_scaling_subprocess():
    """Sharded-pipeline scaling evidence on the 8-virtual-device CPU
    mesh, in a subprocess (the parent owns the device backend; backends
    are per-process).

    8 virtual devices time-share the same physical cores, so raw
    weak-scaling speedups swing >20% between identical reruns.  What such
    a host CAN measure reproducibly:

      * the row-axis halo-communication share, by REBUILD: the same
        row-8 program with halo_mode="local" (edge pads, zero
        communication, identical per-shard compute) vs the real
        ppermute exchange — a ratio of two runs under the same
        contention;
      * the compiled programs' collective footprint: op counts and
        bytes parsed from the optimized sharded HLO (deterministic;
        collectives inside lax.scan bodies are counted once per
        program, stated on the metric);
      * the strong-scaling anchor at the reference geometry (2-way row
        shard of the full tsukuba config vs unsharded)."""
    code = r"""
import os, json, re, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp
from stereo_matchin_tpu.config import StereoConfig, MeshConfig
from stereo_matchin_tpu.parallel import build_mesh, make_asw_sharded, scaling_report
cfg = StereoConfig(d_max=15, radius=4, arm_len=6, r_iters=2, k_iters=2)
rng = np.random.default_rng(0)
H, W = 96, 128
def build(batch, mesh_cfg, height=None, config=None, halo_mode="exchange",
          width=None):
    mesh = build_mesh(mesh_cfg)
    f = make_asw_sharded(config or cfg, mesh, halo_mode=halo_mode)
    h, w = height or H, width or W
    left = jnp.asarray(rng.random((batch, h, w, 3), dtype=np.float32))
    right = jnp.asarray(rng.random((batch, h, w, 3), dtype=np.float32))
    return f, left, right, mesh
def run(batch, mesh_cfg, height=None, config=None, halo_mode="exchange",
        runs=3, width=None):
    f, left, right, mesh = build(batch, mesh_cfg, height, config,
                                 halo_mode, width)
    return scaling_report(f, left, right, mesh, runs=runs)
DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
               "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1, "f64": 8}
def comm_stats(f, left, right):
    # Deterministic collective footprint of the compiled program: sum of
    # result bytes of every (sync-form) collective in the optimized HLO.
    # Collectives inside lax.scan bodies appear (and are counted) once.
    txt = f.lower(left, right).compile().as_text()
    total, counts = 0, {}
    pat = re.compile(r"= *(\w+)\[([\d,]*)\][^\n]*? "
                     r"(collective-permute|all-gather|all-reduce|"
                     r"reduce-scatter)\(")
    for mm in pat.finditer(txt):
        dt, shape, op = mm.group(1), mm.group(2), mm.group(3)
        n = 1
        for s in shape.split(","):
            if s:
                n *= int(s)
        total += n * DTYPE_BYTES.get(dt, 4)
        counts[op] = counts.get(op, 0) + 1
    return total, counts
# Row-axis halo-communication share by REBUILD: real ppermute exchange
# vs halo_mode="local" (edge pads; wrong seams, identical per-shard
# compute, zero communication) — a ratio of two runs under the same
# contention, the stable dynamic measurement this host can make.
s8 = run(1, MeshConfig(batch=1, row=8, disp=1), height=8 * H)
s8l = run(1, MeshConfig(batch=1, row=8, disp=1), height=8 * H,
          halo_mode="local")
comm_pct = max(0.0, 100.0 * (1.0 - s8l["ms"] / s8["ms"])) if s8["ms"] else 0.0
# Static collective footprints: the row-8 program above, and the disp-8
# program at config-2's real per-shard plane count (d_max=231 over 8).
fr, lr, rr, _ = build(1, MeshConfig(batch=1, row=8, disp=1), height=8 * H)
row_bytes, row_ops = comm_stats(fr, lr, rr)
fd, ld, rd, _ = build(1, MeshConfig(batch=1, row=1, disp=8),
                      config=cfg.replace(d_max=231), height=64, width=96)
disp_bytes, disp_ops = comm_stats(fd, ld, rd)
out = {"row_comm_pct": comm_pct,
       "halo_stable": bool(s8.get("stable")) and bool(s8l.get("stable")),
       "row8_comm_bytes": row_bytes, "row8_collectives": row_ops,
       "disp8_comm_bytes": disp_bytes, "disp8_collectives": disp_ops}
# Reference-geometry anchor for the row axis: the
# tsukuba workload at the full reference config, 2-way row-sharded vs
# unsharded — the scaling numbers above use toy geometry, this one
# shares its shape with the per-pair perf claims.
try:
    ref = StereoConfig()
    g1 = run(1, MeshConfig(batch=1, row=1, disp=1), height=288,
             width=384, config=ref, runs=1)
    g2 = run(1, MeshConfig(batch=1, row=2, disp=1), height=288,
             width=384, config=ref, runs=1)
    out["eff_row2_ref_geom"] = g2["mpix_s"] / (2.0 * g1["mpix_s"])
except Exception as e:
    out["eff_row2_ref_geom"] = None
print(json.dumps(out))
"""
    env = dict(**__import__("os").environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=1200, env=env)
    if r.returncode != 0:
        return None
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", choices=["full", "headline"], default=None)
    ap.add_argument("--method", choices=["asw", "cross"], default=None)
    ap.add_argument("--pair", default=None)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=0,
                    help="batched video-stream mode with this many frames")
    args = ap.parse_args()

    from stereo_matchin_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    from stereo_matchin_tpu import REFERENCE_CONFIG as cfg

    single = args.method or args.pair or args.batch
    method = args.method or "asw"
    pair = args.pair or "tsukuba"

    if single:
        best, _, spread = bench_pair(method, pair, cfg, args.runs, args.batch)
        suffix = f"_b{args.batch}" if args.batch else ""
        emit(f"{method}_{pair}{suffix}_throughput", best,
             best / anchor_mdisp(method, pair),
             spread_pct=round(100 * spread, 1))
        return 0

    # --- full suite (headline measured first, EMITTED LAST — the driver
    # parses the final JSON line as the round's number) ------------------
    best_headline, mean, spread_headline = bench_pair(
        "asw", "tsukuba", cfg, args.runs)
    vs_headline = best_headline / anchor_mdisp("asw", "tsukuba")
    if args.suite == "headline":
        emit("asw_tsukuba_throughput", best_headline, vs_headline,
             spread_pct=round(100 * spread_headline, 1))
        return 0
    emit("asw_tsukuba_throughput_mean", mean,
         mean / anchor_mdisp("asw", "tsukuba"))

    for p in ("teddy", "cones", "art", "laundry"):
        b, _, s = bench_pair("asw", p, cfg, args.runs)
        emit(f"asw_{p}_throughput", b, b / anchor_mdisp("asw", p),
             spread_pct=round(100 * s, 1))
    for p in ("tsukuba", "teddy", "cones", "art", "laundry"):
        b, _, s = bench_pair("cross", p, cfg, args.runs)
        emit(f"cross_{p}_throughput", b, b / anchor_mdisp("cross", p),
             spread_pct=round(100 * s, 1))

    b, _, _ = bench_pair("asw", "tsukuba", cfg, max(2, args.runs // 2),
                         batch=8)
    emit("asw_tsukuba_b8_throughput", b, b / anchor_mdisp("asw", "tsukuba"))

    # BASELINE config 0: tsukuba, 16 disparities, 9x9 window — the
    # CPU-runnable config, measured on CPU (subprocess).  vs_baseline
    # anchors to the reference's own CPU OpenCL rate (ANCHOR_CPU_MDISP,
    # i7-4710HQ tsukuba ASW).
    try:
        b = bench_config0_cpu()
        emit("config0_tsukuba_cpu_16d_9x9_throughput", b,
             b / ANCHOR_CPU_MDISP)
    except Exception as e:  # noqa: BLE001 — bench must report what it can
        emit_error("config0_tsukuba_cpu_16d_9x9_throughput", repr(e))
    # BASELINE config 1: 64 disparities, full 35x35 window (radius 17).
    cfg1 = cfg.replace(d_max=63, radius=17)
    b, _, _ = bench_pair("asw", "teddy", cfg1, max(3, args.runs // 2))
    emit("config1_teddy_64d_35w_throughput", b, b / 17.5)
    # BASELINE config 2: ~230 disparities (Middlebury 2005 third-size).
    cfg2 = cfg.replace(d_max=229)
    b, _, _ = bench_pair("asw", "art", cfg2, max(3, args.runs // 2))
    emit("config2_art_230d_throughput", b, b / 17.5)
    # BASELINE config 4: batched video-rate stream at KITTI resolution
    # (fallback ladder inside — `mode` records which rung produced it).
    try:
        b, fps, mode = bench_config4_stream(max(2, args.runs // 4))
        emit("config4_kitti_stream_b4_throughput", b, b / 17.5, mode=mode)
        # Same ratio as the Mdisp/s line (fps = Mdisp/s over one frame's
        # disparity count); reported in stream-native units.
        emit("config4_kitti_stream_b4_fps", fps, b / 17.5, unit="frames/s",
             mode=mode)
    except Exception as e:  # noqa: BLE001 — bench must report what it can
        emit_error("config4_kitti_stream_b4_throughput", repr(e))
    # Config-4 single-frame latency: block after every frame — the stream's user-facing per-frame number.  The fps
    # anchor is the 860M's ASW per-frame rate at teddy-like area scaled to
    # KITTI 64-disp area (613.5 ms -> 1.63 fps is the closest reference
    # per-frame figure; vs_baseline uses the Mdisp/s form for consistency).
    try:
        ms, fps1 = bench_config4_latency(max(10, args.runs * 3))
        mdisp1 = 1242 * 375 * 64 / (ms / 1e3) / 1e6
        emit("config4_kitti_latency_ms", ms, mdisp1 / 17.5, unit="ms")
        emit("config4_kitti_latency_fps", fps1, mdisp1 / 17.5,
             unit="frames/s")
    except Exception as e:  # noqa: BLE001 — bench must report what it can
        emit_error("config4_kitti_latency_ms", repr(e), unit="ms")

    try:
        rep = bench_scaling_subprocess()
    except Exception as e:  # noqa: BLE001 — bench must report what it can
        rep = None
        err = repr(e)[:200]
    else:
        err = "subprocess failed (see stderr)" if rep is None else None
    if rep is None:
        emit_error("scaling_row8_halo_comm_pct", err or "", unit="%")
    if rep is not None:
        # Reported: the halo-comm share measured by REBUILD (ratio of two
        # runs under identical contention), the compiled programs'
        # deterministic collective footprints, and the ref-geometry
        # strong-scaling anchor.
        emit("scaling_row8_halo_comm_pct",
             rep.get("row_comm_pct", 0.0), None, unit="%",
             stable=bool(rep.get("halo_stable")),
             how="row-8 ppermute exchange vs halo_mode=local rebuild")
        if rep.get("row8_comm_bytes") is not None:
            emit("scaling_row8_collective_mb_per_frame",
                 rep["row8_comm_bytes"] / 1e6, None, unit="MB",
                 ops=rep.get("row8_collectives"),
                 how="optimized-HLO result bytes; scan-body collectives "
                     "counted once per program")
        if rep.get("disp8_comm_bytes") is not None:
            emit("scaling_disp8_collective_mb_per_frame",
                 rep["disp8_comm_bytes"] / 1e6, None, unit="MB",
                 ops=rep.get("disp8_collectives"),
                 how="disp=8 mesh at config-2 planes (d_max=231); "
                     "optimized-HLO result bytes")
        if rep.get("eff_row2_ref_geom") is not None:
            # Strong-scaling anchor at the REFERENCE geometry (tsukuba
            # 384x288, full config): 2-way row-sharded vs unsharded on
            # the CPU mesh — ties the scaling lines to the same shape as
            # the per-pair perf claims (efficiency of 1.0 = perfect 2x).
            emit("strong_scaling_2dev_row_ref_geom_efficiency",
                 rep["eff_row2_ref_geom"],
                 rep["eff_row2_ref_geom"], unit="frac")

    # Compact all-metrics summary, then the headline metric LAST — the
    # driver records the final JSON line and keeps only a ~2000-char tail.
    emit_summary()
    emit("asw_tsukuba_throughput", best_headline, vs_headline,
         spread_pct=round(100 * spread_headline, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
