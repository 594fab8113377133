#!/usr/bin/env python3
"""Smoke run of both stereo pipelines on an NVIDIA GPU, end to end.

    python3 chip_smoke.py          # the single-card phases, one GPU
    python3 chip_smoke.py --four   # the sharded pipelines on four GPUs and
                                   # the single-card pipeline they must match

Every phase prints one JSON line with its wall times (cold = compile +
first run, warm = median of later runs), compile seconds, the compiled
program's memory peak and its correctness figures, and raises on any
failure: the exit code is then non-zero and the final line never comes.
The final line is {"ok": true, "device": {"platform", "kind", "count"}};
the line before it is the card's name and power limit as nvidia-smi
reports them.  Inputs are seeded synthetic scenes
(eval.synthetic.synthetic_scene); one process uses the card(s).

Phases (single card):
  device       the first device must be a GPU, else exit 1 at once;
  asw_ref      asw_pipeline at REFERENCE_CONFIG on a 288x384 scene, the
               same program on the in-process CPU backend at a 96x128
               crop, and the Triton aggregation kernel against
               ops.asw_aggregate at full width (error, maps, times);
  cross_ref    cross_pipeline, the same two geometries;
  kitti_stream asw_pipeline_batched, 4 frames of 375x1242, 64 disparities,
               and the kernel against ops.asw_aggregate at that width;
  mb2014_frame one 1988x2880 frame at 280 disparities through the CLI
               (`synth`, then `run --bands 0`), both methods.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Correctness limits (PERF.md "End-to-end metrics"): aggregated volumes
# agree to float32 rounding (FMA contraction, summation order); maps agree
# except at argmin ties.
MAX_REL_ERR = 1e-5
MIN_MAP_AGREEMENT = 0.999

# Geometries (rows, columns): tsukuba, KITTI, Middlebury 2014 full size,
# and the KITTI height the four-card row axis divides.
TSUKUBA = (288, 384)
KITTI = (375, 1242)
MB2014 = (1988, 2880)
KITTI_ROWS4 = (376, 1242)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def ok_line(devices) -> str:
    """The contract's last line for `devices` (JAX device objects)."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def agreement(a, b) -> float:
    """Fraction of elements where two maps are equal."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean())


def max_rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), "non-finite values"
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def normwise_err(got, want) -> float:
    """max |got - want| / max |want|: the error on the volume's own
    scale.  Aggregated costs near zero (exact matches) make the
    elementwise relative error meaningless across backends, whose exp
    and division differ in the last bits."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), "non-finite values"
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def check(name: str, ok: bool, value) -> None:
    if not ok:
        raise AssertionError(f"{name} out of limits: {value}")


def peak_bytes(compiled) -> int:
    m = compiled.memory_analysis()
    peak = getattr(m, "peak_memory_in_bytes", 0)
    return int(peak or (m.temp_size_in_bytes + m.argument_size_in_bytes
                        + m.output_size_in_bytes - m.alias_size_in_bytes))


def run_timed(fn, *args, warm: int = 5):
    """AOT-compile fn at args' shapes, run once cold and `warm` times.
    Returns (output, timing fields)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    first_s = time.perf_counter() - t1
    times = []
    for _ in range(warm):
        t = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t)
    return out, {"compile_s": compile_s, "cold_s": compile_s + first_s,
                 "warm_s": float(np.median(times)),
                 "peak_bytes": peak_bytes(compiled)}


def scene(seed: int, H: int, W: int, disp: int):
    from stereo_matchin_tpu.eval import synthetic_scene

    left, right, _, _ = synthetic_scene(np.random.default_rng(seed), H, W,
                                        disp)
    return left, right


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_device(n_cards: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found "
                         f"{devices[0].platform} devices); nothing is run")
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devices)}")
    smi = nvidia_smi()
    emit("device", kind=devices[0].device_kind, count=len(devices),
         jax=jax.__version__, nvidia_smi=smi)
    return devices, smi


def _cpu_agreement(fn, left, right, crop=(96, 128)):
    """Run jitted fn on the GPU and on the CPU backend at a crop; returns
    both outputs (host arrays)."""
    import jax

    l, r = left[:crop[0], :crop[1]], right[:crop[0], :crop[1]]
    f = jax.jit(fn)
    gpu = jax.tree.map(np.asarray, f(l, r))
    cpu_dev = jax.devices("cpu")[0]
    cpu = jax.tree.map(np.asarray, f(jax.device_put(l, cpu_dev),
                                     jax.device_put(r, cpu_dev)))
    return gpu, cpu


def _kernel_vs_xla(left, right, cfg, label: str):
    """The Triton aggregation kernel against ops.asw_aggregate on the card
    at full width: the volumes, the pipeline maps, and the end-to-end
    pipeline time with each aggregation (runs alternate xla, kernel,
    kernel, xla)."""
    from stereo_matchin_tpu import kernels, ops
    from stereo_matchin_tpu.models import asw

    args = (cfg.radius, cfg.r_iters, cfg.eps)

    def pipeline(aggregate):
        def fn(l, r):
            cost = ops.sad_cost_volume(l, r, cfg.num_disp, scale=255.0)
            aggr = aggregate(cost, *asw.asw_support_weights(l, r, cfg),
                             *args)
            return asw.asw_postaggregate_impl(aggr, l, r, cfg)
        return fn

    runs = {}
    outs = {}
    for name in ("xla", "kernel", "kernel", "xla"):
        aggregate = (kernels.asw_aggregate if name == "kernel"
                     else ops.asw_aggregate)
        out, t = run_timed(pipeline(aggregate), left, right)
        runs.setdefault(name, []).append(t)
        outs[name] = out
    k, x = outs["kernel"], outs["xla"]
    err = max_rel_err(k.aggregated_cost, x.aggregated_cost)
    agree = agreement(k.disparity, x.disparity)
    fields = {
        "geometry": label,
        "aggr_max_rel_err": err,
        "disparity_agreement": agree,
        "pipeline_warm_s_xla": [t["warm_s"] for t in runs["xla"]],
        "pipeline_warm_s_kernel": [t["warm_s"] for t in runs["kernel"]],
        "compile_s_xla": runs["xla"][0]["compile_s"],
        "compile_s_kernel": runs["kernel"][0]["compile_s"],
    }
    emit("kernel_vs_xla", **fields)
    check("kernel aggregated-volume error", err <= MAX_REL_ERR, err)
    check("kernel disparity agreement", agree >= MIN_MAP_AGREEMENT, agree)


def phase_asw_ref(seed: int):
    import jax.numpy as jnp

    from stereo_matchin_tpu import REFERENCE_CONFIG as cfg
    from stereo_matchin_tpu.models import asw

    left, right = map(jnp.asarray, scene(seed, *TSUKUBA, 16))
    fn = lambda l, r: asw.asw_pipeline_impl(l, r, cfg)  # noqa: E731
    out, t = run_timed(fn, left, right)
    d = np.asarray(out.disparity)
    check("asw output", d.shape == TSUKUBA and np.isfinite(d).all()
          and d.min() >= 0 and d.max() <= 1, (d.shape, d.min(), d.max()))
    gpu, cpu = _cpu_agreement(fn, left, right)
    err = normwise_err(gpu.aggregated_cost, cpu.aggregated_cost)
    agree = agreement(gpu.disparity, cpu.disparity)
    emit("asw_ref", shape=list(d.shape), **t, cpu_aggr_normwise_err=err,
         cpu_aggr_max_rel_err=max_rel_err(gpu.aggregated_cost,
                                          cpu.aggregated_cost),
         cpu_disparity_agreement=agree)
    check("GPU vs CPU aggregated volume", err <= MAX_REL_ERR, err)
    check("GPU vs CPU disparity", agree >= MIN_MAP_AGREEMENT, agree)
    _kernel_vs_xla(left, right, cfg,
                   f"tsukuba {TSUKUBA}, {cfg.num_disp} disparities")


def phase_cross_ref(seed: int):
    import jax.numpy as jnp

    from stereo_matchin_tpu import REFERENCE_CONFIG as cfg
    from stereo_matchin_tpu.models import cross_based

    left, right = map(jnp.asarray, scene(seed, *TSUKUBA, 16))
    fn = lambda l, r: cross_based.cross_pipeline_impl(l, r, cfg)  # noqa: E731
    out, t = run_timed(fn, left, right)
    f = np.asarray(out.final)
    check("cross output", f.shape == TSUKUBA and np.isfinite(f).all(),
          f.shape)
    gpu, cpu = _cpu_agreement(fn, left, right)
    ai = agreement(gpu.initial, cpu.initial)
    af = agreement(gpu.final, cpu.final)
    emit("cross_ref", shape=list(f.shape), **t,
         cpu_initial_agreement=ai, cpu_final_agreement=af)
    check("GPU vs CPU initial map", ai >= MIN_MAP_AGREEMENT, ai)
    check("GPU vs CPU final map", af >= MIN_MAP_AGREEMENT, af)


def phase_kitti_stream(seed: int):
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.models import asw

    cfg = REFERENCE_CONFIG.replace(d_max=63)
    frames = [scene(seed + i, *KITTI, 48) for i in range(4)]
    left = jnp.asarray(np.stack([f[0] for f in frames]))
    right = jnp.asarray(np.stack([f[1] for f in frames]))
    fn = lambda l, r: asw.asw_pipeline_batched(l, r, cfg).disparity  # noqa: E731
    out, t = run_timed(fn, left, right, warm=3)
    d = np.asarray(out)
    single = np.asarray(jax.jit(
        lambda l, r: asw.asw_pipeline_impl(l, r, cfg).disparity)(
            left[0], right[0]))
    agree = agreement(d[0], single)
    emit("kitti_stream", shape=list(d.shape), **t,
         frames_per_s=4 / t["warm_s"], frame0_vs_single_agreement=agree)
    check("kitti output", d.shape == (4, *KITTI) and np.isfinite(d).all(),
          d.shape)
    check("batched vs single frame", agree >= MIN_MAP_AGREEMENT, agree)
    _kernel_vs_xla(left[0], right[0], cfg,
                   f"KITTI {KITTI}, {cfg.num_disp} disparities")


def phase_mb2014_frame(seed: int):
    import contextlib
    import io

    from stereo_matchin_tpu import REFERENCE_CONFIG
    from stereo_matchin_tpu.__main__ import main as cli
    from stereo_matchin_tpu.eval import bad_pixel_pct
    from stereo_matchin_tpu.io import png
    from stereo_matchin_tpu.io.groundtruth import read_pfm
    from stereo_matchin_tpu.models.tiled import auto_bands

    (H, W), d_max = MB2014, 279
    cfg = REFERENCE_CONFIG.replace(d_max=d_max)
    with tempfile.TemporaryDirectory() as tmp:
        scene_dir = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli(["synth", "--out", scene_dir, "--height", str(H),
                        "--width", str(W), "--disp", str(d_max - 29),
                        "--seed", str(seed)]) == 0
        synth_s = time.perf_counter() - t0
        bands = auto_bands((H, W, 3), cfg)
        pics = os.path.join(scene_dir, "pics.txt")

        def run(n_bands: int, out: str) -> tuple:
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                assert cli(["run", "--pics", pics, "--out", out,
                            "--d_max", str(d_max),
                            "--bands", str(n_bands)]) == 0
            maps = os.path.join(out, "scene")
            return (time.perf_counter() - t0, log.getvalue(),
                    {art: png.read_gray(os.path.join(maps, art + ".png"))
                     for art in ("asw_disparity", "cross_based_initial",
                                 "cross_based_disparity")})

        cold_s, log, maps = run(0, os.path.join(tmp, "auto"))
        warm_s, _, _ = run(0, os.path.join(tmp, "auto"))
        assert f"auto bands -> {bands}" in log, log
        # The band drivers at this size, against the auto run.  ASW bands
        # are exact by construction; the cross bands run the taps OII and
        # a whole frame the prefix one, which differ at argmin ties and
        # are each held to the ground truth instead.
        n_banded = 2 if bands == 1 else bands + 1
        banded_s, _, banded = run(n_banded, os.path.join(tmp, "banded"))
        plan = _band_plan_memory(cfg, H, W, n_banded)
        gt, valid = read_pfm(os.path.join(scene_dir, "gt.pfm"))
        fields = {f"banded_{art}_agreement": agreement(banded[art], maps[art])
                  for art in maps}
        for tag, out in (("", maps), ("banded_", banded)):
            for art in ("asw_disparity", "cross_based_disparity"):
                check(art + " shape", out[art].shape == (H, W),
                      out[art].shape)
                fields[f"{tag}{art}_bad2_pct"] = bad_pixel_pct(
                    out[art] * d_max, gt, threshold=2.0, mask=valid)
    emit("mb2014_frame", shape=[H, W], bands=bands, synth_s=synth_s,
         cold_s=cold_s, warm_s=warm_s, compile_s=cold_s - warm_s,
         banded_bands=n_banded, banded_cold_s=banded_s, **plan, **fields)
    check("banded ASW agreement",
          fields["banded_asw_disparity_agreement"] >= MIN_MAP_AGREEMENT,
          fields["banded_asw_disparity_agreement"])
    # A local matcher on a textured fronto-parallel scene: most
    # non-occluded pixels within 2 disparities of the truth.
    for name, value in fields.items():
        if name.endswith("_bad2_pct"):
            check(name, value <= 10.0, value)


def _band_plan_memory(cfg, H: int, W: int, bands: int) -> dict:
    """Memory plan of the largest ASW band program at this band count
    (same geometry as models.tiled), and the cost-volume-equivalents it
    holds per row — what models.tiled._ASW_PLAN_FACTOR estimates."""
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu.models import tiled

    reach = tiled.asw_reach(cfg)
    keep = cfg.k_iters * cfg.radius + 1
    band = -(-H // bands)
    rows, crop = 0, (0, 0)
    for b in range(bands):
        y0, y1 = b * band, min(H, (b + 1) * band)
        lo, hi = max(0, y0 - reach), min(H, y1 + reach)
        if hi - lo > rows:
            rows = hi - lo
            crop = (max(0, y0 - lo - keep), max(0, hi - y1 - keep))
    img = jax.ShapeDtypeStruct((rows, W, 3), jnp.float32)
    compiled = tiled._asw_band_jit.lower(img, img, cfg, crop).compile()
    peak = peak_bytes(compiled)
    return {"band_program_rows": rows, "band_program_peak_bytes": peak,
            "volumes_per_row": peak / (cfg.num_disp * W * rows * 4),
            "memory_limit_bytes": tiled.device_memory_bytes()}


def phase_four(seed: int):
    """Sharded ASW and cross steps on three four-card meshes against the
    single-card pipelines on card 0: ASW and the cross final map
    bit-equal, cross-initial disagreements proven argmin ties.  Every
    mesh is checked and reported (unequal pixels listed) before a
    failure raises."""
    import jax
    import jax.numpy as jnp

    from stereo_matchin_tpu import MeshConfig, REFERENCE_CONFIG
    from stereo_matchin_tpu.eval import adjudicate_ties
    from stereo_matchin_tpu.models import asw, cross_based
    from stereo_matchin_tpu.parallel import (build_mesh, make_asw_sharded,
                                             make_cross_sharded)

    H, W = KITTI_ROWS4
    cfg = REFERENCE_CONFIG.replace(d_max=63)
    cross_cfg = cfg.replace(oii_impl="taps")
    frames = [scene(seed + i, H, W, 48) for i in range(4)]
    all_l = np.stack([f[0] for f in frames])
    all_r = np.stack([f[1] for f in frames])
    card0 = jax.devices()[0]
    ref_asw = jax.jit(lambda l, r: asw.asw_pipeline_impl(l, r, cfg))
    ref_cross = jax.jit(
        lambda l, r: cross_based.cross_pipeline_impl(l, r, cross_cfg))
    ref = [(ref_asw(*jax.device_put((all_l[i], all_r[i]), card0)),
            ref_cross(*jax.device_put((all_l[i], all_r[i]), card0)))
           for i in range(4)]
    failures = []
    for mesh_cfg in (MeshConfig(batch=4), MeshConfig(row=4),
                     MeshConfig(row=2, disp=2)):
        B = mesh_cfg.batch
        left, right = jnp.asarray(all_l[:B]), jnp.asarray(all_r[:B])
        mesh = build_mesh(mesh_cfg)
        out, t_asw = run_timed(make_asw_sharded(cfg, mesh), left, right,
                               warm=3)
        cout, t_cross = run_timed(make_cross_sharded(cross_cfg, mesh), left,
                                  right, warm=3)
        want = [ref[i] for i in range(B)]
        diffs = {
            "asw_disparity": mismatches(out.disparity,
                                        [a.disparity for a, _ in want]),
            "asw_filled": mismatches(out.filled, [a.filled for a, _ in want]),
            "cross_final": mismatches(cout.final, [c.final for _, c in want]),
        }
        try:
            n_tied = adjudicate_ties(
                cout.initial, np.stack([np.asarray(c.initial)
                                        for _, c in want]),
                lambda b: cross_based.cross_aggregated_cost(
                    jnp.asarray(all_l[b]), jnp.asarray(all_r[b]), cross_cfg))
        except AssertionError as e:
            n_tied = f"not all ties: {e}"
        emit("four_card", mesh=dict(batch=mesh_cfg.batch, row=mesh_cfg.row,
                                    disp=mesh_cfg.disp),
             frames=B, shape=[H, W], asw=t_asw, cross=t_cross,
             mismatched_pixels=diffs, cross_initial_ties=n_tied)
        failures += [f"{mesh_cfg}: {k} differs at {v}"
                     for k, v in diffs.items() if v]
        if isinstance(n_tied, str):
            failures.append(f"{mesh_cfg}: cross initial {n_tied}")
    if failures:
        raise AssertionError("; ".join(failures))


def mismatches(got, want, limit: int = 8) -> list:
    """(frame, row, col, got, want) of up to `limit` unequal pixels."""
    got = np.asarray(got)
    want = np.stack([np.asarray(w) for w in want])
    return [(int(b), int(y), int(x), float(got[b, y, x]),
             float(want[b, y, x]))
            for b, y, x in np.argwhere(got != want)[:limit]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path and its "
                         "single-card comparison")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devices, smi = phase_device(4 if args.four else 1)
    from stereo_matchin_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    if args.four:
        phase_four(args.seed)
    else:
        phase_asw_ref(args.seed)
        phase_cross_ref(args.seed)
        phase_kitti_stream(args.seed)
        phase_mb2014_frame(args.seed)
    print(smi, flush=True)
    print(ok_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
