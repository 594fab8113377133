"""Command-line interface — the reference binary's workflow, grown up.

The reference is a console program driven by `pics.txt` that runs both
methods on every pair and dumps PNGs + a timing file per device
(main.cpp:134-156,166,357-367,621-631).  Equivalents:

  python -m stereo_matchin_tpu run   --pairs tsukuba teddy --out out/
  python -m stereo_matchin_tpu run   --pics pics.txt --method asw
  python -m stereo_matchin_tpu bench --pairs tsukuba --runs 10
  python -m stereo_matchin_tpu eval  --pairs tsukuba teddy

`run` writes the same artifact set as the reference into <out>/<pair>/:
cross_based_initial.png, cross_based_disparity.png, median.png,
asw_disparity.png, asw_consistency_pre-reff.png,
asw_consistency_post-reff.png.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _config_from_args(args):
    from .config import StereoConfig

    kw = {}
    for f in ("d_max", "radius", "arm_len", "r_iters", "k_iters",
              "oii_impl"):
        v = getattr(args, f, None)
        if v is not None:
            kw[f] = v
    return StereoConfig(**kw)


def _resolve_pairs(args):
    from .io import REGISTRY, parse_pics_txt

    if getattr(args, "pics", None):
        return parse_pics_txt(args.pics)
    names = args.pairs or ["tsukuba"]
    return [REGISTRY[n] for n in names]


def cmd_run(args) -> int:
    import jax.numpy as jnp

    from .io import png
    from .models import asw, cross_based

    cfg = _config_from_args(args)
    pairs = _resolve_pairs(args)
    # Prefetch-decode the next pair on a worker thread while the device
    # computes the current one (the reference decodes synchronously on
    # the host thread, main.cpp:184-186).  The loader lives in the
    # native runtime package; fall back to inline decode without it.
    try:
        from runtime.loader import PairLoader

        decoded = iter(PairLoader([(p.left, p.right) for p in pairs],
                                  depth=2))
    except ImportError:
        decoded = ((png.read_rgb(p.left), png.read_rgb(p.right))
                   for p in pairs)
    for pair, (left_np, right_np) in zip(pairs, decoded):
        # Never let a pair name escape --out (absolute paths / parents).
        from .io.datasets import safe_pair_name
        out_dir = os.path.join(args.out, safe_pair_name(pair.name))
        os.makedirs(out_dir, exist_ok=True)
        left = jnp.asarray(left_np)
        right = jnp.asarray(right_np)
        bands = args.bands
        if bands == 0:  # auto: from the device's memory limit
            from .models.tiled import auto_bands
            bands = auto_bands(left.shape, cfg)
            print(f"{pair.name}: auto bands -> {bands}")
        t0 = time.perf_counter()
        if args.method in ("both", "cross"):
            if bands > 1:
                from .models.tiled import cross_pipeline_tiled

                initial, final = cross_pipeline_tiled(left, right, cfg,
                                                      bands)
            else:
                res = cross_based.cross_pipeline(left, right, cfg)
                initial, final = res.initial, res.final
                png.write_rgb(os.path.join(out_dir, "median.png"),
                              np.asarray(res.median_left))
            png.write_gray(os.path.join(out_dir, "cross_based_initial.png"),
                           np.asarray(initial))
            png.write_gray(os.path.join(out_dir, "cross_based_disparity.png"),
                           np.asarray(final))
        if args.method in ("both", "asw"):
            if bands > 1:
                from .models.tiled import asw_pipeline_tiled

                disparity, _ = asw_pipeline_tiled(left, right, cfg, bands)
                png.write_gray(os.path.join(out_dir, "asw_disparity.png"),
                               np.asarray(disparity))
            else:
                res = asw.asw_pipeline(left, right, cfg)
                png.write_gray(os.path.join(out_dir, "asw_disparity.png"),
                               np.asarray(res.disparity))
                png.write_rgb(
                    os.path.join(out_dir, "asw_consistency_pre-reff.png"),
                    np.asarray(res.consistency_pre))
                png.write_rgb(
                    os.path.join(out_dir, "asw_consistency_post-reff.png"),
                    np.asarray(res.consistency_post))
        print(f"{pair.name}: artifacts in {out_dir} "
              f"({time.perf_counter() - t0:.2f}s incl. compile)")
    return 0


def cmd_bench(args) -> int:
    from .bench import run_benchmark

    cfg = _config_from_args(args)
    names = args.pairs or ["tsukuba"]
    path = run_benchmark(names, cfg, runs=args.runs, out_dir=args.out)
    print(f"per-stage report: {path}")
    return 0


def _parse_gt_args(entries):
    """--gt entries are '<pair>=<path>' (or a bare path for a single pair)."""
    gt = {}
    for e in entries or []:
        name, sep, path = e.partition("=")
        if not sep:
            gt[None] = e  # bare path: applies to the sole --pairs entry
        else:
            gt[name] = path
    return gt


def cmd_eval(args) -> int:
    import jax.numpy as jnp

    from .eval import bad_pixel_pct, compare_to_golden
    from .io import load_pair
    from .io.groundtruth import read_groundtruth
    from .models import asw, cross_based

    cfg = _config_from_args(args)
    gt_by_pair = _parse_gt_args(args.gt)
    names = args.pairs or ["tsukuba"]
    if None in gt_by_pair:
        if len(names) != 1:
            print("--gt without '<pair>=' needs exactly one --pairs entry",
                  file=sys.stderr)
            return 2
        gt_by_pair[names[0]] = gt_by_pair.pop(None)
    failed = False

    def score_gt(name, label, img01):
        gt_path = gt_by_pair.get(name)
        if gt_path is None:
            return
        gt, valid = read_groundtruth(gt_path, scale=args.gt_scale)
        got = np.asarray(img01, np.float64) * cfg.d_max
        if got.shape != gt.shape:
            print(f"{name}/{label}: GT shape {gt.shape} != map {got.shape}",
                  file=sys.stderr)
            return
        b1 = bad_pixel_pct(got, gt, threshold=1.0, mask=valid)
        b2 = bad_pixel_pct(got, gt, threshold=2.0, mask=valid)
        print(f"{name}/{label} vs GT: bad1={b1:.2f}% bad2={b2:.2f}% "
              f"(valid {valid.mean() * 100:.1f}%)")

    for name in names:
        left, right = map(jnp.asarray, load_pair(name))
        if args.method in ("both", "cross"):
            res = cross_based.cross_pipeline(left, right, cfg)
            for art, img in (("cross_based_initial.png", res.initial),
                             ("cross_based_disparity.png", res.final)):
                c = compare_to_golden(np.asarray(img), name, art, cfg.d_max)
                print(f"{name}/{art}: {c}")
                failed |= c.bad2_pct > 1.0
            score_gt(name, "cross_based_disparity", res.final)
        if args.method in ("both", "asw"):
            res = asw.asw_pipeline(left, right, cfg)
            c = compare_to_golden(np.asarray(res.disparity), name,
                                  "asw_disparity.png", cfg.d_max)
            print(f"{name}/asw_disparity.png: {c}")
            failed |= c.bad2_pct > 1.0
            score_gt(name, "asw_disparity", res.disparity)
    return 1 if failed else 0


def cmd_synth(args) -> int:
    """Generate a synthetic stereo pair with known ground truth — a
    self-contained way to exercise the full run→eval-vs-GT loop without
    Middlebury data on disk."""
    from .eval.synthetic import synthetic_scene
    from .io import png
    from .io.groundtruth import write_pfm

    rng = np.random.default_rng(args.seed)
    left, right, gt, mask = synthetic_scene(rng, args.height, args.width,
                                            args.disp)
    os.makedirs(args.out, exist_ok=True)
    lp = os.path.join(args.out, "imL.png")
    rp = os.path.join(args.out, "imR.png")
    png.write_rgb(lp, left)
    png.write_rgb(rp, right)
    write_pfm(os.path.join(args.out, "gt.pfm"), gt, invalid_mask=~mask)
    with open(os.path.join(args.out, "pics.txt"), "w") as f:
        f.write(f"{lp}\n{rp}\n")
    print(f"scene in {args.out}: imL/imR.png ({args.height}x{args.width}, "
          f"max disparity {args.disp}), gt.pfm (nonocc mask), pics.txt")
    print(f"  run:  python -m stereo_matchin_tpu run --pics "
          f"{args.out}/pics.txt --out {args.out}/maps")
    return 0


def main(argv=None) -> int:
    from .utils import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser(prog="stereo_matchin_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--pairs", nargs="*", default=None,
                       help="registered pair names (default: tsukuba)")
        p.add_argument("--method", choices=["both", "cross", "asw"],
                       default="both")
        for f in ("d_max", "radius", "arm_len", "r_iters", "k_iters"):
            p.add_argument(f"--{f}", type=int, default=None)
        p.add_argument("--oii_impl", choices=["auto", "prefix", "taps"],
                       default=None,
                       help="cross-method OII/vote implementation")

    p_run = sub.add_parser("run", help="run pipelines, write PNG artifacts")
    common(p_run)
    p_run.add_argument("--pics", default=None,
                       help="reference-format pics.txt with pair paths")
    p_run.add_argument("--out", default="out")
    p_run.add_argument("--bands", type=int, default=1,
                       help="row-band tiling for frames whose working set "
                            "exceeds device memory; disparity maps only; "
                            "0 = auto from the device's memory limit "
                            "(models.tiled.auto_bands)")
    p_run.set_defaults(fn=cmd_run)

    p_bench = sub.add_parser("bench", help="per-stage TSV benchmark")
    common(p_bench)
    p_bench.add_argument("--runs", type=int, default=10)
    p_bench.add_argument("--out", default="bench_out")
    p_bench.set_defaults(fn=cmd_bench)

    p_eval = sub.add_parser("eval", help="compare outputs to goldens")
    common(p_eval)
    p_eval.add_argument("--gt", nargs="*", default=None, metavar="PAIR=PATH",
                        help="ground-truth disparity files (.pfm/.pgm/.png); "
                             "bad-pixel rates are printed per final map")
    p_eval.add_argument("--gt-scale", type=float, default=None,
                        help="stored-value-per-disparity override "
                             "(defaults: pfm 1, pgm 16, png 4)")
    p_eval.set_defaults(fn=cmd_eval)

    p_synth = sub.add_parser(
        "synth", help="generate a synthetic pair + ground-truth PFM")
    p_synth.add_argument("--out", default="synth")
    p_synth.add_argument("--width", type=int, default=384)
    p_synth.add_argument("--height", type=int, default=288)
    p_synth.add_argument("--disp", type=int, default=24,
                         help="scene's maximum disparity in pixels")
    p_synth.add_argument("--seed", type=int, default=0)
    p_synth.set_defaults(fn=cmd_synth)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
