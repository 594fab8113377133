"""Per-stage benchmark harness reproducing the reference's timing report.

The reference writes a tab-separated file named after the device
(`main.cpp:166`), one header (`main.cpp:181`) and one row per run with
per-kernel event times and totals (`main.cpp:394-411,634-708`).  This
harness reproduces that artifact from stage-jitted pipeline pieces so the
columns are comparable:

  * cross method: medL_solo medR_solo med_full cross_h cross_v cross_full
    aggregation integral_h aggr_h integral_v aggr_v init_disp final_disp
    cross_method_total  (the taps implementation folds integral+window
    into one pass; the integral_* columns then read 0.000 and the pass
    cost lands in aggr_h/aggr_v, keeping the totals comparable)
  * ASW method: aggr supp_w v_aggr_mean h_aggr_mean total_aggregation wta
    consistency v_ref_mean_L v_ref_mean_R h_ref_mean_L h_ref_mean_R
    wta_mean_LR consistency_mean total_refinement median total_wta_method

Timing note: StageTimer dispatches each stage `reps` times (default 8)
and waits once with `jax.block_until_ready`, dividing by reps — the
device queue is serial, so N dispatches + one wait time N runs plus one
dispatch latency, amortised over N.  Stages are timed one at a time, so
unlike the fused pipeline they never overlap.
"""

from __future__ import annotations

import os
import time
 
from functools import lru_cache, partial
from typing import Callable, Dict, List


import jax
import jax.numpy as jnp

from .. import kernels, ops
from ..config import StereoConfig

# Column remapping vs the reference TSV: the reference's cross_h/cross_v
# are its horizontal/vertical cross kernels; here each _arms_stage call
# computes ALL FOUR arms of one image, so cross_h carries the LEFT image's
# arms and cross_v the RIGHT image's.  cross_full (their sum) and the
# method total remain directly comparable; the two sub-columns are not.
CROSS_COLUMNS = [
    "medL_solo", "medR_solo", "med_full", "cross_h", "cross_v", "cross_full",
    "aggregation", "integral_h", "aggr_h", "integral_v", "aggr_v",
    "init_disp", "final_disp", "cross method total",
]
ASW_COLUMNS = [
    "aggr", "supp_w", "v_aggr_mean", "h_aggr_mean", "total aggregation",
    "wta", "consistency", "v_ref_mean_L", "v_ref_mean_R", "h_ref_mean_L",
    "h_ref_mean_R", "wta_mean_LR", "consistency_mean", "total refinement",
    "median", "total WTA method",
]


def _sync(out) -> None:
    jax.block_until_ready(out)


class StageTimer:
    """Times callables with the sync bracket; accumulates named stages.

    reps: dispatches per sync (floor amortisation, see module docstring).
    The stage functions are pure, so re-dispatching is side-effect-free;
    the first call's output is returned for the pipeline dataflow.
    """

    def __init__(self, reps: int = 8):
        self.times: Dict[str, float] = {}
        self.reps = max(1, reps)

    def run(self, name: str, fn: Callable, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        extra = None
        for _ in range(self.reps - 1):
            extra = fn(*args)
        _sync(extra if extra is not None else out)
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0) * 1000.0 / self.reps
        return out

    def ms(self, name: str) -> float:
        return self.times.get(name, 0.0)


def _device_name() -> str:
    d = jax.devices()[0]
    return getattr(d, "device_kind", None) or d.platform


def time_cross_method(left, right, cfg: StereoConfig) -> Dict[str, float]:
    """One timed run of the cross pipeline, stage by stage."""
    from ..models import cross_based as cb

    t = StageTimer()
    ml = t.run("medL_solo", cb._median_stage, left)
    mr = t.run("medR_solo", cb._median_stage, right)
    arms_l = t.run("cross_h", cb._arms_stage, ml, cfg.arm_len, cfg.tau,
                   cfg.legacy_cross_arm_quirk)
    arms_r = t.run("cross_v", cb._arms_stage, mr, cfg.arm_len, cfg.tau,
                   cfg.legacy_cross_arm_quirk)
    cost = t.run("aggregation", cb._sad_stage, ml, mr, cfg.num_disp)
    aggr = t.run("aggr_h", cb._aggr_stage, cost, arms_l, arms_r,
             cfg.arm_len, cfg.oii_impl)
    initial = t.run("init_disp", cb._init_stage, aggr, cfg.d_max,
                    cfg.quantize_maps)
    t.run("final_disp", cb._vote_stage, initial, arms_l, cfg.d_max,
          cfg.quantize_maps, cfg.arm_len, cfg.oii_impl)
    times = dict(t.times)
    times["med_full"] = times["medL_solo"] + times["medR_solo"]
    times["cross_full"] = times["cross_h"] + times["cross_v"]
    times["integral_h"] = 0.0   # folded into aggr_h by the taps impl
    times["integral_v"] = 0.0
    times["aggr_v"] = 0.0
    times["cross method total"] = sum(
        times[k] for k in ("med_full", "cross_full", "aggregation", "aggr_h",
                           "init_disp", "final_disp"))
    return times


def _aggregate_pass(cost, w_left, w_right, axis: int, radius: int,
                    eps: float):
    """One aggregation pass, denominator included: the Triton kernel on
    the GPU (kernels.on_gpu), ops.asw_aggregate_pass elsewhere."""
    D, H, W = cost.shape

    def kernel(c, wl, wr):
        den = kernels.asw_den(wl, wr, D, radius, eps)
        return kernels.asw_pass(c, wl, wr, den, axis, radius, eps)[:D, :H, :W]

    return kernels.on_gpu(
        cost, w_left, w_right, gpu=kernel,
        default=lambda c, wl, wr: ops.asw_aggregate_pass(
            c, wl, wr, axis=axis, radius=radius, eps=eps)[0])


@lru_cache(maxsize=8)
def _asw_stage_jits(cfg: StereoConfig):
    """Stage-level jits for one config — cached so repeated timed runs hit
    the jit cache instead of recompiling (jax.jit keys on function
    identity; a fresh partial() every call would recompile)."""
    R = cfg.radius
    return {
        "sad": jax.jit(partial(ops.sad_cost_volume, num_disp=cfg.num_disp,
                               scale=255.0)),
        "sup_v": jax.jit(partial(ops.support_weights, radius=R,
                                 gamma_c=cfg.gamma_c, gamma_p=cfg.gamma_p,
                                 axis=0)),
        "sup_h": jax.jit(partial(ops.support_weights, radius=R,
                                 gamma_c=cfg.gamma_c, gamma_p=cfg.gamma_p,
                                 axis=1)),
        "vpass": jax.jit(partial(_aggregate_pass, axis=1, radius=R,
                                 eps=cfg.eps)),
        "hpass": jax.jit(partial(_aggregate_pass, axis=2, radius=R,
                                 eps=cfg.eps)),
        "wta": jax.jit(partial(ops.wta_fast, big=cfg.big)),
        "cons": jax.jit(ops.consistency),
        "rw": jax.jit(partial(ops.refinement_weights, radius=R,
                              gamma_c=cfg.ref_gamma_c,
                              gamma_p=cfg.ref_gamma_p)),
        "ref_v": jax.jit(partial(ops.refine_pass_v, radius=R, eps=cfg.eps)),
        "ref_h": jax.jit(partial(ops.refine_pass_h, radius=R, eps=cfg.eps)),
        "wta_ref": jax.jit(partial(ops.wta_refined_fast, penalty=cfg.penalty,
                                   big=cfg.big)),
        "median": jax.jit(ops.median3x3),
    }


def time_asw_method(left, right, cfg: StereoConfig) -> Dict[str, float]:
    """One timed run of the ASW pipeline, stage by stage (same dataflow as
    models.asw.asw_pipeline_impl)."""
    t = StageTimer()
    j = _asw_stage_jits(cfg)
    sad, sup, suph = j["sad"], j["sup_v"], j["sup_h"]
    cost0 = t.run("aggr", sad, left, right)
    wv_l = t.run("supp_w", sup, left)
    wv_r = t.run("supp_w", sup, right)
    wh_l = t.run("supp_w", suph, left)
    wh_r = t.run("supp_w", suph, right)

    vpass, hpass = j["vpass"], j["hpass"]
    c = cost0
    for _ in range(cfg.r_iters):
        c = t.run("v_aggr", vpass, c, wv_l, wv_r)
        c = t.run("h_aggr", hpass, c, wh_l, wh_r)
    aggr = c

    res = t.run("wta", j["wta"], aggr)
    q = partial(ops.quantize_disparity, d_max=cfg.d_max,
                enabled=cfg.quantize_maps)
    cons_j = j["cons"]
    cons = t.run("consistency", cons_j, q(res.disp_ref), q(res.disp_target),
                 res.conf_ref, res.conf_target)

    rv_l, rh_l = j["rw"](left)
    rv_r, rh_r = j["rw"](right)
    refine_v, refine_h = j["ref_v"], j["ref_h"]
    wta_ref_j = j["wta_ref"]

    filled_q, right_q = cons.filled, q(res.disp_target)
    conf_ref, conf_tar = cons.conf_ref, cons.conf_target
    for _ in range(cfg.k_iters):
        vv_l, dv_l = t.run("v_ref_L", refine_v, rv_l, filled_q, conf_ref)
        val_l, den_l = t.run("h_ref_L", refine_h, rh_l, vv_l, dv_l, conf_ref)
        vv_r, dv_r = t.run("v_ref_R", refine_v, rv_r, right_q, conf_tar)
        val_r, den_r = t.run("h_ref_R", refine_h, rh_r, vv_r, dv_r, conf_tar)
        r = t.run("wta_ref", wta_ref_j, aggr, val_l, den_l, val_r, den_r)
        cr = r.conf_target if cfg.wta_ref_conf_bug else r.conf_ref
        ct = conf_tar if cfg.wta_ref_conf_bug else r.conf_target
        right_q = q(r.disp_target)
        cres = t.run("consistency_ref", cons_j, q(r.disp_ref), right_q, cr, ct)
        filled_q, conf_ref, conf_tar = cres.filled, cres.conf_ref, cres.conf_target

    t.run("median", j["median"],
          ops.image_from_q(filled_q, cfg.d_max) if cfg.quantize_maps
          else ops.to_unit(filled_q, cfg.d_max))

    k = max(cfg.k_iters, 1)
    times = {
        "aggr": t.ms("aggr"),
        "supp_w": t.ms("supp_w"),
        "v_aggr_mean": t.ms("v_aggr") / max(cfg.r_iters, 1),
        "h_aggr_mean": t.ms("h_aggr") / max(cfg.r_iters, 1),
        "total aggregation": t.ms("v_aggr") + t.ms("h_aggr"),
        "wta": t.ms("wta"),
        "consistency": t.ms("consistency"),
        "v_ref_mean_L": t.ms("v_ref_L") / k,
        "v_ref_mean_R": t.ms("v_ref_R") / k,
        "h_ref_mean_L": t.ms("h_ref_L") / k,
        "h_ref_mean_R": t.ms("h_ref_R") / k,
        "wta_mean_LR": t.ms("wta_ref") / k,
        "consistency_mean": t.ms("consistency_ref") / k,
        "median": t.ms("median"),
    }
    times["total refinement"] = (t.ms("v_ref_L") + t.ms("v_ref_R") +
                                 t.ms("h_ref_L") + t.ms("h_ref_R") +
                                 t.ms("wta_ref") + t.ms("consistency_ref"))
    times["total WTA method"] = (times["aggr"] + times["supp_w"] +
                                 times["total aggregation"] + times["wta"] +
                                 times["consistency"] +
                                 times["total refinement"] + times["median"])
    return times


def run_benchmark(pair_names: List[str], cfg: StereoConfig, runs: int = 10,
                  out_dir: str = "bench_out") -> str:
    """Full reference-style benchmark: all pairs x `runs`, TSV per device."""
    from ..io import load_pair

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{_device_name()}.tsv")
    with open(path, "w") as f:
        for name in pair_names:
            l, r = load_pair(name)
            left, right = jnp.asarray(l), jnp.asarray(r)
            f.write(f"\n{_device_name()} - {name}\n")
            f.write("id\t" + "\t".join(CROSS_COLUMNS) + "\t\t\t" +
                    "\t".join(ASW_COLUMNS) + "\n")
            # Warmup/compile run (not recorded), like the reference's
            # separately-reported first iteration.
            time_cross_method(left, right, cfg)
            time_asw_method(left, right, cfg)
            for run in range(runs):
                ct = time_cross_method(left, right, cfg)
                at = time_asw_method(left, right, cfg)
                row = [f"Run {run + 1}"]
                row += [f"{ct[c]:.3f}" for c in CROSS_COLUMNS]
                row += ["", ""]
                row += [f"{at[c]:.3f}" for c in ASW_COLUMNS]
                f.write("\t".join(row) + "\n")
    return path
