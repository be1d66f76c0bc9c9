#!/usr/bin/env python3
"""EM knife-edge perturbation regression.

The round-4 side-gate waiver fixed the ihme *symptom*; the underlying
sensitivity — two competing triplets scoring nearly equally in the
horizon search, so an f32-level segment perturbation flips the winner —
is what makes every detector change expensive. This harness quantifies
it: for each bundled reference photo (and the most knife-edge scenes of
the fixed 50-scene synthetic set), run K jittered copies of the DETECTED
segment population through the production EM + horizon search and
measure

  - flip rate: fraction of jitters whose horizon error vs the
    reference figure / exact GT exceeds the 0.10 real-photo gate;
  - rel margin: (s1 - s2) / s1 between the top-2 triplet scores
    (em/horizon.py::triplet_score_margin), per jitter;
  - disagreement: how far the horizon would move if the runner-up
    triplet won (max |dy| at x = +-1, normalized frame units).

Jitter model: i.i.d. Gaussian endpoint noise (default sigma 0.5 px at
the 640 scale — the magnitude of LSD/detector nondeterminism across
implementations) plus 2% random segment dropout. Results print as a
BASELINE.md-ready table + a JSON blob; tests/test_knife_edge.py pins the
rates measured here.

Usage: python scripts/perturb_knife_edge.py [--device cpu] [--jitters 16]
       [--sigma_px 0.5] [--drop 0.02] [--scenes 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REF_EXAMPLES = "/root/reference/assets/examples"
REFERENCE_HORIZONS = [
    ("ihme_zentrum.jpg", 0.7701, 0.7743),
    ("uni_hannover.jpg", 0.7458, 0.7336),
    ("uni_hannover_lichthof.jpg", 0.3889, 0.3877),
]
FLIP_GATE = 0.10


def jitter_population(rng, lp, lmask, sigma_norm: float, drop: float):
    """One jittered copy of a padded segment population."""
    lp2 = lp.copy()
    n = int(lmask.sum())
    lp2[:n] += rng.normal(scale=sigma_norm, size=(n, 4)).astype(np.float32)
    keep = rng.random(n) >= drop
    mask2 = lmask.copy()
    mask2[:n] = keep
    # compact kept segments to the front (the detector emits a dense
    # prefix; EM math is mask-driven but keep the layout canonical)
    idx = np.concatenate([np.flatnonzero(mask2), np.flatnonzero(~mask2)])
    return lp2[idx], mask2[idx]


def run_populations(pipe, cfg, lps, masks):
    """Batch of padded (lp, lmask) populations -> per-item dict rows."""
    import jax
    import jax.numpy as jnp

    from vanishing_points_2017_tpu.em.horizon import triplet_score_margin
    from vanishing_points_2017_tpu.ops import lines as lineops
    from vanishing_points_2017_tpu.pipeline import device_pipeline_batch

    lp = jnp.asarray(np.stack(lps))
    m = jnp.asarray(np.stack(masks))
    l = jax.vmap(lineops.segments_to_homogeneous)(lp)
    l = jnp.where(m[..., None], l, 0.0)
    out = device_pipeline_batch(l, lp, m, pipe.params, pipe.mean, cfg)
    s1, s2, rel, dis = jax.vmap(
        lambda v, c, a: triplet_score_margin(
            v, c, a, maxbest=cfg.maxbest, theta_vmin=cfg.theta_vmin,
            pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)
    )(out["vp"], out["counts"], out["alive"])
    return {k: np.asarray(v) for k, v in dict(
        hp1=out["hp1"], hp2=out["hp2"], em_valid=out["em_valid"],
        s1=s1, s2=s2, rel_margin=rel, disagreement=dis).items()}


def photo_errs(res, image_shape, rl, rr):
    h, w = image_shape
    s = max(h, w) / 2.0
    fl = (h / 2.0 - res["hp1"][:, 1] * s) / h
    fr = (h / 2.0 - res["hp2"][:, 1] * s) / h
    return np.maximum(np.abs(fl - rl), np.abs(fr - rr))


def detect_device(pipe, cfg, gray):
    import jax.numpy as jnp

    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    lp, lmask = detect_segments_device(
        jnp.asarray(gray), max_segments=cfg.n_pad,
        min_count=cfg.det_min_count, min_len_px=cfg.det_min_len_px,
        min_density=cfg.det_min_density, ccl_impl=cfg.ccl_impl,
        selection=cfg.det_selection, max_records=cfg.det_max_records,
        topk_impl=cfg.det_topk)
    return np.asarray(lp), np.asarray(lmask)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--jitters", type=int, default=16)
    ap.add_argument("--sigma_px", type=float, default=0.5)
    ap.add_argument("--drop", type=float, default=0.02)
    ap.add_argument("--scenes", type=int, default=5,
                    help="how many lowest-margin synthetic scenes to probe")
    ap.add_argument("--scene_pool", type=int, default=50)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--consensus", type=int, default=0,
                    help="K>1 enables the bootstrap-consensus horizon "
                         "(PipelineConfig.horizon_consensus) so its "
                         "flip-rate effect is measured under the same "
                         "jitter protocol")
    ap.add_argument("--consensus_mode", default="dropout",
                    choices=("bootstrap", "dropout"))
    ap.add_argument("--consensus_guard", type=float, default=0.0)
    ap.add_argument("--photos_only", action="store_true",
                    help="skip the synthetic-scene probes (quick "
                         "consensus-mode comparisons)")
    ap.add_argument("--json_out", default="/tmp/knife_edge.json")
    args = ap.parse_args()

    if args.device:
        import jax
        jax.config.update("jax_platforms", args.device)

    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    from eval_device_detector import build_scene_set, scene_horizon_errors
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu import weights as wload

    cfg = PipelineConfig()
    if args.consensus > 1:
        cfg = dataclasses.replace(cfg, horizon_consensus=args.consensus,
                                  consensus_mode=args.consensus_mode,
                                  consensus_guard=args.consensus_guard)
    report_consensus = args.consensus
    params, mean = wload.load_params_and_mean(warn=False)
    pipe = Pipeline(params=params, mean=mean, cfg=cfg)
    sigma_norm = args.sigma_px * 2.0 / args.size
    rng = np.random.default_rng(args.seed)
    report = {"sigma_px": args.sigma_px, "drop": args.drop,
              "jitters": args.jitters, "consensus": report_consensus,
              "consensus_mode": args.consensus_mode,
              "consensus_guard": args.consensus_guard,
              "rows": []}

    def probe(name, lp0, m0, err_fn):
        lps, masks = [lp0], [m0]
        for _ in range(args.jitters):
            lp2, m2 = jitter_population(rng, lp0, m0, sigma_norm, args.drop)
            lps.append(lp2)
            masks.append(m2)
        res = run_populations(pipe, cfg, lps, masks)
        errs = err_fn(res)
        base_err, jerrs = errs[0], errs[1:]
        flips = int((jerrs > FLIP_GATE).sum())
        row = {"name": name, "base_err": float(base_err),
               "flip_rate": flips / args.jitters,
               "err_median": float(np.median(jerrs)),
               "err_max": float(jerrs.max()),
               "rel_margin_base": float(res["rel_margin"][0]),
               "rel_margin_min": float(res["rel_margin"][1:].min()),
               "rel_margin_median": float(np.median(res["rel_margin"][1:])),
               "disagreement_max": float(res["disagreement"].max())}
        report["rows"].append(row)
        print(f"{name:<28s} base {row['base_err']:.3f}  "
              f"flips {flips}/{args.jitters}  "
              f"err med/max {row['err_median']:.3f}/{row['err_max']:.3f}  "
              f"margin base/min/med {row['rel_margin_base']:.3f}/"
              f"{row['rel_margin_min']:.3f}/{row['rel_margin_median']:.3f}  "
              f"disagree_max {row['disagreement_max']:.3f}", flush=True)

    # ---- bundled reference photos (device-detected populations) ----
    if os.path.isdir(REF_EXAMPLES):
        for name, rl, rr in REFERENCE_HORIZONS:
            host = pipe.ingest_image(os.path.join(REF_EXAMPLES, name),
                                     target_size=640)
            lp0, m0 = detect_device(pipe, cfg, host["gray"])
            probe(name, lp0, m0,
                  lambda res, shape=host["image_shape"], a=rl, b=rr:
                  photo_errs(res, shape, a, b))
    else:
        print("(reference photos unavailable — skipping)")

    # ---- knife-edge synthetic scenes: lowest unperturbed margin ----
    if args.photos_only:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json_out} (photos only)")
        return 0
    scenes, images = build_scene_set(args.scene_pool, size=args.size)
    pops = [detect_device(pipe, cfg, img) for img in images]
    base = run_populations(pipe, cfg, [p[0] for p in pops],
                           [p[1] for p in pops])
    margins = base["rel_margin"]
    order = np.argsort(margins)[:args.scenes]
    print(f"scene margins: min {margins.min():.4f}  "
          f"median {np.median(margins):.4f}  "
          f"knife-edge picks: {sorted(order.tolist())}")
    report["scene_margin_median"] = float(np.median(margins))
    report["scene_picks"] = sorted(int(i) for i in order)

    for i in order:
        scene = scenes[i]

        def err_fn(res, scene=scene):
            return scene_horizon_errors(
                [scene] * res["hp1"].shape[0], res["hp1"], res["hp2"],
                args.size)

        probe(f"scene_{int(i):02d}", pops[i][0], pops[i][1], err_fn)

    with open(args.json_out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
