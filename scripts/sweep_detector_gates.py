#!/usr/bin/env python3
"""Arbitrate the device-detector noise gates (TODO item 5b, round 3).

Sweeps detector variants — (min_count, min_len_px, min_density),
runs_per_row, and the selection strategy (row | global) — over two
protocols at once:

  * the reference's 3 bundled real photographs with an in-frame horizon
    (expected fractional rows extracted from its published result
    figures — same data as tests/test_real_photos.py), scoring the max
    horizon-row error per photo;
  * K rendered synthetic scenes with exact GT horizons, scoring
    AUC@0.25 (same protocol as scripts/eval_device_detector.py).

DECOMPOSED execution: the detector is jitted per variant (small, fast
compiles) and feeds ONE compiled lines-in pipeline program
(`device_pipeline_batch`), instead of recompiling the fused
`device_pipeline_full` for every config — that made the original
whole-pipeline sweep ~10x slower per grid point on CPU.

Round-3 findings this script produced (BASELINE.md real-photo section):
fixed count/length gates cannot cover both the outdoor facades and the
glass-roof atrium; LSD's region-to-rectangle density test
(min_density=0.7) rejects the meandering micro-texture chains on all
three AND improves synthetic AUC; runs_per_row must be >= 64 for real
photos (p99 142 runs/row); the ihme facade sits on an EM triplet-choice
knife edge — nearby configs flip it between ~0.04 and ~0.3-0.6.

Usage: python scripts/sweep_detector_gates.py [--device cpu]
       [--count 16] [--size 640]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REF_EXAMPLES = "/root/reference/assets/examples"
REFERENCE_HORIZONS = [
    ("ihme_zentrum.jpg", 0.7701, 0.7743),
    ("uni_hannover.jpg", 0.7458, 0.7336),
    ("uni_hannover_lichthof.jpg", 0.3889, 0.3877),
]

# (selection, runs_per_row/max_records, min_count, min_len_px, min_density)
# a "global!" selection = global with topk_impl="approx"
# (jax.lax.approx_max_k, which keeps the exact records on GPU and CPU)
VARIANTS = [
    ("row", 64, 15, 12.0, 0.70),     # row fallback
    ("row", 64, 15, 10.0, 0.70),
    ("row", 64, 15, 12.0, 0.00),     # density gate off
    ("row", 48, 15, 12.0, 0.70),     # budget too small for real photos
    ("global", 32768, 15, 12.0, 0.70),   # shipped defaults
    ("global", 16384, 15, 12.0, 0.70),
    ("global!", 32768, 15, 12.0, 0.70),  # approx top-k candidate
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--count", type=int, default=16)
    ap.add_argument("--size", type=int, default=640)
    args = ap.parse_args()
    if args.device:
        import jax
        jax.config.update("jax_platforms", args.device)

    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    import jax
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.data import datasets as dsets
    from vanishing_points_2017_tpu.metrics import calc_auc
    from vanishing_points_2017_tpu.models import synth
    from vanishing_points_2017_tpu.ops import lines as lineops
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)
    from vanishing_points_2017_tpu.pipeline import (
        Pipeline, PipelineConfig, device_pipeline_batch)
    from vanishing_points_2017_tpu import weights as wload

    params, mean = wload.load_params_and_mean(warn=False)
    cfg = PipelineConfig()
    pipe = Pipeline(params=params, mean=mean, cfg=cfg)
    mean_j = jnp.asarray(mean)

    photos = []
    if os.path.isdir(REF_EXAMPLES):
        for name, rl, rr in REFERENCE_HORIZONS:
            host = pipe.ingest_image(os.path.join(REF_EXAMPLES, name),
                                     target_size=args.size)
            photos.append((name, rl, rr,
                           jnp.asarray(host["gray"].astype(np.float32)),
                           host["image_shape"]))

    rng = np.random.default_rng(7)
    scenes, simgs = [], []
    for _ in range(args.count):
        sc = synth.make_scene(rng, lines_per_vp=int(rng.integers(25, 60)),
                              outliers=int(rng.integers(5, 25)))
        scenes.append(sc)
        simgs.append(jnp.asarray(np.asarray(
            dsets.render_scene_image(sc, size=args.size, rng=rng),
            np.float32)))

    def run_lines(lps, masks):
        lps = jnp.asarray(np.stack(lps))
        masks = jnp.asarray(np.stack(masks))
        l = jax.vmap(lineops.segments_to_homogeneous)(lps)
        l = jnp.where(masks[..., None], l, 0.0)
        return device_pipeline_batch(l, lps, masks, params, mean_j, cfg)

    def frac_rows(hp1, hp2, shape):
        h, w = shape
        s = max(h, w) / 2.0
        return ((h / 2.0 - float(hp1[1]) * s) / h,
                (h / 2.0 - float(hp2[1]) * s) / h)

    print(f"{'sel':>7} {'budget':>6} {'cnt':>3} {'len':>4} {'dens':>4} "
          "| photo errs -> worst | synthAUC")
    for sel, budget, cnt, ln, dens in VARIANTS:
        kw = dict(max_segments=512, min_count=cnt, min_len_px=ln,
                  min_density=dens, selection=sel.rstrip("!"))
        if sel.endswith("!"):
            kw["topk_impl"] = "approx"
        if sel.startswith("global"):
            kw["max_records"] = budget
        else:
            kw["runs_per_row"] = budget
        det = lambda im, kw=kw: detect_segments_device(im, **kw)

        errs = []
        if photos:
            lps, masks = [], []
            for name, rl, rr, img, shape in photos:
                s, m = det(img)
                lps.append(np.asarray(s))
                masks.append(np.asarray(m))
            out = run_lines(lps, masks)
            for i, (name, rl, rr, img, shape) in enumerate(photos):
                if not bool(np.asarray(out["em_valid"])[i]):
                    errs.append(float("nan"))
                    continue
                fl, fr = frac_rows(np.asarray(out["hp1"])[i],
                                   np.asarray(out["hp2"])[i], shape)
                errs.append(max(abs(fl - rl), abs(fr - rr)))

        slps, smasks = [], []
        for img in simgs:
            s, m = det(img)
            slps.append(np.asarray(s))
            smasks.append(np.asarray(m))
        sout = run_lines(slps, smasks)
        serrs = []
        for j in range(len(simgs)):
            est = np.cross(np.asarray(sout["hp1"])[j],
                           np.asarray(sout["hp2"])[j])
            serrs.append(dsets.normalized_horizon_error(
                est, scenes[j].horizon.astype(np.float64),
                width=args.size, height=args.size))
        auc, _ = calc_auc(np.asarray(serrs), 0.25)
        estr = " ".join(f"{e:5.3f}" for e in errs) if errs else "(no photos)"
        # np.max propagates NaN (a photo that lost EM validity must
        # read as a failed config, not be silently ignored by max())
        worst = float(np.max(errs)) if errs else float("nan")
        print(f"{sel:>7} {budget:>6} {cnt:>3} {ln:>4.1f} {dens:>4.2f} "
              f"| {estr} -> {worst:5.3f} | {auc:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
