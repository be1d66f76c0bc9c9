#!/usr/bin/env python3
"""AUC parity harness: host-LSD path vs the zero-host-round-trip path.

Runs the 50-scene synthetic benchmark (same protocol as
``benchmark.py --synthetic``) through both pipelines and prints the
horizon-error AUC@0.25 for each, plus the device-segments + ideal-prior
decomposition. The acceptance criterion is device-full AUC within 0.02
of the host path.

Usage: python scripts/eval_device_detector.py [--device cpu] [--count 50]
       [--batch 10] [--paths host,full,ideal]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_scene_set(count: int, size: int = 640, seed: int = 7):
    """The 50-scene synthetic AUC protocol's scene set — fixed seed so
    every AUC measured against it (BASELINE.md rounds 2-5, the
    re-validation gate) is comparable. Returns (scenes, rendered uint8
    images)."""
    from vanishing_points_2017_tpu.data import datasets as dsets
    from vanishing_points_2017_tpu.models import synth

    rng = np.random.default_rng(seed)
    scenes, images = [], []
    for _ in range(count):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(25, 60)),
                                 outliers=int(rng.integers(5, 25)))
        scenes.append(scene)
        images.append(dsets.render_scene_image(scene, size=size, rng=rng))
    return scenes, images


def scene_horizon_errors(scenes, hp1s, hp2s, size: int):
    from vanishing_points_2017_tpu.data import datasets as dsets

    errs = []
    for scene, hp1, hp2 in zip(scenes, hp1s, hp2s):
        est = np.cross(np.asarray(hp1, np.float64),
                       np.asarray(hp2, np.float64))
        errs.append(dsets.normalized_horizon_error(
            est, scene.horizon.astype(np.float64),
            width=size, height=size))
    return np.array(errs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--count", type=int, default=50)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--paths", default="host,full",
                    help="comma list: host, full, ideal")
    ap.add_argument("--det_selection", default=None,
                    help="override PipelineConfig.det_selection "
                         "(row | global)")
    ap.add_argument("--det_topk", default=None,
                    help="override PipelineConfig.det_topk "
                         "(exact | approx; the same records on GPU and CPU)")
    ap.add_argument("--horizon_tol", type=float, default=None,
                    help="override PipelineConfig.horizon_pos_gate_tol "
                         "(inf = exact reference gating)")
    ap.add_argument("--cnn_dtype", default=None,
                    help="override PipelineConfig.cnn_dtype "
                         "(float32 | bfloat16) for the bf16-default "
                         "AUC-delta measurement")
    args = ap.parse_args()

    if args.device:
        import jax
        jax.config.update("jax_platforms", args.device)

    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    import jax
    import jax.numpy as jnp

    from vanishing_points_2017_tpu.data import io as dio
    from vanishing_points_2017_tpu.data import datasets as dsets
    from vanishing_points_2017_tpu.metrics import calc_auc
    from vanishing_points_2017_tpu.models import synth
    from vanishing_points_2017_tpu.pipeline import (
        Pipeline, PipelineConfig, device_pipeline_batch,
        device_pipeline_full, pad_lines)
    from vanishing_points_2017_tpu import weights as wload

    import dataclasses
    cfg = PipelineConfig()
    if args.det_selection:
        cfg = dataclasses.replace(cfg, det_selection=args.det_selection)
    if args.det_topk:
        cfg = dataclasses.replace(cfg, det_topk=args.det_topk)
    if args.horizon_tol is not None:
        cfg = dataclasses.replace(cfg, horizon_pos_gate_tol=args.horizon_tol)
    if args.cnn_dtype:
        cfg = dataclasses.replace(cfg, cnn_dtype=args.cnn_dtype)
    params, mean = wload.load_params_and_mean(warn=False)
    pipe = Pipeline(params=params, mean=mean, cfg=cfg)
    paths = args.paths.split(",")

    scenes, images = build_scene_set(args.count, size=args.size)

    def horizon_errors(hp1s, hp2s):
        return scene_horizon_errors(scenes, hp1s, hp2s, args.size)

    results = {}

    # ---- path A: host LSD -> fused device program ----
    if "host" in paths:
        t0 = time.time()
        bundles = []
        for img in images:
            det = dio.detect_lsd_lines(img.astype(np.float64))
            l, lp, m = pad_lines(det["segments"], cfg.n_pad)
            bundles.append((l, lp, m))
        t_lsd = time.time() - t0
        hp1s, hp2s = [], []
        t0 = time.time()
        for i in range(0, args.count, args.batch):
            chunk = bundles[i:i + args.batch]
            while len(chunk) < args.batch:
                chunk = chunk + [chunk[-1]]
            out = device_pipeline_batch(
                jnp.asarray(np.stack([c[0] for c in chunk])),
                jnp.asarray(np.stack([c[1] for c in chunk])),
                jnp.asarray(np.stack([c[2] for c in chunk])),
                pipe.params, pipe.mean, cfg)
            n = min(args.batch, args.count - i)
            hp1s += list(np.asarray(out["hp1"])[:n])
            hp2s += list(np.asarray(out["hp2"])[:n])
        t_dev = time.time() - t0
        errs = horizon_errors(hp1s, hp2s)
        auc, _ = calc_auc(errs, 0.25)
        results["host"] = auc
        print(f"host-LSD path:   AUC {auc:.4f}  (lsd {t_lsd:.1f}s + "
              f"device {t_dev:.1f}s for {args.count} imgs)")

    # ---- path B: fully fused (device detector) ----
    if "full" in paths:
        hp1s, hp2s, masks = [], [], []
        t0 = time.time()
        for i in range(0, args.count, args.batch):
            chunk = images[i:i + args.batch]
            while len(chunk) < args.batch:
                chunk = chunk + [chunk[-1]]
            imgs = jnp.asarray(np.stack(chunk).astype(np.float32))
            out = device_pipeline_full(imgs, pipe.params, pipe.mean, cfg)
            n = min(args.batch, args.count - i)
            hp1s += list(np.asarray(out["hp1"])[:n])
            hp2s += list(np.asarray(out["hp2"])[:n])
        t_dev = time.time() - t0
        errs = horizon_errors(hp1s, hp2s)
        auc, _ = calc_auc(errs, 0.25)
        results["full"] = auc
        print(f"device-full path: AUC {auc:.4f}  (device {t_dev:.1f}s incl. "
              f"compile for {args.count} imgs)")

    # ---- path C: device segments + IDEAL prior (detector-only gap) ----
    if "ideal" in paths:
        from vanishing_points_2017_tpu.ops.lines_device import (
            detect_segments_device)
        from vanishing_points_2017_tpu.ops import lines as lineops
        from vanishing_points_2017_tpu.em import (EMConfig,
                                                  expectation_maximisation)
        from vanishing_points_2017_tpu.em.horizon import (
            calculate_horizon_and_ortho_vp)
        from vanishing_points_2017_tpu.ops import sphere as sphere_mod

        import functools

        @functools.partial(jax.jit, static_argnames=())
        def ideal_one(img, label):
            # same detector + horizon-gate config as path B, so the
            # host-vs-full-vs-ideal decomposition isolates the PRIOR
            # difference only (cfg overrides like --det_selection and
            # --horizon_tol must reach all paths)
            lp, lmask = detect_segments_device(
                img, max_segments=cfg.n_pad,
                min_count=cfg.det_min_count,
                min_len_px=cfg.det_min_len_px,
                min_density=cfg.det_min_density,
                ccl_impl=cfg.ccl_impl,
                selection=cfg.det_selection,
                max_records=cfg.det_max_records,
                topk_impl=cfg.det_topk)
            l = lineops.segments_to_homogeneous(lp)
            l = jnp.where(lmask[:, None], l, 0.0)
            img_u8 = sphere_mod.sphere_image_uint8(l, lmask,
                                                   size=cfg.sphere_size)
            em = expectation_maximisation(l, lp, label,
                                          img_u8.astype(jnp.float32),
                                          lmask, cfg.em)
            return calculate_horizon_and_ortho_vp(
                em.vp, em.counts, em.alive, maxbest=cfg.maxbest,
                theta_vmin=cfg.theta_vmin,
                pos_gate_ideal_tol=cfg.horizon_pos_gate_tol)

        ideal_batch = jax.jit(jax.vmap(ideal_one))
        hp1s, hp2s = [], []
        for i in range(0, args.count, args.batch):
            chunk = images[i:i + args.batch]
            labels = [synth.vp_grid_label(s.vps)
                      for s in scenes[i:i + args.batch]]
            while len(chunk) < args.batch:
                chunk = chunk + [chunk[-1]]
                labels = labels + [labels[-1]]
            out = ideal_batch(jnp.asarray(np.stack(chunk).astype(np.float32)),
                              jnp.asarray(np.stack(labels)))
            n = min(args.batch, args.count - i)
            hp1s += list(np.asarray(out[0])[:n])
            hp2s += list(np.asarray(out[1])[:n])
        errs = horizon_errors(hp1s, hp2s)
        auc, _ = calc_auc(errs, 0.25)
        results["ideal"] = auc
        print(f"device segs + ideal prior: AUC {auc:.4f}")

    if "host" in results and "full" in results:
        gap = results["host"] - results["full"]
        print(f"gap (host - full): {gap:+.4f}  "
              f"({'OK: within 0.02' if gap <= 0.02 else 'NOT within 0.02'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
