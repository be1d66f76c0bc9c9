#!/usr/bin/env python3
"""Synthetic-AUC comparison of weights artifacts (round-5 weights item).

Runs the fixed-seed 50-scene host-LSD protocol (the weights-quality
anchor used since round 2: LSD segments are weights-independent, so the
AUC differences isolate the CNN prior) once per artifact in ONE process
and prints an AUC table. Used to pick the smallest factorized artifact
within 0.001 of the dense retrain.

Usage:
  python scripts/eval_weights_artifacts.py assets/weights.npz \
      /tmp/wc_256.npz /tmp/wc_384.npz /tmp/wc_512.npz [--count 50]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("artifacts", nargs="+")
    ap.add_argument("--count", type=int, default=50)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    if args.device:
        import jax
        jax.config.update("jax_platforms", args.device)

    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    import jax.numpy as jnp

    from eval_device_detector import build_scene_set, scene_horizon_errors
    from vanishing_points_2017_tpu.data import io as dio
    from vanishing_points_2017_tpu.metrics import calc_auc
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_batch,
                                                    pad_lines)
    from vanishing_points_2017_tpu import weights as wload

    cfg = PipelineConfig()
    scenes, images = build_scene_set(args.count, size=args.size)
    print(f"detecting (host C++ LSD, {args.count} scenes) ...", flush=True)
    bundles = [pad_lines(dio.detect_lsd_lines(img.astype(np.float64))
                         ["segments"], cfg.n_pad) for img in images]
    l = jnp.asarray(np.stack([b[0] for b in bundles]))
    lp = jnp.asarray(np.stack([b[1] for b in bundles]))
    m = jnp.asarray(np.stack([b[2] for b in bundles]))

    mean = jnp.asarray(np.load(os.path.join(REPO, "assets", "mean.npy")))
    results = []
    for path in args.artifacts:
        if not os.path.isfile(path):
            print(f"{path}: MISSING")
            continue
        params = wload.params_from_npz(path)
        hp1s, hp2s = [], []
        for i in range(0, args.count, args.batch):
            j = min(i + args.batch, args.count)
            pad = args.batch - (j - i)
            sl = slice(i, j)

            def padb(a):
                x = a[sl]
                if pad:
                    x = jnp.concatenate([x, x[-1:].repeat(pad, axis=0)])
                return x

            out = device_pipeline_batch(padb(l), padb(lp), padb(m),
                                        params, mean, cfg)
            hp1s += list(np.asarray(out["hp1"])[:j - i])
            hp2s += list(np.asarray(out["hp2"])[:j - i])
        errs = scene_horizon_errors(scenes, hp1s, hp2s, args.size)
        auc, _ = calc_auc(errs, 0.25)
        mb = os.path.getsize(path) / 1e6
        fp = wload.artifact_fingerprint(path)
        results.append((path, auc, mb, fp))
        print(f"{path:<40s} AUC {auc:.4f}  {mb:7.1f} MB  [{fp}]",
              flush=True)

    if results:
        best = max(r[1] for r in results)
        print("\n| artifact | AUC@0.25 | size MB | vs best |")
        print("|---|---|---|---|")
        for path, auc, mb, fp in results:
            print(f"| {os.path.basename(path)} [{fp}] | {auc:.4f} "
                  f"| {mb:.1f} | {auc - best:+.4f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
