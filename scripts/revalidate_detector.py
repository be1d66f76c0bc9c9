#!/usr/bin/env python3
"""One-command detector re-validation gate.

Any change that can move the on-device detector's f32 output bits —
selection strategy, top-k implementation, scan restructuring, record
budget, gate constants — re-rolls the EM's knife-edge sensitivity on
texture-heavy real photos (BASELINE.md rounds 3-4). This script is the
ritual turned into a command: it runs, in ONE process on the target
device (one compile per program),

  A. the real-photo gate — zero-host device path on the 3 bundled
     reference photographs, horizon error vs the reference's published
     result figures <= 0.10 each (tests/test_real_photos.py protocol;
     reference contract /root/reference/evaluation.py:238-251 — the
     call-site the device detector replaces);
  B. the synthetic AUC gap — the fixed-seed 50-scene protocol, host
     C++-LSD path vs device-full path, AUC gap <= 0.005
     (scripts/eval_device_detector.py protocol, same seed);
  C. the golden pins — the committed miniset golden-AUC regression,
     run as a CPU pytest subprocess (host-LSD path: catches
     weights/pipeline slips a detector change could smuggle in).
     Skippable with --skip_pins when only detector bits changed (the
     pins don't exercise the device detector).

and prints a PASS/FAIL block suitable for pasting into BASELINE.md.
Exit code 0 only if every stage passes.

Usage:
  python scripts/revalidate_detector.py                       # defaults
  python scripts/revalidate_detector.py --det_topk approx     # gate a knob
  python scripts/revalidate_detector.py --device cpu --count 16 --skip_pins
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REF_EXAMPLES = "/root/reference/assets/examples"

# (photo, frac_left, frac_right) — the reference's published horizons,
# extracted from its result figures (tests/test_real_photos.py docstring
# documents the extraction)
REFERENCE_HORIZONS = [
    ("ihme_zentrum.jpg", 0.7701, 0.7743),
    ("uni_hannover.jpg", 0.7458, 0.7336),
    ("uni_hannover_lichthof.jpg", 0.3889, 0.3877),
]
PHOTO_GATE = 0.10
AUC_GAP_GATE = 0.005


def _fracs(hp1, hp2, image_shape):
    h, w = image_shape
    s = max(h, w) / 2.0
    fl = (h / 2.0 - float(hp1[1]) * s) / h
    fr = (h / 2.0 - float(hp2[1]) * s) / h
    return fl, fr


def stage_real_photos(pipe, batch_shapes: bool = True):
    """Returns (passed, rows) where rows = [(name, err)]."""
    rows = []
    for name, rl, rr in REFERENCE_HORIZONS:
        host = pipe.ingest_image(os.path.join(REF_EXAMPLES, name),
                                 target_size=640)
        out = pipe.process_images([host["gray"]])
        if not bool(np.asarray(out["em_valid"])[0]):
            rows.append((name, float("inf")))
            continue
        fl, fr = _fracs(np.asarray(out["hp1"])[0], np.asarray(out["hp2"])[0],
                        host["image_shape"])
        rows.append((name, max(abs(fl - rl), abs(fr - rr))))
    return all(e <= PHOTO_GATE for _, e in rows), rows


def stage_synthetic_gap(pipe, cfg, count: int, batch: int, size: int):
    """Returns (passed, host_auc, device_auc, gap)."""
    import jax.numpy as jnp

    from eval_device_detector import build_scene_set, scene_horizon_errors
    from vanishing_points_2017_tpu.data import io as dio
    from vanishing_points_2017_tpu.metrics import calc_auc
    from vanishing_points_2017_tpu.pipeline import (device_pipeline_batch,
                                                    device_pipeline_full,
                                                    pad_lines)

    scenes, images = build_scene_set(count, size=size)

    # host C++ LSD -> fused device program
    bundles = []
    for img in images:
        det = dio.detect_lsd_lines(img.astype(np.float64))
        bundles.append(pad_lines(det["segments"], cfg.n_pad))
    hp1s, hp2s = [], []
    for i in range(0, count, batch):
        chunk = bundles[i:i + batch]
        while len(chunk) < batch:
            chunk = chunk + [chunk[-1]]
        out = device_pipeline_batch(
            jnp.asarray(np.stack([c[0] for c in chunk])),
            jnp.asarray(np.stack([c[1] for c in chunk])),
            jnp.asarray(np.stack([c[2] for c in chunk])),
            pipe.params, pipe.mean, cfg)
        n = min(batch, count - i)
        hp1s += list(np.asarray(out["hp1"])[:n])
        hp2s += list(np.asarray(out["hp2"])[:n])
    host_auc, _ = calc_auc(scene_horizon_errors(scenes, hp1s, hp2s, size),
                           0.25)

    # zero-host device-detector path
    hp1s, hp2s = [], []
    for i in range(0, count, batch):
        chunk = images[i:i + batch]
        while len(chunk) < batch:
            chunk = chunk + [chunk[-1]]
        out = device_pipeline_full(
            jnp.asarray(np.stack(chunk).astype(np.float32)),
            pipe.params, pipe.mean, cfg)
        n = min(batch, count - i)
        hp1s += list(np.asarray(out["hp1"])[:n])
        hp2s += list(np.asarray(out["hp2"])[:n])
    dev_auc, _ = calc_auc(scene_horizon_errors(scenes, hp1s, hp2s, size),
                          0.25)

    gap = host_auc - dev_auc
    return gap <= AUC_GAP_GATE, host_auc, dev_auc, gap


def stage_golden_pins():
    """Runs the committed golden-AUC pytest on CPU in a subprocess.

    The child is held to the CPU (JAX_PLATFORMS=cpu), so it never opens
    the card this process holds: one JAX process per GPU."""
    cmd = [sys.executable, "-m", "pytest", "-q", "--no-header",
           "tests/test_minisets.py::test_golden_auc_regression"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=1200, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    tail = "\n".join((r.stdout + r.stderr).splitlines()[-6:])
    return r.returncode == 0, tail


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--count", type=int, default=50,
                    help="synthetic scene count (stage B)")
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--skip_pins", action="store_true",
                    help="skip stage C (detector-only changes: the pins "
                         "run the host-LSD path and cannot move)")
    ap.add_argument("--skip_photos", action="store_true")
    ap.add_argument("--skip_synthetic", action="store_true")
    # detector/pipeline knobs under validation
    ap.add_argument("--det_selection", default=None)
    ap.add_argument("--det_topk", default=None)
    ap.add_argument("--det_max_records", type=int, default=None)
    ap.add_argument("--horizon_tol", type=float, default=None)
    args = ap.parse_args()

    if args.device:
        import jax
        jax.config.update("jax_platforms", args.device)

    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu import weights as wload

    cfg = PipelineConfig()
    overrides = {}
    if args.det_selection:
        overrides["det_selection"] = args.det_selection
    if args.det_topk:
        overrides["det_topk"] = args.det_topk
    if args.det_max_records is not None:
        overrides["det_max_records"] = args.det_max_records
    if args.horizon_tol is not None:
        overrides["horizon_pos_gate_tol"] = args.horizon_tol
    cfg = dataclasses.replace(cfg, **overrides)
    params, mean = wload.load_params_and_mean(warn=False)
    pipe = Pipeline(params=params, mean=mean, cfg=cfg)

    import jax
    backend = jax.devices()[0].platform
    knobs = (" ".join(f"{k}={v}" for k, v in overrides.items())
             or "production defaults")
    wfp = wload.weights_identity()
    print(f"=== detector re-validation gate ===")
    print(f"backend: {backend}  weights: {wfp}  cfg: {knobs}")
    print(f"det_key: {cfg.det_key()}")

    results = []  # (stage, passed, detail lines)

    if args.skip_photos or not os.path.isdir(REF_EXAMPLES):
        why = ("skipped by flag" if args.skip_photos
               else "reference photos unavailable")
        print(f"A real photos: SKIPPED ({why})")
    else:
        t0 = time.time()
        ok, rows = stage_real_photos(pipe)
        lines = [f"  {name:<28s} err {err:.3f}  "
                 f"{'PASS' if err <= PHOTO_GATE else 'FAIL'}"
                 for name, err in rows]
        print(f"A real photos (device path, gate {PHOTO_GATE}) "
              f"[{time.time()-t0:.0f}s]:")
        print("\n".join(lines))
        results.append(("A real photos", ok))

    if not args.skip_synthetic:
        t0 = time.time()
        ok, host_auc, dev_auc, gap = stage_synthetic_gap(
            pipe, cfg, args.count, args.batch, args.size)
        print(f"B synthetic AUC ({args.count} scenes) "
              f"[{time.time()-t0:.0f}s]: host {host_auc:.4f}  "
              f"device {dev_auc:.4f}  gap {gap:+.4f} "
              f"(gate {AUC_GAP_GATE})  {'PASS' if ok else 'FAIL'}")
        results.append(("B synthetic gap", ok))

    if args.skip_pins:
        print("C golden pins: SKIPPED (--skip_pins)")
    else:
        t0 = time.time()
        ok, tail = stage_golden_pins()
        print(f"C golden pins [{time.time()-t0:.0f}s]: "
              f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            print(tail)
        results.append(("C golden pins", ok))

    all_ok = all(ok for _, ok in results) and results
    print(f"=== GATE: {'PASS' if all_ok else 'FAIL'} "
          f"({', '.join(f'{s}={'ok' if ok else 'FAIL'}' for s, ok in results)}) ===")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
