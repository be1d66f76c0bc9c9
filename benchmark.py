#!/usr/bin/env python3
"""Benchmark driver — the reference CLI surface, fused JAX programs underneath.

Mirrors ``benchmark.py`` of fkluger/vanishing_points_2017: pick a dataset
(``--yud/--ecd/--hlw``, plus ``--synthetic`` which needs no downloads),
optionally (re)compute per-image stages, then print per-image ``max_error``
and the horizon-error AUC at cutoff 0.25.

Differences by design (SURVEY §7): the CNN and EM stages are ONE fused XLA
program (``--run_cnn`` / ``--run_em`` both enable it); stage state lives in
npz files (config-keyed, resume-safe) instead of pickles; ``--gpu`` becomes
``--device`` (any JAX backend); the CDF plot is written to a PNG instead of
shown. The eval protocol is identical: first 25 images skipped on YUD/ECD,
cutoff 0.25, top-20 VPs, theta_vmin = pi/10.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--yud", action="store_true", help="York Urban dataset")
    ap.add_argument("--ecd", action="store_true", help="Eurasian Cities dataset")
    ap.add_argument("--hlw", action="store_true", help="Horizon Lines in the Wild")
    ap.add_argument("--synthetic", action="store_true",
                    help="self-contained synthetic benchmark (no downloads)")
    ap.add_argument("--dataset_dir", default=None,
                    help="dataset root (YUD/ECD/HLW)")
    ap.add_argument("--result_dir", default="/tmp/vp_tpu",
                    help="stage-cache directory")
    ap.add_argument("--device", default=None,
                    help="JAX platform override, e.g. cpu")
    ap.add_argument("--update_datalist", action="store_true")
    ap.add_argument("--update_datafiles", action="store_true")
    ap.add_argument("--run_cnn", action="store_true",
                    help="run the fused CNN+EM device stage")
    ap.add_argument("--run_em", action="store_true",
                    help="alias of --run_cnn (stages are fused)")
    ap.add_argument("--weights", default=None,
                    help=".npz params / .caffemodel to load")
    ap.add_argument("--mean", default=None,
                    help="mean image (.npy or .binaryproto)")
    ap.add_argument("--batch", type=int, default=8,
                    help="device batch for the fused stage")
    ap.add_argument("--device_detect", action="store_true",
                    help="zero-host-round-trip path: line detection runs "
                         "on device inside the fused program (no host "
                         "LSD); images are grouped by shape, each "
                         "distinct shape compiles one program")
    ap.add_argument("--num_synthetic", type=int, default=50)
    ap.add_argument("--no_weights_warn", action="store_true")
    ap.add_argument("--consensus", type=int, default=0, metavar="K",
                    help="K-member dropout-ensemble horizon (medoid pick); "
                         "0 = single EM, reference parity. Enters the "
                         "result-cache identity (em/consensus.py; "
                         "BASELINE.md round-5 consensus table)")
    args = ap.parse_args()

    if args.device:
        import jax
        jax.config.update("jax_platforms", args.device)

    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    from vanishing_points_2017_tpu.data import datasets as dsets
    from vanishing_points_2017_tpu.data.cache import StageCache
    from vanishing_points_2017_tpu.data import io as dio
    from vanishing_points_2017_tpu.metrics import calc_auc
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu import weights as wload

    if args.yud:
        name, target = "york", None
    elif args.ecd:
        name, target = "eurasian", 800
    elif args.hlw:
        name, target = "horizon", 800
    elif args.synthetic:
        name, target = "synthetic", None
    else:
        ap.error("pick a dataset: --yud / --ecd / --hlw / --synthetic")

    cfg = PipelineConfig(horizon_consensus=args.consensus)
    wfp = wload.weights_identity(args.weights)
    params, mean = wload.load_params_and_mean(args.weights, args.mean,
                                              warn=not args.no_weights_warn)
    pipe = Pipeline(params=params, mean=mean, cfg=cfg)

    if name == "synthetic":
        records, start = dsets.synthetic_records(count=args.num_synthetic)
    else:
        if not args.dataset_dir:
            ap.error(f"--dataset_dir required for {name}")
        records, start = dsets.DATASETS[name][0](args.dataset_dir)

    # device-detect results come from a different detector — separate
    # cache identity so the two modes never serve each other's results
    # device-detect results also key on the detector config (gates +
    # selection strategy), so detector changes invalidate exactly those
    # caches; host-LSD results don't depend on det_* and keep their key
    cache_key = cfg.cache_key() + (
        "_devdet_" + cfg.det_key() if args.device_detect else "")
    cache = StageCache(os.path.join(args.result_dir, name), cache_key)
    # the weights + mean fingerprints scope the RESULT stage only: results
    # downstream of the CNN depend on the exact weights AND mean artifacts
    # (both shift CNN output), and a retrain/mean swap must never serve a
    # previous artifact's cached results — but the ingest/LSD stage outputs
    # are weights-independent and must survive a retrain (host LSD over a
    # dataset is the expensive stage)
    mfp = wload.mean_identity(args.mean)
    result_stage = "result_w" + wfp + "_m" + mfp
    print(f"dataset: {name}  images: {len(records)}  skip: {start}  "
          f"weights: {wfp}  mean: {mfp}")

    # ---- stage 1: host ingest (+ LSD unless detection runs on device) ----
    for rec in records:
        stage = "gray" if args.device_detect else "lines"
        if cache.has(rec.name, stage) and not args.update_datafiles:
            continue
        img = rec.image if rec.image is not None else rec.image_path
        if args.device_detect:
            host = pipe.ingest_image(img, target_size=target)
            cache.save(rec.name, "gray", gray=host["gray"],
                       image_shape=np.asarray(host["image_shape"]))
            print(f"gray: {rec.name}  shape={host['image_shape']}")
        else:
            host = pipe.ingest(img, target_size=target)
            cache.save(rec.name, "lines", l=host["l"], lp=host["lp"],
                       lmask=host["lmask"], segments=host["segments"],
                       image_shape=np.asarray(host["image_shape"]))
            print(f"lines: {rec.name}  segments={host['segments'].shape[0]}")

    # ---- stage 2: fused device pass, batched ----
    # (device_detect: detection + CNN + EM + horizon in ONE program)
    if args.run_cnn or args.run_em:
        todo = [r for r in records
                if args.update_datafiles or not cache.has(r.name, result_stage)]
        if args.device_detect:
            by_shape: dict[tuple, list] = {}
            for r in todo:
                g = cache.load(r.name, "gray")
                by_shape.setdefault(tuple(g["image_shape"]), []).append(
                    (r, g["gray"]))
            groups = [(s, chunk) for s, recs in sorted(by_shape.items())
                      for chunk in (recs[i:i + args.batch]
                                    for i in range(0, len(recs), args.batch))]
        else:
            groups = [(None, todo[i:i + args.batch])
                      for i in range(0, len(todo), args.batch)]
        # PIPELINED dispatch: every batch's H2D + compute is enqueued
        # back-to-back, results are read back afterwards — the transfer
        # hides behind compute instead of serializing with it. Device
        # outputs per batch
        # are small (sphere images dominate, ~0.25 MB/img), so holding
        # a dataset's worth on device is safe.
        t_all = time.time()
        pending = []
        for gi, (shape, chunk) in enumerate(groups):
            if args.device_detect:
                grays = [g for _, g in chunk]
                while len(grays) < args.batch:  # pad the last batch
                    grays.append(grays[-1])
                out = pipe.process_images(grays)
                recs = [r for r, _ in chunk]
            else:
                bundles = [cache.load(r.name, "lines") for r in chunk]
                while len(bundles) < args.batch:  # pad the last batch
                    bundles.append(bundles[-1])
                out = pipe.process_batch(bundles)
                recs = chunk
            pending.append((gi, recs, out))
        n_done = 0
        for gi, recs, out in pending:
            out = {k: np.asarray(v) for k, v in out.items()}
            for j, rec in enumerate(recs):
                cache.save(rec.name, result_stage,
                           **{k: v[j] for k, v in out.items()})
            n_done += len(recs)
            print(f"device batch {gi}: {len(recs)} imgs")
        if pending:
            dt = time.time() - t_all
            print(f"device stage: {n_done} imgs in {dt:.2f}s "
                  f"({n_done / dt:.2f} img/s, pipelined)")

    # ---- eval loop (identical protocol to the reference) ----
    errors = []
    skipped = 0  # images in the eval slice without a result or ground truth
    start_time = time.time()
    for count, rec in enumerate(records, 1):
        if count <= start:
            continue
        if rec.true_horizon is None or not cache.has(rec.name, result_stage):
            skipped += 1
            continue
        res = cache.load(rec.name, result_stage)
        shape = cache.load(rec.name,
                           "gray" if args.device_detect
                           else "lines")["image_shape"]
        est = np.cross(res["hp1"], res["hp2"])
        err = dsets.normalized_horizon_error(
            est, rec.true_horizon, width=int(shape[1]), height=int(shape[0]))
        print(f"max_error: {err}")
        errors.append(err)
    print("time elapsed: ", time.time() - start_time)
    # the reference silently skips images with missing results/GT
    # (its benchmark.py:119-132); an AUC over a partial set must not print
    # identically to a full run, so report the coverage explicitly
    print(f"evaluated: {len(errors)} / {len(records) - start} "
          f"(skipped: {skipped})")

    if not errors:
        print("no evaluated images (missing results or ground truth)")
        return 1

    auc, plot_points = calc_auc(np.array(errors), cutoff=0.25)
    print("AUC: ", auc)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        ax.plot(plot_points[:, 0], plot_points[:, 1], "-", lw=2, c="b")
        ax.set_xlabel("horizon error", fontsize=18)
        ax.set_ylabel("fraction of images", fontsize=18)
        ax.axis([0, 0.25, 0, 1])
        out_png = os.path.join(args.result_dir, f"auc_{name}.png")
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
        print(f"CDF plot: {out_png}")
    except Exception as e:  # plotting is best-effort
        print(f"plot skipped: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
