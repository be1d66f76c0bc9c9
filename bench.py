#!/usr/bin/env python3
"""Throughput of the fused image -> horizon program on one NVIDIA GPU.

Times ``pipeline.device_pipeline_full`` — Gaussian blur, gradient,
connected-component line detection, inverse-gnomonic sphere render, CNN
forward, EM with split/merge, horizon search — on synthetic 640x640 scenes
with the shipped weights, in this one process:

* images/s with the batch resident on the device (host clock around
  ``block_until_ready``), and with each batch's host->device copy inside
  the timed loop;
* with ``--trace DIR``: a ``jax.profiler`` trace of --iters more resident
  iterations, reduced to the device's busy time, its idle share inside the
  traced window, and the heaviest kernels per iteration.

Model FLOP utilization is reported as null, with the reason: there is no
FLOP count of the GPU program yet (XLA's static count misses the library
convolutions and matmuls, and counts loop bodies once). The divisor it
will take is the card's published dense bf16 peak, looked up by
``device_kind``.

Refuses to run without a GPU. Prints the card's name and power limit, then
ONE JSON line.

    python bench.py [--batch 32] [--iters 10] [--size 640] [--trace DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

# Published dense bf16 tensor-core peaks, FLOP/s, keyed by jax device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5, without sparsity).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device_kind: str) -> tuple[float | None, str]:
    """(peak FLOP/s, source) for a device kind, or (None, reason)."""
    peak = PEAK_BF16_FLOPS.get(device_kind)
    if peak is None:
        return None, f"no published peak on record for {device_kind!r}"
    return peak, "NVIDIA data sheet, dense bf16"


def mfu_note(device_kind: str) -> str:
    """Why the utilization field is null."""
    reason = "no FLOP count of the GPU program yet"
    peak, note = peak_flops(device_kind)
    return reason if peak is not None else f"{reason}; {note}"


def trace_summary(trace_dir: str, iters: int, top: int = 10) -> dict:
    """Reduce the newest jax.profiler trace under trace_dir: device busy
    time (union of the GPU streams' events), idle share of the window from
    the first event's start to the last one's end, and the top kernels by
    total time, per iteration."""
    from jax.profiler import ProfileData

    pb = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                       "*.xplane.pb")))[-1]
    spans, kernels = [], {}
    for plane in ProfileData.from_file(pb).planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                t, n = kernels.get(ev.name, (0.0, 0))
                kernels[ev.name] = (t + ev.duration_ns, n + 1)
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    heavy = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ms": window / 1e6, "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "top_kernels_per_iter": [
            {"name": name[:100], "ms": t / 1e6 / iters, "count": n / iters,
             "share_of_busy": t / busy}
            for name, (t, n) in heavy],
    }


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace --iters resident iterations into DIR")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform}); refusing to "
              "report a number", file=sys.stderr)
        return 1
    print(f"card: {card()}", flush=True)

    import jax.numpy as jnp
    import numpy as np

    from vanishing_points_2017_tpu import weights as wload
    from vanishing_points_2017_tpu.data.datasets import render_scene_image
    from vanishing_points_2017_tpu.models import synth
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)
    from vanishing_points_2017_tpu.utils import compile_cache

    compile_cache.enable()
    cfg = PipelineConfig()
    params, mean = wload.load_params_and_mean(warn=False)
    params = jax.tree.map(jnp.asarray, params)
    mean = jnp.asarray(mean)
    rng = np.random.default_rng(0)
    imgs_host = np.stack([
        render_scene_image(synth.make_scene(
            rng, lines_per_vp=int(rng.integers(30, 60)),
            outliers=int(rng.integers(10, 30))), size=args.size, rng=rng)
        for _ in range(args.batch)]).astype(np.uint8)
    imgs = jnp.asarray(imgs_host)

    t0 = time.perf_counter()
    prog = device_pipeline_full.lower(imgs, params, mean, cfg).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(prog(imgs, params, mean))

    def loop(make_input):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = prog(make_input(), params, mean)
        jax.block_until_ready(out)
        return args.batch * args.iters / (time.perf_counter() - t0)

    resident_ips = loop(lambda: imgs)
    with_h2d_ips = loop(lambda: jnp.asarray(imgs_host))
    trace = None
    if args.trace:
        with jax.profiler.trace(args.trace):
            loop(lambda: imgs)
        trace = trace_summary(args.trace, args.iters)
        for k in trace["top_kernels_per_iter"]:
            print(f"{k['ms']:9.3f} ms/iter {k['share_of_busy']:6.1%} "
                  f"x{k['count']:6.1f}  {k['name']}")

    print(json.dumps({
        "metric": "end_to_end_images_per_sec",
        "value": round(resident_ips, 3),
        "unit": "images/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card()},
        "breakdown": {
            "batch": args.batch, "image_size": args.size,
            "iters": args.iters, "compile_s": round(compile_s, 1),
            "with_h2d_images_per_sec": round(with_h2d_ips, 3),
            "weights_fingerprint": wload.weights_identity(),
            "mfu": None,
            "mfu_null_reason": mfu_note(dev.device_kind),
            "trace": trace,
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
