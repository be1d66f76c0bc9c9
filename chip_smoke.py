#!/usr/bin/env python3
"""Chip smoke test: image -> horizon on an NVIDIA GPU, checked.

    python chip_smoke.py              # one card: phases 0-6 below
    python chip_smoke.py --devices 4  # only the four-card dp path + its check

Phases (one card), each of which fails the run:
  0. device: a GPU or exit 1 (no CPU fallback); card, versions, flags.
  1. main path: 32 synthetic 640x640 scenes (fixed seed) through
     ``device_pipeline_full`` with the defaults and the shipped weights,
     every autotuned choice from the shipped picks; compile time, memory
     analysis, steady img/s (informational), finite outputs, AUC@0.25
     against the scenes' exact horizons.
  2. plain reference: 8 of the images through the same program on the CPU
     backend of this process, float32 CNN at matmul precision "highest";
     two pinned geometric products alone, GPU against CPU.
  3. host-LSD path: the C++ LSD built from lsd.cpp, 4 images through
     ``Pipeline.process_batch`` on the GPU and on the CPU.
  4. CCL: the CUDA kernel's labels against the XLA scan on all 32 images;
     the CCL, the whole detector and the whole program timed with each.
  5. top-k: det_topk "exact" vs "approx" on the 32 images; identical valid
     segments; the detector and the whole program timed with each.
  6. the tests marked ``gpu``, in this process.

The last line of stdout is one JSON object {"ok": true, "device": {...}}.
Times are host-clock medians around work that ends in block_until_ready,
on this card at its power limit (printed); they are not benchmark numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

BATCH, SIZE, SEED = 32, 640, 0
# Phase 2/3 tolerance. The GPU runs the production numerics: a bf16 CNN
# (bf16 operands, float32 accumulation, bf16 layer outputs) and every
# geometric float32 product at Precision.HIGHEST (full float32, no TF32),
# compiled with the shipped autotuning picks (utils/compile_cache.py).
# The CPU runs a float32 CNN with every matmul at "highest". Both horizons
# are compared by the reference's normalized horizon error (max deviation
# at x = +-1 over the image height). 0.01 of the height is 4% of the AUC
# cutoff. One image in eight (none of phase 3's four) may exceed it,
# because the bf16 CNN prior can legitimately tip the EM's triplet choice
# on a knife-edge scene.
HORIZON_TOL = 0.01
# Phase 2 also runs two of the pinned geometric products alone, GPU against
# CPU: their largest difference over the largest value. At HIGHEST they
# agree to ~1e-6; with the pins removed XLA runs them in TF32 on an H100
# and they differ by ~3e-4 to 6e-4, while the horizons above do not move
# (scripts/gpu_numerics.py, PERF.md). This is the check that sees TF32.
PRODUCT_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """nvidia-smi's name and power limit, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_time(compiled, *args, iters: int = 5):
    """(median run s, output) of a compiled program on args."""
    import jax
    import numpy as np

    out = jax.block_until_ready(compiled(*args))
    runs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    return float(np.median(runs)), out


def timed(fn, *args, iters: int = 5, options=None, **static):
    """(compile s, median run s, output, compiled) of fn on args. A jitted
    entry point compiles with its own options, plus ``options``; anything
    else is jitted with the package's (fixed autotuning picks)."""
    import jax
    from vanishing_points_2017_tpu.utils.compile_cache import (
        COMPILER_OPTIONS)

    if not hasattr(fn, "lower"):
        fn = jax.jit(fn, compiler_options=COMPILER_OPTIONS)
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **static).compile(options)
    compile_s = time.perf_counter() - t0
    run_s, out = run_time(compiled, *args, iters=iters)
    return compile_s, run_s, out, compiled


def alternate(progs: dict, *args, rounds: int = 3) -> dict:
    """Median run s of each compiled program, timed in turns (A, B, A, B,
    ...) so a drift of the card's clock hits both alike."""
    import numpy as np

    times = {k: [] for k in progs}
    for _ in range(rounds):
        for k, prog in progs.items():
            times[k].append(run_time(prog, *args, iters=3)[0])
    return {k: float(np.median(v)) for k, v in times.items()}


def load_inputs():
    """The shipped weights and mean image, as device arrays."""
    import jax
    import jax.numpy as jnp
    from vanishing_points_2017_tpu import weights as wload

    params, mean = wload.load_params_and_mean(warn=False)
    return jax.tree.map(jnp.asarray, params), jnp.asarray(mean)


def scenes_and_images(n: int, seed: int = SEED):
    """The bench's scene generator: (scenes, (n, SIZE, SIZE) uint8)."""
    import numpy as np
    from vanishing_points_2017_tpu.data.datasets import render_scene_image
    from vanishing_points_2017_tpu.models import synth

    rng = np.random.default_rng(seed)
    scenes, imgs = [], []
    for _ in range(n):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(30, 60)),
                                 outliers=int(rng.integers(10, 30)))
        scenes.append(scene)
        imgs.append(render_scene_image(scene, size=SIZE, rng=rng))
    return scenes, np.stack(imgs).astype(np.uint8)


def horizon_errors(out, truths) -> list[float]:
    import numpy as np
    from vanishing_points_2017_tpu.data.datasets import (
        normalized_horizon_error)

    hp1, hp2 = np.asarray(out["hp1"], np.float64), np.asarray(
        out["hp2"], np.float64)
    return [normalized_horizon_error(np.cross(a, b), t, SIZE, SIZE)
            for a, b, t in zip(hp1, hp2, truths)]


def compare_horizons(name, gpu_out, cpu_out, truths) -> None:
    """Phase 2/3 check: GPU vs CPU horizons within HORIZON_TOL on all but
    one image in eight (rounded down)."""
    import numpy as np
    from vanishing_points_2017_tpu.data.datasets import (
        normalized_horizon_error)

    g = [np.cross(a, b) for a, b in zip(np.asarray(gpu_out["hp1"], float),
                                        np.asarray(gpu_out["hp2"], float))]
    c = [np.cross(a, b) for a, b in zip(np.asarray(cpu_out["hp1"], float),
                                        np.asarray(cpu_out["hp2"], float))]
    diffs = [normalized_horizon_error(a, b, SIZE, SIZE) for a, b in zip(g, c)]
    eg, ec = horizon_errors(gpu_out, truths), horizon_errors(cpu_out, truths)
    bad = [i for i, d in enumerate(diffs) if not d <= HORIZON_TOL]
    log(f"{name}: GPU-vs-CPU horizon diff max {max(diffs):.3g}, "
        f"{len(diffs) - len(bad)}/{len(diffs)} within {HORIZON_TOL}")
    for i in bad:
        log(f"  outlier image {i}: diff {diffs[i]:.4f}, error vs truth "
            f"GPU {eg[i]:.4f} CPU {ec[i]:.4f}")
    if len(bad) > len(diffs) // 8:
        raise AssertionError(f"{name}: {len(bad)} horizons differ")


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); "
              "this check runs only on the card", file=sys.stderr)
        raise SystemExit(1)
    if len(devs) < n:
        print(f"chip_smoke: needs {n} GPUs, found {len(devs)}",
              file=sys.stderr)
        raise SystemExit(1)
    return devs


def phase0(devs) -> None:
    import jax
    import jaxlib

    log(f"card: {card()}")
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; devices "
        f"{len(devs)} x {devs[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    try:
        import PIL  # noqa: F401
        log("PIL importable: yes")
    except ImportError:
        log("PIL importable: no")


def main_path(imgs, scenes, params, mean):
    """Phase 1. Returns the compiled program and its outputs."""
    import numpy as np
    from vanishing_points_2017_tpu.metrics.auc import calc_auc
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)
    from vanishing_points_2017_tpu.utils.compile_cache import REQUIRE_PICKS

    # REQUIRE_PICKS: the compile fails unless every autotuned choice comes
    # from the shipped picks, so this program's bits do not depend on the
    # process that compiled it (utils/compile_cache.py).
    compile_s, run_s, out, compiled = timed(
        device_pipeline_full, imgs, params, mean, cfg=PipelineConfig(),
        iters=10, options=REQUIRE_PICKS)
    log(f"phase 1: compile {compile_s:.1f} s (compile cache: "
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR') or 'repo .jax_cache'});"
        " every autotuned choice from the shipped picks")
    log(f"phase 1: memory_analysis {compiled.memory_analysis()}")
    log(f"phase 1: {BATCH / run_s:.2f} img/s steady ({run_s * 1e3:.2f} ms "
        f"per batch of {BATCH} at {SIZE}x{SIZE}) on "
        f"{card().splitlines()[0]}")
    for k, v in out.items():
        a = np.asarray(v)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            raise AssertionError(f"phase 1: non-finite values in {k}")
    if out["hp1"].shape != (BATCH, 3):
        raise AssertionError(f"phase 1: hp1 shape {out['hp1'].shape}")
    errs = horizon_errors(out, [s.horizon for s in scenes])
    auc, _ = calc_auc(np.asarray(errs), 0.25)
    log(f"phase 1: AUC@0.25 {auc:.4f} against exact horizons "
        f"(median error {np.median(errs):.4f}); all outputs finite")
    return compiled, out


def cpu_reference(imgs, params, mean):
    """The fused program on the CPU backend: float32 CNN, matmuls at
    "highest"."""
    import jax
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)

    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        return jax.block_until_ready(device_pipeline_full(
            jax.device_put(imgs, cpu), jax.device_put(params, cpu),
            jax.device_put(mean, cpu), PipelineConfig(cnn_dtype="float32")))


def product_errors() -> list[float]:
    """GPU-vs-CPU relative error of two pinned products on random inputs:
    calc_lsim of 512 segments and the E-step's line-VP dot products."""
    import jax
    import numpy as np
    from vanishing_points_2017_tpu.ops import lines, probability

    rng = np.random.default_rng(0)
    lp = rng.uniform(-1, 1, (512, 4)).astype(np.float32)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    l = rng.standard_normal((512, 3)).astype(np.float32)

    def products():
        return [np.asarray(x) for x in (
            lines.calc_lsim(lp, np.ones(512, bool)),
            probability.calc_lvsq_dotprod(v, l))]

    got = products()
    with jax.default_device(jax.devices("cpu")[0]):
        want = products()
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


def plain_reference(imgs, scenes, params, mean, gpu_out) -> None:
    """Phase 2: the same program on the CPU backend, float32 + highest;
    and two pinned products alone."""
    errs = product_errors()
    log(f"phase 2: pinned products GPU vs CPU, relative error calc_lsim "
        f"{errs[0]:.3g}, line-VP dot products {errs[1]:.3g} "
        f"(limit {PRODUCT_RTOL})")
    if max(errs) > PRODUCT_RTOL:
        raise AssertionError("phase 2: geometric products below float32")
    t0 = time.perf_counter()
    out = cpu_reference(imgs[:8], params, mean)
    log(f"phase 2: CPU reference of 8 images in "
        f"{time.perf_counter() - t0:.1f} s")
    compare_horizons("phase 2", {k: gpu_out[k][:8] for k in ("hp1", "hp2")},
                     out, [s.horizon for s in scenes[:8]])


def lsd_bundles(imgs, params, mean) -> list:
    """Builds the C++ LSD from lsd.cpp and ingests imgs through it."""
    from vanishing_points_2017_tpu import lsd
    from vanishing_points_2017_tpu.pipeline import Pipeline

    t0 = time.perf_counter()
    lsd._build()
    log(f"built the C++ LSD in {time.perf_counter() - t0:.1f} s")
    pipe = Pipeline(params=params, mean=mean)
    return [pipe.ingest(im) for im in imgs]


def lsd_run(bundles, params, mean, on_cpu: bool = False):
    """``Pipeline.process_batch`` on the GPU with the production numerics,
    or on the CPU with the float32/"highest" reference numerics."""
    import jax
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig

    if not on_cpu:
        return jax.block_until_ready(Pipeline(
            params=params, mean=mean).process_batch(bundles))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        pipe = Pipeline(params=jax.device_put(params, cpu),
                        mean=jax.device_put(mean, cpu),
                        cfg=PipelineConfig(cnn_dtype="float32"))
        return jax.block_until_ready(pipe.process_batch(bundles))


def host_lsd_path(imgs, scenes, params, mean) -> None:
    """Phase 3: C++ LSD on the host, the rest fused on the GPU vs CPU."""
    bundles = lsd_bundles(imgs[:4], params, mean)
    gpu_out = lsd_run(bundles, params, mean)
    cpu_out = lsd_run(bundles, params, mean, on_cpu=True)
    log(f"phase 3: {[b['segments'].shape[0] for b in bundles]} LSD "
        "segments per image")
    compare_horizons("phase 3", gpu_out, cpu_out,
                     [s.horizon for s in scenes[:4]])


def detector(im, topk_impl: str = "exact"):
    """The production detector on one image (PipelineConfig defaults)."""
    from vanishing_points_2017_tpu.ops import lines_device as ld
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    cfg = PipelineConfig()
    return ld.detect_segments_device(
        im, max_segments=cfg.n_pad, min_count=cfg.det_min_count,
        min_len_px=cfg.det_min_len_px, min_density=cfg.det_min_density,
        selection=cfg.det_selection, max_records=cfg.det_max_records,
        topk_impl=topk_impl)


def log_ab(what: str, t: dict) -> None:
    """One line: each program's median time per batch, and its img/s."""
    log(f"{what}, batch {BATCH}: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms ({BATCH / v:.2f} img/s)" for k, v in t.items()))


def ccl_phase(imgs, params, mean, prog) -> None:
    """Phase 4: CUDA kernel vs XLA scan: labels; CCL, detector and whole
    program times (prog: phase 1's compiled program, with the kernel)."""
    from unittest import mock

    import jax
    import numpy as np
    from vanishing_points_2017_tpu.ops import lines_device as ld
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)

    cos_tol = math.cos(math.radians(ld.TOL_DEG))
    fr = jax.block_until_ready(jax.jit(jax.vmap(
        lambda im: ld.level_lines(im)[:3]))(imgs))

    def ccl(fn, passes):
        return jax.vmap(lambda a, x, y: fn(a, x, y, cos_tol, passes))

    def resid(labels):
        return np.asarray(jax.jit(jax.vmap(
            lambda a, x, y, l: ld.ccl_fixpoint_residual(a, x, y, cos_tol, l))
        )(*fr, labels))

    _, t_k, lab_k, _ = timed(ccl(ld.connected_components, 8), *fr)
    _, t_s, lab_s, _ = timed(ccl(ld._connected_components, 8), *fr, iters=2)
    same = np.asarray(lab_k) == np.asarray(lab_s)
    log(f"phase 4: CCL alone, batch {BATCH}: kernel {t_k * 1e3:.3f} ms, "
        f"XLA scan {t_s * 1e3:.3f} ms")
    if not same.all():
        raise AssertionError(f"phase 4: {int((~same).sum())} labels differ")
    r_k, r_s = resid(lab_k), resid(lab_s)
    log(f"phase 4: labels bit-identical on all {BATCH} images; fixpoint "
        f"residual at 8 passes kernel {r_k.tolist()} scan {r_s.tolist()}")
    if not np.array_equal(r_k, r_s):
        raise AssertionError("phase 4: residuals differ")
    _, _, lab16, _ = timed(ccl(ld.connected_components, 16), *fr, iters=1)
    r16 = resid(lab16)
    log(f"phase 4: kernel fixpoint residual at 16 passes: max {r16.max()}")
    if r16.any():
        raise AssertionError("phase 4: kernel misses the CCL fixpoint")

    _, _, _, det_k = timed(jax.vmap(detector), imgs, iters=1)
    with mock.patch.object(ld, "connected_components",
                           ld._connected_components):
        jax.clear_caches()
        _, _, _, det_s = timed(jax.vmap(detector), imgs, iters=1)
        _, _, out_s, prog_s = timed(device_pipeline_full, imgs, params,
                                    mean, cfg=PipelineConfig(), iters=1)
    jax.clear_caches()
    log_ab("phase 4: whole detector", alternate(
        {"kernel": det_k, "XLA scan": det_s}, imgs))
    log_ab("phase 4: whole program", alternate(
        {"kernel": prog, "XLA scan": prog_s}, imgs, params, mean))
    out_k = prog(imgs, params, mean)
    log("phase 4: whole program hp1/hp2 max |kernel - scan| " + str(max(
        float(np.abs(np.asarray(out_k[k]) - np.asarray(out_s[k])).max())
        for k in ("hp1", "hp2"))))


def topk_phase(imgs, params, mean, prog) -> None:
    """Phase 5: exact vs approx record selection: identical segments;
    detector and whole program times (prog: phase 1's, exact)."""
    import jax
    import numpy as np
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)

    res, dets = {}, {}
    for impl in ("exact", "approx"):
        _, _, (seg, m), dets[impl] = timed(jax.vmap(
            lambda im, impl=impl: detector(im, impl)), imgs, iters=1)
        res[impl] = (np.asarray(seg), np.asarray(m))
    (s_e, m_e), (s_a, m_a) = res["exact"], res["approx"]
    if not (np.array_equal(m_e, m_a)
            and np.array_equal(s_e[m_e], s_a[m_a])):
        raise AssertionError("phase 5: exact and approx segments differ")
    log(f"phase 5: valid segments identical ({int(m_e.sum())} in total)")
    log_ab("phase 5: whole detector", alternate(dets, imgs))
    _, _, _, prog_a = timed(device_pipeline_full, imgs, params, mean,
                            cfg=PipelineConfig(det_topk="approx"), iters=1)
    log_ab("phase 5: whole program", alternate(
        {"exact": prog, "approx": prog_a}, imgs, params, mean))


def gpu_tests() -> None:
    """Phase 6: the tests marked gpu, run in this process."""
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")])
    if rc != 0:
        raise AssertionError(f"phase 6: gpu tests exit {rc}")


def four_cards() -> None:
    """dp=4 x tp=1: 128 images, 32 per card, through the program behind
    ``sharded_pipeline_full``, against one card in four batches of 32
    (the same per-card program)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vanishing_points_2017_tpu.parallel.inference import sharded_program
    from vanishing_points_2017_tpu.parallel.mesh import make_mesh
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)
    from vanishing_points_2017_tpu.utils.compile_cache import REQUIRE_PICKS

    # The one-card program compiles with REQUIRE_PICKS (every autotuned
    # choice from the shipped picks). The picks do not cover the sharded
    # program: some of its fusions have no recorded pick and are autotuned
    # as it compiles, here or in whichever process filled the persistent
    # cache. Its convolutions and matmuls have the one-card shapes; the
    # check below says whether the two programs agree bit for bit.
    devs = jax.devices()[:4]
    params, mean = load_inputs()
    scenes, imgs_np = scenes_and_images(4 * BATCH)
    cfg = PipelineConfig()
    mesh = make_mesh(dp=4, tp=1, devices=devs)
    # inputs placed once, so the steady loop times the devices' work
    repl = NamedSharding(mesh, P())
    params = jax.device_put(params, repl)
    mean = jax.device_put(jnp.asarray(mean), repl)
    imgs = jax.device_put(imgs_np, NamedSharding(mesh, P("dp")))
    compile_s, run_s, out, _ = timed(sharded_program(mesh, cfg), imgs,
                                     params, mean)
    log(f"four cards: compile {compile_s:.1f} s")
    log(f"four cards: {4 * BATCH / run_s:.2f} img/s steady "
        f"({run_s * 1e3:.2f} ms per batch of {4 * BATCH}, inputs resident) "
        f"on 4 x {card().splitlines()[0]}")
    p1 = jax.device_put(params, devs[0])
    m1 = jax.device_put(mean, devs[0])
    one = device_pipeline_full.lower(
        jax.device_put(imgs_np[:BATCH], devs[0]), p1, m1,
        cfg=cfg).compile(REQUIRE_PICKS)
    ref = [one(jax.device_put(imgs_np[i:i + BATCH], devs[0]), p1, m1)
           for i in range(0, 4 * BATCH, BATCH)]
    for key in ("hp1", "hp2"):
        want = np.concatenate([np.asarray(r[key]) for r in ref])
        np.testing.assert_allclose(np.asarray(out[key]), want, rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    same = all(np.array_equal(np.asarray(out[k]), np.concatenate(
        [np.asarray(r[k]) for r in ref])) for k in ("hp1", "hp2"))
    errs = horizon_errors(out, [s.horizon for s in scenes])
    log(f"four cards: hp1/hp2 match one card within 1e-5 on all "
        f"{4 * BATCH} images (bit-identical: {same}); median horizon "
        f"error {np.median(errs):.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 = run only the four-card data-parallel path")
    args = ap.parse_args()

    import jax

    devs = require_gpus(args.devices)
    phase0(devs)
    from vanishing_points_2017_tpu.utils import compile_cache
    compile_cache.enable()

    if args.devices == 4:
        four_cards()
    else:
        import jax.numpy as jnp

        scenes, imgs_np = scenes_and_images(BATCH)
        imgs = jnp.asarray(imgs_np)
        params, mean = load_inputs()
        prog, out = main_path(imgs, scenes, params, mean)
        plain_reference(imgs, scenes, params, mean, out)
        host_lsd_path(imgs_np, scenes, params, mean)
        ccl_phase(imgs, params, mean, prog)
        topk_phase(imgs, params, mean, prog)
        gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
