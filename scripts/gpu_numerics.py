#!/usr/bin/env python3
"""Numerics of the fused program on one NVIDIA GPU: compile determinism
and the float32 precision pins.

    python scripts/gpu_numerics.py [--out chiprun_out/numerics]

1. Compile determinism. XLA's GPU autotuner times the candidate cuDNN and
   cuBLAS algorithms while it compiles and keeps the fastest. Each run below
   is a fresh process (one at a time, so one process holds the card) that
   compiles the b32 640x640 ``device_pipeline_full`` (chip_smoke.py's phase-1
   program) with the persistent compile cache off, runs it on 128 bench
   images in four batches, twice (run-to-run check), and saves hp1/hp2:

     tuned_a, tuned_b   autotuning on (XLA's level 4), each dumping the
                        algorithms it picked;
     tuned_a_replay     autotuning on, loading tuned_a's picks;
     tuned_cached       autotuning on, with the persistent compile cache on.
                        JAX then also turns on XLA's per-fusion autotune
                        cache beside it, so the picks come from whichever
                        earlier process (on whichever card) tuned each
                        fusion first; dumps its picks;
     pinned_a, pinned_b autotuning off (level 0);
     pinned_cached      autotuning off, persistent cache on (as chip_smoke.py
                        and bench.py keep it);
     detops_a, detops_b autotuning on with xla_gpu_deterministic_ops;
     picks              the picks shipped in assets/autotune_h100.txt loaded,
                        and every pick required to come from that file;
     record             (only when named in --only) autotuning on, dumping
                        its picks to assets/autotune_h100.txt: regenerates
                        the shipped picks after the program changes.

   The parent compares the runs with tuned_a and the pairs bit for bit, and
   the autotune dumps with tuned_a's.
2. Precision. Phases 2 and 3 of chip_smoke.py with the geometric float32
   products at Precision.HIGHEST (as shipped), with the pins removed (XLA's
   default float32 precision), and with the pins removed under TF32
   (``jax.default_matmul_precision("tensorfloat32")``), against one CPU
   reference, to show whether those checks see the lower precision; and
   the same three settings on two pinned products alone (a 512x512 matmul
   and calc_lsim of 512 segments), GPU against CPU.

Prints a summary; the per-run arrays and dumps go to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_IMAGES = 128
TUNED, PINNED = {"xla_gpu_autotune_level": 4}, {"xla_gpu_autotune_level": 0}
DETOPS = {"xla_gpu_deterministic_ops": True}
PICKS = os.path.join(ROOT, "assets", "autotune_h100.txt")


def log(msg: str) -> None:
    print(msg, flush=True)


def runs(out: str) -> list[tuple[str, dict, bool]]:
    """(name, compile options, persistent cache on) of each fresh process."""
    def dump(name):
        return {"xla_gpu_dump_autotune_results_to":
                os.path.join(out, f"{name}.autotune.txt")}

    return [
        ("tuned_a", TUNED | dump("tuned_a"), False),
        ("tuned_b", TUNED | dump("tuned_b"), False),
        ("tuned_a_replay", TUNED | {"xla_gpu_load_autotune_results_from":
                                    dump("tuned_a").popitem()[1]}, False),
        ("tuned_cached", TUNED | dump("tuned_cached"), True),
        ("pinned_a", PINNED, False),
        ("pinned_b", PINNED, False),
        ("pinned_cached", PINNED, True),
        ("detops_a", TUNED | DETOPS | dump("detops_a"), False),
        ("detops_b", TUNED | DETOPS | dump("detops_b"), False),
        ("picks", {"xla_gpu_load_autotune_results_from": PICKS,
                   "xla_gpu_require_complete_aot_autotune_results": True},
         False),
        ("record", TUNED | {"xla_gpu_dump_autotune_results_to": PICKS},
         False),
    ]


def determinism_child(name: str, options: dict, cache: bool,
                      out: str) -> None:
    """One fresh process: compile, run twice, save hp1/hp2 and times."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke as cs
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    _device_pipeline_full)
    from vanishing_points_2017_tpu.utils import compile_cache

    if cache:
        tune_dir = os.path.join(compile_cache.enable(),
                                "xla_gpu_per_fusion_autotune_cache_dir")
        log(f"{name}: per-fusion autotune cache holds "
            f"{len(os.listdir(tune_dir)) if os.path.isdir(tune_dir) else 0} "
            "entries")
    else:
        jax.config.update("jax_enable_compilation_cache", False)
    _, imgs = cs.scenes_and_images(N_IMAGES)
    params, mean = cs.load_inputs()
    batches = [jnp.asarray(imgs[i:i + cs.BATCH])
               for i in range(0, N_IMAGES, cs.BATCH)]
    cfg = PipelineConfig()
    # The undecorated program under a jit of its own, so each run compiles
    # with exactly the options given here.
    fn = jax.jit(lambda im, p, m: _device_pipeline_full(im, p, m, cfg))
    t0 = time.perf_counter()
    prog = fn.lower(batches[0], params, mean).compile(options)
    compile_s = time.perf_counter() - t0

    def all_hp():
        outs = [prog(b, params, mean) for b in batches]
        return np.concatenate([np.stack([np.asarray(o["hp1"]),
                                         np.asarray(o["hp2"])], 1)
                               for o in outs])

    hp = all_hp()
    rerun_equal = bool(np.array_equal(hp, all_hp()))
    run_s, _ = cs.run_time(prog, batches[0], params, mean, iters=10)
    np.save(os.path.join(out, f"{name}.npy"), hp)
    log(json.dumps({"run": name, "compile_s": round(compile_s, 1),
                    "ms_per_batch": round(run_s * 1e3, 3),
                    "rerun_bit_identical": rerun_equal}))


def dump_choices(path: str) -> list[str]:
    """The algorithm choices of an autotune dump, without its timings."""
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return sorted(line.strip() for line in fh
                      if not any(k in line for k in ("run_time", "seconds",
                                                     "nanos")))


def compare(out: str, names: list[str]) -> None:
    import numpy as np

    hp = {n: np.load(os.path.join(out, f"{n}.npy")) for n in names
          if os.path.exists(os.path.join(out, f"{n}.npy"))}
    pairs = [("tuned_a", n) for n in names if n != "tuned_a"]
    pairs += [("pinned_a", "pinned_b"), ("pinned_a", "pinned_cached"),
              ("detops_a", "detops_b")]
    for a, b in pairs:
        if a not in hp or b not in hp:
            log(f"{a} vs {b}: missing (a run failed)")
            continue
        d = np.abs(hp[a] - hp[b])
        img = d.reshape(d.shape[0], -1).max(1)
        log(f"{a} vs {b}: bit-identical {np.array_equal(hp[a], hp[b])}; "
            f"max |diff| {d.max():.3g}; images with a diff > 1e-5: "
            f"{int((img > 1e-5).sum())}/{img.size}, > 1e-3: "
            f"{int((img > 1e-3).sum())}")
    ca = dump_choices(os.path.join(out, "tuned_a.autotune.txt"))
    for k in ("tuned_b", "tuned_cached", "detops_a", "detops_b"):
        cb = dump_choices(os.path.join(out, f"{k}.autotune.txt"))
        log(f"autotune dumps: tuned_a {len(ca)} lines, {k} {len(cb)} lines, "
            f"{len(set(ca) ^ set(cb))} lines in one but not the other")


def precision_child(out: str) -> None:
    """Phases 2 and 3 of chip_smoke.py, and two pinned products alone,
    with the HIGHEST pins, without them, and without them under TF32."""
    import contextlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke as cs
    from vanishing_points_2017_tpu.em import em, weights
    from vanishing_points_2017_tpu.ops import lines, probability
    from vanishing_points_2017_tpu.parallel import sharded_lsim
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)

    jax.config.update("jax_enable_compilation_cache", False)
    scenes, imgs = cs.scenes_and_images(cs.BATCH)
    params, mean = cs.load_inputs()
    truths = [s.horizon for s in scenes]
    cpu8 = cs.cpu_reference(imgs[:8], params, mean)
    bundles = cs.lsd_bundles(imgs[:4], params, mean)
    cpu4 = cs.lsd_run(bundles, params, mean, on_cpu=True)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 512, 512)).astype(np.float32)
    lp = rng.uniform(-1, 1, (512, 4)).astype(np.float32)
    mask = np.ones(512, bool)
    cpu = jax.devices("cpu")[0]

    def products():
        return (jnp.matmul(a, b, precision=lines.HIGHEST),
                lines.calc_lsim(jnp.asarray(lp), jnp.asarray(mask)))

    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        want = [np.asarray(x) for x in products()]
    settings = (("pins HIGHEST", lines.HIGHEST, None),
                ("pins removed", None, None),
                ("pins removed, TF32", None, "tensorfloat32"))
    for label, pin, ctx in settings:
        for mod in (lines, probability, em, weights, sharded_lsim):
            mod.HIGHEST = pin
        jax.clear_caches()
        with (jax.default_matmul_precision(ctx) if ctx
              else contextlib.nullcontext()):
            got = [np.asarray(x) for x in products()]
            gpu = device_pipeline_full(jnp.asarray(imgs), params, mean,
                                       PipelineConfig())
            gpu8 = {k: gpu[k][:8] for k in ("hp1", "hp2")}
            gpu4 = cs.lsd_run(bundles, params, mean)
        log(f"{label}: GPU vs CPU max relative error: 512x512 matmul "
            + ", calc_lsim ".join(
                f"{np.abs(g - w).max() / np.abs(w).max():.3g}"
                for g, w in zip(got, want)))
        for phase, g, c, t in (("phase 2", gpu8, cpu8, truths[:8]),
                               ("phase 3", gpu4, cpu4, truths[:4])):
            try:
                cs.compare_horizons(f"{label}, {phase}", g, c, t)
                log(f"{label}, {phase}: passes")
            except AssertionError as e:
                log(f"{label}, {phase}: FAILS ({e})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "numerics"))
    ap.add_argument("--only", help="comma-separated runs (and/or "
                    "'precision') to make; default all")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import chip_smoke as cs

    if args.child == "precision":
        cs.require_gpus(1)
        precision_child(args.out)
        return 0
    if args.child:
        cs.require_gpus(1)
        name, options, cache = next(r for r in runs(args.out)
                                    if r[0] == args.child)
        determinism_child(name, options, cache, args.out)
        return 0

    os.makedirs(args.out, exist_ok=True)
    log(f"card: {cs.card()}")
    failed = []
    names = [r[0] for r in runs(args.out)] + ["precision"]
    if args.only:
        names = [n for n in names if n in args.only.split(",")]
    else:
        names.remove("record")
    for name in names:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--out", args.out, "--child", name],
                            timeout=900).returncode
        if rc:
            log(f"run {name}: exit {rc}")
            failed.append(name)
    compare(args.out, [r[0] for r in runs(args.out)
                       if os.path.exists(os.path.join(args.out,
                                                      f"{r[0]}.npy"))])
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
