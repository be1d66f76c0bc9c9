"""Compilation settings: the persistent XLA cache, and the compile options
every jitted inference entry point of the package uses.

The fused pipeline takes long enough to compile that a warm cache pays for
itself from the second process on. Call :func:`enable` before the first jit
execution. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
cache there and nothing is set here; otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (a fixed path, because the path is part of the
cache key).
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_ROOT, ".jax_cache")

# XLA's GPU autotuner times the candidate algorithms of every convolution,
# matmul and fusion while it compiles and keeps the fastest. Near-ties go
# either way, and the candidates round differently (split-K factors, fusion
# emitters), so two compilations of one program in two processes gave
# horizons up to 0.007 apart on 21 of 128 images (scripts/gpu_numerics.py;
# PERF.md). The entry points therefore load fixed picks, recorded on an
# H100 for the production program (b32 640x640, PipelineConfig defaults):
# XLA uses a loaded pick instead of timing, so that program computes the
# same bits whichever process compiled it. XLA loads the file once per
# process, at the first compile that names it: compile an entry point
# before any other program that shares its convolutions. Programs and cards
# the picks do not cover are autotuned as usual. Regenerate the file with
# ``scripts/gpu_numerics.py --only record`` when the program changes
# (chip_smoke.py fails while it does not cover the production program) or
# when JAX is upgraded. The CPU compiler ignores these options.
AUTOTUNE_PICKS = os.path.join(_ROOT, "assets", "autotune_h100.txt")
COMPILER_OPTIONS = {"xla_gpu_load_autotune_results_from": AUTOTUNE_PICKS}
# Added to COMPILER_OPTIONS where a check needs every pick from the file.
REQUIRE_PICKS = {"xla_gpu_require_complete_aot_autotune_results": True}


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
