"""Mesh-sharded inference: the serving-scale path for the fused pipeline.

The reference scales evaluation by running more CPU processes over the
pickle bus (``evaluation.py:295-307`` of fkluger/vanishing_points_2017
supports [start:end) range slicing so several invocations can split a
dataset). Here the zero-host-round-trip program
(``pipeline.device_pipeline_full``) is a ``vmap`` over independent images,
so each device of the mesh's ``dp`` axis runs that same program on its own
slice of the batch (``shard_map``), with NO collectives on the forward
path. The CNN's parameters are replicated: the 43.7 MB model fits on every
device, and sharding it would only add collectives.

Numerics are those of the single-device program at the per-device batch
(each device runs it as is), asserted by ``tests/test_sharding.py`` and,
on four GPUs, by ``chip_smoke.py --devices 4``.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..pipeline import PipelineConfig, _device_pipeline_full
from ..utils.compile_cache import COMPILER_OPTIONS

# jitted-entry cache: (mesh, cfg) -> jitted program (jax.jit keeps one
# executable per input shape). A fresh jax.jit per call would retrace and
# recompile the whole pipeline every invocation.
_FN_CACHE: dict = {}


def sharded_pipeline_full(mesh: Mesh, images: jnp.ndarray, params: Any,
                          mean: jnp.ndarray, cfg: PipelineConfig) -> dict:
    """Run the zero-host-round-trip pipeline dp-sharded over ``mesh``.

    images: (B, H, W) grayscale batch, B divisible by the dp axis size.
    Each dp shard runs ``device_pipeline_full`` on B/dp images under
    ``shard_map``, so the detector's GPU kernel (a custom call with no
    partitioning rule) runs on each device's own images. The mesh's tp
    axis must have size 1: the parameters are replicated, so devices along
    tp would only compute the same shard again. Returns the same dict as
    ``device_pipeline_full``; leaves keep their dp sharding.
    """
    if mesh.shape["tp"] != 1:
        raise ValueError(
            f"serving replicates the model; use a mesh with tp=1, not "
            f"tp={mesh.shape['tp']}")
    if images.shape[0] % mesh.shape["dp"]:
        raise ValueError(
            f"batch {images.shape[0]} not divisible by dp={mesh.shape['dp']}")
    img_s = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())
    return sharded_program(mesh, cfg)(
        jax.device_put(images, img_s), jax.device_put(params, repl),
        jax.device_put(jnp.asarray(mean), repl))


def sharded_program(mesh: Mesh, cfg: PipelineConfig):
    """The jitted dp-sharded program behind :func:`sharded_pipeline_full`
    (images, params, mean) -> outputs, one per (mesh, cfg)."""
    key = (mesh, cfg)
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = jax.jit(jax.shard_map(
            lambda im, p, mn: _device_pipeline_full(im, p, mn, cfg=cfg),
            mesh=mesh, in_specs=(P("dp"), P(), P()), out_specs=P("dp"),
            check_vma=False), compiler_options=COMPILER_OPTIONS)
        _FN_CACHE[key] = fn
    return fn
