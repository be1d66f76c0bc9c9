"""Device-mesh construction and sharding rules.

The reference's only parallelism is joblib CPU pools inside one image's EM
(``vp_localisation.py:44,92,647`` of fkluger/vanishing_points_2017) plus
on-disk pickles between stages (SURVEY §2.10). Here:

* **dp** axis — data parallelism over images: the batched pipeline and the
  CNN training batch shard their leading axis here; XLA inserts the gradient
  all-reduces (NCCL over NVLink on a GPU host) for the sharded-batch
  matmuls. Inference runs one per-device program per dp shard
  (``parallel/inference.py``).
* **tp** axis — tensor parallelism over the wide fc6/fc7 layers (the only
  weights where sharding pays: fc6 is 57600x4096 = 94% of the model's
  parameters). fc6's output dim and fc7's input dim are sharded so the
  activation stays tp-sharded between them and XLA places a single
  reduce-scatter/all-gather pair. Used by training only (serving
  replicates the model and takes tp=1); the GPUs of one host
  are joined all to all, so the mesh follows the algorithm, not a topology.

Multi-process runs initialise ``jax.distributed`` before calling
:func:`make_mesh`; the mesh then spans all processes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dp: int | None = None, tp: int = 1,
              devices=None) -> Mesh:
    """Build a (dp, tp) mesh. Defaults to all devices on the dp axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def param_spec(path, leaf) -> P:
    """Sharding rule for a CNN parameter leaf (see module docstring)."""
    keys = [getattr(p, "key", None) for p in path]
    if "fc6" in keys:
        return P(None, "tp") if leaf.ndim == 2 else P("tp")
    if "fc7" in keys:
        return P("tp", None) if leaf.ndim == 2 else P(None)
    return P()  # conv stack + fc8: replicated


def shard_params(params, mesh: Mesh):
    """Place a parameter pytree with the TP sharding rules."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jax.device_put(
            leaf, NamedSharding(mesh, param_spec(path, leaf))),
        params)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (image batch) sharding over dp."""
    return NamedSharding(mesh, P("dp"))


def shard_batch(tree, mesh: Mesh):
    """Shard every leaf's leading axis over dp."""
    s = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)
