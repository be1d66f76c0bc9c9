"""Multi-process (one process per host) initialisation helpers.

The reference has NO distributed runtime — stages talk through pickle files
and joblib worker pipes (SURVEY §2.10 of the fkluger/vanishing_points_2017
analysis). Here every process calls :func:`initialize` (a thin, env-aware
wrapper over ``jax.distributed.initialize``), after which ``jax.devices()``
spans all processes and the SAME ``shard_map``/``jit`` programs run across
them; XLA hands the collectives to NCCL.

Mesh layout rule for several hosts: put the model axis (tp) INSIDE a host,
where the GPUs share NVLink, and the data axis (dp) across hosts, which
then only carry the dp all-reduces. :func:`make_multislice_mesh` encodes
that with ``mesh_utils.create_hybrid_device_mesh``.
"""

from __future__ import annotations

import os

import jax

from .mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Start the JAX distributed runtime (idempotent).

    Arguments default to the standard env vars (``JAX_COORDINATOR_ADDRESS``
    / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), so launchers can export
    env and call ``initialize()`` bare. Nothing is autodetected on a plain
    GPU host, so the launcher must give the coordinator address, the
    process count and this process's id.
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def make_multislice_mesh(tp: int = 1):
    """A (dp, tp) mesh that keeps tp inside one process granule.

    Single-process: plain ``make_mesh``. Multi-process: a hybrid mesh whose
    outer (dp) axis crosses the process boundary while tp stays inside one
    process's devices, so the only cross-process collective is the dp
    all-reduce.
    """
    n_proc = jax.process_count()
    if n_proc == 1:
        return make_mesh(tp=tp)

    from jax.experimental import mesh_utils
    from jax.sharding import Mesh

    per_proc = len(jax.devices()) // n_proc
    if tp > per_proc or per_proc % tp != 0:
        raise ValueError(f"tp={tp} must divide the {per_proc} devices of "
                         "one process granule")
    # devices that report no distinct slice_index per process (CPU, GPU)
    # use the process as the granule
    slice_ids = {getattr(d, "slice_index", None) for d in jax.devices()}
    granule_by_process = len(slice_ids) != n_proc
    devices = mesh_utils.create_hybrid_device_mesh(
        mesh_shape=(per_proc // tp, tp),
        dcn_mesh_shape=(n_proc, 1),
        process_is_granule=granule_by_process)
    return Mesh(devices, ("dp", "tp"))
