#!/usr/bin/env python3
"""Worker for ``__graft_entry__.dryrun_multiprocess``.

One process of an n-process CPU 'pod': initialises ``jax.distributed`` from
the env (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID),
builds the hybrid (dp across processes, tp inside) mesh and runs one sharded
CNN train step on tiny shapes. Prints ``DRYRUN_LOSS <value>`` on success;
the spawner asserts all processes report the identical finite loss.
"""

import os
import sys

n_local = int(os.environ.get("VP_LOCAL_DEVICES", "2"))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={n_local}").strip()

import jax  # noqa: E402

# a CPU dry run by design, whatever accelerator the host has
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vanishing_points_2017_tpu.parallel import distributed as dist  # noqa: E402

dist.initialize()

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from vanishing_points_2017_tpu.models import train  # noqa: E402
from vanishing_points_2017_tpu.parallel import mesh as pmesh  # noqa: E402


def main() -> int:
    tp = 2 if n_local % 2 == 0 else 1
    mesh = dist.make_multislice_mesh(tp=tp)
    assert mesh.shape["dp"] * mesh.shape["tp"] == len(jax.devices())

    size = 120
    state = train.init_state(jax.random.PRNGKey(0), input_size=size)
    state = train.TrainState(
        params=pmesh.shard_params(state.params, mesh),
        momentum=pmesh.shard_params(state.momentum, mesh),
        step=jax.device_put(state.step, NamedSharding(mesh, P())))

    batch = mesh.shape["dp"] * 2
    batch_sh = pmesh.batch_sharding(mesh)
    # every process materialises its own shard of the SAME global batch
    imgs = jax.make_array_from_callback(
        (batch, size, size, 1), batch_sh,
        lambda idx: jnp.ones((batch, size, size, 1), jnp.float32)[idx] * 0.25)
    labels = jax.make_array_from_callback(
        (batch, 20, 20), batch_sh,
        lambda idx: jnp.zeros((batch, 20, 20), jnp.float32)[idx])

    state, loss = train.train_step(state, imgs, labels, jax.random.PRNGKey(1))
    jax.block_until_ready(loss)
    loss = float(jax.device_get(jax.tree.map(lambda x: x, loss)))
    assert loss == loss and abs(loss) < 1e9, loss
    print(f"process {jax.process_index()}/{jax.process_count()} "
          f"mesh dp={mesh.shape['dp']} tp={mesh.shape['tp']}")
    print(f"DRYRUN_LOSS {loss:.9f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
