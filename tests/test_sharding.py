"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8) — the JAX-standard replacement for
distributed tests (SURVEY §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vanishing_points_2017_tpu.parallel import mesh as pmesh


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    m = pmesh.make_mesh(dp=4, tp=2)
    assert m.shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError):
        pmesh.make_mesh(dp=3, tp=2)


def test_param_sharding_rules():
    from vanishing_points_2017_tpu.models import cnn

    m = pmesh.make_mesh(dp=4, tp=2)
    params = cnn.init_params(jax.random.PRNGKey(0), input_size=250)
    sharded = pmesh.shard_params(params, m)
    # fc6 weight sharded over tp on the output dim
    fc6 = sharded["fc6"]["w"]
    assert fc6.sharding.spec == jax.sharding.PartitionSpec(None, "tp")
    # conv weights replicated
    c1 = sharded["conv1"]["w"]
    assert c1.sharding.spec == jax.sharding.PartitionSpec()


@pytest.mark.slow
def test_dryrun_multichip_full():
    """The driver-facing contract: full training step + batched inference
    pipeline over an 8-device mesh."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(__file__), "..",
                                    "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


@pytest.mark.slow
def test_entry_compiles():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry2", os.path.join(os.path.dirname(__file__), "..",
                                     "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn).lower(*args).compile()
    assert out is not None


def test_sharded_lsim_matches_dense():
    import numpy as np
    from vanishing_points_2017_tpu.ops import lines as lineops
    from vanishing_points_2017_tpu.parallel.sharded_lsim import (
        calc_lsim_sharded)

    rng = np.random.default_rng(0)
    n = 64  # divisible by dp=8
    lp = rng.uniform(-1, 1, size=(n, 4)).astype(np.float32)
    mask = np.arange(n) < 50

    mesh = pmesh.make_mesh(dp=8, tp=1)
    got = np.asarray(calc_lsim_sharded(jnp.asarray(lp), jnp.asarray(mask),
                                       mesh, sigma=1.0))
    want = np.asarray(lineops.calc_lsim(jnp.asarray(lp), jnp.asarray(mask),
                                        sigma=1.0))
    np.testing.assert_allclose(got, want, atol=2e-6)

    with __import__("pytest").raises(ValueError):
        calc_lsim_sharded(jnp.asarray(lp[:63]), jnp.asarray(mask[:63]), mesh)


@pytest.mark.slow
def test_sharded_inference_matches_single_device():
    """The serving-scale path (parallel/inference.py): the zero-host-
    round-trip pipeline dp-sharded over a (4, 1) mesh must produce the
    single-device program's outputs (each dp shard runs the per-device
    program on its images, with the params replicated; horizons must
    agree to f32 tolerance)."""
    from vanishing_points_2017_tpu.models import cnn, synth
    from vanishing_points_2017_tpu.data.datasets import render_scene_image
    from vanishing_points_2017_tpu.pipeline import (PipelineConfig,
                                                    device_pipeline_full)
    from vanishing_points_2017_tpu.em import EMConfig
    from vanishing_points_2017_tpu.parallel.inference import (
        sharded_pipeline_full)

    rng = np.random.default_rng(7)
    imgs = np.stack([
        render_scene_image(synth.make_scene(rng, lines_per_vp=10,
                                            outliers=3),
                           size=160, rng=rng).astype(np.uint8)
        for _ in range(8)])
    cfg = PipelineConfig(sphere_size=200, n_pad=128,
                         em=EMConfig(num_iter=12))
    params = cnn.init_params(jax.random.PRNGKey(0), input_size=200)
    mean = np.zeros((200, 200), np.float32)

    want = device_pipeline_full(jnp.asarray(imgs), params,
                                jnp.asarray(mean), cfg=cfg)
    mesh = pmesh.make_mesh(dp=4, tp=1, devices=jax.devices()[:4])
    got = sharded_pipeline_full(mesh, jnp.asarray(imgs), params, mean, cfg)

    assert got["hp1"].sharding.is_equivalent_to(
        pmesh.batch_sharding(mesh), got["hp1"].ndim)
    np.testing.assert_array_equal(np.asarray(got["em_valid"]),
                                  np.asarray(want["em_valid"]))
    for key, atol in (("hp1", 5e-4), ("hp2", 5e-4), ("vp", 5e-4),
                      ("counts", 1.5)):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), atol=atol,
                                   err_msg=key)

    with pytest.raises(ValueError):
        sharded_pipeline_full(mesh, jnp.asarray(imgs[:6]), params, mean, cfg)


@pytest.mark.slow
def test_dryrun_multiprocess_dcn():
    """The multi-host analogue: 2 separate
    processes x 2 virtual devices, jax.distributed over a localhost
    coordinator, hybrid mesh with dp crossing the process boundary
    and tp inside; all processes must report the identical train loss."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry3", os.path.join(os.path.dirname(__file__), "..",
                                     "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multiprocess(2, 2)


def test_sharded_inference_refuses_tp():
    """Serving replicates the model, so a tp axis would only repeat each
    shard's work: the entry point refuses it before compiling anything."""
    from vanishing_points_2017_tpu.parallel.inference import (
        sharded_pipeline_full)
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    mesh = pmesh.make_mesh(dp=4, tp=2)
    imgs = jnp.zeros((8, 16, 16), jnp.uint8)
    with pytest.raises(ValueError, match="tp=1"):
        sharded_pipeline_full(mesh, imgs, {}, jnp.zeros((4, 4)),
                              PipelineConfig())
