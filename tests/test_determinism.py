"""Determinism and batching-consistency properties (SURVEY §4: the
reference has no concurrency to race, so the JAX replacement is
determinism + vmap==single equivalence tests)."""

import pytest
import numpy as np
import jax
import jax.numpy as jnp

from vanishing_points_2017_tpu.em import EMConfig, expectation_maximisation
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.ops import sphere


def build(seed, n_pad=192):
    rng = np.random.default_rng(seed)
    scene = synth.make_scene(rng, lines_per_vp=25, outliers=6)
    n = min(scene.segments.shape[0], n_pad)
    lp = np.zeros((n_pad, 4), np.float32)
    l = np.zeros((n_pad, 3), np.float32)
    lp[:n] = scene.segments[:n]
    l[:n] = scene.lines[:n]
    lmask = np.arange(n_pad) < n
    cnn = synth.vp_grid_label(scene.vps)
    img = sphere.sphere_image_uint8(jnp.asarray(l), jnp.asarray(lmask),
                                    size=500).astype(jnp.float32)
    return (jnp.asarray(l), jnp.asarray(lp), jnp.asarray(cnn), img,
            jnp.asarray(lmask))


@pytest.mark.slow
def test_em_deterministic():
    args = build(0)
    cfg = EMConfig()
    r1 = expectation_maximisation(*args, cfg)
    r2 = expectation_maximisation(*args, cfg)
    np.testing.assert_array_equal(np.asarray(r1.vp), np.asarray(r2.vp))
    np.testing.assert_array_equal(np.asarray(r1.counts),
                                  np.asarray(r2.counts))
    np.testing.assert_array_equal(np.asarray(r1.vp_assoc),
                                  np.asarray(r2.vp_assoc))


@pytest.mark.slow
def test_vmap_em_matches_single():
    cfg = EMConfig(m_slots=32)
    singles = [build(s, n_pad=160) for s in (1, 2, 3)]
    stacked = tuple(jnp.stack([s[i] for s in singles]) for i in range(5))

    batched = jax.jit(jax.vmap(
        lambda l, lp, c, im, m: expectation_maximisation(l, lp, c, im, m, cfg)
    ))(*stacked)

    for b in range(3):
        one = expectation_maximisation(*singles[b], cfg)
        assert bool(batched.valid[b]) == bool(one.valid)
        np.testing.assert_allclose(np.asarray(batched.vp[b]),
                                   np.asarray(one.vp), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(batched.counts[b]),
                                      np.asarray(one.counts))


def test_sphere_render_deterministic():
    l, lp, cnn, img, lmask = build(4)
    i1 = np.asarray(sphere.sphere_render(l, lmask, size=256))
    i2 = np.asarray(sphere.sphere_render(l, lmask, size=256))
    np.testing.assert_array_equal(i1, i2)
