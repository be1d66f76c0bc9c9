"""Every float32 product of the geometry (EM, line similarity, horizon
search) carries Precision.HIGHEST in the traced program. On a GPU an
unpinned float32 product may run in TF32; a CPU run computes full float32
either way and cannot show the difference, so the check is on the jaxpr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vanishing_points_2017_tpu.em import (EMConfig, expectation_maximisation,
                                          calculate_horizon_and_ortho_vp)
from vanishing_points_2017_tpu.em import weights as wmod
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.ops import lines as lineops
from vanishing_points_2017_tpu.ops import probability as prob
from vanishing_points_2017_tpu.parallel import mesh as pmesh
from vanishing_points_2017_tpu.parallel.sharded_lsim import calc_lsim_sharded

N = 64


def _dot_precisions(closed):
    """(input dtypes, precision) of every dot_general, sub-jaxprs included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append((tuple(str(v.aval.dtype) for v in eqn.invars),
                              eqn.params["precision"]))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(closed.jaxpr)
    return found


def _inputs():
    rng = np.random.default_rng(0)
    scene = synth.make_scene(rng, lines_per_vp=8, outliers=3)
    n = scene.segments.shape[0]
    lp = np.zeros((N, 4), np.float32)
    l = np.zeros((N, 3), np.float32)
    lp[:n], l[:n] = scene.segments, scene.lines
    return (jnp.asarray(l), jnp.asarray(lp), jnp.asarray(np.arange(N) < n),
            jnp.asarray(synth.vp_grid_label(scene.vps)))


def _em(l, lp, mask, cnn):
    img = jnp.zeros((500, 500), jnp.float32)
    res = expectation_maximisation(l, lp, cnn, img, mask, EMConfig())
    return calculate_horizon_and_ortho_vp(res.vp, res.counts, res.alive)


CASES = {
    "em_and_horizon": _em,
    "calc_lsim": lambda l, lp, mask, cnn: lineops.calc_lsim(lp, mask),
    "calc_lsim_sharded": lambda l, lp, mask, cnn: calc_lsim_sharded(
        lp, mask, pmesh.make_mesh(dp=8, tp=1)),
    "weight_matrix": lambda l, lp, mask, cnn: wmod.weight_matrix(
        jnp.ones((4, N)), mask.astype(jnp.float32), jnp.eye(N), 0.5),
    "calc_new_vanishing_point": lambda l, lp, mask, cnn:
        wmod.calc_new_vanishing_point(l, mask.astype(jnp.float32)),
    "calc_probabilities_pdf": lambda l, lp, mask, cnn: prob.calc_pdf(
        prob.pdf_params(cnn), jnp.zeros((N, 2))),
    "calc_lvsq_dotprod": lambda l, lp, mask, cnn: prob.calc_lvsq_dotprod(
        l[:4], l),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometric_products_pin_highest(name):
    dots = _dot_precisions(jax.make_jaxpr(CASES[name])(*_inputs()))
    assert dots, f"{name}: no matrix product traced"
    loose = [(dt, p) for dt, p in dots
             if "float32" in dt and p != (jax.lax.Precision.HIGHEST,) * 2]
    assert not loose, f"{name}: float32 products without HIGHEST: {loose}"
