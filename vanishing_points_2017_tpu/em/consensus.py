"""Bootstrap-consensus horizon estimation — beyond-parity robustness.

The round-5 knife-edge measurement (BASELINE.md; scripts/
perturb_knife_edge.py) quantifies a structural sensitivity of the
reference's design: the horizon is the argmax over C(n,3) triplet
scores (``calc_horizon.py:88-197`` of fkluger/vanishing_points_2017),
and on texture-heavy real photographs the top two triplets can score
within ~3% of each other (ihme_zentrum: rel margin 0.034), so a
sub-pixel perturbation of the detected segment population flips the
winner and moves the horizon by 0.3 image heights (7/16 flips at
0.5 px jitter). The reference runs ONE EM from ONE segment population
and has no answer to this.

``vmap`` turns K EM instances into one wider program, with no extra
dispatches; its device cost on the GPU is not measured yet. The
consensus estimator:

1. draw K-1 perturbed copies of the VALID segment population —
   member 0 is the untouched original. Default perturbation:
   "dropout" (each member keeps a random 85% subset), the measured
   winner — strictly fewer knife-edge flips than single-EM on every
   probed photo. The classical "bootstrap" (resample with
   replacement) is kept as a mode but measured WORSE on
   drift-sensitive populations: its integer reweighting is a harsher
   perturbation than the sub-pixel noise being defended against
   (BASELINE.md round-5 consensus table);
2. run the full production EM + triplet horizon search per member
   (same CNN prior for all members: the sphere render / CNN forward
   is computed once from the original population, so the ensemble
   perturbs exactly the likelihood side the knife edge lives on);
3. report the MEDOID member: the one whose horizon intersections with
   x = +-1 are jointly closest (L1) to the per-edge median over valid
   members. A medoid — not an average — so every reported output
   (VPs, counts, triplet, zenith) is a real, self-consistent EM
   result; averaging horizons from incompatible triplets would
   fabricate geometry no member estimated.

Opt-in via ``PipelineConfig.horizon_consensus = K`` (default 0 = off:
the production path is bit-identical to the reference-parity single
EM). Flip-rate measurements under the knife-edge harness:
``scripts/perturb_knife_edge.py --consensus K`` and the BASELINE.md
round-5 consensus table.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .em import EMConfig, EMResult, expectation_maximisation
from .horizon import calculate_horizon_and_ortho_vp


def masked_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median of ``x[mask]`` with static shapes (invalid sorted to +inf).

    Returns ``x[0]`` when nothing is valid (callers guard on that case
    anyway; this keeps the value finite so no NaN flows downstream).
    """
    xs = jnp.sort(jnp.where(mask, x, jnp.inf))
    nv = jnp.sum(mask).astype(jnp.int32)
    lo = xs[jnp.maximum((nv - 1) // 2, 0)]
    hi = xs[jnp.maximum(nv // 2, 0)]
    return jnp.where(nv > 0, 0.5 * (lo + hi), x[0])


def bootstrap_populations(l: jnp.ndarray, lp: jnp.ndarray,
                          lmask: jnp.ndarray, k: int, seed: int,
                          mode: str = "bootstrap",
                          drop: float = 0.15):
    """(l, lp, lmask) -> K stacked populations; member 0 is the original.

    ``mode="bootstrap"``: members 1..K-1 draw n_valid segments with
    replacement from the valid set (classical bootstrap: same
    population size, ~63% unique members each). ``mode="dropout"``: a
    gentler perturbation — each member keeps a random
    (1 - ``drop``)-fraction subset WITHOUT replacement (no duplicate
    weighting), sized for drift-sensitive populations where the full
    bootstrap's integer reweighting is a harsher perturbation than the
    noise being defended against (measured: BASELINE.md round-5
    consensus table). Static shapes throughout: draws index the
    valid-first permutation of the rows and each member's mask is a
    dense prefix.
    """
    n = l.shape[0]
    order = jnp.argsort(~lmask, stable=True)        # valid rows first
    n_valid = jnp.sum(lmask).astype(jnp.int32)
    nv1 = jnp.maximum(n_valid, 1)                   # guard empty input
    ls, lps = l[order], lp[order]

    if mode == "dropout":
        n_keep = jnp.maximum((nv1.astype(jnp.float32)
                              * (1.0 - drop)).astype(jnp.int32), 1)
        mask_boot = jnp.arange(n) < n_keep

        def draw(key):
            # random subset of the valid prefix, compacted to the front:
            # sort random scores ascending over valid rows (invalid to
            # +inf), take the first n_keep by that order
            u = jnp.where(jnp.arange(n) < n_valid,
                          jax.random.uniform(key, (n,)), jnp.inf)
            return jnp.argsort(u)
    else:
        mask_boot = jnp.arange(n) < n_valid

        def draw(key):
            u = jax.random.uniform(key, (n,))
            return jnp.minimum((u * nv1).astype(jnp.int32), nv1 - 1)

    keys = jax.random.split(jax.random.PRNGKey(seed), k - 1)
    idx = jax.vmap(draw)(keys)                      # (K-1, N)
    l_all = jnp.concatenate([l[None], ls[idx]], axis=0)
    lp_all = jnp.concatenate([lp[None], lps[idx]], axis=0)
    m_all = jnp.concatenate(
        [lmask[None], jnp.broadcast_to(mask_boot, (k - 1, n))], axis=0)
    return l_all, lp_all, m_all


@functools.partial(jax.jit, static_argnames=("em_cfg", "k", "seed",
                                             "maxbest", "mode", "guard"))
def consensus_em_horizon(l: jnp.ndarray, lp: jnp.ndarray,
                         pred: jnp.ndarray, sphere_image: jnp.ndarray,
                         lmask: jnp.ndarray, em_cfg: EMConfig, *,
                         k: int, seed: int = 0, mode: str = "dropout",
                         guard: float = 0.0, maxbest: int = 20,
                         theta_vmin: float = float(np.pi / 10),
                         pos_gate_ideal_tol: float = float("inf")):
    """K-member bootstrap EM + horizon; returns the medoid member.

    Returns ``(em: EMResult, horizon: 6-tuple, diag: dict)`` where the
    6-tuple matches :func:`calculate_horizon_and_ortho_vp`'s return for
    the picked member and ``diag`` carries the per-member horizon edge
    heights (``yl``/``yr``, the y of the x = +-1 intersections), member
    validity, the picked index and the valid-member edge spread
    (max - min) — the quantity the knife edge moves.

    ``guard`` > 0 enables the GUARDED medoid: the original population
    (member 0) is kept whenever its summed edge deviation from the
    member median, |yl0 - med_l| + |yr0 - med_r|, is within ``guard``
    (normalized frame units) — the ensemble then only *overrides* the
    base result when base fell off the member majority (a triplet
    flip), and never perturbs a base result that sits inside the
    member cloud (gate-marginal drift, where the ensemble's own
    resampling variance is the larger noise source — measured:
    BASELINE.md round-5 consensus table). ``guard=0`` always reports
    the medoid.
    """
    l_all, lp_all, m_all = bootstrap_populations(l, lp, lmask, k, seed,
                                                 mode=mode)

    emr: EMResult = jax.vmap(
        lambda a, b, m: expectation_maximisation(a, b, pred, sphere_image,
                                                 m, em_cfg)
    )(l_all, lp_all, m_all)
    hp1, hp2, z_vp, h_vp1, h_vp2, combo = jax.vmap(
        lambda v, c, a: calculate_horizon_and_ortho_vp(
            v, c, a, maxbest=maxbest, theta_vmin=theta_vmin,
            pos_gate_ideal_tol=pos_gate_ideal_tol)
    )(emr.vp, emr.counts, emr.alive)

    yl, yr = hp1[:, 1], hp2[:, 1]
    valid = emr.valid
    med_l = masked_median(yl, valid)
    med_r = masked_median(yr, valid)
    dist = jnp.where(valid, jnp.abs(yl - med_l) + jnp.abs(yr - med_r),
                     jnp.inf)
    pick = jnp.where(jnp.any(valid), jnp.argmin(dist), 0)
    if guard > 0.0:
        base_ok = valid[0] & (dist[0] <= guard)
        pick = jnp.where(base_ok, 0, pick)

    def take(t):
        return jax.tree.map(lambda x: x[pick], t)

    spread_l = (jnp.max(jnp.where(valid, yl, -jnp.inf))
                - jnp.min(jnp.where(valid, yl, jnp.inf)))
    spread_r = (jnp.max(jnp.where(valid, yr, -jnp.inf))
                - jnp.min(jnp.where(valid, yr, jnp.inf)))
    nv = jnp.sum(valid)
    diag = {
        "consensus_yl": yl, "consensus_yr": yr,
        "consensus_valid": valid, "consensus_pick": pick,
        "consensus_spread": jnp.where(
            nv > 0, jnp.maximum(spread_l, spread_r), jnp.inf),
    }
    horizon = (hp1[pick], hp2[pick], z_vp[pick], h_vp1[pick], h_vp2[pick],
               combo[pick])
    return take(emr), horizon, diag
