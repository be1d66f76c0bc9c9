"""Responsibility regularisation, VP refits and inlier counting.

Dense masked re-derivations of ``weight_matrix`` (``vp_localisation.py:
515-524``), ``calc_new_vanishing_point`` (``vp_localisation.py:453-479``) and
``calc_vp_line_counts`` (``vp_localisation.py:482-512``) of
fkluger/vanishing_points_2017.

``calc_new_vanishing_point`` replaces the reference's SVD of the N x 3
weighted line matrix with the smallest eigenvector of the 3 x 3 Gram matrix
L^T diag(w~^2) L — identical null direction, but a fixed-size symmetric
eigenproblem that vmaps and compiles cleanly (SURVEY §7 hard-part 1).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import probability as prob
from ..ops.lines import HIGHEST


def smallest_eigvec_3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3.

    Closed form (trigonometric Cardano eigenvalues + adjugate cross-product
    eigenvector, the standard non-iterative 3x3 symmetric eigensolver):
    pure elementwise ops that fuse into the surrounding EM kernel, replacing
    XLA's iterative ``eigh`` in the ``lax.while_loop`` hot path. a: (..., 3, 3)
    symmetric; returns (..., 3), sign unspecified (callers sign-fix).

    Degenerate handling: if the smallest eigenvalue has multiplicity >= 2
    (all row cross products of A - lambda I vanish), any null-plane vector is
    a valid answer — we return a vector orthogonal to the largest row, and
    for a fully isotropic A (= q I) the fixed vector (1, 0, 0), mirroring the
    arbitrary-basis freedom ``eigh`` also has there.
    """
    q = jnp.trace(a, axis1=-2, axis2=-1)[..., None, None] / 3.0
    b = a - q * jnp.eye(3, dtype=a.dtype)
    p2 = jnp.sum(b * b, axis=(-2, -1), keepdims=True) / 6.0
    p = jnp.sqrt(p2)
    p_safe = jnp.where(p > 0, p, 1.0)
    bn = b / p_safe
    # det(bn) / 2, clamped into acos domain
    det = (bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2]
                            - bn[..., 1, 2] * bn[..., 2, 1])
           - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2]
                              - bn[..., 1, 2] * bn[..., 2, 0])
           + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1]
                              - bn[..., 1, 1] * bn[..., 2, 0]))
    r = jnp.clip(det / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # eigenvalues q + 2 p cos(phi + 2 pi k / 3); k = 1 gives the smallest
    lam_min = q[..., 0, 0] + 2.0 * p[..., 0, 0] * jnp.cos(
        phi + 2.0 * jnp.pi / 3.0)

    m = a - lam_min[..., None, None] * jnp.eye(3, dtype=a.dtype)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    cands = jnp.stack([c01, c02, c12], axis=-2)  # (..., 3, 3)
    norms = jnp.sum(cands * cands, axis=-1)  # (..., 3)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None].repeat(3, -1),
                            axis=-2)[..., 0, :]
    rn = jnp.sum(m * m, axis=-1)  # (..., 3) row norms^2
    # crosses of rank-1 rows are pure f32 noise; accept them only when their
    # norm is significant RELATIVE to the row scale (rel eigengap > ~1e-3 —
    # below that the TLS objective is flat and any null-plane vector is as
    # good an answer as eigh's)
    rn_max = jnp.max(rn, axis=-1)
    good = jnp.max(norms, axis=-1) > 1e-6 * rn_max * rn_max

    # multiplicity >= 2: null space is the plane orthogonal to the largest
    # row of m; build an in-plane vector robustly
    bi = jnp.argmax(rn, axis=-1)
    brow = jnp.take_along_axis(m, bi[..., None, None].repeat(3, -1),
                               axis=-2)[..., 0, :]
    # cross with the coordinate axis least aligned with brow
    ax = jnp.argmin(jnp.abs(brow), axis=-1)
    e = jnp.eye(3, dtype=a.dtype)[ax]
    alt = jnp.cross(brow, e)
    isotropic = jnp.max(rn, axis=-1) <= 0
    alt = jnp.where(isotropic[..., None],
                    jnp.array([1.0, 0.0, 0.0], a.dtype), alt)

    v = jnp.where(good[..., None], v, alt)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def weight_matrix(p_vl: jnp.ndarray, lweight: jnp.ndarray, lsim: jnp.ndarray,
                  bias: float = 1.0) -> jnp.ndarray:
    """Smooth responsibilities across similar lines.

    w[m, k] = (w'[k] + bias lw[k] <w', lsim[:, k]>) /
              (1 + bias lw[k] sum_n lsim[n, k]),   w' = p_vl[m, :] * lweight.

    One (M, N) x (N, N) matmul — the reference's dominant O(M N^2) Python
    loop, as one matrix product. Rows of dead VP slots (p_vl row = 0) stay 0;
    invalid lines (lweight = 0, lsim row/col = 0) stay 0.
    """
    wp = p_vl * lweight[None, :]  # (M, N)
    smooth = jnp.matmul(wp, lsim, precision=HIGHEST)  # (M, N)
    colsum = jnp.sum(lsim, axis=0)  # (N,)
    return (wp + bias * lweight[None, :] * smooth) / \
        (1.0 + bias * lweight * colsum)[None, :]


def calc_new_vanishing_point(l: jnp.ndarray, w: jnp.ndarray):
    """Weighted total-least-squares VP: null vector of diag(w / max w) @ L.

    l: (N, 3) unit lines, w: (N,) nonnegative weights (zero on padding).
    Returns (vp (3,), valid ()). valid is False when all weights are zero
    (the reference returns None there). The sign fix multiplies by
    sign(z) — a VP with z exactly 0 collapses to the zero vector, matching
    ``vp_localisation.py:474``; downstream NaN/err checks then remove it.
    """
    wmax = jnp.max(w)
    valid = wmax > 0
    wn = w / jnp.where(valid, wmax, 1.0)
    lw = l * wn[:, None]
    gram = jnp.matmul(lw.T, lw, precision=HIGHEST)  # L^T diag(wn^2) L
    vp = smallest_eigvec_3x3(gram)  # = SVD null direction
    vp = vp * jnp.sign(vp[2])
    return vp, valid


def assoc_argmax(w: jnp.ndarray, alive: jnp.ndarray,
                 lmask: jnp.ndarray) -> jnp.ndarray:
    """Per-line best VP slot by weight; -1 for invalid lines.

    Dead slots are pushed to -1 weight so they can never win a tie against an
    alive slot (the reference has no dead slots to begin with).
    """
    wm = jnp.where(alive[:, None], w, -1.0)
    a = jnp.argmax(wm, axis=0)
    return jnp.where(lmask, a, -1)


def calc_vp_line_counts(vp: jnp.ndarray, alive: jnp.ndarray, l: jnp.ndarray,
                        lp: jnp.ndarray, lmask: jnp.ndarray,
                        log_s: jnp.ndarray, decision_metric: jnp.ndarray,
                        lweights: jnp.ndarray, distance_measure: str,
                        thresh: float = 1.96 ** 2):
    """Inlier counting with outlier rejection (``calc_vp_line_counts``).

    Line n belongs to its argmax VP m unless its distance exceeds
    thresh * sqrt(s_m) or its weight is zero. Returns
    (counts (M,), counts_weighted (M,), vp_assoc (N,) with -1 outliers).
    """
    n = l.shape[0]
    assoc = assoc_argmax(decision_metric, alive, lmask)
    safe = jnp.clip(assoc, 0, vp.shape[0] - 1)
    vpn = vp[safe]  # (N, 3)

    if distance_measure == "dotprod":
        dist = jnp.abs(jnp.sum(vpn * l, axis=-1))
    elif distance_measure == "angle":
        dist = prob.calc_lvsq_single(vpn, lp)
    elif distance_measure == "area":
        dist = prob.calc_lvsq_area_single(vpn, lp)
    else:
        raise ValueError(f"unknown distance measure: {distance_measure}")

    cut = thresh * jnp.exp(0.5 * log_s)[safe]
    keep = (assoc >= 0) & ~(dist > cut) & (lweights != 0)
    assoc = jnp.where(keep, assoc, -1)

    onehot = (assoc[None, :] == jnp.arange(vp.shape[0])[:, None])  # (M, N)
    counts = jnp.sum(onehot, axis=1).astype(l.dtype)
    counts_weighted = jnp.sum(onehot * lweights[None, :], axis=1)
    return counts, counts_weighted, assoc
