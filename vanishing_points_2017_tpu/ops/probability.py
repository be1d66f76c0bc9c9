"""E-step probability kernels for the VP expectation-maximisation.

Re-derivation of ``probability_functions.py`` of fkluger/vanishing_points_2017
as dense, masked, jittable jnp kernels. Two deliberate departures from the
reference's numerics, both behaviour-preserving:

1. **Log-space likelihoods.** The reference computes the per-line likelihood
   ``p(l|v) = N(lvsq; 0, s)`` in linear float64 where ``1/sqrt(2 pi s)`` can
   reach 1e100 (s is floored at 1e-200, ``probability_functions.py:139``).
   Accelerators are float32-first, so we carry ``log s`` and ``log p(l|v)`` instead;
   the posterior ``p(v|l)`` is always in [0, 1] and is materialised linearly.
   The evidence floor ``p(l) >= 1e-12`` (``probability_functions.py:117``)
   becomes a clamp on ``log p(l)``.

2. **Masked static shapes.** Lines are padded to a static N with a validity
   mask; VP slots are padded to a static M with an alive mask. Padded entries
   contribute exactly zero to every sum.

Reference quirks preserved on purpose:

* ``calc_pdf`` evaluates the hemisphere GMM with 5 wraparound displacement
  terms of which the 4th and 5th are identical
  (``probability_functions.py:25-26``) — term d4 is double counted and the
  symmetric ``beta + pi`` term is missing. ``wrap_quirk=False`` applies the
  symmetric fix instead.
* ``pdf_params`` keeps only the top-100 grid cells
  (``probability_functions.py:87``).
* The "area" distance takes a cross product of a 2-vector with a 3-vector,
  which NumPy zero-pads — i.e. the VP acts as a point at infinity
  (``probability_functions.py:200``). Reproduced exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from .lines import HIGHEST

LOG2PI = math.log(2.0 * math.pi)
LOG_S_FLOOR = -460.517018598809136804  # log(1e-200), reference's s floor
LOG_PL_FLOOR = -27.63102111592854820822  # log(1e-12), reference's p(l) floor


class PDFParams(NamedTuple):
    """Hemisphere GMM prior derived from the CNN's 20x20 grid."""

    means: jnp.ndarray    # (A*B, 2) cell-centre (alpha, beta)
    weights: jnp.ndarray  # (A*B,) normalized, top-k truncated, scaled
    sigma: jnp.ndarray    # () isotropic std dev


class PDFResult(NamedTuple):
    """Per-E-step probability bundle (the reference's ``PDF`` namedtuple)."""

    p_v: jnp.ndarray      # (M,) prior at VP positions; 0 on dead slots
    log_plv: jnp.ndarray  # (N, M) log likelihood
    p_vl: jnp.ndarray     # (M, N) posterior; 0 on dead slots / invalid lines
    log_pl: jnp.ndarray   # (N,) log evidence (floored)
    lvsq: jnp.ndarray     # (N, M) squared line-VP inconsistency
    angles: jnp.ndarray   # (M, 2) VP angles


def pdf_params(cnn_response: jnp.ndarray, confidence: float = 1.282,
               top_k: int = 100) -> PDFParams:
    """CNN 20x20 grid -> GMM prior (``pdf_params``, ``probability_functions.py:62-96``).

    sigma = pi / (confidence * A) puts ~80% of each component's mass within
    its cell at the default confidence. Cell (b, a) of the response maps to
    mean (alpha_a, beta_b); only the top-k cells keep nonzero weight; weights
    are normalized to sum 1 then scaled by 1 / (2 pi sigma^2).
    """
    a_dim, b_dim = cnn_response.shape[0], cnn_response.shape[1]
    sigma = jnp.asarray(jnp.pi / (confidence * a_dim), cnn_response.dtype)

    alphas = jnp.linspace(-(a_dim - 1.0) / a_dim * jnp.pi / 2,
                          (a_dim - 1.0) / a_dim * jnp.pi / 2, a_dim)
    betas = jnp.linspace(-(b_dim - 1.0) / b_dim * jnp.pi / 2,
                         (b_dim - 1.0) / b_dim * jnp.pi / 2, b_dim)
    # cell (b, a) -> (alpha_a, beta_b); flatten row-major like the response.
    mean_alpha = jnp.tile(alphas, b_dim)
    mean_beta = jnp.repeat(betas, a_dim)
    means = jnp.stack([mean_alpha, mean_beta], axis=-1)

    weights = cnn_response.reshape(-1)
    n = weights.shape[0]
    if top_k < n:
        kth = jnp.sort(weights)[n - top_k]  # keep the top_k largest
        weights = jnp.where(weights >= kth, weights, 0.0)
    wsum = jnp.sum(weights)
    weights = weights / jnp.where(wsum == 0, 1.0, wsum)
    weights = weights / (2.0 * jnp.pi * sigma * sigma)

    return PDFParams(means=means, weights=weights, sigma=sigma)


def calc_pdf(pdfpar: PDFParams, query: jnp.ndarray,
             wrap_quirk: bool = True) -> jnp.ndarray:
    """Evaluate the GMM prior at query angles (``calc_pdf``, ``probability_functions.py:8-40``).

    query: (Q, 2) of (alpha, beta). Returns (Q,).

    Five wraparound displacement terms handle the hemisphere's topological
    identifications; with ``wrap_quirk=True`` (default) the reference's
    duplicated d4 term is reproduced (d4 counted twice, the ``beta + pi``
    mirror missing).
    """
    mx = pdfpar.means[:, 0][None, :]  # (1, K)
    my = pdfpar.means[:, 1][None, :]
    qx = query[:, 0][:, None]  # (Q, 1)
    qy = query[:, 1][:, None]

    def sq(dx, dy):
        return dx * dx + dy * dy

    d1 = sq(qx - mx, qy - my)
    d2 = sq(qx - mx + jnp.pi, qy + my)
    d3 = sq(qx - mx - jnp.pi, qy + my)
    d4 = sq(qx + mx, qy - my - jnp.pi)
    if wrap_quirk:
        d5 = d4
    else:
        d5 = sq(qx + mx, qy - my + jnp.pi)

    inv = -0.5 / (pdfpar.sigma * pdfpar.sigma)
    e = (jnp.exp(d1 * inv) + jnp.exp(d2 * inv) + jnp.exp(d3 * inv)
         + jnp.exp(d4 * inv) + jnp.exp(d5 * inv))
    return jnp.matmul(e, pdfpar.weights, precision=HIGHEST)


def calc_angles(v: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) VP points -> (..., 2) angles (``calc_angles``, ``probability_functions.py:252-259``)."""
    beta = jnp.arcsin(jnp.clip(v[..., 1], -1.0, 1.0))
    inner = v[..., 0] / jnp.cos(beta)
    alpha = jnp.arcsin(jnp.clip(inner, -1.0, 1.0))
    return jnp.stack([alpha, beta], axis=-1)


def calc_lvsq_dotprod(v: jnp.ndarray, l: jnp.ndarray) -> jnp.ndarray:
    """(M,3) VPs x (N,3) lines -> (N,M) squared dot products
    (``calc_lvsq_dotprod``, ``probability_functions.py:150-154``)."""
    lv = jnp.matmul(l, v.T, precision=HIGHEST)
    return lv * lv


def calc_lvsq_angle(v: jnp.ndarray, lp: jnp.ndarray) -> jnp.ndarray:
    """Angle-consistency measure (``calc_lvsq_angle``, ``probability_functions.py:157-176``).

    For VP m and segment n: vec1 = midpoint_n - dehomogenized VP_m,
    vec2 = p1 - p2; lvsq = (1 - |cos(vec1, vec2)|)^2. Returns (N, M).
    """
    v2 = v[:, 0:2] / v[:, 2:3]  # (M, 2); inf/nan propagate like the reference
    lm = 0.5 * (lp[:, 0:2] + lp[:, 2:4])  # (N, 2)
    vec1 = lm[:, None, :] - v2[None, :, :]  # (N, M, 2)
    vec2 = lp[:, 0:2] - lp[:, 2:4]  # (N, 2)
    dot = jnp.sum(vec1 * vec2[:, None, :], axis=-1)
    n1 = jnp.linalg.norm(vec1, axis=-1)
    n2 = jnp.linalg.norm(vec2, axis=-1)[:, None]
    c = jnp.abs(dot / (n1 * n2))
    d = 1.0 - c
    return d * d


def calc_lvsq_area(v: jnp.ndarray, lp: jnp.ndarray) -> jnp.ndarray:
    """Triangle-area measure (``calc_lvsq_area``, ``probability_functions.py:179-209``).

    Keeps the reference's zero-padded cross product: the dehomogenized VP
    (vx, vy) enters as the infinite point (vx, vy, 0), so ``vl`` is the line
    through the segment midpoint with direction (vx, vy). b = distance of
    endpoint 1 to that line, c = half segment length, a = sqrt(c^2 - b^2),
    lvsq = (a b^2 / c)^2. Returns (N, M).
    """
    v2 = v[:, 0:2] / v[:, 2:3]  # (M, 2)
    vx, vy = v2[:, 0][None, :], v2[:, 1][None, :]  # (1, M)
    lm = 0.5 * (lp[:, 0:2] + lp[:, 2:4])  # (N, 2)
    lmx, lmy = lm[:, 0][:, None], lm[:, 1][:, None]  # (N, 1)
    # vl = cross((vx, vy, 0), (lmx, lmy, 1)) = (vy, -vx, vx*lmy - vy*lmx)
    vl0 = jnp.broadcast_to(vy, (lp.shape[0], v.shape[0]))
    vl1 = jnp.broadcast_to(-vx, (lp.shape[0], v.shape[0]))
    vl2 = vx * lmy - vy * lmx
    norm12 = jnp.sqrt(vl0 * vl0 + vl1 * vl1)
    p1x, p1y = lp[:, 0][:, None], lp[:, 1][:, None]
    b = jnp.abs(vl0 * p1x + vl1 * p1y + vl2) / norm12
    c = jnp.linalg.norm(lm - lp[:, 2:4], axis=-1)[:, None]
    a = jnp.sqrt(c * c - b * b)  # nan when b > c, as in the reference
    t = a * b * b / c
    return t * t


def calc_lvsq(v: jnp.ndarray, l: jnp.ndarray, lp: jnp.ndarray,
              distance_measure: str) -> jnp.ndarray:
    if distance_measure == "angle":
        return calc_lvsq_angle(v, lp)
    if distance_measure == "dotprod":
        return calc_lvsq_dotprod(v, l)
    if distance_measure == "area":
        return calc_lvsq_area(v, lp)
    raise ValueError(f"unknown distance measure: {distance_measure}")


def calc_probabilities(pdfpar: PDFParams, v: jnp.ndarray, alive: jnp.ndarray,
                       l: jnp.ndarray, lp: jnp.ndarray, log_s: jnp.ndarray,
                       lmask: jnp.ndarray, distance_measure: str = "angle",
                       wrap_quirk: bool = True) -> PDFResult:
    """Full E-step (``calc_probabilities``, ``probability_functions.py:99-120``).

    v: (M, 3) VP slots, alive: (M,) slot mask, l: (N, 3) unit homogeneous
    lines, lp: (N, 4) segments, log_s: (M,) log variance, lmask: (N,) line
    validity. Dead slots are replaced by the placeholder (0, 0, 1) before any
    geometry so their NaNs cannot leak into sums; their prior is zeroed, which
    removes them from the evidence.
    """
    v_safe = jnp.where(alive[:, None], v, jnp.array([0.0, 0.0, 1.0], v.dtype))

    angles = calc_angles(v_safe)
    p_v = calc_pdf(pdfpar, angles, wrap_quirk=wrap_quirk)
    p_v = jnp.where(alive, p_v, 0.0)

    lvsq = calc_lvsq(v_safe, l, lp, distance_measure)  # (N, M)

    log_s_f = jnp.maximum(log_s, LOG_S_FLOOR)
    # -lvsq / (2 s) computed as -exp(log lvsq - log s - log 2): exact for
    # lvsq == 0 (-> 0) and overflow-safe into -inf for s -> 0.
    expo = -jnp.exp(jnp.log(lvsq) - log_s_f[None, :] - jnp.log(2.0))
    log_plv = expo - 0.5 * (LOG2PI + log_s_f)[None, :]  # (N, M)

    log_pv = jnp.where(p_v > 0, jnp.log(jnp.where(p_v > 0, p_v, 1.0)), -jnp.inf)
    joint = log_plv + log_pv[None, :]  # (N, M)
    joint = jnp.where(alive[None, :], joint, -jnp.inf)
    jmax = jnp.max(joint, axis=1, keepdims=True)
    jmax_safe = jnp.where(jnp.isfinite(jmax), jmax, 0.0)
    log_pl = jnp.squeeze(jmax_safe, 1) + jnp.log(
        jnp.sum(jnp.exp(joint - jmax_safe), axis=1))
    log_pl = jnp.maximum(log_pl, LOG_PL_FLOOR)  # p(l) >= 1e-12

    p_vl = jnp.exp(joint - log_pl[:, None]).T  # (M, N), in [0, 1]
    p_vl = jnp.where(alive[:, None] & lmask[None, :], p_vl, 0.0)

    return PDFResult(p_v=p_v, log_plv=log_plv, p_vl=p_vl, log_pl=log_pl,
                     lvsq=lvsq, angles=angles)


def calc_lvsq_single(v: jnp.ndarray, lp: jnp.ndarray) -> jnp.ndarray:
    """Per-(VP, line) angle measure for the outlier test
    (``calc_lvsq_single``, ``probability_functions.py:212-224``).

    v: (..., 3), lp: (..., 4) broadcasting; returns (...,).
    """
    v2 = v[..., 0:2] / v[..., 2:3]
    lm = 0.5 * (lp[..., 0:2] + lp[..., 2:4])
    vec1 = lm - v2
    vec2 = lp[..., 0:2] - lp[..., 2:4]
    dot = jnp.sum(vec1 * vec2, axis=-1)
    c = jnp.abs(dot / (jnp.linalg.norm(vec1, axis=-1) *
                       jnp.linalg.norm(vec2, axis=-1)))
    d = 1.0 - c
    return d * d


def pdf_grid(cnn_response: jnp.ndarray, n: int = 50,
             wrap_quirk: bool = True) -> dict:
    """Evaluate the GMM prior on an n x n angle grid for visualization
    (``pdf_grid``/``calc_pdf_grid``, ``probability_functions.py:43-59,
    269-296`` — exported but unused by the reference pipeline)."""
    pdfpar = pdf_params(cnn_response)
    xs = jnp.arange(-jnp.pi / 2, jnp.pi / 2, jnp.pi / n)
    grid_x, grid_y = jnp.meshgrid(xs, xs)
    q = jnp.stack([grid_x.reshape(-1), grid_y.reshape(-1)], axis=-1)
    p = calc_pdf(pdfpar, q, wrap_quirk=wrap_quirk).reshape(grid_x.shape)
    return {"X": grid_x, "Y": grid_y, "p": p}


def calc_vp_line_triangles(vp: jnp.ndarray, lp: jnp.ndarray) -> jnp.ndarray:
    """Signed VP-facing test per segment (``calc_vp_line_triangles``,
    ``probability_functions.py:299-316`` — exported, unused in the main
    path). vp: (3,), lp: (N, 4). Returns (N,)."""
    v = vp[0:2] / vp[2]
    p1, p2 = lp[:, 0:2], lp[:, 2:4]
    a1 = jnp.sum((v[None, :] - p1) * (p2 - p1), axis=-1)
    a2 = jnp.sum((v[None, :] - p2) * (p1 - p2), axis=-1)
    return jnp.where(a1 > 0, jnp.minimum(a1, a2), a1)


def vp_is_within_image(vp: jnp.ndarray) -> jnp.ndarray:
    """|x/z|, |y/z| < 2 test (``vp_is_within_image``,
    ``probability_functions.py:319-324`` — note the looser +-2 bound vs the
    horizon module's +-1 ``VPinImage``)."""
    v2 = vp[..., 0:2] / vp[..., 2:3]
    return (jnp.abs(v2[..., 0]) < 2) & (jnp.abs(v2[..., 1]) < 2)


def calc_lvsq_area_single(v: jnp.ndarray, lp: jnp.ndarray) -> jnp.ndarray:
    """Per-(VP, line) area measure (``calc_lvsq_area_single``,
    ``probability_functions.py:227-248``)."""
    v2 = v[..., 0:2] / v[..., 2:3]
    vx, vy = v2[..., 0], v2[..., 1]
    lm = 0.5 * (lp[..., 0:2] + lp[..., 2:4])
    vl0, vl1 = vy, -vx
    vl2 = vx * lm[..., 1] - vy * lm[..., 0]
    norm12 = jnp.sqrt(vl0 * vl0 + vl1 * vl1)
    b = jnp.abs(vl0 * lp[..., 0] + vl1 * lp[..., 1] + vl2) / norm12
    c = jnp.linalg.norm(lm - lp[..., 2:4], axis=-1)
    a = jnp.sqrt(c * c - b * b)
    t = a * b * b / c
    return t * t
