"""Line-segment geometry kernels.

Batched, jittable re-derivations of the reference's per-pair Python loops
(``vp_localisation.py:700-776`` helpers, ``calc_lsim``
``vp_localisation.py:87-108``, ``line_rating_knn`` ``vp_localisation.py:34-72``
of fkluger/vanishing_points_2017). Those are the O(N^2) hot kernels the
reference fans out over CPU worker processes with joblib; here each becomes a
single dense masked (N, N) computation.

Conventions:
* A segment ``lp`` is a length-4 vector (x1, y1, x2, y2) in the pipeline's
  normalized image frame (origin at image centre, +y up, long axis scaled
  to [-1, 1]).
* All kernels take padded arrays of static length N plus a boolean validity
  ``mask``; padded rows contribute exactly zero to every output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PI = jnp.pi
# Precision of every geometric float32 product in ops/ and em/: full
# float32. A GPU may otherwise run them in TF32 (about three decimal
# digits), and the EM's tightest triplet decisions sit at relative margins
# of 0.002-0.005 (BASELINE.md knife-edge probes). Only the CNN runs in bf16.
HIGHEST = jax.lax.Precision.HIGHEST
# Sentinel self/padding distance; larger than any real distance in the
# normalized frame (max ~2*sqrt(2)). Matches the reference's self-distance 4
# (``vp_localisation.py:82``).
SELF_DIST = 4.0


def line_length(lp: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) segments -> (...,) Euclidean endpoint distance."""
    d = lp[..., 0:2] - lp[..., 2:4]
    return jnp.linalg.norm(d, axis=-1)


def lines_angles(lp: jnp.ndarray) -> jnp.ndarray:
    """Per-segment undirected inclination angle in [0, pi/2].

    phi = |arccos(clip(vx, -1, 1))| of the unit direction, folded so that
    phi > pi/2 becomes pi - phi (``vp_localisation.py:765-776``).
    """
    v = lp[..., 0:2] - lp[..., 2:4]
    n = jnp.linalg.norm(v, axis=-1)
    vx = v[..., 0] / jnp.where(n == 0, 1.0, n)
    phi = jnp.abs(jnp.arccos(jnp.clip(vx, -1.0, 1.0)))
    return jnp.where(phi > PI / 2, PI - phi, phi)


def pairwise_cosangle(lp: jnp.ndarray, f: float = 1.0) -> jnp.ndarray:
    """(N, 4) segments -> (N, N) sharpened absolute cosine of direction angle.

    cos(clip(f * dphi, -pi/2, pi/2)) where dphi is the absolute angle between
    the two segment directions (``lines_points_cosangle``,
    ``vp_localisation.py:715-724``). The sharpening factor f narrows the
    angular acceptance window (f=9 for similarity/knn, f=2 for split
    clustering).
    """
    v = lp[:, 0:2] - lp[:, 2:4]
    n = jnp.linalg.norm(v, axis=-1)
    vn = v / jnp.where(n == 0, 1.0, n)[:, None]
    dot = jnp.abs(jnp.matmul(vn, vn.T, precision=HIGHEST))
    # |cross_z| of the unit directions; atan2 formulation of
    # dphi = arccos(|dot|) — identical math, but float32-stable near dphi=0
    # (arccos loses ~sqrt(eps) precision exactly where f=9 amplifies it)
    cross = jnp.abs(vn[:, None, 0] * vn[None, :, 1]
                    - vn[:, None, 1] * vn[None, :, 0])
    dphi = jnp.arctan2(cross, dot)
    return jnp.cos(jnp.clip(f * dphi, -PI / 2, PI / 2))


def segment_point_distance(lp: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Distance from 2-D point(s) to segment(s), broadcasting.

    lp: (..., 4) segments; p: (..., 2) points (shapes must broadcast).
    Projects p onto the segment, clamping the parameter to [0, 1]
    (``line_segment_point_distance``, ``vp_localisation.py:743-758``).
    """
    a = lp[..., 0:2]
    b = lp[..., 2:4]
    ab = b - a
    denom = jnp.sum(ab * ab, axis=-1)
    t = jnp.sum((p - a) * ab, axis=-1) / jnp.where(denom == 0, 1.0, denom)
    t = jnp.clip(t, 0.0, 1.0)
    closest = a + t[..., None] * ab
    return jnp.linalg.norm(closest - p, axis=-1)


def pairwise_closest_distance(lp: jnp.ndarray) -> jnp.ndarray:
    """(N, 4) segments -> (N, N) min endpoint-to-other-segment distance.

    d(i, j) = min over the four endpoint/segment combinations
    (``line_distance_closest``, ``vp_localisation.py:727-740``). The diagonal
    is set to SELF_DIST = 4, matching the reference's self-distance sentinel.
    """
    n = lp.shape[0]
    p1 = lp[:, 0:2]
    p2 = lp[:, 2:4]
    # d_to[i, j] = distance from endpoint-k of j to segment i
    d1 = segment_point_distance(lp[:, None, :], p1[None, :, :])  # (N_seg, N_pt)
    d2 = segment_point_distance(lp[:, None, :], p2[None, :, :])
    d = jnp.minimum(jnp.minimum(d1, d2), jnp.minimum(d1.T, d2.T))
    return jnp.where(jnp.eye(n, dtype=bool), SELF_DIST, d)


def pairwise_proximity(lp: jnp.ndarray, sigma: float = 0.1,
                       dist: jnp.ndarray | None = None) -> jnp.ndarray:
    """(N, N) Gaussian proximity exp(-d^2 / (2 s^2)), s = sigma*min(len_i, len_j).

    (``lines_proximity``, ``vp_localisation.py:708-712``.)
    """
    if dist is None:
        dist = pairwise_closest_distance(lp)
    ll = line_length(lp)
    s = sigma * jnp.minimum(ll[:, None], ll[None, :])
    s2 = jnp.where(s == 0, 1.0, 2.0 * s * s)
    prox = jnp.exp(-(dist * dist) / s2)
    return jnp.where(s == 0, 0.0, prox)


def calc_lsim(lp: jnp.ndarray, mask: jnp.ndarray, sigma: float = 0.1) -> jnp.ndarray:
    """Masked (N, N) line-similarity matrix.

    lsim[i, j] = cosangle(f=9)[i, j] * proximity(sigma)[i, j], symmetric, with
    a zero diagonal and zeroed rows/columns for invalid lines
    (``calc_lsim`` + ``lines_similarity``, ``vp_localisation.py:87-108,
    700-705``; the reference leaves the diagonal zero because only j < i is
    filled before symmetrisation).
    """
    n = lp.shape[0]
    sim = pairwise_cosangle(lp, f=9.0) * pairwise_proximity(lp, sigma)
    sim = jnp.where(jnp.eye(n, dtype=bool), 0.0, sim)
    m2 = mask[:, None] & mask[None, :]
    return jnp.where(m2, sim, 0.0)


def line_rating_knn(lp: jnp.ndarray, mask: jnp.ndarray,
                    k1: int = 10, k2: int = 3, sigma: float = 1.0) -> jnp.ndarray:
    """Per-line kNN quality score (``line_rating_knn``, ``vp_localisation.py:34-72``).

    For each line: among the k1 nearest segments (by closest endpoint-to-
    segment distance, self included at distance 4), take the k2 best by
    sharpened cosine angle (f=9), sum proximity * cosangle over them, and
    divide by k2. k1/k2 are clipped to the number of valid lines.

    Padded/invalid lines never enter a neighbourhood (distance pushed to
    +inf-like sentinel) and receive score 0 themselves.
    """
    n = lp.shape[0]
    num_valid = jnp.sum(mask)
    dist = pairwise_closest_distance(lp)  # diagonal = 4 (self sentinel kept)
    big = 1e9
    dist = jnp.where(mask[None, :], dist, big)  # invalid columns: never nearest

    k1 = min(k1, n)
    k2 = min(k2, n)

    # k1 nearest per row (valid self included with distance 4, as in the
    # reference where it can enter the neighbourhood when N <= k1).
    neg = -dist
    _, nbr = jax.lax.top_k(neg, k1)  # (N, k1) indices of smallest distances

    cosang = pairwise_cosangle(lp, f=9.0)
    prox = pairwise_proximity(lp, sigma, dist=pairwise_closest_distance(lp))

    rows = jnp.arange(n)[:, None]
    nbr_valid = mask[nbr] & (dist[rows, nbr] < big / 2)
    cosphi = jnp.where(nbr_valid, cosang[rows, nbr], -1.0)  # (N, k1)
    proxk = jnp.where(nbr_valid, prox[rows, nbr], 0.0)

    # top-k2 by cosphi among the k1 neighbours
    topc, topi = jax.lax.top_k(cosphi, k2)  # (N, k2)
    topp = jnp.take_along_axis(proxk, topi, axis=1)
    contrib = jnp.where(topc > -0.5, topp * topc, 0.0)
    # Reference divides by k2 = min(k2, N); reproduce with the dynamic number
    # of valid lines when it is smaller than the static k2.
    k2_eff = jnp.minimum(jnp.asarray(k2, dist.dtype), num_valid.astype(dist.dtype))
    k2_eff = jnp.maximum(k2_eff, 1.0)
    score = jnp.sum(contrib, axis=1) / k2_eff
    return jnp.where(mask, score, 0.0)


def segments_to_homogeneous(lp: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) segments -> (..., 3) homogeneous line l = p1 x p2, p=(x, y, 1).

    (``evaluation.py:158-169``.) Not normalized; the EM entry point
    normalizes rows to unit L2 norm.
    """
    x1, y1, x2, y2 = lp[..., 0], lp[..., 1], lp[..., 2], lp[..., 3]
    # cross([x1,y1,1],[x2,y2,1])
    return jnp.stack([y1 - y2, x2 - x1, x1 * y2 - y1 * x2], axis=-1)


def normalize_rows(x: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """L2-normalize the last axis; zero rows stay zero."""
    n = jnp.linalg.norm(x, axis=-1, keepdims=True)
    return x / jnp.where(n <= eps, 1.0, n)
