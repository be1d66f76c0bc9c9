"""Test-only differential oracle: the reference EM algorithm in py3 numpy.

This module re-implements, in plain NumPy, the exact algorithm of the
reference's ``vp_localisation.py:168-450`` + ``probability_functions.py``
+ ``coordinate_conversion.py`` — including every ordering choice and
quirk — so the static-shape EM (`vanishing_points_2017_tpu.em`) can be
compared against the original's end-to-end behavior on identical inputs.
It is a TEST FIXTURE: never imported by the
package, not part of the framework surface, and written vectorized where
that cannot change behavior (the reference uses O(N^2) Python loops).

Known deliberate deltas from the reference (also listed in PARITY.md):

- ``split``'s 2-clustering uses scipy average-linkage on the precomputed
  distance matrix; the reference used sklearn 0.18's
  AgglomerativeClustering with ``connectivity=Ldist`` — a
  connectivity-CONSTRAINED average linkage whose exact merge order on a
  dense "connectivity" matrix is a versioned sklearn implementation
  detail. On well-separated clusters both give the same 2-partition.
- joblib process fan-outs are plain loops (identical results).
- py2 ``/`` on ints is ``//`` here (`find_initial_vps` patch indexing).

Reference citations use file:line of /root/reference throughout.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import squareform

pi = np.pi

PDFParams = namedtuple("PDFParams", "means weights sigma")
PDF = namedtuple("PDF", "v lv vl l lvsq angles")

EMPTY_RESULT = {"vp_assoc": None, "vp": None, "counts": None,
                "count_id": None, "decision_metric": None, "iterations": 0}


# ---------------------------------------------------------------------------
# coordinate_conversion.py
# ---------------------------------------------------------------------------

def index_to_angle(index, shape):
    """coordinate_conversion.py:4-20."""
    a, b = index[0], index[1]
    m, n = shape[0], shape[1]
    return np.array([(a - 0.5 * m + 0.5) * pi / m,
                     (b - 0.5 * n + 0.5) * pi / n])


def angle_to_point(angle):
    """coordinate_conversion.py:38-50 (incl. the sign(z)=0 collapse)."""
    alpha, beta = angle[0], angle[1]
    point = np.array([np.sin(alpha) * np.cos(beta), np.sin(beta),
                      np.cos(alpha) * np.cos(beta)])
    return point * np.sign(point[2])


# ---------------------------------------------------------------------------
# probability_functions.py
# ---------------------------------------------------------------------------

def pdf_params(cnn_response, confidence=1.282):
    """probability_functions.py:62-96 — top-100 GMM prior."""
    a_dim = cnn_response.shape[0]
    b_dim = cnn_response.shape[1]
    sigma = pi / (confidence * a_dim)

    alphas = np.linspace(-(a_dim - 1.0) / a_dim * pi / 2,
                         (a_dim - 1.0) / a_dim * pi / 2, a_dim)
    alphas = np.tile(alphas, (b_dim, 1)).flatten()
    betas = np.linspace(-(b_dim - 1.0) / b_dim * pi / 2,
                        (b_dim - 1.0) / b_dim * pi / 2, b_dim)
    betas = np.tile(betas, (a_dim, 1)).T.flatten()

    weights = cnn_response.flatten().astype(np.float64).copy()
    order_desc = np.argsort(weights)[::-1]
    weights[order_desc[100:]] = 0
    weights /= np.sum(weights)
    weights /= 2 * pi * sigma * sigma

    means = np.stack([alphas, betas], axis=1)
    return PDFParams(means=means, weights=weights, sigma=sigma)


def calc_pdf(pdfpar, x, y):
    """probability_functions.py:8-40 — 5 wraparound terms with the
    DUPLICATED d4 term (d4v == d5v; the symmetric y+pi term is missing).
    Vectorized over (points, mixture components)."""
    means, weights, sigma = pdfpar
    keep = weights > 0
    mu, w = means[keep], weights[keep]
    x = np.asarray(x)[:, None]
    y = np.asarray(y)[:, None]
    mx, my = mu[None, :, 0], mu[None, :, 1]
    d1 = (x - mx) ** 2 + (y - my) ** 2
    d2 = (x - mx + pi) ** 2 + (y + my) ** 2
    d3 = (x - mx - pi) ** 2 + (y + my) ** 2
    d4 = (x + mx) ** 2 + (y - my - pi) ** 2
    d5 = d4  # the reference's duplicated term (lines 25-26)
    c = -0.5 / (sigma * sigma)
    p = (np.exp(c * d1) + np.exp(c * d2) + np.exp(c * d3)
         + np.exp(c * d4) + np.exp(c * d5))
    return p @ w


def calc_angles(m_count, v):
    """probability_functions.py:252-259 — arcsin formulation with the
    inner clamp; NOT atan2 (alpha collapses for |inner|>1)."""
    angle = np.zeros((m_count, 2))
    angle[:, 1] = np.arcsin(np.clip(v[:, 1], -1, 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        inner = v[:, 0] / np.cos(angle[:, 1])
    angle[:, 0] = np.arcsin(np.clip(inner, -1, 1))
    return angle


def calc_lvsq_dotprod(v, l):
    """probability_functions.py:150-154: (l . v)^2, (N, M)."""
    lv = l @ v
    return lv * lv


def calc_lvsq_angle(v, lp):
    """probability_functions.py:157-176: (1-|cos(mid->VP, dir)|)^2."""
    with np.errstate(divide="ignore", invalid="ignore"):
        v2 = (v[0:2, :] / v[2, :]).T                      # (M, 2)
    lm = 0.5 * (lp[:, 0:2] + lp[:, 2:4])                  # (N, 2)
    d = lp[:, 0:2] - lp[:, 2:4]                           # (N, 2)
    vec1 = lm[:, None, :] - v2[None, :, :]                # (N, M, 2)
    num = np.abs(np.einsum("nmk,nk->nm", vec1, d))
    den = np.linalg.norm(vec1, axis=2) * np.linalg.norm(d, axis=1)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        return (1 - num / den) ** 2


def calc_plv(m_count, s, lvsq):
    """probability_functions.py:133-147. NB the reference MUTATES s in
    place (s[m] floored at 1e-200) — callers rely on it; we do the same
    on the array passed in."""
    np.maximum(s, 1e-200, out=s)
    lve = lvsq / (2 * s)[None, :]
    return np.exp(-lve) / np.sqrt(2 * pi * s)[None, :]


def calc_probabilities(i, pdfpar, v, l, lp, s, distance_measure):
    """probability_functions.py:99-120 (llen arg unused there; dropped)."""
    m_count = v.shape[1]
    vi = v[i, :, :]
    angles = calc_angles(m_count, vi)
    p_v = calc_pdf(pdfpar, angles[:, 0], angles[:, 1])
    if distance_measure == "angle":
        lvsq = calc_lvsq_angle(vi.T, lp)
    elif distance_measure == "dotprod":
        lvsq = calc_lvsq_dotprod(vi.T, l)
    else:
        raise AssertionError(distance_measure)
    p_lv = calc_plv(m_count, s, lvsq)
    p_l = np.maximum(p_lv @ p_v, 1e-12)
    p_vl = (p_lv * p_v[None, :]).T / p_l[None, :]
    return PDF(v=p_v, lv=p_lv, vl=p_vl, l=p_l, lvsq=lvsq, angles=angles)


def calc_lvsq_single(vp, lp):
    """probability_functions.py:212-224."""
    v2 = vp[0:2] / vp[2]
    lm = 0.5 * (lp[0:2] + lp[2:4])
    vec1 = lm - v2
    vec2 = lp[0:2] - lp[2:4]
    return (1 - np.abs(vec1 @ vec2 /
                       (np.linalg.norm(vec1) * np.linalg.norm(vec2)))) ** 2


# ---------------------------------------------------------------------------
# vp_localisation.py geometry/weight helpers
# ---------------------------------------------------------------------------

def line_length(lp):
    return np.linalg.norm(lp[0:2] - lp[2:4])


def line_segment_point_distance(lp, p):
    """vp_localisation.py:743-758 (p is a homogeneous 3-vector)."""
    lp1 = np.array([lp[0], lp[1], 1.0])
    lp2 = np.array([lp[2], lp[3], 1.0])
    param = (p - lp1) @ (lp2 - lp1) / np.linalg.norm(lp2 - lp1) ** 2
    if param < 0:
        pc = lp1
    elif param > 1:
        pc = lp2
    else:
        pc = lp1 + param * (lp2 - lp1)
    return np.linalg.norm(pc - p)


def line_distance_closest(lp1, lp2):
    """vp_localisation.py:727-740 — min over 4 endpoint-to-segment dists."""
    return min(
        line_segment_point_distance(lp1, np.array([lp2[0], lp2[1], 1.0])),
        line_segment_point_distance(lp1, np.array([lp2[2], lp2[3], 1.0])),
        line_segment_point_distance(lp2, np.array([lp1[0], lp1[1], 1.0])),
        line_segment_point_distance(lp2, np.array([lp1[2], lp1[3], 1.0])))


def lines_points_cosangle(lp1, lp2, f=1):
    """vp_localisation.py:715-724 — sharpened |cos| of the direction angle."""
    v1 = lp1[0:2] - lp1[2:4]
    v2 = lp2[0:2] - lp2[2:4]
    cosdphi = np.abs(v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2)))
    dphi = np.abs(np.arccos(np.clip(cosdphi, -1, 1)))
    return np.cos(np.clip(f * dphi, -pi / 2, pi / 2))


def lines_proximity(lp1, lp2, sigma=0.1):
    """vp_localisation.py:708-712."""
    sigma = sigma * min(line_length(lp1), line_length(lp2))
    d = line_distance_closest(lp1, lp2)
    return np.exp(-(d * d) / (2 * sigma * sigma))


def calc_lsim(lp, sigma=0.1):
    """vp_localisation.py:87-108 — symmetric, ZERO diagonal."""
    n = lp.shape[0]
    lsim = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            lsim[i, j] = (lines_points_cosangle(lp[i], lp[j], f=9)
                          * lines_proximity(lp[i], lp[j], sigma))
            lsim[j, i] = lsim[i, j]
    return lsim


def line_rating_knn(lp, k1=10, k2=3, sigma=1):
    """vp_localisation.py:34-72 (diag distance 4 excludes self)."""
    n = lp.shape[0]
    k1 = min(k1, n)
    k2 = min(k2, n)
    ldist = np.full((n, n), 4.0)
    for i in range(n):
        for j in range(n):
            if i != j:
                ldist[i, j] = line_distance_closest(lp[i], lp[j])
    lscore = np.zeros(n)
    nearest = np.argsort(ldist, axis=1)[:, 0:k1]
    for li in range(n):
        cosphi = np.array([lines_points_cosangle(lp[li], lp[j], f=9)
                           for j in nearest[li]])
        best = np.argsort(cosphi)[::-1][0:k2]
        tot = 0.0
        for ki in best:
            tot += lines_proximity(lp[li], lp[nearest[li, ki]],
                                   sigma) * cosphi[ki]
        lscore[li] = tot
    return lscore / k2


def lines_angles(lp):
    """vp_localisation.py:765-776 — direction angle folded into [0, pi/2]."""
    d = lp[:, 0:2] - lp[:, 2:4]
    d = d / np.linalg.norm(d, axis=1)[:, None]
    phi = np.abs(np.arccos(np.clip(d[:, 0], -1, 1)))
    return np.where(phi > pi / 2, pi - phi, phi)


def weight_matrix(p_vl, lweight, lsim, bias=0.001):
    """vp_localisation.py:515-524 — similarity-regularized responsibility."""
    wp = p_vl * lweight[None, :]                 # (M, N)
    col_dot = wp @ lsim                          # dot(w'_m, lsim[:, k])
    denom = 1 + bias * lweight * lsim.sum(axis=0)
    return (wp + bias * lweight[None, :] * col_dot) / denom[None, :]


def calc_new_vanishing_point(l, w):
    """vp_localisation.py:453-479 — weighted-SVD smallest right vector."""
    try:
        if np.size(w) == 0 or np.max(w) == 0:
            return None
        mat = np.diag(w / np.max(w)) @ l
        _, _, vt = np.linalg.svd(mat)
        vp = vt.T[:, 2].copy()
        vp /= np.linalg.norm(vp)
        vp *= np.sign(vp[2])
        return vp
    except np.linalg.LinAlgError:
        return None


def calc_vp_line_counts(vp, l, lp, s, decision_metric, lweights,
                        distance_measure, thresh=2.57, vp_assoc=None):
    """vp_localisation.py:482-512. NB for the angle measure the outlier
    test compares the SQUARED lvsq against thresh*sqrt(s) (quirk kept)."""
    n = l.shape[0]
    m_count = vp.shape[0]
    if vp_assoc is None:
        vp_assoc = np.argmax(decision_metric, axis=0)
    vp_assoc = np.asarray(vp_assoc).copy()
    counts = np.zeros(m_count)
    counts_weighted = np.zeros(m_count)
    for li in range(n):
        m = vp_assoc[li]
        if m > -1:
            if distance_measure == "dotprod":
                dist = np.abs(vp[m] @ l[li])
            elif distance_measure == "angle":
                dist = calc_lvsq_single(vp[m], lp[li])
            else:
                raise AssertionError(distance_measure)
            if dist > thresh * np.sqrt(s[m]):
                vp_assoc[li] = -1
            elif lweights[li] == 0:
                vp_assoc[li] = -1
            else:
                counts[m] += 1
                counts_weighted[m] += lweights[li]
    return counts, counts_weighted, vp_assoc


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def find_maxima(cnn_response):
    """vp_localisation.py:13-31 — 4-neighbour strict maxima with the
    reference's boundary quirks: the comparison neighbour is 0 outside the
    grid AND at index -1 reached from index 1 (``a-1 > 0``, not >= 0)."""
    b_dim, a_dim = cnn_response.shape
    maxima = np.zeros_like(cnn_response)
    for b in range(b_dim):
        for a in range(a_dim):
            vm = cnn_response[b, a]
            vu = cnn_response[b, a + 1] if a + 1 < a_dim else 0
            vd = cnn_response[b, a - 1] if a - 1 > 0 else 0
            vl = cnn_response[b - 1, a] if b - 1 > 0 else 0
            vr = cnn_response[b + 1, a] if b + 1 < b_dim else 0
            if vm > vu and vm > vd and vm > vl and vm > vr:
                maxima[b, a] = 1
    return maxima


def find_initial_vps(sphere_image, cnn_response, num_max):
    """vp_localisation.py:111-165 — per-maximal-cell argmax-average on the
    vertically flipped sphere image."""
    sphere = sphere_image[::-1, :].copy()
    r_a, r_b = cnn_response.shape
    s_a, s_b = sphere_image.shape

    maxima = find_maxima(cnn_response).flatten()
    flat = cnn_response.flatten()
    best = np.argsort(flat[maxima == 1])[::-1]
    maxima[np.where(maxima == 1)[0][best[num_max:]]] = 0
    maxima = maxima.reshape(cnn_response.shape)

    vps = []
    for ra in range(r_a):
        for rb in range(r_b):
            if maxima[ra, rb] != 1:
                continue
            patch = sphere[ra * s_a // r_a:(ra + 1) * s_a // r_a,
                           rb * s_b // r_b:(rb + 1) * s_b // r_b]
            mx = np.max(patch)
            flatp = patch.flatten().copy()
            flatp[flatp < mx] = 0
            idx = np.where(flatp > 0)[0]
            if idx.shape[0] == 0:
                continue
            avg = np.zeros(2)
            for k in idx:
                avg += np.unravel_index(k, patch.shape)
            avg /= idx.shape[0]
            max_index = np.array([avg[1] + rb * s_b // r_b,
                                  avg[0] + ra * s_a // r_a])
            angle = index_to_angle(max_index, sphere_image.shape)
            vps.append(angle_to_point(angle))
    return np.vstack(vps)


# ---------------------------------------------------------------------------
# split & merge
# ---------------------------------------------------------------------------

def split_best_vp(i, v, s, line_points, lines, weight_mat, line_weights,
                  line_angles, num_clusters=2, min_diff=0.0001):
    """vp_localisation.py:527-630 — incl. the raw-slot-index in-image
    quirk (``vp = v[i, m, :]`` uses the LOOP index m, not worstVPs[m])."""
    m_count = v.shape[1]
    n = lines.shape[0]

    greedy = np.zeros_like(weight_mat)
    arg = weight_mat.argmax(axis=0)
    for li in range(n):
        greedy[arg[li], li] = weight_mat[arg[li], li]
    greedy = greedy / weight_mat.max()

    with np.errstate(invalid="ignore"):
        stdd_phi = np.array([np.std(line_angles[greedy[m, :] > 0])
                             if np.any(greedy[m, :] > 0) else np.nan
                             for m in range(m_count)])
    worst_order = np.argsort(stdd_phi)[::-1]

    worst_vp = None
    lp_w = l_w = None
    assoc_lines = None
    for m in range(m_count):
        vp_assoc = np.argmax(weight_mat, axis=0)
        assoc_lines = np.where(vp_assoc == worst_order[m])[0]
        lp_w = line_points[assoc_lines]
        l_w = lines[assoc_lines].copy()
        n_worst = lp_w.shape[0]
        vp = v[i, m, :].copy()          # reference quirk: index m
        with np.errstate(divide="ignore", invalid="ignore"):
            vp /= vp[2]
        if n_worst > num_clusters * 4 and (-1 < vp[0] < 1
                                           and -1 < vp[1] < 1):
            worst_vp = worst_order[m]
            break

    if worst_vp is not None:
        n_worst = lp_w.shape[0]
        stdd = s[worst_vp] / num_clusters
        ldist = np.zeros((n_worst, n_worst))
        for li in range(n_worst):
            for lj in range(n_worst):
                if lj != li:
                    ldist[li, lj] = 1 - lines_points_cosangle(
                        lp_w[li], lp_w[lj], f=2)
        # average-linkage 2-clustering on the precomputed distances
        # (reference: sklearn AgglomerativeClustering; see module note)
        z = linkage(squareform(ldist, checks=False), method="average")
        labels = fcluster(z, num_clusters, criterion="maxclust") - 1

        lw = line_weights[assoc_lines]
        l_w = l_w * lw[:, None]

        new_vps = []
        for c in range(num_clusters):
            line_set = l_w[labels == c]
            if line_set.shape[0] < 3:
                continue
            _, _, vt = np.linalg.svd(line_set)
            vp = vt.T[:, 2].copy()
            vp /= np.linalg.norm(vp)
            if vp[2] < 0:
                vp *= -1
            new_vps.append(vp)

        too_similar = True
        for c in range(len(new_vps)):
            for d in range(c + 1, len(new_vps)):
                cosphi = np.clip(new_vps[c] @ new_vps[d], -1, 1)
                ang = np.abs(np.arccos(np.clip(np.abs(cosphi), -1, 1)))
                if ang > min_diff:
                    too_similar = False

        if not too_similar:
            first = True
            for vp in new_vps:
                if first:
                    v[i, worst_vp, :] = vp
                    s[worst_vp] = stdd
                    first = False
                else:
                    v = np.append(v, np.zeros((v.shape[0], 1, v.shape[2])),
                                  axis=1)
                    s = np.append(s, stdd)
                    v[i, -1, :] = vp
    return {"v": v, "s": s}


def calc_angle_to_other_vp(v, i, k):
    """vp_localisation.py:687-697."""
    this_vp = np.squeeze(v[i, k, :])
    others = np.squeeze(v[i, :, :])
    cosphi = np.clip(others @ this_vp, -1, 1)
    angles = np.abs(np.arccos(np.clip(np.abs(cosphi), -1, 1)))
    if np.isscalar(angles) or angles.ndim == 0:
        return np.array(pi)
    angles[k] = pi
    return angles


def merge_vps(i, v, s, l, thresh, lweight, lsim, wbias, pdfpar, lp,
              distance_measure, max_stdd=0.01):
    """vp_localisation.py:633-684 — incl. the quirk that s[k] keeps the
    merged variance even when the merge is REJECTED for s[k] > max_stdd."""
    m_count = v.shape[1]
    try_again = True
    while try_again and m_count > 1:
        angles = np.stack([calc_angle_to_other_vp(v, i, j)
                           for j in range(m_count)])
        j, k = np.unravel_index(angles.argmin(), angles.shape)
        if angles[j, k] < thresh:
            try:
                p = calc_probabilities(i, pdfpar, v, l, lp, s,
                                       distance_measure)
                w = weight_matrix(p.vl, lweight, lsim, bias=wbias)
                new_vp = calc_new_vanishing_point(l, w[j, :] + w[k, :])
                p_vl_sum = np.sum(p.vl[k, :] + p.vl[j, :])
                with np.errstate(divide="ignore", invalid="ignore"):
                    s_log = (np.log(np.sum(
                        0.5 * (p.lvsq[:, j] + p.lvsq[:, k])
                        * (p.vl[k, :] + p.vl[j, :]))) - np.log(p_vl_sum))
                s[k] = np.exp(s_log)
                if new_vp is None or s[k] > max_stdd:
                    try_again = False
                    continue
                v[i, k, :] = new_vp
                v = np.delete(v, j, axis=1)
                s = np.delete(s, j, axis=0)
            except np.linalg.LinAlgError:
                continue
        else:
            try_again = False
        m_count = v.shape[1]
    return {"v": v, "s": s}


# ---------------------------------------------------------------------------
# the EM loop (vp_localisation.py:168-450)
# ---------------------------------------------------------------------------

def expectation_maximisation(l, lp, cnn_response, num_iter=100,
                             sphere_image=None, init_vp=None, do_merge=True,
                             do_split=True, do_iterations=True,
                             distance_measure="angle", use_weights=True,
                             wbias=1, num_init_vp=25, split_merge_freq=10,
                             merge_thresh=1e-3, outlier_thresh=1.96 ** 2,
                             final_convergence=5e-3, s_thresh=1e-200,
                             num_min_lines=3, verbose=False):
    l = np.asarray(l, np.float64).copy()
    lp = np.asarray(lp, np.float64).copy()
    n = l.shape[0]

    lsim = calc_lsim(lp, sigma=1) if use_weights else np.zeros((n, n))

    l /= np.linalg.norm(l, axis=1)[:, None]

    merge_thresh_final = merge_thresh * 10
    merge_freq = split_freq = split_merge_freq
    split_merge_it = 100
    splits = 1

    if distance_measure == "angle":
        max_stdd = 1e-6
        s_init_factor = 1e-6
    elif distance_measure == "dotprod":
        max_stdd = 1e-3
        s_init_factor = 1e-3
    else:
        raise AssertionError(distance_measure)

    result = dict(EMPTY_RESULT)

    v0 = find_initial_vps(sphere_image, cnn_response, num_init_vp)
    pdfpar = pdf_params(cnn_response)
    if init_vp is not None:
        v0 = np.asarray(init_vp, np.float64).copy()
        v0 /= np.linalg.norm(v0, axis=1)[:, None]

    langles = lines_angles(lp)
    s_init = pdfpar.sigma * s_init_factor

    llen = np.linalg.norm(lp[:, 0:2] - lp[:, 2:4], axis=1)
    if use_weights:
        lscore = np.clip(line_rating_knn(lp, k2=4), 0.2, 1)
        lweight = llen * lscore
    else:
        lweight = np.ones(n)

    m_count = v0.shape[0]
    s = np.ones(m_count) * s_init
    v = np.zeros((num_iter + 1, m_count, 3))
    v[0] = v0

    p = calc_probabilities(0, pdfpar, v, l, lp, s, distance_measure)
    w = weight_matrix(p.vl, lweight, lsim, bias=wbias)
    counts, _, _ = calc_vp_line_counts(v[0], l, lp, s, w, lweight,
                                       distance_measure,
                                       thresh=outlier_thresh)
    v = np.delete(v, np.where(counts < 3)[0], axis=1)
    s = np.delete(s, np.where(counts < 3)[0], axis=0)
    m_count = v.shape[1]

    for i in range(num_iter):
        if m_count == 0:
            return result

        if i % split_freq == 0 and 0 < i < split_merge_it and do_split:
            for _ in range(splits):
                p = calc_probabilities(i, pdfpar, v, l, lp, s,
                                       distance_measure)
                w = weight_matrix(p.vl, lweight, lsim, bias=wbias)
                sp = split_best_vp(i, v, s, line_points=lp, lines=l,
                                   weight_mat=w, line_weights=lweight,
                                   line_angles=langles,
                                   min_diff=merge_thresh)
                v, s = sp["v"].copy(), sp["s"].copy()

        m_count = v.shape[1]
        p = calc_probabilities(i, pdfpar, v, l, lp, s, distance_measure)

        max_err = 0.0
        to_be_removed = []
        lweight_temp = lweight.copy()
        w = weight_matrix(p.vl, lweight_temp, lsim, bias=wbias)

        for m in range(m_count):
            if not do_iterations:
                break
            new_vp = calc_new_vanishing_point(l, w[m, :])
            if new_vp is None:
                to_be_removed.append(m)
                continue
            v[i + 1, m, :] = new_vp
            p_vl_sum = np.sum(p.vl[m, :])
            with np.errstate(divide="ignore", invalid="ignore"):
                s_log = (np.log(np.sum(p.lvsq[:, m] * p.vl[m, :]))
                         - np.log(p_vl_sum))
            s[m] = np.exp(s_log)
            s[m] = min(s[m], max_stdd)
            s[m] = max(s[m], s_thresh)
            if np.isnan(s[m]):
                to_be_removed.append(m)
            else:
                err = np.arccos(min(np.abs(v[i, m, :] @ v[i + 1, m, :]),
                                    1.0))
                max_err = max(max_err, err)
                if err > 1.5:
                    to_be_removed.append(m)

        if not do_iterations:
            v[i + 1] = v[i].copy()

        if verbose:
            print("%03d - max. VP change: %.4f - VPs: %d"
                  % (i, max_err, m_count))

        v = np.delete(v, np.array(to_be_removed, dtype=int), axis=1)
        s = np.delete(s, np.array(to_be_removed, dtype=int), axis=0)
        p = calc_probabilities(i, pdfpar, v, l, lp, s, distance_measure)
        m_count = v.shape[1]

        if (max_err < final_convergence or i == num_iter - 1
                or not do_iterations):
            # ---- finalization (vp_localisation.py:335-442) ----
            if do_merge:
                merged = merge_vps(i + 1, v, s, l, merge_thresh_final,
                                   lweight, lsim, wbias, pdfpar, lp,
                                   distance_measure)
                v, s = merged["v"], merged["s"]

            p = calc_probabilities(i, pdfpar, v, l, lp, s, distance_measure)
            w = weight_matrix(p.vl, lweight_temp, lsim, bias=wbias)

            to_be_removed = []
            assoc = np.argmax(w, axis=0)
            m_count = v.shape[1]
            for m in range(m_count):
                if np.size(w[m, assoc == m]) == 0:
                    continue
                w[m, assoc == m] /= np.max(w[m, assoc == m])
                new_vp = calc_new_vanishing_point(l[assoc == m, :],
                                                  w[m, assoc == m])
                if new_vp is None:
                    to_be_removed.append(m)
                    continue
                v[i + 1, m, :] = new_vp
                p_vl_sum = np.sum(p.vl[m, :])
                with np.errstate(divide="ignore", invalid="ignore"):
                    s_log = (np.log(np.sum(p.lvsq[:, m] * p.vl[m, :]))
                             - np.log(p_vl_sum))
                s[m] = np.exp(s_log)
                s[m] = min(s[m], max_stdd)
                if np.isnan(s[m]) or s[m] < s_thresh:
                    to_be_removed.append(m)
                else:
                    err = np.arccos(min(np.abs(v[i, m, :] @ v[i + 1, m, :]),
                                        1.0))
                    if err > 1.5:
                        to_be_removed.append(m)

            v = np.delete(v, np.array(to_be_removed, dtype=int), axis=1)
            s = np.delete(s, np.array(to_be_removed, dtype=int), axis=0)

            p = calc_probabilities(i, pdfpar, v, l, lp, s, distance_measure)
            decision_metric = weight_matrix(p.vl, lweight, lsim, bias=wbias)
            if decision_metric.size <= 0:
                return result

            good_vp = np.unique(np.argmax(decision_metric, axis=0))
            v = v[:, good_vp, :]
            s = s[good_vp]

            p = calc_probabilities(i + 1, pdfpar, v, l, lp, s,
                                   distance_measure)
            decision_metric = weight_matrix(p.vl, lweight, lsim, bias=wbias)
            counts, counts_weighted, vp_assoc = calc_vp_line_counts(
                v[i + 1], l, lp, s, decision_metric, lweight,
                distance_measure, thresh=outlier_thresh)

            m_count = v.shape[1]
            vidx = 0
            while vidx < m_count:
                if counts[vidx] < num_min_lines:
                    v = np.delete(v, vidx, axis=1)
                    s = np.delete(s, vidx)
                    m_count = v.shape[1]
                    p = calc_probabilities(i + 1, pdfpar, v, l, lp, s,
                                           distance_measure)
                    decision_metric = weight_matrix(p.vl, lweight, lsim,
                                                    bias=wbias)
                    counts, counts_weighted, vp_assoc = calc_vp_line_counts(
                        v[i + 1], l, lp, s, decision_metric, lweight,
                        distance_measure, thresh=outlier_thresh,
                        vp_assoc=None)
                else:
                    vidx += 1

            return {"vp_assoc": vp_assoc, "vp": v[i + 1], "counts": counts,
                    "counts_weighted": counts_weighted, "count_id": None,
                    "decision_metric": decision_metric, "iterations": i,
                    "distribution": p, "sigma": s}

        if (i % merge_freq == 0 and i > 0
                and i <= split_merge_it + merge_freq and do_merge):
            merged = merge_vps(i + 1, v, s, l, merge_thresh, lweight, lsim,
                               wbias, pdfpar, lp, distance_measure)
            v, s = merged["v"], merged["s"]

    return result
