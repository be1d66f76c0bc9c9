"""Expectation-maximisation VP refinement — the algorithmic heart.

Static-shape re-design of ``expectation_maximisation``
(``vp_localisation.py:168-450`` of fkluger/vanishing_points_2017). The
reference mutates the VP count M constantly (delete / split / merge) and runs
data-dependent Python control flow; XLA needs static shapes, so here:

* VPs live in a fixed array of ``m_slots`` slots with a boolean ``alive``
  mask. Delete = mask off; split = masked write into the first free slot;
  merge = masked write + mask off.
* Lines are padded to a static N with an ``lmask``; padded lines carry zero
  weight and zero similarity so they contribute nothing.
* The EM iteration is a ``lax.while_loop`` whose body is a no-op once the
  per-element ``done`` flag is set, so the whole EM can be ``vmap``-ed over
  an image batch (elements converge at different iterations).
* Variances are carried as ``log s``: the reference floors s at 1e-200
  (``float64``-only territory); log-space keeps everything in float32
  (see ``ops/probability.py``).
* The per-VP M-step SVD becomes a batched 3x3 symmetric eigenproblem
  (``em/weights.py``), the split's sklearn agglomerative clustering a masked
  on-device linkage loop (``em/cluster.py``).

Control flow, update order, thresholds and the reference's quirks (split's
in-image check on the raw slot index ``vp_localisation.py:557``; merge
writing s[k] before validating the merge ``vp_localisation.py:666-668``;
``lweight_temp`` aliasing; hardcoded count<3 initial prune
``vp_localisation.py:250``) are reproduced faithfully — see inline notes.

Like the reference (``vp_localisation.py:196-203``), only the "angle" and
"dotprod" distance measures are accepted here; "area" exists in the
probability module but the EM rejects it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lines as lineops
from ..ops.lines import HIGHEST
from ..ops import probability as prob
from . import cluster as clust
from . import init_vps
from . import weights as wmod

LOG_S_THRESH = prob.LOG_S_FLOOR  # log(1e-200)
SPLIT_MERGE_IT = 100  # reference hardcodes split_merge_it = 100
MERGE_MAX_STDD = 0.01  # merge_vps' own default max_stdd


@dataclasses.dataclass(frozen=True)
class EMConfig:
    """Static EM hyperparameters (defaults = reference defaults,
    ``vp_localisation.py:168-172``)."""

    num_iter: int = 100
    do_merge: bool = True
    do_split: bool = True
    do_iterations: bool = True
    distance_measure: str = "angle"
    use_weights: bool = True
    wbias: float = 1.0
    num_init_vp: int = 25
    split_merge_freq: int = 10
    merge_thresh: float = 1e-3
    outlier_thresh: float = 1.96 ** 2
    final_convergence: float = 5e-3
    num_min_lines: int = 3
    m_slots: int = 40
    wrap_quirk: bool = True
    # Loop structure. "uniform" = one while_loop body containing the
    # gated split/merge (the default). "phase" = [full body + scan of
    # split_merge_freq-1 plain bodies] per trip — half the E-steps per
    # plain iteration; not measured on the GPU yet.
    loop: str = "uniform"

    def __post_init__(self):
        if self.distance_measure == "angle":
            pass
        elif self.distance_measure == "dotprod":
            pass
        else:
            raise ValueError(
                f"distance measure {self.distance_measure!r} not supported by "
                "the EM (reference asserts at vp_localisation.py:203)")

    @property
    def max_stdd(self) -> float:
        return 1e-6 if self.distance_measure == "angle" else 1e-3

    @property
    def s_init_factor(self) -> float:
        return self.max_stdd  # same constants in the reference


class EMResult(NamedTuple):
    """Masked equivalent of the reference's result dict
    (``vp_localisation.py:441-442``)."""

    vp: jnp.ndarray               # (m_slots, 3)
    alive: jnp.ndarray            # (m_slots,)
    vp_assoc: jnp.ndarray         # (N,) slot index or -1
    counts: jnp.ndarray           # (m_slots,)
    counts_weighted: jnp.ndarray  # (m_slots,)
    decision_metric: jnp.ndarray  # (m_slots, N)
    log_sigma: jnp.ndarray        # (m_slots,)
    iterations: jnp.ndarray       # ()
    valid: jnp.ndarray            # () False = the reference's empty dict


class _State(NamedTuple):
    i: jnp.ndarray
    v_cur: jnp.ndarray
    v_next: jnp.ndarray
    log_s: jnp.ndarray
    alive: jnp.ndarray
    done: jnp.ndarray
    empty: jnp.ndarray


def _log(x):
    return jnp.log(x)


def _logsumexp_prod(log_a: jnp.ndarray, b: jnp.ndarray, axis: int):
    """log(sum exp(log_a) * b) for b >= 0, robust to tiny magnitudes.

    Terms with b == 0 are excluded entirely — padded lines carry p_vl = 0 and
    may have NaN lvsq (their geometry is all-zero), and must contribute
    nothing. NaN log_a with b > 0 still propagates, like the reference's
    linear float64 math.
    """
    lb = jnp.log(jnp.where(b > 0, b, 1.0))
    t = jnp.where(b > 0, log_a + lb, -jnp.inf)
    m = jnp.max(t, axis=axis, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    out = jnp.squeeze(m_safe, axis) + jnp.log(
        jnp.sum(jnp.exp(t - m_safe), axis=axis))
    has_nan = jnp.any(jnp.isnan(t), axis=axis)
    return jnp.where(has_nan, jnp.nan, out)


def _s_update_log(lvsq_col: jnp.ndarray, p_vl_row: jnp.ndarray):
    """log s = log(sum lvsq * p_vl) - log(sum p_vl)
    (``vp_localisation.py:303-304``). Returns NaN when sum p_vl == 0,
    matching the reference's -inf - -inf."""
    log_lvsq = jnp.where(lvsq_col > 0,
                         jnp.log(jnp.where(lvsq_col > 0, lvsq_col, 1.0)),
                         -jnp.inf)
    log_lvsq = jnp.where(jnp.isnan(lvsq_col), jnp.nan, log_lvsq)
    num = _logsumexp_prod(log_lvsq, p_vl_row, axis=0)
    den_lin = jnp.sum(p_vl_row)
    den = jnp.where(den_lin > 0, jnp.log(jnp.where(den_lin > 0, den_lin, 1.0)),
                    -jnp.inf)
    return num - den  # -inf - -inf = nan, as intended


def _vp_change(v_old: jnp.ndarray, v_new: jnp.ndarray):
    """arccos(min(|<v_old, v_new>|, 1)) (``vp_localisation.py:312``)."""
    d = jnp.abs(jnp.sum(v_old * v_new, axis=-1))
    return jnp.arccos(jnp.minimum(d, 1.0))


def _pairwise_vp_angles(v: jnp.ndarray, alive: jnp.ndarray):
    """(M, M) |arccos(clip(|clip(cos, -1, 1)|, -1, 1))|, diag pi, dead -> big
    (``calc_angle_to_other_vp``, ``vp_localisation.py:687-697``)."""
    m = v.shape[0]
    cos = jnp.clip(jnp.matmul(v, v.T, precision=HIGHEST), -1.0, 1.0)
    ang = jnp.abs(jnp.arccos(jnp.clip(jnp.abs(cos), -1.0, 1.0)))
    ang = jnp.where(jnp.eye(m, dtype=bool), jnp.pi, ang)
    ok = alive[:, None] & alive[None, :]
    return jnp.where(ok, ang, 10.0)


def _merge_vps(v: jnp.ndarray, log_s: jnp.ndarray, alive: jnp.ndarray,
               thresh: float, go: jnp.ndarray, pdfpar, l, lp, lmask,
               lweight, lsim, cfg: EMConfig):
    """Masked ``merge_vps`` (``vp_localisation.py:633-684``).

    Repeatedly merges the closest alive VP pair (j < k: j deleted, k keeps
    the merged VP) while the minimum angle is below ``thresh``. The merged
    variance is written to slot k BEFORE the acceptance check, reproducing
    the reference's mutation-on-rejection quirk.
    """
    ms = v.shape[0]

    def cond(state):
        _, _, _, try_again = state
        return try_again

    def body(state):
        v, log_s, alive, _ = state
        ang = _pairwise_vp_angles(v, alive)
        flat = jnp.argmin(ang)
        j, k = flat // ms, flat % ms  # row-major first min: j < k
        min_angle = ang[j, k]
        mergeable = min_angle < thresh

        p = prob.calc_probabilities(pdfpar, v, alive, l, lp, log_s, lmask,
                                    cfg.distance_measure, cfg.wrap_quirk)
        w = wmod.weight_matrix(p.p_vl, lweight, lsim, bias=cfg.wbias)
        new_vp, vp_ok = wmod.calc_new_vanishing_point(l, w[j] + w[k])

        pair_pvl = p.p_vl[k] + p.p_vl[j]  # (N,)
        mean_lvsq = 0.5 * (p.lvsq[:, j] + p.lvsq[:, k])
        s_k = _s_update_log(mean_lvsq, pair_pvl)

        # NaN s_k ACCEPTS the merge: the reference's `s[k] > max_stdd` is
        # False for NaN (vp_localisation.py:668) so the merge proceeds; the
        # NaN sigma is removed by the next M-step's NaN check, like there.
        accept = vp_ok & ~(s_k > jnp.log(MERGE_MAX_STDD))
        # quirk: s[k] is overwritten whenever a merge is attempted
        log_s2 = log_s.at[k].set(s_k)
        v2 = jnp.where((jnp.arange(ms) == k)[:, None] & accept & mergeable,
                       new_vp[None, :], v)
        alive2 = alive & ~((jnp.arange(ms) == j) & accept & mergeable)

        upd = mergeable  # min_angle >= thresh: stop, no state change
        v_out = jnp.where(upd, v2, v)
        log_s_out = jnp.where(upd, log_s2, log_s)
        alive_out = jnp.where(upd, alive2, alive)
        try_again = upd & accept & (jnp.sum(alive_out) > 1)
        return v_out, log_s_out, alive_out, try_again

    try0 = go & (jnp.sum(alive) > 1)
    v, log_s, alive, _ = jax.lax.while_loop(cond, body,
                                            (v, log_s, alive, try0))
    return v, log_s, alive


def _split_best_vp(v_cur, log_s, alive, w, l, lp, lmask, lweight, langles,
                   go, cfg: EMConfig):
    """Masked ``split_best_vp`` (``vp_localisation.py:527-630``).

    Reference quirks preserved: the candidate scan checks the in-image
    condition of the RAW slot at loop position m while counting the lines of
    worstVPs[m] (``vp_localisation.py:557``); empty-assignment VPs get NaN
    angle-stddev which sorts FIRST after the descending argsort, exactly like
    np.argsort placing NaN last before the reversal.
    """
    ms = v_cur.shape[0]
    n = l.shape[0]

    assoc = wmod.assoc_argmax(w, alive, lmask)  # (N,)
    wmax_global = jnp.max(w)
    greedy_pos = (assoc[None, :] == jnp.arange(ms)[:, None]) & \
        (w > 0) & (wmax_global > 0)  # greedy entries that are > 0

    cnt = jnp.sum(greedy_pos, axis=1)
    mean_phi = jnp.sum(greedy_pos * langles[None, :], axis=1) / cnt
    var_phi = jnp.sum(greedy_pos * (langles[None, :] - mean_phi[:, None]) ** 2,
                      axis=1) / cnt
    stdd_phi = jnp.sqrt(var_phi)  # NaN for empty assignment, like np.std([])
    stdd_key = jnp.where(alive, stdd_phi, -jnp.inf)  # dead slots sort last
    order = jnp.argsort(stdd_key)[::-1]  # descending; NaN first, dead last

    n_assigned = jnp.sum((assoc[None, :] == order[:, None]) & lmask[None, :],
                         axis=1)  # lines of worstVPs[m]
    v2 = v_cur[:, 0:2] / v_cur[:, 2:3]  # raw slot m (quirk), NaN for dead
    in_img = (v2[:, 0] > -1) & (v2[:, 0] < 1) & (v2[:, 1] > -1) & (v2[:, 1] < 1)
    cand = (n_assigned > 2 * 4) & in_img  # numClusters * 4 = 8
    found = jnp.any(cand)
    pos = jnp.argmax(cand)  # first candidate position
    chosen = order[pos]

    assigned = (assoc == chosen) & lmask & found & go
    ldist = 1.0 - lineops.pairwise_cosangle(lp, f=2.0)
    in_a = clust.agglomerative_two(ldist, assigned)
    in_b = assigned & ~in_a

    lw = lweight  # reference scales the assigned lines by their weights
    lsc = l * lw[:, None]

    def fit(mask_c):
        cnt_c = jnp.sum(mask_c)
        lc = jnp.where(mask_c[:, None], lsc, 0.0)
        gram = jnp.matmul(lc.T, lc, precision=HIGHEST)
        vp = wmod.smallest_eigvec_3x3(gram)
        vp = jnp.where(vp[2] < 0, -vp, vp)  # z == 0 left as-is (reference)
        return vp, cnt_c >= 3

    vp_a, ok_a = fit(in_a)
    vp_b, ok_b = fit(in_b)

    cosphi = jnp.clip(jnp.dot(vp_a, vp_b, precision=HIGHEST), -1.0, 1.0)
    pair_angle = jnp.abs(jnp.arccos(jnp.clip(jnp.abs(cosphi), -1.0, 1.0)))
    not_too_similar = ok_a & ok_b & (pair_angle > cfg.merge_thresh)

    do = go & found & not_too_similar
    stdd_new = log_s[chosen] - jnp.log(2.0)  # s / numClusters

    slot_ids = jnp.arange(ms)
    free = jnp.argmax(~alive)  # first dead slot
    has_free = jnp.any(~alive)

    is_chosen = (slot_ids == chosen) & do
    is_free = (slot_ids == free) & do & has_free

    v_out = jnp.where(is_chosen[:, None], vp_a[None, :], v_cur)
    v_out = jnp.where(is_free[:, None], vp_b[None, :], v_out)
    log_s_out = jnp.where(is_chosen | is_free, stdd_new, log_s)
    alive_out = alive | is_free
    return v_out, log_s_out, alive_out


def _finalize(state: _State, pdfpar, l, lp, lmask, lweight, lsim, langles,
              cfg: EMConfig) -> EMResult:
    """The reference's convergence block (``vp_localisation.py:335-442``):
    final merge at 10x threshold, per-VP refit from argmax-assigned lines,
    decision-metric uniqueness filter, outlier counting and iterative
    min-line pruning."""
    i, v_cur, v_next, log_s, alive = (state.i, state.v_cur, state.v_next,
                                      state.log_s, state.alive)
    ms = v_cur.shape[0]
    n = l.shape[0]
    go = ~state.empty

    dm_name = cfg.distance_measure
    log_max_stdd = jnp.log(cfg.max_stdd)

    if cfg.do_merge:
        v_next, log_s, alive = _merge_vps(
            v_next, log_s, alive, cfg.merge_thresh * 10.0, go, pdfpar, l, lp,
            lmask, lweight, lsim, cfg)

    # refit each VP from its argmax-assigned lines, weights renormalized
    # per VP (reference lines 344-369; p uses the OLD positions v_cur)
    p = prob.calc_probabilities(pdfpar, v_cur, alive, l, lp, log_s, lmask,
                                dm_name, cfg.wrap_quirk)
    w = wmod.weight_matrix(p.p_vl, lweight, lsim, bias=cfg.wbias)
    assoc = wmod.assoc_argmax(w, alive, lmask)

    assigned = (assoc[None, :] == jnp.arange(ms)[:, None])  # (M, N)
    has_lines = jnp.any(assigned, axis=1)

    w_masked = jnp.where(assigned, w, 0.0)
    new_vps, vp_ok = jax.vmap(wmod.calc_new_vanishing_point,
                              in_axes=(None, 0))(l, w_masked)

    s_log_new = jax.vmap(_s_update_log, in_axes=(1, 0))(p.lvsq, p.p_vl)
    s_log_new = jnp.minimum(s_log_new, log_max_stdd)

    upd = alive & has_lines  # "continue" keeps slots with no assigned lines
    v_next = jnp.where((upd & vp_ok)[:, None], new_vps, v_next)
    bad_s = jnp.isnan(s_log_new) | (s_log_new < LOG_S_THRESH)
    log_s = jnp.where(upd & vp_ok & ~bad_s, s_log_new, log_s)
    err = _vp_change(v_cur, v_next)
    removed = upd & (~vp_ok | bad_s | (vp_ok & ~bad_s & (err > 1.5)))
    alive = alive & ~removed

    # uniqueness filter: keep only VPs that win at least one line
    # (reference lines 398-413; p again at the OLD positions)
    p = prob.calc_probabilities(pdfpar, v_cur, alive, l, lp, log_s, lmask,
                                dm_name, cfg.wrap_quirk)
    dm = wmod.weight_matrix(p.p_vl, lweight, lsim, bias=cfg.wbias)
    empty2 = state.empty | (jnp.sum(alive) == 0)
    max_dec = wmod.assoc_argmax(dm, alive, lmask)
    wins = jnp.any(max_dec[None, :] == jnp.arange(ms)[:, None], axis=1)
    alive = alive & wins

    # counts at the NEW positions + iterative min-line pruning
    # (reference lines 415-437)
    def count_pass(alive):
        p3 = prob.calc_probabilities(pdfpar, v_next, alive, l, lp, log_s,
                                     lmask, dm_name, cfg.wrap_quirk)
        dm3 = wmod.weight_matrix(p3.p_vl, lweight, lsim, bias=cfg.wbias)
        counts, cw, assoc3 = wmod.calc_vp_line_counts(
            v_next, alive, l, lp, lmask, log_s, dm3, lweight, dm_name,
            thresh=cfg.outlier_thresh)
        return counts, cw, assoc3, dm3

    counts, cw, assoc3, dm3 = count_pass(alive)

    def prune_cond(st):
        alive_, counts_, *_ = st
        return jnp.any(alive_ & (counts_ < cfg.num_min_lines))

    def prune_body(st):
        alive_, counts_, cw_, assoc_, dm_ = st
        under = alive_ & (counts_ < cfg.num_min_lines)
        go_p = jnp.any(under)
        vidx = jnp.argmax(under)  # lowest slot first, like the vidx scan
        alive2 = alive_ & (jnp.arange(ms) != vidx)
        alive2 = jnp.where(go_p, alive2, alive_)
        c2, w2, a2, d2 = count_pass(alive2)
        return (alive2,
                jnp.where(go_p, c2, counts_), jnp.where(go_p, w2, cw_),
                jnp.where(go_p, a2, assoc_), jnp.where(go_p, d2, dm_))

    alive, counts, cw, assoc3, dm3 = jax.lax.while_loop(
        prune_cond, prune_body, (alive, counts, cw, assoc3, dm3))

    valid = ~empty2 & (jnp.sum(alive) > 0)
    zero_if_invalid = lambda x: jnp.where(valid, x, jnp.zeros_like(x))
    return EMResult(
        vp=jnp.where((alive & valid)[:, None], v_next, 0.0),
        alive=alive & valid,
        vp_assoc=jnp.where(valid, assoc3, -1),
        counts=zero_if_invalid(counts),
        counts_weighted=zero_if_invalid(cw),
        decision_metric=zero_if_invalid(dm3),
        log_sigma=log_s,
        iterations=i,
        valid=valid,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def expectation_maximisation(l: jnp.ndarray, lp: jnp.ndarray,
                             cnn_response: jnp.ndarray,
                             sphere_image: jnp.ndarray,
                             lmask: jnp.ndarray,
                             cfg: EMConfig = EMConfig(),
                             init_vp: jnp.ndarray | None = None,
                             init_alive: jnp.ndarray | None = None) -> EMResult:
    """Run the full EM. All shapes static; jit- and vmap-safe.

    l: (N, 3) homogeneous lines (will be row-normalized), lp: (N, 4)
    segments, cnn_response: (B, A) sigmoid grid, sphere_image: (S, S) in Agg
    orientation, lmask: (N,) validity. ``init_vp``/``init_alive`` override
    the CNN-maxima initialisation (the reference's ``init_vp``).
    """
    n = l.shape[0]
    ms = cfg.m_slots
    f32 = jnp.float32

    l = lineops.normalize_rows(l.astype(f32))
    l = jnp.where(lmask[:, None], l, 0.0)
    lp = jnp.where(lmask[:, None], lp.astype(f32), 0.0)

    llen = lineops.line_length(lp)
    langles = lineops.lines_angles(lp)

    if cfg.use_weights:
        lsim = lineops.calc_lsim(lp, lmask, sigma=1.0)
        lscore = lineops.line_rating_knn(lp, lmask, k1=10, k2=4, sigma=1.0)
        lweight = llen * jnp.clip(lscore, 0.2, 1.0)
    else:
        lsim = jnp.zeros((n, n), f32)
        lweight = jnp.ones(n, f32)
    lweight = jnp.where(lmask, lweight, 0.0)

    pdfpar = prob.pdf_params(cnn_response.astype(f32))

    if init_vp is not None:
        v0 = lineops.normalize_rows(init_vp.astype(f32))
        if init_alive is None:
            init_alive = jnp.ones(v0.shape[0], bool)
        pad = ms - v0.shape[0]
        v0 = jnp.concatenate([v0, jnp.zeros((pad, 3), f32)], axis=0)
        alive0 = jnp.concatenate([init_alive, jnp.zeros(pad, bool)], axis=0)
    else:
        v0, alive0 = init_vps.find_initial_vps(
            sphere_image, cnn_response.astype(f32), cfg.num_init_vp, ms)

    log_s0 = jnp.full((ms,), jnp.log(pdfpar.sigma * cfg.s_init_factor), f32)
    log_max_stdd = jnp.log(cfg.max_stdd)

    def estep(v, alive, log_s):
        p = prob.calc_probabilities(pdfpar, v, alive, l, lp, log_s, lmask,
                                    cfg.distance_measure, cfg.wrap_quirk)
        w = wmod.weight_matrix(p.p_vl, lweight, lsim, bias=cfg.wbias)
        return p, w

    # ---- initial prune: VPs with < 3 inliers (hardcoded 3, ref line 250)
    p0, w0 = estep(v0, alive0, log_s0)
    counts0, _, _ = wmod.calc_vp_line_counts(
        v0, alive0, l, lp, lmask, log_s0, w0, lweight, cfg.distance_measure,
        thresh=cfg.outlier_thresh)
    alive0 = alive0 & (counts0 >= 3)

    state0 = _State(
        i=jnp.zeros((), jnp.int32), v_cur=v0, v_next=jnp.zeros_like(v0),
        log_s=log_s0, alive=alive0,
        done=jnp.zeros((), bool), empty=jnp.zeros((), bool))

    def cond(st: _State):
        return ~st.done

    def body(st: _State, with_split_merge: bool = True):
        i, v_cur, v_next, log_s, alive = (st.i, st.v_cur, st.v_next,
                                          st.log_s, st.alive)
        empty_now = jnp.sum(alive) == 0
        go = ~st.done & ~empty_now

        # ---- split move (every split_merge_freq iters, 0 < i < 100)
        if cfg.do_split and with_split_merge:
            split_due = go & (jnp.mod(i, cfg.split_merge_freq) == 0) & \
                (i > 0) & (i < SPLIT_MERGE_IT)
            _, w_s = estep(v_cur, alive, log_s)
            v_cur, log_s, alive = _split_best_vp(
                v_cur, log_s, alive, w_s, l, lp, lmask, lweight, langles,
                split_due, cfg)

        # ---- E-step
        p, w = estep(v_cur, alive, log_s)

        # ---- M-step: per-VP weighted TLS refit + variance update
        if cfg.do_iterations:
            new_vps, vp_ok = jax.vmap(wmod.calc_new_vanishing_point,
                                      in_axes=(None, 0))(l, w)
            s_log_new = jax.vmap(_s_update_log, in_axes=(1, 0))(p.lvsq, p.p_vl)
            s_log_new = jnp.clip(s_log_new, LOG_S_THRESH, log_max_stdd)
            s_nan = jnp.isnan(s_log_new)

            v_next2 = jnp.where((alive & vp_ok)[:, None], new_vps, v_cur)
            log_s2 = jnp.where(alive & vp_ok, s_log_new, log_s)
            err = _vp_change(v_cur, v_next2)
            contributes = alive & vp_ok & ~s_nan
            max_err = jnp.max(jnp.where(contributes, err, 0.0))
            removed = alive & (~vp_ok | s_nan | (contributes & (err > 1.5)))
            alive2 = alive & ~removed
        else:
            v_next2 = v_cur
            log_s2 = log_s
            alive2 = alive
            max_err = jnp.zeros((), f32)

        v_next = jnp.where(go, v_next2, v_next)
        log_s = jnp.where(go, log_s2, log_s)
        alive = jnp.where(go, alive2, alive)

        converged = (max_err < cfg.final_convergence) | \
            (i == cfg.num_iter - 1) | (not cfg.do_iterations)

        # ---- periodic merge (only when not converged this iteration)
        if cfg.do_merge and with_split_merge:
            merge_due = go & ~converged & (jnp.mod(i, cfg.split_merge_freq) == 0) \
                & (i > 0) & (i <= SPLIT_MERGE_IT + cfg.split_merge_freq)
            v_next, log_s, alive = _merge_vps(
                v_next, log_s, alive, cfg.merge_thresh, merge_due, pdfpar,
                l, lp, lmask, lweight, lsim, cfg)

        done = st.done | (go & converged) | empty_now
        empty = st.empty | (~st.done & empty_now)

        # buffer swap for the next iteration (frozen once done)
        swap = go & ~converged
        return _State(
            i=jnp.where(swap, i + 1, i),
            v_cur=jnp.where(swap, v_next, v_cur),
            v_next=v_next,
            log_s=log_s, alive=alive, done=done, empty=empty)

    # Phase-structured loop. Split/merge are only ever due when
    # i % split_merge_freq == 0, and i advances in lockstep across a vmapped
    # batch (elements either advance by exactly 1 per iteration or freeze at
    # convergence), so every iteration with i % freq != 0 provably skips the
    # gated split/merge blocks. Running [1 full iteration + (freq-1) plain
    # E+M iterations] per phase executes the identical op sequence while
    # keeping the split E-step, the clustering linkage loop and the merge
    # loop out of the hot path — ~2x fewer E-steps per iteration than a
    # single uniform body (the gated blocks are selects, not branches, under
    # vmap so they would otherwise be paid every iteration).
    plain_steps = max(int(cfg.split_merge_freq) - 1, 0)

    def phase(st: _State):
        st = body(st, with_split_merge=True)
        if plain_steps:
            st = jax.lax.scan(
                lambda s, _: (body(s, with_split_merge=False), None),
                st, None, length=plain_steps)[0]
        return st

    if cfg.loop == "uniform":
        # split/merge due-ness is decided inside body by i % freq, so the
        # uniform loop executes the identical op sequence one iteration
        # at a time (round-1 structure; see EMConfig.loop)
        trip = lambda st: body(st, with_split_merge=True)
    else:
        trip = phase
    state = jax.lax.while_loop(cond, trip, state0)

    return _finalize(state, pdfpar, l, lp, lmask, lweight, lsim, langles, cfg)
