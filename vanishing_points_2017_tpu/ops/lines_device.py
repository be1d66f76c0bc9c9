"""On-device line-segment detection (XLA, static shapes).

The reference's only host-side hot stage is LSD (C/Cython there, C++ in
``lsd/`` here; call-site contract ``evaluation.py:227-251`` of
fkluger/vanishing_points_2017). This module is the on-device equivalent for
the fully fused path, built around the same primitives as von Gioi's LSD but
reformulated as data-parallel passes with static shapes:

1. 2x2 gradient + DIRECTED level-line angles (exactly LSD's operators and
   its ``rho = quant / sin(tol)`` activation threshold).
2. Connected components over the pixel grid: two 8-neighbours join when both
   are active and their level-line directions agree within ``tol`` (LSD's
   region-growing predicate, applied pairwise). Labels converge by
   alternating raster min-label passes (descending + ascending rows, with
   bidirectional segmented min scans inside each row) — exact in two
   passes for digital straight lines and free of (H*W)-element random
   gathers. On a GPU a CUDA kernel runs the same passes (``ccl_gpu``).
3. Component selection + exact moments + endpoints from per-row RUN
   RECORDS: a component's pixels in one row are contiguous runs, so
   segmented row scans produce per-run mass/moment/endpoint records;
   per-row top-k compresses the grid ~10x before the single sort-by-root,
   and segmented doubling sums reduce each group's moments. Centroid +
   covariance give the principal direction (LSD's region2rect); min/max
   projections over run ENDPOINTS (the projection is linear in the
   column, so per-run extrema sit at endpoints — exact) give the true
   extremal span, not a variance estimate.
5. Validation: an NFA gate in the spirit of LSD's binomial test — the
   Hoeffding bound on log10 B(area, count, p) with p = tol/pi and the
   (HW)^(5/2) test count — plus minimum count/length gates.

vs LSD: no iterative rectangle refinement (rect_improve) and curves are
rejected (wide components fail the NFA/width gates) instead of being
approximated by many short segments. The payoff: the detector is pure XLA
with static output shape (max_segments, 4) + mask, so image -> segments ->
sphere -> CNN -> EM -> horizon compiles into ONE device program with no
host round-trip (``pipeline.device_pipeline_full``).

Outputs use the same normalized frame as ``data/io.normalize_segments``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

QUANT = 2.0
TOL_DEG = 22.5

_I32_MAX = jnp.iinfo(jnp.int32).max
_NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
               (0, 1), (1, -1), (1, 0), (1, 1))


def _shift(a: jnp.ndarray, dy: int, dx: int, fill):
    """out[y, x] = a[y + dy, x + dx], border-filled."""
    h, w = a.shape
    p = jnp.pad(a, ((1, 1), (1, 1)), constant_values=fill)
    return jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w))


def _gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian with edge-replicated borders.

    LSD smooths before the gradient (scale 0.8, sigma 0.6/0.8) to remove
    staircase aliasing, which otherwise makes the per-pixel level-line angle
    alternate between the two +-tol extremes and fragments regions. Blur
    without the downsample keeps the pixel grid (and all static shapes).
    """
    r = max(1, int(3.0 * sigma + 0.5))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    # shift-and-add instead of conv: a (2r+1)-tap single-channel conv
    # has no use for a matrix unit; static shifted slices are elementwise
    # adds that XLA fuses.
    h, w = img.shape
    p = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    out = sum(float(k[i]) * jax.lax.dynamic_slice(p, (i, 0), (h, w))
              for i in range(2 * r + 1))
    p = jnp.pad(out, ((0, 0), (r, r)), mode="edge")
    return sum(float(k[i]) * jax.lax.dynamic_slice(p, (0, i), (h, w))
               for i in range(2 * r + 1))


def level_lines(image: jnp.ndarray, blur_sigma: float = 1.0,
                tol_deg: float = TOL_DEG):
    """(H, W) image -> (active, ux, uy, mag) on the (H-1, W-1) grid.

    LSD's 2x2 gradient after the Gaussian blur; ``active`` is LSD's
    ``rho = quant / sin(tol)`` threshold on the gradient magnitude and
    (ux, uy) the unit DIRECTED level-line direction.
    """
    img = image.astype(jnp.float32)
    if blur_sigma > 0:
        img = _gaussian_blur(img, blur_sigma)
    com1 = img[1:, 1:] - img[:-1, :-1]
    com2 = img[:-1, 1:] - img[1:, :-1]
    gx = 0.5 * (com1 + com2)
    gy = 0.5 * (com1 - com2)
    mag = jnp.sqrt(gx * gx + gy * gy)
    active = mag > QUANT / math.sin(math.radians(tol_deg))
    inv = jnp.where(mag > 0, 1.0 / jnp.maximum(mag, 1e-12), 0.0)
    # level-line direction = gradient rotated 90 degrees: (ux, uy) =
    # (gx, -gy)/|g|, an orthogonal transform of (cos, sin) of LSD's
    # atan2(gx, -gy) angle — dot products, hence angle differences, are
    # preserved
    return active, gx * inv, -gy * inv, mag


def _edge_masks(active: jnp.ndarray, ux: jnp.ndarray, uy: jnp.ndarray,
                cos_tol: float) -> dict:
    """masks[(dy, dx)][y, x] = edge between (y, x) and (y+dy, x+dx).

    An edge exists when both pixels are active and dot(dir_p, dir_q) >
    cos_tol (directed, like LSD: the two sides of a dark stroke have
    opposite gradients and stay separate components).
    """
    masks = {}
    for dy, dx in _NEIGHBOURS:
        dot = (ux * _shift(ux, dy, dx, 0.0)
               + uy * _shift(uy, dy, dx, 0.0))
        masks[(dy, dx)] = (active & _shift(active, dy, dx, False)
                           & (dot > cos_tol))
    return masks


def _connected_components_jump(active: jnp.ndarray, ux: jnp.ndarray,
                               uy: jnp.ndarray, cos_tol: float,
                               rounds: int) -> jnp.ndarray:
    """Min-label CCL by neighbour-min propagation + pointer jumping.

    Each round: one neighbour-min propagation + two pointer jumps
    (``lab = lab[lab]``). Labels only decrease and lab[i] <= i is invariant,
    so the jumps always shorten chains; ``rounds ~ log2(HW)`` suffices.
    Returns (H*W,) int32 root labels (inactive pixels keep their own index).

    Exact for arbitrary shapes, but each jump is a (H*W,)-element random
    gather. Kept as the oracle for the raster variant below.
    """
    h, w = active.shape
    lab0 = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    masks = _edge_masks(active, ux, uy, cos_tol)

    def body(_, lab):
        best = lab
        for key in _NEIGHBOURS:
            dy, dx = key
            nb = _shift(lab, dy, dx, _I32_MAX)
            best = jnp.minimum(best, jnp.where(masks[key], nb, _I32_MAX))
        flat = best.reshape(-1)
        flat = flat[flat]
        flat = flat[flat]
        return flat.reshape(h, w)

    lab = jax.lax.fori_loop(0, rounds, body, lab0)
    return lab.reshape(-1)


def _segmented_min_scan_rows(v: jnp.ndarray, conn: jnp.ndarray,
                             log_steps: int) -> jnp.ndarray:
    """Per-row segmented min scan, vectorized over leading axes.

    v: (..., W) values; conn: (..., W) bool, conn[..., x] means x joins
    x-1 (conn[..., 0] must be False). Returns s with
    s[..., x] = min(v[..., j..x]) where j is the start of x's segment.
    Hillis-Steele doubling: log2(W) rounds of shifted selects, no gathers.
    """
    m = conn
    for k in range(log_steps):
        d = 1 << k
        v_sh = jnp.pad(v[..., :-d], [(0, 0)] * (v.ndim - 1) + [(d, 0)],
                       constant_values=_I32_MAX)
        m_sh = jnp.pad(m[..., :-d], [(0, 0)] * (v.ndim - 1) + [(d, 0)],
                       constant_values=False)
        v = jnp.where(m, jnp.minimum(v, v_sh), v)
        m = m & m_sh
    return v


def _raster_half_pass(lab: jnp.ndarray, m_up: jnp.ndarray,
                      m_upl: jnp.ndarray, m_upr: jnp.ndarray,
                      m_w: jnp.ndarray, m_e: jnp.ndarray) -> jnp.ndarray:
    """One top-to-bottom raster CCL pass (all-direction within rows).

    Per row: inject min labels from the FINAL previous row through the
    N/NW/NE edges, then spread within the row in both x directions via
    segmented min scans over the W/E edges. Exactly the classic raster
    connected-components pass; a digital straight line visits rows
    monotonically, so one descending + one ascending pass reach the CCL
    fixpoint for every straight segment — no gathers, no pointer jumping.
    """
    h, w = lab.shape
    log_w = max(1, math.ceil(math.log2(w)))

    def row_step(prev, xs):
        row, mu, mul, mur, mw, me = xs
        up = jnp.where(mu, prev, _I32_MAX)
        upl = jnp.where(mul, jnp.pad(prev[:-1], (1, 0),
                                     constant_values=_I32_MAX), _I32_MAX)
        upr = jnp.where(mur, jnp.pad(prev[1:], (0, 1),
                                     constant_values=_I32_MAX), _I32_MAX)
        init = jnp.minimum(jnp.minimum(row, up), jnp.minimum(upl, upr))
        fwd = _segmented_min_scan_rows(init, mw, log_w)
        bwd = _segmented_min_scan_rows(init[::-1], me[::-1], log_w)[::-1]
        out = jnp.minimum(fwd, bwd)
        return out, out

    _, rows = jax.lax.scan(row_step, jnp.full((w,), _I32_MAX, lab.dtype),
                           (lab, m_up, m_upl, m_upr, m_w, m_e))
    return rows


def _raster_ccl(em: dict, passes: int) -> jnp.ndarray:
    """Alternating raster passes over precomputed edge masks -> (H*W,)."""
    h, w = em[(0, 1)].shape
    lab = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)

    def pass_pair(_, lab):
        # descending rows, then ascending (== descending on the flipped grid)
        lab = _raster_half_pass(lab, em[(-1, 0)], em[(-1, -1)],
                                em[(-1, 1)], em[(0, -1)], em[(0, 1)])
        return _raster_half_pass(
            lab[::-1], em[(1, 0)][::-1], em[(1, -1)][::-1],
            em[(1, 1)][::-1], em[(0, -1)][::-1], em[(0, 1)][::-1])[::-1]

    # fori over pass PAIRS keeps the compiled graph one pair deep no
    # matter how many passes run
    lab = jax.lax.fori_loop(0, max(1, passes // 2), pass_pair, lab)
    return lab.reshape(-1)


def _connected_components(active: jnp.ndarray, ux: jnp.ndarray,
                          uy: jnp.ndarray, cos_tol: float,
                          passes: int = 4) -> jnp.ndarray:
    """Min-label CCL on the masked orientation graph, raster formulation.

    Alternates descending and ascending raster passes (``passes`` total,
    starting descending). Two passes are exact for every digital straight
    line (monotone row visitation — the only shape class the downstream
    NFA/width gates keep); extra passes mop up noise-induced zigzags.
    Returns (H*W,) int32 root labels (inactive pixels keep their own index).

    Measured on rendered synthetic scenes (tests/test_pipeline.py): 8
    passes reach the exact BFS fixpoint, while the pointer-jumping
    variant still has a few dozen unconverged pixels after 34 rounds —
    this formulation needs no gathers and is more exact. It is the plain
    reference of the GPU kernel (``ccl_gpu``) and the path on every other
    backend.
    """
    return _raster_ccl(_edge_masks(active, ux, uy, cos_tol), passes)


def connected_components(active: jnp.ndarray, ux: jnp.ndarray,
                         uy: jnp.ndarray, cos_tol: float,
                         passes: int) -> jnp.ndarray:
    """:func:`_connected_components`, run by the CUDA kernel on a GPU.

    The choice is made when the program is lowered for its platform
    (``lax.platform_dependent``), so one traced program runs the kernel on
    the card and the scan on the CPU. The labels are identical.
    """
    em = _edge_masks(active, ux, uy, cos_tol)

    def gpu(em):
        from . import ccl_gpu
        return ccl_gpu.raster_ccl(ccl_gpu.pack_edge_masks(em),
                                  passes).reshape(-1)

    return jax.lax.platform_dependent(
        em, cuda=gpu, default=lambda em: _raster_ccl(em, passes))


def ccl_fixpoint_residual(active: jnp.ndarray, ux: jnp.ndarray,
                          uy: jnp.ndarray, cos_tol: float,
                          labels: jnp.ndarray) -> jnp.ndarray:
    """Number of pixels whose label would still change under one more
    neighbour-min round — 0 iff ``labels`` is the CCL fixpoint.

    Debug/validation helper for :func:`_connected_components`'s fixed
    ``ccl_passes``: raster passes are provably exact only for digital
    straight lines; curved/zigzag noise components may need more. Tests
    assert residual == 0 across seeds/sizes (tests/test_pipeline.py), and
    ``detect_segments_device(..., check_fixpoint=True)`` folds the check
    into the jitted program via a NaN poison on the output.
    """
    h, w = active.shape
    lab = labels.reshape(h, w)
    masks = _edge_masks(active, ux, uy, cos_tol)
    best = lab
    for key in _NEIGHBOURS:
        dy, dx = key
        nb = _shift(lab, dy, dx, _I32_MAX)
        best = jnp.minimum(best, jnp.where(masks[key], nb, _I32_MAX))
    return jnp.sum(best != lab)


def _segmented_sum_scan(v: jnp.ndarray, conn: jnp.ndarray,
                        log_steps: int) -> jnp.ndarray:
    """Per-segment inclusive prefix SUM along the last axis (leading axes
    vectorized). conn[..., x] means x joins x-1. Error stays proportional
    to each segment's own magnitude (no cross-segment cumsum-difference
    cancellation)."""
    m = conn
    for k in range(log_steps):
        d = 1 << k
        pads = [(0, 0)] * (v.ndim - 1) + [(d, 0)]
        v_sh = jnp.pad(v[..., :-d], pads)
        m_sh = jnp.pad(m[..., :-d], [(0, 0)] * (m.ndim - 1) + [(d, 0)],
                       constant_values=False)
        v = jnp.where(m, v + v_sh, v)
        m = m & m_sh
    return v


def _segmented_copy_first(v: jnp.ndarray, conn: jnp.ndarray,
                          log_steps: int) -> jnp.ndarray:
    """Broadcast each segment's FIRST value to all its members (last
    axis; leading axes vectorized)."""
    m = conn
    for k in range(log_steps):
        d = 1 << k
        pads = [(0, 0)] * (v.ndim - 1) + [(d, 0)]
        v_sh = jnp.pad(v[..., :-d], pads)
        m_sh = jnp.pad(m[..., :-d], [(0, 0)] * (m.ndim - 1) + [(d, 0)],
                       constant_values=False)
        v = jnp.where(m, v_sh, v)
        m = m & m_sh
    return v


def _component_stats(root: jnp.ndarray, wgt: jnp.ndarray, xn2: jnp.ndarray,
                     yn2: jnp.ndarray, max_segments: int,
                     shape: tuple[int, int],
                     runs_per_row: int | None = None,
                     selection: str = "row",
                     max_records: int = 32768,
                     global_prefilter: int | None = None,
                     topk_impl: str = "exact",
                     coord_affine: tuple[float, float, float] | None = None):
    """Top-k components by gradient mass, with exact moments + extremal
    projections — all from per-row RUN RECORDS, never a per-pixel
    sort/scatter/membership pass.

    A component's pixels within one image row are contiguous runs, so
    per-row segmented scans (dense vector work) produce each run's mass,
    x-moments and count (w, wx, wxx, count — the y-moments are derived
    per record since y is constant within a row-run) and endpoint
    coordinates at its last pixel. Per-row top-``runs_per_row`` (by run
    mass) compresses the grid to H*k records; those are sorted by root
    once, reduced per group by segmented doubling sums, and each group's
    principal direction (from its own total moments) is broadcast back
    to its records so the extremal projections — whose per-run extrema
    provably sit at run endpoints (the projection is linear in the
    column) — reduce by segmented min/max. Everything downstream of the
    sort is O(H * runs_per_row), ~10x smaller than per-pixel.

    Exact unless a row holds more than ``runs_per_row`` nonzero-mass
    runs, in which case that row's weakest runs stop contributing (the
    components survive through their other rows' records).

    ``yn2`` MUST be constant along each image row (it is the row's
    normalized y coordinate): the y-moments are reconstructed per record
    from the run-end pixel's yn2 — a non-row-constant yn2 would give
    wrong moments with no error raised.

    ``coord_affine`` = (w_full, h_full, s): when the xn2/yn2 grids are the
    detector's standard normalized frame (xn2 = ((col+0.5) - w/2)/s,
    yn2 = -((row+0.5) - h/2)/s on the inner gradient grid), passing the
    constants lets the record fetch RECOMPUTE each record's coordinates
    from its flat position with the same f32 op sequence — bit-identical
    to gathering the grids — so the stacked gather matrix drops from 7
    channels to 5, and the root channel rides the same matrix as a
    bitcast (6 total) instead of a second gather. None keeps the pure
    gather formulation (the equivalence oracle,
    tests/test_pipeline.py::test_coord_affine_equivalence).

    Returns a dict of per-slot arrays (all shaped (max_segments,)):
    ``valid, mass, cnt, cx, cy, ddx, ddy, lam_min, tmin, tmax``.
    """
    h, w = shape
    if runs_per_row is None:
        # per-row record budget. Rendered synthetic scenes have a p99
        # nonzero-run count of 44 per row at 640x640, so 48 was tried as
        # the default (halves the sort size) — but REAL photographs are
        # texture-dense (the reference's bundled example photos: median
        # 42 runs/row, p99 142) and at 48 the dropped rows demonstrably
        # move the horizon (uni_hannover_lichthof err 0.215 at 48 vs
        # 0.006 at 64, scripts/sweep_detector_gates.py round 3). 64 is
        # the smallest budget that held on all real photos at 640 px;
        # run counts scale with row WIDTH, so the default scales as w/10
        # (= exactly 64 at the arbitration width — every 640-px result
        # is bit-unchanged — and 80 at the ECD/HLW 800-px resize). The
        # record count H*k is the detector's main cost axis (TODO 3).
        runs_per_row = max(64, w // 10, max_segments // 8)
    f32 = jnp.float32
    r2 = root.reshape(h, w)
    w2 = wgt.reshape(h, w)

    # ---- per-row run scans
    conn = jnp.concatenate(
        [jnp.zeros((h, 1), bool), r2[:, 1:] == r2[:, :-1]], axis=1)
    is_end = jnp.concatenate(
        [r2[:, 1:] != r2[:, :-1], jnp.ones((h, 1), bool)], axis=1)
    log_w = max(1, math.ceil(math.log2(w)))
    # Only the x-moments (and mass/count) need a per-pixel scan: within a
    # row-run yn2 is CONSTANT, so the y-moments are per-record products of
    # the run's y with its w/wx sums (wy = y*w, wxx stays, wxy = y*wx,
    # wyy = y^2*w) — computed below on the ~10x smaller record set. Cuts
    # the dominant (C, H, W) doubling scan from 7 channels to 4.
    # Mathematically exact; f32 rounding of the per-record products
    # differs from the per-pixel sums (gated on the real-photo suite).
    q = jnp.stack([w2, w2 * xn2, w2 * xn2 * xn2,
                   (w2 > 0).astype(f32)], axis=0)  # (4,H,W)
    qs = _segmented_sum_scan(q, conn[None], log_w)
    # In affine mode the run's FIRST x is derived per record from the
    # run-end column and the count channel (see the fetch below), so the
    # whole (H, W) copy-first doubling chain (log2 W rounds) is dropped
    # from the production path; the oracle (coord_affine=None) keeps it.
    x_first = (None if coord_affine is not None
               else _segmented_copy_first(xn2, conn, log_w))

    # ---- run-record selection: global top-R (by run mass over the whole
    # image) or per-row top-k. Global is exact whenever the image holds
    # <= max_records nonzero runs and degrades by dropping the GLOBALLY
    # weakest runs — a principled noise floor — where the per-row budget
    # drops the locally weakest run of each over-budget row even when it
    # is strong in absolute terms (texture-dense real photos hit p99 142
    # runs/row; see runs_per_row note above).
    if selection not in ("row", "global"):
        raise ValueError(f"unknown selection {selection!r}; "
                         "expected 'row' or 'global'")
    if topk_impl not in ("exact", "approx"):
        raise ValueError(f"unknown topk_impl {topk_impl!r}; "
                         "expected 'exact' or 'approx'")
    if selection == "global" and topk_impl == "approx":
        # jax.lax.approx_max_k over all H*W run ends. On the GPU and the
        # CPU XLA lowers it to an exact sort, so the kept SET equals the
        # exact selection's (tests/test_pipeline.py, chip_smoke.py phase
        # 5); above max_records an approximate lowering may additionally
        # miss ~(1 - recall_target) of records near the mass boundary —
        # the same graceful partial-drop class as the row budget (a
        # component keeps its other rows' records). The indices ARE the
        # flat run-end positions (no prefilter/pos bookkeeping).
        r_sel = min(max_records, h * w)
        mass_flat = jnp.where(is_end, qs[0], -1.0).reshape(-1)
        top_mass, flat_pos = jax.lax.approx_max_k(
            mass_flat, r_sel, recall_target=0.99)
        flat_pos = flat_pos.astype(jnp.int32)
        rec_ok = top_mass > 0.0
    elif selection == "global":
        # Two-stage selection: a per-row top-k_pre prefilter, then the
        # flat top-max_records over the H*k_pre candidates. The naive
        # one-stage top_k over all H*W run-end masses is a full
        # ~400k-element sort; the prefilter shrinks the big sort's
        # operand ~4x. It can only change the result if one row holds
        # more than k_pre nonzero-mass runs AND one of the dropped
        # (that row's weakest) runs would have made the global top-k:
        # k_pre = 3w/10 (191 at 640 px, 240 at the ECD/HLW 800 px
        # resize) is ≥ 26% above the densest row ever measured (152,
        # reference real photos; synthetic scenes max 56), so on every
        # available input the candidate SET — and, by the canonical
        # (root, pos) record sort, every downstream f32 bit — is
        # identical to the one-stage selection
        # (tests/test_pipeline.py::test_global_prefilter_equivalence).
        # ``global_prefilter``: None = the 3w/10 rule, 0 = disable
        # (one-stage; the equivalence oracle), >0 = explicit cap.
        if global_prefilter is None:
            k_pre = min(w, max(64, (3 * w) // 10))
        elif global_prefilter == 0:
            k_pre = 0
        else:
            k_pre = min(w, int(global_prefilter))
        mass_row = jnp.where(is_end, qs[0], -1.0)            # (H, W)
        if k_pre > 0:
            pre_mass, pre_col = jax.lax.top_k(mass_row, k_pre)
            row_i = jnp.arange(h, dtype=jnp.int32)[:, None]
            pre_pos = row_i * w + pre_col.astype(jnp.int32)  # (H, k_pre)
            cand_mass = pre_mass.reshape(-1)
            cand_pos = pre_pos.reshape(-1)
        else:
            cand_mass = mass_row.reshape(-1)
            cand_pos = jnp.arange(h * w, dtype=jnp.int32)
        r_sel = min(max_records, cand_pos.shape[0])
        top_mass, top_i = jax.lax.top_k(cand_mass, r_sel)    # (R,)
        rec_ok = top_mass > 0.0
        flat_pos = cand_pos[top_i]                           # (R,)
    else:
        k_row = min(runs_per_row, w)
        mass_row = jnp.where(is_end, qs[0], -1.0)
        top_mass, top_pos = jax.lax.top_k(mass_row, k_row)   # (H, k)
        rec_ok = (top_mass > 0.0).reshape(-1)
        row_i = jnp.arange(h, dtype=jnp.int32)[:, None]
        flat_pos = (row_i * w + top_pos.astype(jnp.int32)).reshape(-1)
    # fetch every record channel with ONE row-gather of the stacked
    # (H*W, C) matrix at the selected flat positions instead of one
    # minor-axis take_along_axis per channel. Identical values in
    # identical (row-major) order, so outputs are bit-identical to the
    # take formulation.
    chans = [qs[i].reshape(-1) for i in range(4)]
    if coord_affine is None:
        chans += [x_first.reshape(-1), xn2.reshape(-1), yn2.reshape(-1)]
        g = jnp.stack(chans, axis=1)[flat_pos]                # (R, 7)
        rec_root = jnp.where(rec_ok, r2.reshape(-1)[flat_pos], -1)
        rec_x0, rec_x1, rec_y = g[:, 4], g[:, 5], g[:, 6]
    else:
        # ride the root along the same gather as a bitcast f32 channel
        # (int32 bit patterns survive exactly), and RECOMPUTE the
        # coordinate channels from the gathered position with the
        # detector's own affine op sequence — bit-identical to gathering
        # the xn2/yn2 grids, two fewer (H*W,) channels of gather traffic.
        chans.append(jax.lax.bitcast_convert_type(r2.reshape(-1), f32))
        g = jnp.stack(chans, axis=1)[flat_pos]                # (R, 5)
        root_g = jax.lax.bitcast_convert_type(g[:, 4], jnp.int32)
        rec_root = jnp.where(rec_ok, root_g, -1)
        w_full, h_full, s_half = coord_affine
        row_idx = flat_pos // w
        col_idx = flat_pos - row_idx * w
        rec_x1 = ((col_idx.astype(f32) + 0.5) - w_full / 2.0) / s_half
        rec_y = -((row_idx.astype(f32) + 0.5) - h_full / 2.0) / s_half
        # the run's FIRST x, derived: a mass>0 run is all-active
        # (inactive pixels are CCL singletons, _connected_components
        # docstring), so its pixel count IS its length and
        # first_col = end_col - cnt + 1. All quantities are small
        # integers (exact in f32) and the affine expression below is the
        # op-for-op xn2 grid formula, so rec_x0 is BIT-IDENTICAL to
        # gathering the segmented copy-first scan of xn2
        # (tests/test_pipeline.py::test_coord_affine_equivalence) while
        # the (H, W) copy-first chain disappears from this path.
        col0 = col_idx.astype(f32) - g[:, 3] + 1.0
        rec_x0 = ((col0 + 0.5) - w_full / 2.0) / s_half
    rec_w, rec_wx, rec_wxx, rec_cnt = [
        jnp.where(rec_ok, g[:, i], 0.0) for i in range(4)]
    # derive the y-moments per record (yn2 constant within a row-run;
    # rec_w/rec_wx are zeroed for invalid records, so the products are too)
    rec_q = [rec_w, rec_wx, rec_y * rec_w, rec_wxx, rec_y * rec_wx,
             rec_y * rec_y * rec_w, rec_cnt]
    rec_pos = flat_pos

    # ---- one sort by root groups each component's records contiguously,
    # then per-group reductions (segmented doubling sums, min/max).
    n_rec = rec_root.shape[0]
    payload = jnp.stack([*rec_q, rec_x0, rec_x1, rec_y], axis=0)  # (10, R)
    # CANONICAL order: (root, run-end flat position) is a total order on
    # records, so the sorted sequence — and with it every downstream f32
    # association (group sums, first/last broadcasts) — is identical for
    # any selection strategy or budget that keeps the same record SET.
    # With root as the only key, lax.sort's tie order leaks the
    # pre-sort record order into the f32 results; that made outputs
    # depend on runs_per_row/selection even when no record was dropped.
    #
    # Sort 3 operands (keys + an iota), then move the 10 payload
    # channels with ONE row-gather of the (R, 10) matrix by the sort
    # permutation, rather than dragging all 10 channels through a
    # 12-operand sort: the identical f32 values land in the identical
    # order.
    idx = jnp.arange(n_rec, dtype=jnp.int32)
    rs, _, perm = jax.lax.sort([rec_root, rec_pos, idx], num_keys=2)
    payload = payload.T[perm].T                               # (10, R)
    sq = payload[:7]                                          # (7, R)
    sx0, sx1, sy = payload[7], payload[8], payload[9]
    log_r = max(1, math.ceil(math.log2(n_rec)))
    gconn = jnp.concatenate(
        [jnp.zeros((1,), bool), rs[1:] == rs[:-1]])
    g_end = jnp.concatenate([rs[1:] != rs[:-1], jnp.ones((1,), bool)])

    gsum = _segmented_sum_scan(sq, gconn[None], log_r)        # (7, R)
    s_w, s_wx, s_wy, s_wxx, s_wxy, s_wyy, s_cnt = [
        gsum[i] for i in range(7)]

    # ---- moments -> principal direction (meaningful at group ends)
    sw = jnp.maximum(s_w, 1e-9)
    cx, cy = s_wx / sw, s_wy / sw
    vxx = jnp.maximum(s_wxx / sw - cx * cx, 0.0)
    vxy = s_wxy / sw - cx * cy
    vyy = jnp.maximum(s_wyy / sw - cy * cy, 0.0)
    tr = vxx + vyy
    det = vxx * vyy - vxy * vxy
    lam_max = 0.5 * tr + jnp.sqrt(jnp.maximum(0.25 * tr * tr - det, 0.0))
    lam_min = jnp.maximum(tr - lam_max, 0.0)
    # both (vxy, lam-vxx) and (lam-vyy, vxy) are eigenvectors of lam_max;
    # pick the larger — an |vxy|>eps branch sends exactly-vertical
    # components (f32 vxy == 0) to the degenerate vector and then to the
    # (1, 0) fallback, i.e. a 90-degree-wrong direction
    ex_a, ey_a = vxy, lam_max - vxx
    ex_b, ey_b = lam_max - vyy, vxy
    use_a = ex_a * ex_a + ey_a * ey_a >= ex_b * ex_b + ey_b * ey_b
    ex = jnp.where(use_a, ex_a, ex_b)
    ey = jnp.where(use_a, ey_a, ey_b)
    en = jnp.sqrt(ex * ex + ey * ey)
    ok_e = en > 1e-12
    ddx = jnp.where(ok_e, ex / jnp.where(ok_e, en, 1.0), 1.0)
    ddy = jnp.where(ok_e, ey / jnp.where(ok_e, en, 1.0), 0.0)

    # ---- broadcast each group's END direction back to its records.
    # Paired scans sharing a conn mask are stacked into ONE scan over a
    # (2, R) operand — identical elementwise ops per lane, bit-identical
    # results, half the HLO ops.
    same_next = jnp.concatenate([rs[:-1] == rs[1:], jnp.zeros((1,), bool)])
    flip_conn = same_next[::-1]
    dd_b = _segmented_copy_first(
        jnp.stack([ddx[::-1], ddy[::-1]]), flip_conn[None], log_r)[:, ::-1]
    ddx_b, ddy_b = dd_b[0], dd_b[1]

    # ---- extremal projections: per-run extrema sit at run endpoints
    t0 = ddx_b * sx0 + ddy_b * sy
    t1 = ddx_b * sx1 + ddy_b * sy
    inf = jnp.where(rs >= 0, 0.0, jnp.inf)  # invalid records can't win
    gmm = _segmented_min_scan_rows(
        jnp.stack([jnp.minimum(t0, t1) + inf,
                   -jnp.maximum(t0, t1) + inf]), gconn[None], log_r)
    gmin, gmax = gmm[0], -gmm[1]

    # ---- top-k components by total mass (group ends only)
    score = jnp.where(g_end & (rs >= 0), gsum[0], -1.0)
    top, pos = jax.lax.top_k(score, max_segments)
    sel = lambda a: a[pos]
    return {
        "valid": top > 0.0, "root": sel(rs), "mass": sel(s_w),
        "cnt": sel(s_cnt),
        "cx": sel(cx), "cy": sel(cy), "ddx": sel(ddx), "ddy": sel(ddy),
        "lam_min": sel(lam_min), "tmin": sel(gmin), "tmax": sel(gmax),
    }


@functools.partial(jax.jit, static_argnames=("max_segments", "tol_deg",
                                             "min_count", "min_len_px",
                                             "min_density",
                                             "ccl_passes",
                                             "blur_sigma", "pair_tol_factor",
                                             "runs_per_row",
                                             "check_fixpoint",
                                             "selection", "max_records",
                                             "global_prefilter",
                                             "topk_impl"))
def detect_segments_device(image: jnp.ndarray, max_segments: int = 512,
                           tol_deg: float = TOL_DEG, min_count: int = 15,
                           min_len_px: float = 12.0,
                           min_density: float = 0.7,
                           ccl_passes: int = 8,
                           blur_sigma: float = 1.0,
                           pair_tol_factor: float = 1.0,
                           runs_per_row: int | None = None,
                           check_fixpoint: bool = False,
                           selection: str = "row",
                           max_records: int = 32768,
                           global_prefilter: int | None = None,
                           topk_impl: str = "exact"):
    """(H, W) grayscale in [0, 255] -> (segments (S, 4) normalized, mask).

    Segments are sorted by decreasing accumulated gradient mass.
    ``runs_per_row`` bounds the per-row run-record budget of the selection
    stage (default max(64, w/10, max_segments/8)); rows denser than that drop
    their weakest runs, so dense-scene users can raise it explicitly.
    ``check_fixpoint=True`` poisons the output with NaN if ``ccl_passes``
    raster passes did not reach the CCL fixpoint (debug aid; the passes
    are provably exact only for digital straight lines).
    ``selection``: "row" (this function's low-level default) = per-row
    top-``runs_per_row`` run records; "global" = image-wide
    top-``max_records`` by run mass — free of per-row drops, and the
    production default (PipelineConfig.det_selection; the f32
    record-order knife edge that kept it opt-in was resolved by the
    zenith side-gate waiver, see BASELINE.md round-4 section).
    ``global_prefilter``: per-row candidate cap of the global selection's
    two-stage top-k (None = the 3w/10 rule, 0 = the one-stage oracle;
    see _component_stats).
    ``topk_impl``: "exact" (bit-exact two-stage global top-``max_records``,
    the production default) or "approx" (``jax.lax.approx_max_k``; the
    same record set on GPU and CPU, see _component_stats). Only
    meaningful with selection="global".
    """
    h, w = image.shape
    hi, wi = h - 1, w - 1  # inner 2x2-gradient grid
    npix = hi * wi
    tol = math.radians(tol_deg)
    active, ux, uy, mag = level_lines(image, blur_sigma, tol_deg)

    # LSD admits pixels within tol of the REGION angle, so two member
    # pixels can differ by up to 2*tol (triangle inequality); the pairwise
    # predicate defaults to 2*tol or residual staircase wobble (which
    # alternates between the two +-tol extremes) fragments regions.
    root = connected_components(active, ux, uy,
                                math.cos(pair_tol_factor * tol), ccl_passes)
    if check_fixpoint:
        resid = ccl_fixpoint_residual(active, ux, uy,
                                      math.cos(pair_tol_factor * tol), root)
        poison = jnp.where(resid > 0, jnp.nan, 0.0)
    else:
        poison = 0.0

    # ---- pixel tables in the NORMALIZED frame (centre origin, +y up,
    # long axis [-1, 1]) so the moment sums stay O(1)-scaled for float32
    s = max(h, w) / 2.0
    ys_i, xs_i = jnp.meshgrid(jnp.arange(hi, dtype=jnp.float32),
                              jnp.arange(wi, dtype=jnp.float32),
                              indexing="ij")
    xn2 = ((xs_i + 0.5) - w / 2.0) / s   # 2x2 support centre
    yn2 = -((ys_i + 0.5) - h / 2.0) / s
    wgt = jnp.where(active, mag / 255.0, 0.0)

    # ---- component selection + exact moments + extremal projections,
    # all via per-row run records (no per-pixel sort/scatter/membership)
    st = _component_stats(root, wgt.reshape(-1), xn2, yn2, max_segments,
                          (hi, wi), runs_per_row=runs_per_row,
                          selection=selection,
                          max_records=max_records,
                          global_prefilter=global_prefilter,
                          topk_impl=topk_impl,
                          coord_affine=(float(w), float(h), s))
    slot_valid = st["valid"]
    s_cnt, cx, cy = st["cnt"], st["cx"], st["cy"]
    ddx, ddy = st["ddx"], st["ddy"]
    tmin, tmax = st["tmin"], st["tmax"]

    span = jnp.maximum(tmax - tmin, 0.0)           # normalized units
    span_px = span * s
    width_px = jnp.sqrt(12.0 * st["lam_min"]) * s  # rectangle thickness

    # ---- NFA-style validation (Hoeffding bound on LSD's binomial test)
    p_align = tol_deg / 180.0
    area = span_px * jnp.maximum(width_px, 1.0)
    dens = jnp.clip(s_cnt / jnp.maximum(area, 1.0), 1e-6, 1.0 - 1e-6)
    kl = (dens * jnp.log(dens / p_align)
          + (1.0 - dens) * jnp.log((1.0 - dens) / (1.0 - p_align)))
    log10_nfa = 2.5 * math.log10(npix) - area * kl / math.log(10.0)
    meaningful = (dens > p_align) & (log10_nfa < 0.0)
    if min_density > 0.0:
        # LSD's region-to-rectangle density test (its 0.7 default): a
        # straight stroke fills its own bounding rectangle (dens ~ 1)
        # while a curved/zigzag texture chain — which pairwise-tolerance
        # CCL keeps connected even though LSD's region-angle growth
        # would not — meanders through a rectangle it mostly leaves
        # empty. LSD reacts by shrinking tol or cutting the region
        # (lsd.c's reduce_region_radius/refine); with static shapes we
        # reject instead: the straight sub-pieces the cut would have
        # salvaged are below the count/NFA gates anyway.
        meaningful = meaningful & (dens >= min_density)

    valid = (slot_valid & jnp.isfinite(span) & meaningful
             & (s_cnt >= min_count) & (span_px >= min_len_px))

    t_c = cx * ddx + cy * ddy
    p1x = cx + (tmin - t_c) * ddx
    p1y = cy + (tmin - t_c) * ddy
    p2x = cx + (tmax - t_c) * ddx
    p2y = cy + (tmax - t_c) * ddy
    seg = jnp.stack([p1x, p1y, p2x, p2y], axis=-1)
    seg = jnp.where(valid[:, None], seg + poison, 0.0)

    # re-rank so valid segments occupy the leading mask slots
    order = jnp.argsort(~valid, stable=True)
    return seg[order], valid[order]
