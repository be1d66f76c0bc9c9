"""End-to-end pipeline tests: real LSD on rendered images -> fused device
program -> horizon, plus the cache and dataset plumbing."""

import numpy as np
import pytest

from vanishing_points_2017_tpu.data import io as dio
from vanishing_points_2017_tpu.data.cache import StageCache
from vanishing_points_2017_tpu.data.datasets import (normalized_horizon_error,
                                                     render_scene_image,
                                                     synthetic_records)
from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.pipeline import (Pipeline, PipelineConfig,
                                                pad_lines)

# small-but-divisible sphere size keeps the CNN cheap on the test CPU
CFG = PipelineConfig(sphere_size=240, n_pad=256)


def test_lsd_extracts_scene_segments():
    rng = np.random.default_rng(0)
    scene = synth.make_scene(rng, lines_per_vp=30, outliers=5)
    img = render_scene_image(scene, size=640)
    det = dio.detect_lsd_lines(img.astype(np.float64))
    segs = det["segments"]
    # LSD sees both edges of each drawn bar; expect >= the drawn count
    assert segs.shape[0] >= scene.segments.shape[0] * 0.8
    # normalized frame: everything within [-1, 1] + margin
    assert np.all(np.abs(segs) <= 1.05)


def test_pad_lines_bucket_overflow_keeps_longest():
    rng = np.random.default_rng(1)
    seg = rng.uniform(-1, 1, size=(300, 4))
    l, lp, m = pad_lines(seg, 128)
    assert l.shape == (128, 3) and m.sum() == 128
    # kept segments are the longest ones
    length = np.hypot(seg[:, 0] - seg[:, 2], seg[:, 1] - seg[:, 3])
    kept_min = np.sort(length)[-128]
    got_len = np.hypot(lp[:, 0] - lp[:, 2], lp[:, 1] - lp[:, 3])
    assert got_len.min() >= kept_min - 1e-6


@pytest.fixture(scope="module")
def pipe():
    return Pipeline(cfg=CFG)


@pytest.mark.slow
def test_full_image_to_horizon(pipe):
    # idealized-CNN shortcut is not available here: random weights mean the
    # CNN prior is noise, so this checks WIRING (shapes/validity), not AUC
    rng = np.random.default_rng(2)
    scene = synth.make_scene(rng, lines_per_vp=40, outliers=8)
    img = render_scene_image(scene, size=640)
    res = pipe.process(img)
    assert res["sphere_image"].shape == (240, 240)
    assert res["cnn_prediction"].shape == (20, 20)
    assert res["hp1"].shape == (3,)
    assert np.isfinite(res["hp1"]).all() and np.isfinite(res["hp2"]).all()


@pytest.mark.slow
def test_batch_matches_single(pipe):
    rng = np.random.default_rng(3)
    bundles = []
    for _ in range(2):
        scene = synth.make_scene(rng, lines_per_vp=25, outliers=5)
        l, lp, m = pad_lines(scene.segments, CFG.n_pad)
        bundles.append({"l": l, "lp": lp, "lmask": m})
    out_b = pipe.process_batch(bundles)
    out_0 = pipe.run_lines(bundles[0]["l"], bundles[0]["lp"],
                           bundles[0]["lmask"])
    # batch-1 vs batch-2 XLA fusion/layout choices shift the renderer +
    # conv stack by ~1e-4 on the sigmoid scale; this checks WIRING
    np.testing.assert_allclose(np.asarray(out_b["cnn_prediction"])[0],
                               np.asarray(out_0["cnn_prediction"]),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(out_b["hp1"])[0],
                               np.asarray(out_0["hp1"]), atol=1e-4)


def test_det_key_tracks_detector_config():
    """Device-detect cache identity must change with every field that
    changes detector outputs — gates, selection strategy, budget, top-k
    form — and must NOT change with EM config (that is cache_key()'s
    job). The CCL implementation is not a field: the GPU kernel and the
    scan give identical labels."""
    import dataclasses
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    base = PipelineConfig()
    seen = {base.det_key()}
    other_topk = "approx" if base.det_topk == "exact" else "exact"
    for field, val in (("det_min_count", 20), ("det_min_len_px", 15.0),
                       ("det_min_density", 0.0), ("det_selection", "row"),
                       ("det_max_records", 16384), ("det_topk", other_topk)):
        key = dataclasses.replace(base, **{field: val}).det_key()
        assert key not in seen, (field, key)
        seen.add(key)
    em2 = dataclasses.replace(base, maxbest=10)
    assert em2.det_key() == base.det_key()
    # "exact" keys bare (its historical form); approx is recorded
    exact = dataclasses.replace(base, det_topk="exact")
    assert exact.det_key() == "detglobal15-12-0.7-32768"
    approx = dataclasses.replace(base, det_topk="approx")
    assert approx.det_key() == exact.det_key() + "-approx"


def test_cache_key_tracks_horizon_gate_tol():
    """The horizon pos-gate relaxation changes cached hp1/hp2, so it is
    part of cache_key() — and omitted at the reference-exact inf so
    pre-existing cache keys stay valid."""
    import dataclasses
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    base = PipelineConfig()
    ref = dataclasses.replace(base, horizon_pos_gate_tol=float("inf"))
    assert "_hz" not in ref.cache_key()
    assert base.cache_key() == ref.cache_key() + "_hz8"
    other = dataclasses.replace(base, horizon_pos_gate_tol=4.0)
    assert other.cache_key() != base.cache_key()


def test_stage_cache_roundtrip(tmp_path):
    cache = StageCache(str(tmp_path), "cfgkey")
    cache.save("img_001", "lines", segments=np.ones((5, 4)),
               image_shape=np.array([480, 640]))
    assert cache.has("img_001", "lines")
    assert not cache.has("img_001", "result")
    got = cache.load("img_001", "lines")
    np.testing.assert_array_equal(got["segments"], np.ones((5, 4)))


def test_synthetic_records_have_gt():
    recs, start = synthetic_records(count=3, seed=1)
    assert start == 0 and len(recs) == 3
    for r in recs:
        assert r.image is not None and r.true_horizon is not None


def test_normalized_horizon_error_zero_for_exact():
    h = np.array([0.1, 1.0, -0.05])
    assert normalized_horizon_error(h, h, 640, 480) == 0.0
    h2 = np.array([0.0, 1.0, 0.1])  # horizontal line shifted by 0.1... y=-0.1
    e = normalized_horizon_error(np.array([0.0, 1.0, 0.0]), h2, 640, 480)
    np.testing.assert_allclose(e, 0.1 / 2 * 640 / 480, rtol=1e-6)


def test_device_detector_finds_scene_lines():
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    rng = np.random.default_rng(7)
    scene = synth.make_scene(rng, lines_per_vp=30, outliers=5)
    img = render_scene_image(scene, size=640, rng=rng).astype(np.float32)
    seg, mask = detect_segments_device(jnp.asarray(img), max_segments=256)
    seg, mask = np.asarray(seg), np.asarray(mask)
    n = mask.sum()
    assert n >= 40  # the ~90 drawn bars yield edge segments
    gt = scene.lines / np.linalg.norm(scene.lines[:, :2], axis=1,
                                      keepdims=True)
    ds = []
    for s in seg[mask]:
        d1 = np.abs(gt @ np.array([s[0], s[1], 1.0])).min()
        d2 = np.abs(gt @ np.array([s[2], s[3], 1.0])).min()
        ds.append(max(d1, d2))
    # median endpoint-to-support-line distance within ~2.5 px
    assert np.median(ds) < 2.5 * 2 / 640, np.median(ds)


@pytest.mark.slow
def test_device_detector_endpoint_parity():
    """The CCL detector must localize endpoints, not just support lines
    (the round-1 Hough formulation had ~0.48 fused AUC from bad spans)."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    rng = np.random.default_rng(3)
    scene = synth.make_scene(rng, lines_per_vp=25, outliers=5)
    img = render_scene_image(scene, size=640, rng=rng).astype(np.float32)
    seg, mask = detect_segments_device(jnp.asarray(img), max_segments=512)
    det = np.asarray(seg)[np.asarray(mask)]
    s = 320.0

    def match_err(ts):
        d1 = (np.linalg.norm(det[:, :2] - ts[:2], axis=1)
              + np.linalg.norm(det[:, 2:] - ts[2:], axis=1))
        d2 = (np.linalg.norm(det[:, :2] - ts[2:], axis=1)
              + np.linalg.norm(det[:, 2:] - ts[:2], axis=1))
        return np.minimum(d1, d2).min() / 2

    errs = np.array([match_err(ts) for ts in scene.segments]) * s
    assert np.median(errs) < 3.0, np.median(errs)
    assert (errs < 5.0).mean() > 0.5


def _detector_edge_graph(seed: int, size: int):
    """Active mask, directions, and edge masks of a rendered scene."""
    import math as _math

    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops import lines_device as ld

    rng = np.random.default_rng(seed)
    scene = synth.make_scene(rng, lines_per_vp=25, outliers=8)
    img = render_scene_image(scene, size=size, rng=rng).astype(np.float32)
    im = ld._gaussian_blur(jnp.asarray(img), 1.0)
    com1 = im[1:, 1:] - im[:-1, :-1]
    com2 = im[:-1, 1:] - im[1:, :-1]
    gx, gy = 0.5 * (com1 + com2), 0.5 * (com1 - com2)
    mag = jnp.sqrt(gx * gx + gy * gy)
    tol = _math.radians(ld.TOL_DEG)
    active = mag > ld.QUANT / _math.sin(tol)
    inv = jnp.where(mag > 0, 1.0 / jnp.maximum(mag, 1e-12), 0.0)
    return active, gx * inv, -gy * inv, _math.cos(tol)


def test_raster_ccl_reaches_fixpoint():
    """After the default pass count, one more neighbour-min round over the
    edge graph must be a no-op (the labels are a CCL fixpoint) — checked
    across several rendered seeds and image sizes (the raster passes are
    provably exact only for digital straight lines; these scenes include
    noise-induced zigzag components)."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops import lines_device as ld

    for seed, size in ((0, 320), (7, 320), (3, 256), (11, 384), (23, 200)):
        active, ux, uy, cos_tol = _detector_edge_graph(seed, size)
        lab = ld._connected_components(active, ux, uy, cos_tol, passes=8)
        resid = int(ld.ccl_fixpoint_residual(active, ux, uy, cos_tol, lab))
        assert resid == 0, (seed, size, resid)


def test_detector_check_fixpoint_flag_clean():
    """check_fixpoint=True must not alter the output when the pass count
    suffices (the NaN poison stays dormant)."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    rng = np.random.default_rng(2)
    scene = synth.make_scene(rng, lines_per_vp=20, outliers=5)
    img = jnp.asarray(render_scene_image(scene, size=320, rng=rng)
                      .astype(np.float32))
    seg0, m0 = detect_segments_device(img, max_segments=256)
    seg1, m1 = detect_segments_device(img, max_segments=256,
                                      check_fixpoint=True)
    np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
    np.testing.assert_array_equal(np.asarray(seg0), np.asarray(seg1))
    assert np.isfinite(np.asarray(seg1)).all()


def test_detector_global_selection_matches_row():
    """selection="global" must reproduce the per-row result BIT-EXACTLY
    whenever both budgets keep every run (synthetic scenes): the
    grouping sort orders records canonically by (root, run position),
    so identical record SETS give identical f32 associations regardless
    of the selection strategy."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    for seed in range(3):
        rng = np.random.default_rng(seed)
        scene = synth.make_scene(rng, lines_per_vp=25, outliers=8)
        img = jnp.asarray(render_scene_image(scene, size=320, rng=rng)
                          .astype(np.float32))
        seg0, m0 = detect_segments_device(img, max_segments=256)
        seg1, m1 = detect_segments_device(img, max_segments=256,
                                          selection="global")
        np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
        np.testing.assert_array_equal(np.asarray(seg0), np.asarray(seg1))


def test_global_prefilter_equivalence():
    """The global selection's two-stage top-k (per-row top-3w/10
    prefilter, then the flat top-max_records — the production path; it
    shrinks the ~400k-element top_k sort ~4x) must be
    BIT-IDENTICAL to the one-stage flat top_k (global_prefilter=0, the
    oracle) whenever no row holds more than 3w/10 nonzero-mass runs.
    Measured densities: synthetic scenes max 56 runs/row, the
    reference's real photos max 152 — both under the 640 px cap of 191,
    so the candidate set (and with the canonical (root, pos) grouping
    sort, every downstream f32 bit) is unchanged on every available
    input. A cap of 1 must change the result (knob is live)."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    for seed in range(3):
        rng = np.random.default_rng(seed)
        scene = synth.make_scene(rng, lines_per_vp=30, outliers=10)
        img = jnp.asarray(render_scene_image(scene, size=320, rng=rng)
                          .astype(np.float32))
        seg0, m0 = detect_segments_device(img, max_segments=256,
                                          selection="global",
                                          global_prefilter=0)
        seg1, m1 = detect_segments_device(img, max_segments=256,
                                          selection="global")
        np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
        np.testing.assert_array_equal(np.asarray(seg0), np.asarray(seg1))
    # a degenerate cap must actually bind (prove the knob reaches the code)
    seg2, m2 = detect_segments_device(img, max_segments=256,
                                      selection="global",
                                      global_prefilter=1)
    assert int(np.sum(np.asarray(m2))) < int(np.sum(np.asarray(m1)))


def test_global_topk_approx_matches_exact_on_cpu():
    """topk_impl='approx' routes the global selection through
    jax.lax.approx_max_k, which XLA lowers to the exact top-k (recall
    1.0) on the CPU and the GPU, so the approx path must be
    BIT-IDENTICAL to the exact one — this guards the wiring (flat
    positions taken directly from the approx indices, rec_ok masking,
    no prefilter). chip_smoke.py checks the same on the card."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    for seed in range(3):
        rng = np.random.default_rng(seed)
        scene = synth.make_scene(rng, lines_per_vp=30, outliers=10)
        img = jnp.asarray(render_scene_image(scene, size=320, rng=rng)
                          .astype(np.float32))
        seg0, m0 = detect_segments_device(img, max_segments=256,
                                          selection="global")
        seg1, m1 = detect_segments_device(img, max_segments=256,
                                          selection="global",
                                          topk_impl="approx")
        np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
        np.testing.assert_array_equal(np.asarray(seg0), np.asarray(seg1))
    with pytest.raises(ValueError):
        detect_segments_device(img, max_segments=256, selection="global",
                               topk_impl="sloppy")


def test_coord_affine_equivalence():
    """The record fetch's coord_affine fast path (5-channel stack +
    bitcast root + per-record affine recompute of the coordinate
    channels — the production path) must be BIT-IDENTICAL to the pure
    7-channel gather formulation (coord_affine=None, the oracle) on
    every output slot, for both selection modes: the recompute replays
    the grid construction's exact f32 op sequence on the same values."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops import lines_device as ld

    for seed, selection in ((0, "row"), (1, "global"), (2, "global")):
        rng = np.random.default_rng(seed)
        scene = synth.make_scene(rng, lines_per_vp=30, outliers=10)
        img = jnp.asarray(render_scene_image(scene, size=320, rng=rng)
                          .astype(np.float32))
        h, w = img.shape
        blurred = ld._gaussian_blur(img, 1.0)
        com1 = blurred[1:, 1:] - blurred[:-1, :-1]
        com2 = blurred[:-1, 1:] - blurred[1:, :-1]
        gx, gy = 0.5 * (com1 + com2), 0.5 * (com1 - com2)
        mag = jnp.sqrt(gx * gx + gy * gy)
        tol = np.radians(ld.TOL_DEG)
        active = mag > ld.QUANT / np.sin(tol)
        inv = jnp.where(mag > 0, 1.0 / jnp.maximum(mag, 1e-12), 0.0)
        root = ld._connected_components(active, gx * inv, -gy * inv,
                                        float(np.cos(tol)), 8)
        hi, wi = h - 1, w - 1
        s = max(h, w) / 2.0
        ys_i, xs_i = jnp.meshgrid(jnp.arange(hi, dtype=jnp.float32),
                                  jnp.arange(wi, dtype=jnp.float32),
                                  indexing="ij")
        xn2 = ((xs_i + 0.5) - w / 2.0) / s
        yn2 = -((ys_i + 0.5) - h / 2.0) / s
        wgt = jnp.where(active, mag / 255.0, 0.0).reshape(-1)
        kw = dict(runs_per_row=64, selection=selection, max_records=8192)
        st_fast = ld._component_stats(root, wgt, xn2, yn2, 256, (hi, wi),
                                      coord_affine=(float(w), float(h), s),
                                      **kw)
        st_ref = ld._component_stats(root, wgt, xn2, yn2, 256, (hi, wi),
                                     coord_affine=None, **kw)
        for k in st_ref:
            np.testing.assert_array_equal(np.asarray(st_ref[k]),
                                          np.asarray(st_fast[k]), err_msg=k)


def test_detector_runs_per_row_tunable():
    """A generous runs_per_row must reproduce the default result (the
    default budget is already exact on these scenes), proving the plumb-
    through; the parameter exists so dense-scene users can raise it."""
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    rng = np.random.default_rng(4)
    scene = synth.make_scene(rng, lines_per_vp=20, outliers=5)
    img = jnp.asarray(render_scene_image(scene, size=320, rng=rng)
                      .astype(np.float32))
    seg0, m0 = detect_segments_device(img, max_segments=256)
    seg1, m1 = detect_segments_device(img, max_segments=256,
                                      runs_per_row=160)
    np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
    # canonical (root, position) grouping order: same record set ->
    # bit-identical outputs regardless of the budget
    np.testing.assert_array_equal(np.asarray(seg0), np.asarray(seg1))


@pytest.mark.slow
def test_raster_ccl_matches_bfs_oracle():
    """The gather-free raster CCL must produce the exact min-label
    connected components (python BFS oracle) on a rendered scene.  NB the
    pointer-jumping formulation it replaced does NOT pass this — it keeps
    a few dozen unconverged pixels even at 2x log2(HW) rounds."""
    from collections import deque

    from vanishing_points_2017_tpu.ops import lines_device as ld

    active, ux, uy, cos_tol = _detector_edge_graph(0, 256)
    h, w = active.shape
    em = {k: np.asarray(v)
          for k, v in ld._edge_masks(active, ux, uy, cos_tol).items()}

    out = np.arange(h * w).reshape(h, w)
    visited = np.zeros((h, w), bool)
    for y in range(h):
        for x in range(w):
            if visited[y, x]:
                continue
            comp = [(y, x)]
            visited[y, x] = True
            q = deque([(y, x)])
            while q:
                cy, cx = q.popleft()
                for (dy, dx), mm in em.items():
                    ny, nx = cy + dy, cx + dx
                    if (0 <= ny < h and 0 <= nx < w and mm[cy, cx]
                            and not visited[ny, nx]):
                        visited[ny, nx] = True
                        comp.append((ny, nx))
                        q.append((ny, nx))
            ml = min(cy * w + cx for cy, cx in comp)
            for cy, cx in comp:
                out[cy, cx] = ml

    raster = np.asarray(ld._connected_components(active, ux, uy,
                                                 cos_tol, passes=8))
    np.testing.assert_array_equal(raster, out.reshape(-1))


def test_device_detector_rejects_noise():
    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops.lines_device import (
        detect_segments_device)

    rng = np.random.default_rng(0)
    img = np.clip(rng.normal(128, 3.0, (320, 320)), 0, 255).astype(np.float32)
    _, mask = detect_segments_device(jnp.asarray(img), max_segments=256)
    assert np.asarray(mask).sum() == 0


def test_select_bucket():
    from vanishing_points_2017_tpu.pipeline import select_bucket
    assert select_bucket(10) == 512
    assert select_bucket(512) == 512
    assert select_bucket(513) == 1024
    assert select_bucket(2049) == 2048  # capped at the largest


def test_pad_lines_truncation_warns(caplog):
    import logging
    seg = np.zeros((600, 4), np.float32)
    seg[:, 2] = np.linspace(0.1, 0.9, 600)
    with caplog.at_level(logging.WARNING, logger="vp_tpu"):
        l, lp, m = pad_lines(seg, 512)
    assert m.sum() == 512
    assert any("truncating" in r.getMessage() for r in caplog.records)


@pytest.mark.slow
def test_process_batch_mixed_buckets():
    import jax
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig

    cfg = PipelineConfig(n_pad=64, buckets=(64, 128))
    pipe = Pipeline(cfg=cfg, rng_seed=0)
    rng = np.random.default_rng(1)
    sc1 = synth.make_scene(rng, lines_per_vp=8, outliers=2)     # < 64
    sc2 = synth.make_scene(rng, lines_per_vp=30, outliers=10)   # > 64
    b1 = dict(zip(("l", "lp", "lmask"), pad_lines(sc1.segments, 64)))
    b2 = dict(zip(("l", "lp", "lmask"), pad_lines(sc2.segments, 128)))
    out = pipe.process_batch([b1, b2])
    assert np.asarray(out["hp1"]).shape == (2, 3)
    assert np.isfinite(np.asarray(out["hp1"])).all()


@pytest.mark.slow
def test_component_stats_match_numpy_oracle():
    """Record-based component selection/moments/extremal projections must
    match an exact per-pixel numpy group-by for every component that can
    pass the min_count gate (tiny 3-5 px components may diverge in
    direction from f32 covariance cancellation; they are gated out)."""
    import collections
    import math as _math

    import jax.numpy as jnp
    from vanishing_points_2017_tpu.ops import lines_device as ld

    active, ux, uy, cos_tol = _detector_edge_graph(0, 320)
    hh, ww = active.shape
    root = ld._connected_components(active, ux, uy, cos_tol, 8)
    # reconstruct the detector's pixel tables
    h, w = hh + 1, ww + 1
    s = max(h, w) / 2.0
    ys_i, xs_i = np.meshgrid(np.arange(hh, dtype=np.float32),
                             np.arange(ww, dtype=np.float32), indexing="ij")
    xn2 = ((xs_i + 0.5) - w / 2.0) / s
    yn2 = -((ys_i + 0.5) - h / 2.0) / s
    # mirror the magnitude used for weights
    mag = np.hypot(np.asarray(ux), np.asarray(uy))  # unit where active
    wgt = np.where(np.asarray(active), 0.3 + 0.7 * mag, 0.0).reshape(-1)

    S = 256
    st = ld._component_stats(jnp.asarray(root), jnp.asarray(wgt),
                             jnp.asarray(xn2), jnp.asarray(yn2), S,
                             (hh, ww))
    st = {k: np.asarray(v) for k, v in st.items()}

    r = np.asarray(root)
    x, y = xn2.reshape(-1), yn2.reshape(-1)
    agg = collections.defaultdict(lambda: np.zeros(7))
    members = collections.defaultdict(list)
    for i in range(r.size):
        if wgt[i] > 0:
            agg[r[i]] += np.array([wgt[i], wgt[i] * x[i], wgt[i] * y[i],
                                   wgt[i] * x[i] * x[i],
                                   wgt[i] * x[i] * y[i],
                                   wgt[i] * y[i] * y[i], 1.0])
            members[r[i]].append(i)

    oracle_top = set(k for k, _ in sorted(
        agg.items(), key=lambda kv: -kv[1][0])[:S])
    got = set(st["root"][st["valid"]].tolist())
    assert got == oracle_top

    checked = 0
    for j in range(int(st["valid"].sum())):
        a = agg[int(st["root"][j])]
        if a[6] < 15:
            continue
        sw = a[0]
        assert abs(sw - st["mass"][j]) / sw < 1e-5
        assert a[6] == st["cnt"][j]
        cxo, cyo = a[1] / sw, a[2] / sw
        assert abs(cxo - st["cx"][j]) < 1e-5
        vxx = a[3] / sw - cxo * cxo
        vxy = a[4] / sw - cxo * cyo
        vyy = a[5] / sw - cyo * cyo
        lam = 0.5 * (vxx + vyy) + _math.sqrt(max(
            0.25 * (vxx + vyy) ** 2 - (vxx * vyy - vxy * vxy), 0))
        evec = (np.array([vxy, lam - vxx]) if abs(vxy) > 1e-16
                else np.array([1.0, 0.0]))
        evec = evec / np.linalg.norm(evec)
        assert abs(evec @ np.array([st["ddx"][j], st["ddy"][j]])) > 1 - 1e-4
        mem = members[int(st["root"][j])]
        t = evec[0] * x[mem] + evec[1] * y[mem]
        assert abs((t.max() - t.min())
                   - (st["tmax"][j] - st["tmin"][j])) < 1e-4
        checked += 1
    assert checked > 50
