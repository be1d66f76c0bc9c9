"""EM knife-edge perturbation regression.

Pins the horizon's robustness to f32-level segment perturbations at the
rate measured in round 5 (scripts/perturb_knife_edge.py; table in
BASELINE.md round-5 section). The round-4 side-gate waiver fixed the
ihme symptom; THIS is the regression that detects the underlying
triplet-flip sensitivity creeping back — any detector or EM change that
makes the horizon flip under sub-pixel endpoint noise more often than
the pinned rate fails here before it ships.

Protocol (shared with the script): detect segments on device at
production defaults, then run K jittered copies (Gaussian endpoint
noise sigma 0.5 px at 640, 2% dropout) through the fused EM + horizon
program and count flips (err > 0.10 vs the reference figure / exact
GT). The jitter seed is fixed — rates are deterministic on CPU.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "scripts"))

REF_EXAMPLES = "/root/reference/assets/examples"

# (photo, ref frac_left, ref frac_right, max flips of K=8)
# Pinned at the round-5 measured values (deterministic on CPU for the
# fixed per-probe seed; BASELINE.md knife-edge table). ihme sits near
# the triplet boundary (base margin 0.034) and is ALLOWED its measured
# flip budget. lichthof's 6/8 is a different phenomenon: its jittered
# errors are GATE-MARGINAL drift (0.11-0.24, vs its 0.009 base), not
# catastrophic triplet flips — the pin still catches a regression that
# pushes it to 7-8/8 or breaks the base.
PHOTO_PINS = [
    ("ihme_zentrum.jpg", 0.7701, 0.7743, 2),
    ("uni_hannover.jpg", 0.7458, 0.7336, 1),
    ("uni_hannover_lichthof.jpg", 0.3889, 0.3877, 6),
]
K = 8
SIGMA_PX = 0.5
DROP = 0.02


def _pipe():
    from vanishing_points_2017_tpu.pipeline import Pipeline, PipelineConfig
    from vanishing_points_2017_tpu import weights as wload

    params, mean = wload.load_params_and_mean(warn=False)
    return Pipeline(params=params, mean=mean, cfg=PipelineConfig())


def _flips(pipe, lp0, m0, err_fn, seed=11):
    from perturb_knife_edge import jitter_population, run_populations

    rng = np.random.default_rng(seed)
    sigma_norm = SIGMA_PX * 2.0 / 640
    lps, masks = [lp0], [m0]
    for _ in range(K):
        lp2, m2 = jitter_population(rng, lp0, m0, sigma_norm, DROP)
        lps.append(lp2)
        masks.append(m2)
    res = run_populations(pipe, pipe.cfg, lps, masks)
    errs = err_fn(res)
    return errs[0], int((errs[1:] > 0.10).sum()), res


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(REF_EXAMPLES),
                    reason="reference example photos not available")
def test_real_photo_flip_rate_pinned():
    from perturb_knife_edge import detect_device, photo_errs

    pipe = _pipe()
    for name, rl, rr, max_flips in PHOTO_PINS:
        host = pipe.ingest_image(os.path.join(REF_EXAMPLES, name),
                                 target_size=640)
        lp0, m0 = detect_device(pipe, pipe.cfg, host["gray"])
        base_err, flips, _res = _flips(
            pipe, lp0, m0,
            lambda res, shape=host["image_shape"], a=rl, b=rr:
            photo_errs(res, shape, a, b))
        assert base_err <= 0.10, (name, base_err)
        assert flips <= max_flips, (name, flips, max_flips)


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(REF_EXAMPLES),
                    reason="reference example photos not available")
def test_consensus_flip_rate_pinned():
    """The dropout-consensus horizon (em/consensus.py, K=8) must stay at
    or below ITS measured in-env flip rates — which are <= the single-EM
    pins on every probe (measured 2026-08-20 under the conftest flags:
    ihme 2->1, uni_hannover 1->0, lichthof 6->6; protocol-level table in
    BASELINE.md's round-5 consensus section)."""
    import dataclasses

    from perturb_knife_edge import detect_device, photo_errs
    from vanishing_points_2017_tpu.pipeline import Pipeline

    CONSENSUS_PINS = [
        ("ihme_zentrum.jpg", 0.7701, 0.7743, 1),
        ("uni_hannover.jpg", 0.7458, 0.7336, 0),
        ("uni_hannover_lichthof.jpg", 0.3889, 0.3877, 6),
    ]
    pipe = _pipe()
    cfg_c = dataclasses.replace(pipe.cfg, horizon_consensus=8)
    pipe_c = Pipeline(params=pipe.params, mean=np.asarray(pipe.mean),
                      cfg=cfg_c)
    for name, rl, rr, max_flips in CONSENSUS_PINS:
        host = pipe.ingest_image(os.path.join(REF_EXAMPLES, name),
                                 target_size=640)
        # detection at production defaults (consensus does not change it)
        lp0, m0 = detect_device(pipe, pipe.cfg, host["gray"])
        base_err, flips, _res = _flips(
            pipe_c, lp0, m0,
            lambda res, shape=host["image_shape"], a=rl, b=rr:
            photo_errs(res, shape, a, b))
        assert base_err <= 0.10, (name, base_err)
        assert flips <= max_flips, (name, flips, max_flips)


@pytest.mark.slow
def test_synthetic_knife_edge_scenes_flip_rate():
    """The lowest-margin scenes of the fixed 50-scene set (indices pinned
    from the round-5 measurement) must not flip more than measured."""
    from eval_device_detector import build_scene_set, scene_horizon_errors
    from perturb_knife_edge import detect_device

    # (scene index in the seed-7 pool of 50, max flips of K=8) — the five
    # lowest-margin scenes from the round-5 measurement, all solid at 0
    # flips; see BASELINE.md knife-edge table
    SCENE_PINS = [(12, 0), (15, 0), (27, 0), (31, 0), (38, 0)]

    pipe = _pipe()
    scenes, images = build_scene_set(50, size=640)
    for idx, max_flips in SCENE_PINS:
        scene, img = scenes[idx], images[idx]
        lp0, m0 = detect_device(pipe, pipe.cfg, img)

        def err_fn(res, scene=scene):
            return scene_horizon_errors(
                [scene] * res["hp1"].shape[0], res["hp1"], res["hp2"], 640)

        base_err, flips, _res = _flips(pipe, lp0, m0, err_fn)
        assert flips <= max_flips, (idx, flips, max_flips)
