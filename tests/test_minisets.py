"""Real-dataset-format parity harness.

Miniature YUD / ECD / HLW datasets are materialised on disk in each
dataset's exact layout (minisets.py) and driven through the REAL adapters
and the full benchmark CLI. Fast tests assert the GT inversion is exact
(adapter output == known synthetic horizon); the slow test runs
``benchmark.py --yud/--ecd/--hlw`` end-to-end (JPEG decode, resize, LSD,
fused device stage, .mat/.csv GT parsing, AUC).
"""

import os
import sys

import numpy as np
import pytest

from vanishing_points_2017_tpu.data import datasets as dsets
from vanishing_points_2017_tpu.data import minisets


def _line_err(adapter_h, scene_h, w, h):
    return dsets.normalized_horizon_error(
        np.asarray(adapter_h, np.float64), np.asarray(scene_h, np.float64),
        width=w, height=h)


def test_mini_yud_gt_inversion(tmp_path):
    root = str(tmp_path / "yud")
    scenes = minisets.make_mini_yud(root, n_eval=2)
    records, start = dsets.yud_records(root)
    assert start == 25
    assert len(records) == 27
    for rec, scene in zip(records, scenes):
        assert rec.true_horizon is not None
        assert _line_err(rec.true_horizon, scene.horizon, 640, 480) < 1e-6


def test_mini_ecd_gt_inversion(tmp_path):
    root = str(tmp_path / "ecd")
    scenes = minisets.make_mini_ecd(root, n_eval=1)
    records, start = dsets.ecd_records(root)
    assert start == 25
    assert len(records) == 26
    for rec, scene in zip(records, scenes):
        assert _line_err(rec.true_horizon, scene.horizon, 1024, 768) < 1e-6


def test_mini_hlw_gt_inversion(tmp_path):
    root = str(tmp_path / "hlw")
    scenes = minisets.make_mini_hlw(root, n_eval=3)
    records, start = dsets.hlw_records(root)
    assert start == 0
    assert len(records) == 3
    for rec, scene in zip(records, scenes):
        assert _line_err(rec.true_horizon, scene.horizon, 900, 600) < 1e-6


def _run_benchmark(argv, capsys):
    import benchmark

    old = sys.argv
    sys.argv = ["benchmark.py"] + argv
    try:
        rc = benchmark.main()
    finally:
        sys.argv = old
    # NB: do not re-emit `out` to stdout here — capsys would capture it
    # again and the NEXT _run_benchmark call's output would accumulate
    # the previous legs' text (assertion messages carry `out` anyway)
    out = capsys.readouterr().out
    assert rc == 0, out
    auc_lines = [ln for ln in out.splitlines() if ln.startswith("AUC:")]
    assert auc_lines, out
    return float(auc_lines[-1].split()[-1]), out


def _seed_skip_results(result_dir, dataset_name, records, start,
                       key_suffix=""):
    """Write placeholder result entries for the protocol-skipped first 25
    images so the device stage only computes the evaluated tail. The eval
    loop never reads skipped entries; this only saves CI time (the REAL
    datasets have 100+ images, the minis exist to exercise the formats).

    Must compose the cache directory key and the weights-scoped result
    stage name exactly as benchmark.py does (benchmark.py:101-114), or
    the placeholders land in a directory/stage the driver never reads."""
    from vanishing_points_2017_tpu import weights as wload
    from vanishing_points_2017_tpu.data.cache import StageCache
    from vanishing_points_2017_tpu.pipeline import PipelineConfig

    cache = StageCache(os.path.join(result_dir, dataset_name),
                       PipelineConfig().cache_key() + key_suffix)
    for rec in records[:start]:
        cache.save(rec.name, "result_w" + wload.weights_identity()
                   + "_m" + wload.mean_identity(),
                   hp1=np.zeros(3), hp2=np.zeros(3))


@pytest.mark.slow
def test_benchmark_real_formats_end_to_end(tmp_path, capsys):
    from vanishing_points_2017_tpu import weights as wload

    trained = os.path.isfile(wload.default_weights_path())
    # with trained weights the pipeline recovers synthetic horizons at
    # AUC ~0.95+; with random init the EM still works off the top-100 prior
    # but much less reliably on 1-3 images
    threshold = 0.7 if trained else 0.2

    result_dir = str(tmp_path / "results")

    root = str(tmp_path / "yud")
    minisets.make_mini_yud(root, n_eval=2)
    recs, start = dsets.yud_records(root)
    _seed_skip_results(result_dir, "york", recs, start)
    auc, out = _run_benchmark(
        ["--yud", "--dataset_dir", root, "--result_dir", result_dir,
         "--run_cnn", "--batch", "2", "--no_weights_warn"], capsys)
    assert out.count("max_error:") == 2, out
    # the seeded placeholders must actually be FOUND by the driver (same
    # directory key + weights-scoped stage name), so the device stage
    # computed only the 2-image eval tail, not the 25 skipped images
    assert "device stage: 2 imgs" in out, out
    assert auc > threshold, (auc, out)

    root = str(tmp_path / "ecd")
    minisets.make_mini_ecd(root, n_eval=1)
    recs, start = dsets.ecd_records(root)
    _seed_skip_results(result_dir, "eurasian", recs, start)
    auc, out = _run_benchmark(
        ["--ecd", "--dataset_dir", root, "--result_dir", result_dir,
         "--run_cnn", "--batch", "2", "--no_weights_warn"], capsys)
    assert out.count("max_error:") == 1, out
    assert auc > threshold, (auc, out)

    root = str(tmp_path / "hlw")
    minisets.make_mini_hlw(root, n_eval=3)
    auc, out = _run_benchmark(
        ["--hlw", "--dataset_dir", root, "--result_dir", result_dir,
         "--run_cnn", "--batch", "2", "--no_weights_warn"], capsys)
    assert out.count("max_error:") == 3, out
    assert auc > threshold, (auc, out)


@pytest.mark.slow
def test_benchmark_device_detect_real_format(tmp_path, capsys):
    """--device_detect must execute the real-dataset-format path end to
    end (JPEG decode, on-device detection inside the fused program,
    .mat GT) and land in the same AUC regime as the host-LSD path."""
    from vanishing_points_2017_tpu import weights as wload

    trained = os.path.isfile(wload.default_weights_path())
    threshold = 0.7 if trained else 0.2

    result_dir = str(tmp_path / "results")
    root = str(tmp_path / "yud")
    minisets.make_mini_yud(root, n_eval=2)
    recs, start = dsets.yud_records(root)
    from vanishing_points_2017_tpu.pipeline import PipelineConfig
    _seed_skip_results(result_dir, "york", recs, start,
                       key_suffix="_devdet_"
                       + PipelineConfig().det_key())
    auc, out = _run_benchmark(
        ["--yud", "--dataset_dir", root, "--result_dir", result_dir,
         "--run_cnn", "--batch", "2", "--no_weights_warn",
         "--device_detect"], capsys)
    assert out.count("max_error:") == 2, out
    assert auc > threshold, (auc, out)


@pytest.mark.slow
def test_golden_auc_regression(tmp_path, capsys):
    """Committed golden-AUC gate: fixed-seed 8-image
    minisets per dataset format, pinned expected AUC. The paper's real
    YUD/ECD/HLW numbers remain environmentally blocked (datasets + paper
    not fetchable in this image; BASELINE.md); this pin gives the full
    driver path a NUMERIC regression gate instead of the loose >0.7
    threshold. Values measured on CPU with the shipped trained weights;
    +-0.02 absorbs cross-version numeric drift."""
    from vanishing_points_2017_tpu import weights as wload

    if not os.path.isfile(wload.default_weights_path()):
        pytest.skip("golden pins assume the shipped trained weights")

    result_dir = str(tmp_path / "results")
    golden = {"yud": 0.9750, "ecd": 0.9695, "hlw": 0.9461}

    root = str(tmp_path / "yud")
    minisets.make_mini_yud(root, n_eval=8)
    recs, start = dsets.yud_records(root)
    _seed_skip_results(result_dir, "york", recs, start)
    auc, out = _run_benchmark(
        ["--yud", "--dataset_dir", root, "--result_dir", result_dir,
         "--run_cnn", "--batch", "4", "--no_weights_warn"], capsys)
    assert abs(auc - golden["yud"]) < 0.02, (auc, out)

    root = str(tmp_path / "ecd")
    minisets.make_mini_ecd(root, n_eval=8)
    recs, start = dsets.ecd_records(root)
    _seed_skip_results(result_dir, "eurasian", recs, start)
    auc, out = _run_benchmark(
        ["--ecd", "--dataset_dir", root, "--result_dir", result_dir,
         "--run_cnn", "--batch", "4", "--no_weights_warn"], capsys)
    assert abs(auc - golden["ecd"]) < 0.02, (auc, out)

    root = str(tmp_path / "hlw")
    minisets.make_mini_hlw(root, n_eval=8)
    auc, out = _run_benchmark(
        ["--hlw", "--dataset_dir", root, "--result_dir", result_dir,
         "--run_cnn", "--batch", "4", "--no_weights_warn"], capsys)
    assert abs(auc - golden["hlw"]) < 0.02, (auc, out)
