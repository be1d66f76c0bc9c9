import pytest
import numpy as np

from vanishing_points_2017_tpu.utils import StageTimer, get_logger, trace
from vanishing_points_2017_tpu import weights as wload


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    with t.span("b"):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2 and rep["b"]["count"] == 1
    assert "stage timings" in t.pretty()


def test_trace_noop():
    with trace(None):
        x = 1
    assert x == 1


def test_logger_singleton():
    assert get_logger() is get_logger()


@pytest.mark.slow
def test_params_npz_roundtrip(tmp_path):
    import jax
    from vanishing_points_2017_tpu.models import cnn

    params = cnn.init_params(jax.random.PRNGKey(0), input_size=120)
    path = str(tmp_path / "w.npz")
    wload.params_to_npz(params, path)
    back = wload.params_from_npz(path)
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(np.asarray(params[layer][k]),
                                          np.asarray(back[layer][k]))


def test_artifact_fingerprint_tracks_content(tmp_path):
    p = tmp_path / "w.npz"
    p.write_bytes(b"weights-v1")
    f1 = wload.artifact_fingerprint(str(p))
    assert f1 != "none" and len(f1) == 16
    assert wload.artifact_fingerprint(str(p)) == f1  # cached, stable
    import os
    p.write_bytes(b"weights-v2")
    os.utime(p, ns=(1, 1))  # force distinct mtime even on coarse clocks
    assert wload.artifact_fingerprint(str(p)) != f1
    assert wload.artifact_fingerprint(str(tmp_path / "missing.npz")) == "none"
    assert wload.artifact_fingerprint(None) == "none"


def test_default_weights_path_shadowing(tmp_path, monkeypatch, capsys):
    """A stale gitignored dense artifact must NOT shadow the versioned
    compact weights; a FRESHER dense retrain wins with a notice. The
    arbitration notice goes to STDERR unconditionally — even warn=False
    callers (bench.py) must reveal which artifact won, since it changes
    every AUC/bench number (advisor r4 #1) — and is deduped per process."""
    import os
    assets = tmp_path / "assets"
    assets.mkdir()
    compact = assets / "weights_compact.npz"
    dense = assets / "weights.npz"
    monkeypatch.setattr(wload, "_repo_root", lambda: str(tmp_path))
    wload._arbitration_notified.clear()

    # only compact -> compact
    compact.write_bytes(b"compact")
    assert wload.default_weights_path(warn=False) == str(compact)

    # stale dense (older mtime) -> still compact, with a notice EVEN at
    # warn=False (the silent-shadowing scenario the advisor flagged)
    dense.write_bytes(b"dense-old")
    os.utime(dense, ns=(10, 10))
    os.utime(compact, ns=(20, 20))
    assert wload.default_weights_path(warn=False) == str(compact)
    assert "IGNORING stale dense" in capsys.readouterr().err

    # deduped: the same decision does not spam a second notice
    assert wload.default_weights_path() == str(compact)
    assert "IGNORING" not in capsys.readouterr().err

    # fresher dense retrain -> dense, with a notice
    os.utime(dense, ns=(30, 30))
    assert wload.default_weights_path(warn=False) == str(dense)
    assert "dense retrain" in capsys.readouterr().err

    # only dense -> dense
    compact.unlink()
    assert wload.default_weights_path(warn=False) == str(dense)
    wload._arbitration_notified.clear()


def test_weights_identity_resolves_default(tmp_path, monkeypatch):
    monkeypatch.setattr(wload, "_repo_root", lambda: str(tmp_path))
    assert wload.weights_identity() == "none"  # no assets at all
    assets = tmp_path / "assets"
    assets.mkdir()
    (assets / "weights_compact.npz").write_bytes(b"compact")
    fp = wload.weights_identity()
    assert fp == wload.artifact_fingerprint(str(assets / "weights_compact.npz"))


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX keeps its cache there and
    enable() sets no other directory."""
    import jax
    from vanishing_points_2017_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """No env: the fixed <checkout>/.jax_cache, which .gitignore lists."""
    import os

    import jax
    from vanishing_points_2017_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("name", ["device_pipeline", "device_pipeline_batch",
                                  "device_pipeline_full"])
def test_entry_points_compile_with_shipped_picks(name):
    """The pipeline's entry points compile with COMPILER_OPTIONS (the
    shipped autotuning picks), so the production program's numerics do not
    depend on which process compiled it."""
    from vanishing_points_2017_tpu import pipeline
    from vanishing_points_2017_tpu.utils.compile_cache import (
        COMPILER_OPTIONS)

    fn = getattr(pipeline, name)
    assert dict(fn._jit_info.compiler_options_kvs) == COMPILER_OPTIONS


def test_shipped_picks_file():
    """The picks file is in the checkout and holds H100 results in XLA's
    text format."""
    from vanishing_points_2017_tpu.utils.compile_cache import (
        AUTOTUNE_PICKS, COMPILER_OPTIONS)

    assert COMPILER_OPTIONS == {
        "xla_gpu_load_autotune_results_from": AUTOTUNE_PICKS}
    assert AUTOTUNE_PICKS.endswith(".txt")  # XLA reads .txt as text
    with open(AUTOTUNE_PICKS) as fh:
        text = fh.read()
    assert text.startswith("version:")
    assert "Cores: 132" in text and "results {" in text

