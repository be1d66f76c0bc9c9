"""bench.py and chip_smoke.py: refuse to report without a GPU, and the
peak table behind the utilization figure."""

import importlib.util
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_cpu_device(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""      # no result line of any kind
    assert "no GPU" in proc.stderr


def test_peak_known_device_kind():
    peak, note = _load_bench().peak_flops("NVIDIA H100 80GB HBM3")
    assert peak == 989e12 and "bf16" in note


def test_peak_unknown_device_kind_is_null():
    peak, note = _load_bench().peak_flops("NVIDIA A100-SXM4-80GB")
    assert peak is None and "A100" in note


@pytest.mark.parametrize("kind, extra", [
    ("NVIDIA H100 80GB HBM3", None),
    ("NVIDIA A100-SXM4-80GB", "A100"),
])
def test_mfu_null_reason(kind, extra):
    note = _load_bench().mfu_note(kind)
    assert note.startswith("no FLOP count of the GPU program")
    assert (extra in note) if extra else ";" not in note


def test_trace_summary_reduces_gpu_streams(tmp_path):
    """Busy time is the union of the GPU streams' events (overlaps count
    once), the window runs from the first start to the last end, and host
    planes are ignored."""
    from jax.profiler import ProfileData

    proto = """
    planes {
      id: 1 name: "/device:GPU:0"
      lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
        events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
        events { metadata_id: 2 offset_ps: 1000000 duration_ps: 2000000 }
        events { metadata_id: 1 offset_ps: 6000000 duration_ps: 2000000 } }
      lines { id: 2 name: "Stream #31(Compute)" timestamp_ns: 1000
        events { metadata_id: 2 offset_ps: 2000000 duration_ps: 2000000 } }
      event_metadata { key: 1 value { id: 1 name: "gemm" } }
      event_metadata { key: 2 value { id: 2 name: "ccl_kernel" } }
    }
    planes { id: 2 name: "/host:CPU"
      lines { id: 1 name: "python" timestamp_ns: 0
        events { metadata_id: 1 offset_ps: 0 duration_ps: 99000000 } }
      event_metadata { key: 1 value { id: 1 name: "host" } } }
    """
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    (d / "h.xplane.pb").write_bytes(
        ProfileData.text_proto_to_serialized_xspace(proto))
    s = _load_bench().trace_summary(str(tmp_path), iters=2)
    # events (us): [1,3] [2,4] [3,5] [7,9] -> busy 6 us of a 8 us window
    assert s["window_ms"] == pytest.approx(0.008)
    assert s["busy_ms"] == pytest.approx(0.006)
    assert s["idle_share"] == pytest.approx(0.25)
    top = {k["name"]: k for k in s["top_kernels_per_iter"]}
    assert top["gemm"]["ms"] == pytest.approx(0.002)
    assert top["ccl_kernel"]["count"] == 1.0
    assert "host" not in top
