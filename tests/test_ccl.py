"""Raster CCL dispatch: the CUDA kernel (ops/ccl.cu via ops/ccl_gpu.py) on
the GPU, the XLA scan (lines_device._connected_components) elsewhere.

The kernel has no interpret mode. Here the CPU tests reach what surrounds
it: the mask packing, the platform dispatch as lowered for each platform,
the batched call's shapes and the input checks. The ``gpu`` test compares
the kernel's labels with the scan bit for bit on the card
(``chip_smoke.py`` runs it)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vanishing_points_2017_tpu.models import synth
from vanishing_points_2017_tpu.data.datasets import render_scene_image
from vanishing_points_2017_tpu.ops import ccl_gpu
from vanishing_points_2017_tpu.ops import lines_device as ld

COS_TOL = math.cos(math.radians(ld.TOL_DEG))


def _fronts(sizes, seed=0):
    """Stacked (active, ux, uy) of rendered scenes, one per size (H, W)."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        scene = synth.make_scene(rng, lines_per_vp=12, outliers=4)
        img = render_scene_image(scene, size=max(h, w), rng=rng)[:h, :w]
        out.append(ld.level_lines(jnp.asarray(img))[:3])
    return [jnp.stack(c) for c in zip(*out)]


@pytest.fixture
def gpu_device():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run on the card by chip_smoke.py")


def test_ccl_dispatch_vmap_cpu_path():
    """The dispatch under jax.vmap on CPU must equal per-image scan
    results."""
    a, x, y = _fronts([(128, 128)] * 2)
    got = jax.vmap(lambda aa, xx, yy: ld.connected_components(
        aa, xx, yy, COS_TOL, 4))(a, x, y)
    for i in range(2):
        ref = ld._connected_components(a[i], x[i], y[i], COS_TOL, 4)
        assert np.array_equal(np.asarray(got[i]), np.asarray(ref))


@pytest.mark.parametrize("platform,kernel", [("cuda", True), ("cpu", False)])
def test_ccl_dispatch_lowers_per_platform(platform, kernel):
    """One traced program: the CUDA lowering holds the one batched kernel
    call and no row scan; every other lowering holds the scan."""
    a, x, y = _fronts([(64, 80)] * 3)
    fn = jax.jit(jax.vmap(lambda aa, xx, yy: ld.connected_components(
        aa, xx, yy, COS_TOL, 8)))
    text = fn.trace(a, x, y).lower(lowering_platforms=(platform,)).as_text()
    calls = [ln for ln in text.splitlines() if ccl_gpu.TARGET in ln]
    if kernel:
        assert len(calls) == 1
        assert "tensor<3x63x79xui8>" in calls[0]     # batch folded in
        assert "tensor<3x63x79xi32>" in calls[0]
        assert "pairs = 4" in calls[0]
        assert "stablehlo.while" not in text
    else:
        assert not calls
        assert "stablehlo.while" in text


def test_pack_edge_masks_bits():
    """Bit k of the packed plane is the mask of direction _BIT^-1[k]."""
    a, x, y = _fronts([(96, 96)])
    masks = ld._edge_masks(a[0], x[0], y[0], COS_TOL)
    packed = np.asarray(ccl_gpu.pack_edge_masks(masks))
    assert packed.dtype == np.uint8
    for key, bit in ccl_gpu._BIT.items():
        np.testing.assert_array_equal((packed >> bit) & 1,
                                      np.asarray(masks[key]).astype(np.uint8))
    # the border bits the kernel also clears are never set
    assert not ((packed[0] >> ccl_gpu._BIT[(-1, 0)]) & 1).any()
    assert not ((packed[:, 0] >> ccl_gpu._BIT[(0, -1)]) & 1).any()


def test_raster_ccl_checks_input():
    with pytest.raises(ValueError, match="uint8"):
        ccl_gpu.raster_ccl(jnp.zeros((4, 4), jnp.int32), 8)
    with pytest.raises(ValueError, match="width"):
        ccl_gpu.raster_ccl(
            jnp.zeros((2, ccl_gpu.MAX_WIDTH + 1), jnp.uint8), 8)
    out = jax.eval_shape(lambda m: ccl_gpu.raster_ccl(m, 8),
                         jax.ShapeDtypeStruct((2, 5, 7), jnp.uint8))
    assert out.shape == (2, 5, 7) and out.dtype == jnp.int32


def test_kernel_not_built_without_gpu(monkeypatch):
    """Tracing the CUDA branch on a machine with no GPU must neither call
    nvcc nor register anything."""
    monkeypatch.setattr(ccl_gpu, "_registered", False)
    monkeypatch.setattr(ccl_gpu, "_gpu_present", lambda: False)
    monkeypatch.setattr(ccl_gpu, "_build", lambda: pytest.fail("built"))
    ccl_gpu.ensure_registered()
    assert ccl_gpu._registered is False


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(200, 256), (300, 639), (120, 1000)])
def test_ccl_kernel_matches_scan_on_gpu(gpu_device, h, w):
    """Chunk sizes 1, 3 and 4 pixels per thread; labels bit-identical to
    the scan run on the same card."""
    with jax.default_device(gpu_device):
        a, x, y = _fronts([(h, w)] * 3, seed=h)
        got = jax.jit(jax.vmap(lambda aa, xx, yy: ld.connected_components(
            aa, xx, yy, COS_TOL, 8)))(a, x, y)
        ref = jax.jit(jax.vmap(lambda aa, xx, yy: ld._connected_components(
            aa, xx, yy, COS_TOL, 8)))(a, x, y)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
