"""GPU raster CCL: ``ccl.cu`` called through ``jax.ffi``.

The kernel computes exactly what ``lines_device._connected_components``
(the ``lax.scan`` over rows) computes, one block per image with the rows
as a loop inside the block; see the header of ``ccl.cu``. This module packs
the detector's eight directed edge masks into one uint8 bit plane, builds
the kernel with ``nvcc`` into ``_libccl.so`` beside its source at first use
(like ``lsd/``'s C++ build), registers it with XLA, and calls it.

The kernel has no interpret mode: the CPU tests reach the packing, the
shapes, the registration guard and the platform dispatch; the labels are
compared with the scan on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

TARGET = "vp_raster_ccl"

# bit index of each neighbour direction (dy, dx); must match ccl.cu
_BIT = {(-1, -1): 0, (-1, 0): 1, (-1, 1): 2, (0, -1): 3,
        (0, 1): 4, (1, -1): 5, (1, 0): 6, (1, 1): 7}
MAX_WIDTH = 2048  # ccl.cu: 256 threads x 8 pixels per thread

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ccl.cu")
_SO = os.path.join(_HERE, "_libccl.so")
_lock = threading.Lock()
_registered = False


def pack_edge_masks(masks: dict) -> jnp.ndarray:
    """``lines_device._edge_masks`` output -> (..., H, W) uint8 bit plane."""
    packed = None
    for key, bit in _BIT.items():
        plane = masks[key].astype(jnp.uint8) << bit
        packed = plane if packed is None else packed | plane
    return packed


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _build() -> None:
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), _SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{proc.stderr}")
    os.replace(tmp, _SO)  # atomic: a concurrent loader never sees half a file


def _gpu_present() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def ensure_registered() -> None:
    """Build (if stale) and register the kernel when a GPU backend exists.

    Called while tracing; on a machine without a GPU it does nothing, and
    the CUDA branch it belongs to is never lowered there."""
    global _registered
    with _lock:
        if _registered or not _gpu_present():
            return
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO)
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.VpRasterCcl),
                                    platform="CUDA")
        _registered = True


def raster_ccl(packed: jnp.ndarray, passes: int) -> jnp.ndarray:
    """(..., H, W) packed edge masks -> (..., H, W) int32 min labels.

    ``passes`` counts half passes like ``_connected_components``: it runs
    ``max(1, passes // 2)`` descending+ascending pairs. Batched under
    ``jax.vmap`` by folding the batch into the leading dimensions, which
    the kernel walks one block per image.
    """
    if packed.dtype != jnp.uint8 or packed.ndim < 2:
        raise ValueError(f"expected (..., H, W) uint8, got {packed.dtype}"
                         f"{packed.shape}")
    if packed.shape[-1] > MAX_WIDTH:
        raise ValueError(f"row width {packed.shape[-1]} > {MAX_WIDTH}")
    ensure_registered()
    call = jax.ffi.ffi_call(TARGET,
                            jax.ShapeDtypeStruct(packed.shape, jnp.int32),
                            vmap_method="broadcast_all")
    return call(packed, pairs=np.int32(max(1, passes // 2)))
