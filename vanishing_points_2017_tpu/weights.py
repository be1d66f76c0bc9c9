"""Parameter/mean loading: npz checkpoints or Caffe artifacts.

The reference hard-codes ``cnn/weights.caffemodel`` + ``cnn/mean.binaryproto``
paths in ``config.py:7-8`` (both downloaded artifacts). Here weights come
from (in priority order): an explicit ``.npz``/``.caffemodel`` path, the
bundled ``assets/weights.npz`` if present, else freshly initialized params
(with a warning — AUC numbers are meaningless without trained weights).
"""

from __future__ import annotations

import functools
import hashlib
import os

import numpy as np


def params_to_npz(params, path: str, step: int | None = None,
                  dtype=None) -> None:
    """``dtype=np.float16`` halves the artifact (10 mantissa bits cover the
    trained weight range comfortably; loading upcasts to float32)."""
    flat = {}
    for layer, d in params.items():
        for k, v in d.items():
            v = np.asarray(v)
            if dtype is not None and v.dtype.kind == "f":
                v = v.astype(dtype)
            flat[f"{layer}/{k}"] = v
    if step is not None:
        flat["__step__"] = np.asarray(step)
    # uncompressed: trained float weights are incompressible and zlib on the
    # single host core stalls training for minutes per snapshot
    np.savez(path, **flat)


def params_from_npz(path: str, with_step: bool = False,
                    as_numpy: bool = False):
    """``as_numpy=True`` keeps the arrays on the host — required when the
    caller does host-side numpy work on them (e.g. the compression
    script's randomized SVD): with jax arrays on the device the first
    ``np.asarray(fc6)`` is a ~1 GB device-to-host copy."""
    import jax.numpy as jnp

    params: dict = {}
    step = 0
    with np.load(path) as z:
        for key in z.files:
            if key == "__step__":
                step = int(z[key])
                continue
            layer, k = key.split("/")
            v = z[key]
            if v.dtype.kind == "f":
                v = v.astype(np.float32)  # storage may be float16
            params.setdefault(layer, {})[k] = (
                v if as_numpy else jnp.asarray(v))
    return (params, step) if with_step else params


@functools.lru_cache(maxsize=32)
def _fingerprint_cached(path: str, size: int, mtime_ns: int) -> str:
    h = hashlib.blake2b(digest_size=8)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def artifact_fingerprint(path: str | None) -> str:
    """Short content hash of a weights/mean artifact file.

    Two runs with different weights must never be confused in the
    record or serve each other's caches: the fingerprint goes into the
    printed run header, ``bench.py``'s breakdown JSON and the
    ``StageCache`` config key (like the detector's ``det_key``). Cached
    per (path, size, mtime) so repeated calls don't rehash a ~GB dense
    artifact. Returns "none" for a missing/absent artifact (random
    init)."""
    if not path or not os.path.isfile(path):
        return "none"
    st = os.stat(path)
    return _fingerprint_cached(os.path.abspath(path), st.st_size,
                               st.st_mtime_ns)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# dense-vs-compact arbitration notices already emitted this process (the
# resolver runs several times per driver; the user needs the fact once)
_arbitration_notified: set = set()


def _notice(msg: str) -> None:
    """Arbitration notices go to stderr UNCONDITIONALLY (not gated on
    ``warn``): which artifact wins changes every AUC/bench number, so a
    bench header run with ``warn=False`` must still reveal the switch
    (advisor r4 #1)."""
    import sys

    if msg not in _arbitration_notified:
        _arbitration_notified.add(msg)
        print(msg, file=sys.stderr)


def default_weights_path(warn: bool = True) -> str:
    """The VERSIONED factorized float16 artifact
    (assets/weights_compact.npz, rank-256 fc6/fc7 via
    scripts/compress_weights.py) so a fresh clone runs at full quality
    with no retrain. Round 5 RATIFIED this artifact as the operating
    point: under the same-protocol sweep it is
    within 0.0003 of a fresh dense retrain (0.9746 vs 0.9749 synthetic
    AUC), and the retrain-lineage artifacts that score higher on
    synthetic (0.9774 at rank 256/512) FAIL the real-photo gate — the
    ihme knife edge flips to 0.120/0.106 vs this artifact's 0.040
    (BASELINE.md round-5 weights table). Exception: a dense retrained
    ``assets/weights.npz`` (~0.5-1 GB, gitignored) that exists
    AND is newer than the compact artifact, in which case the fresher
    retrain wins with a visible notice (a stale leftover dense file
    must not silently shadow the versioned weights and change every
    AUC/bench number)."""
    here = _repo_root()
    dense = os.path.join(here, "assets", "weights.npz")
    compact = os.path.join(here, "assets", "weights_compact.npz")
    if os.path.isfile(dense):
        if not os.path.isfile(compact):
            return dense
        if os.path.getmtime(dense) >= os.path.getmtime(compact):
            _notice(f"weights: using dense retrain {dense} "
                    f"[{artifact_fingerprint(dense)}] (newer than the "
                    "versioned compact artifact)")
            return dense
        _notice(f"weights: IGNORING stale dense {dense} (older than the "
                "versioned compact artifact; delete it or retrain to "
                "use it)")
    return compact


def default_mean_path() -> str:
    return os.path.join(_repo_root(), "assets", "mean.npy")


def weights_identity(weights_path: str | None = None) -> str:
    """Fingerprint of the artifact :func:`load_params_and_mean` would load
    for ``weights_path`` (default resolution included). "none" = random
    init."""
    if weights_path is None:
        p = default_weights_path(warn=False)
        weights_path = p if os.path.isfile(p) else None
    return artifact_fingerprint(weights_path)


def mean_identity(mean_path: str | None = None) -> str:
    """Fingerprint of the mean artifact :func:`load_params_and_mean` would
    load for ``mean_path`` (default resolution included). The mean changes
    CNN output exactly like the weights do, so result caches must key on
    it too (advisor r4 #2). "none" = no mean subtraction."""
    if mean_path is None:
        p = default_mean_path()
        mean_path = p if os.path.isfile(p) else None
    return artifact_fingerprint(mean_path)


def load_params_and_mean(weights_path: str | None = None,
                         mean_path: str | None = None, warn: bool = True):
    """Returns (params_or_None, mean_or_None) ready for ``Pipeline``."""
    from .models import caffe_import

    params = None
    if weights_path is None and os.path.isfile(default_weights_path(warn)):
        weights_path = default_weights_path(warn=False)
    if weights_path:
        if weights_path.endswith(".caffemodel"):
            params = caffe_import.caffemodel_to_params(weights_path)
        else:
            params = params_from_npz(weights_path)
    elif warn:
        print("WARNING: no trained weights found - using random init "
              "(train with train_cnn.py or pass --weights)")

    mean = None
    if mean_path is None and os.path.isfile(default_mean_path()):
        mean_path = default_mean_path()
    if mean_path:
        if mean_path.endswith(".binaryproto"):
            mean = caffe_import.read_mean_binaryproto(mean_path)
        else:
            mean = np.load(mean_path)
    return params, mean
