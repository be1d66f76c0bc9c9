"""Low-rank factorization of the wide FC layers.

The reference ships a 233 MB caffemodel whose bulk is fc6
(4096 x 57600, ``cnn/deploy.prototxt:192-223`` of
fkluger/vanishing_points_2017); our float32 retrained equivalent is
~950 MB — too large to version. fc6/fc7 of this network are heavily
redundant (the 20x20 sigmoid target has ~400 effective outputs), so a
truncated-SVD factorization ``w ~= u @ v`` with a short fine-tune keeps the
synthetic-benchmark AUC while shrinking the artifact to tens of MB (stored
bfloat16) AND cutting fc6's matmul FLOPs ~15x.

``cnn.forward`` consumes factorized layers natively (``{"u", "v", "b"}``
instead of ``{"w", "b"}``); ``densify`` restores dense weights for the
Caffe exporter and activation-parity tests.
"""

from __future__ import annotations

import numpy as np


def _randomized_svd(w: np.ndarray, rank: int, oversample: int = 16,
                    iters: int = 4, seed: int = 0):
    """Halko-style randomized truncated SVD (row x col, rank << min dim)."""
    rng = np.random.default_rng(seed)
    k = min(rank + oversample, min(w.shape))
    q = rng.standard_normal((w.shape[1], k)).astype(w.dtype)
    y = w @ q
    for _ in range(iters):  # power iterations sharpen the spectrum
        y, _ = np.linalg.qr(y)
        y = w @ (w.T @ y)
    q, _ = np.linalg.qr(y)
    b = q.T @ w
    ub, s, vt = np.linalg.svd(b, full_matrices=False)
    u = q @ ub[:, :rank]
    return u, s[:rank], vt[:rank]


def factorize_layer(w: np.ndarray, rank: int, seed: int = 0):
    """Dense (in, out) weight -> (u (in, r), v (r, out)) with w ~= u @ v.

    The singular values are split evenly (sqrt(s) on each factor) so both
    factors have comparable scale for SGD fine-tuning.
    """
    u, s, vt = _randomized_svd(np.asarray(w, np.float32), rank, seed=seed)
    rs = np.sqrt(s)
    return (u * rs[None, :]).astype(np.float32), \
        (rs[:, None] * vt).astype(np.float32)


def factorize_params(params, ranks: dict[str, int], seed: int = 0):
    """Factorize the named FC layers of a dense param pytree (numpy/jax
    arrays in, numpy out; non-listed layers pass through unchanged)."""
    out = {}
    for name, layer in params.items():
        if name in ranks and "w" in layer:
            u, v = factorize_layer(np.asarray(layer["w"]), ranks[name],
                                   seed=seed)
            out[name] = {"u": u, "v": v, "b": np.asarray(layer["b"])}
        else:
            out[name] = {k: np.asarray(a) for k, a in layer.items()}
    return out


def densify(params):
    """Expand factorized layers back to dense ``{"w", "b"}`` (numpy)."""
    out = {}
    for name, layer in params.items():
        if "u" in layer:
            out[name] = {"w": np.asarray(layer["u"]) @ np.asarray(layer["v"]),
                         "b": np.asarray(layer["b"])}
        else:
            out[name] = {k: np.asarray(a) for k, a in layer.items()}
    return out
