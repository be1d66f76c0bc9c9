"""Reference-shaped result contracts.

The EM core returns masked fixed-slot arrays (static shapes); the reference
returns compact arrays keyed exactly as ``vp_localisation.py:441-442`` of
fkluger/vanishing_points_2017. This module converts between the two and
offers a ``run_em_single``-style convenience entry
(``evaluation.py:332-354``) for users migrating from the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..ops import probability as prob
from .em import EMConfig, EMResult, expectation_maximisation


class PDF(NamedTuple):
    """The reference's E-step bundle (``probability_functions.py:5``:
    ``PDF = namedtuple('PDF', 'v lv vl l lvsq angles')``), compact arrays,
    linear float64 probabilities."""

    v: np.ndarray       # (M,) prior at the VPs
    lv: np.ndarray      # (N, M) likelihood p(l|v)
    vl: np.ndarray      # (M, N) posterior p(v|l)
    l: np.ndarray       # (N,) evidence p(l), floored at 1e-12
    lvsq: np.ndarray    # (N, M) squared line-VP inconsistency
    angles: np.ndarray  # (M, 2) VP angles


def _final_distribution(res: EMResult, l, lp, lmask, cnn_prediction,
                        cfg: EMConfig, n: int) -> PDF:
    """Recompute the E-step at the final VP state — the reference returns
    the last ``p`` bundle as ``'distribution'`` (``vp_localisation.py:442``).
    Linearized to float64 on the host (log p(l|v) can exceed float32 range,
    exactly like the reference's 1/sqrt(2 pi s) factors)."""
    pdfpar = prob.pdf_params(jnp.asarray(cnn_prediction, jnp.float32))
    p = prob.calc_probabilities(
        pdfpar, res.vp, res.alive, l, lp, res.log_sigma, lmask,
        cfg.distance_measure, cfg.wrap_quirk)
    alive = np.asarray(res.alive).astype(bool)
    log_plv = np.asarray(p.log_plv, np.float64)[:n][:, alive]
    return PDF(
        v=np.asarray(p.p_v, np.float64)[alive],
        lv=np.exp(log_plv),
        vl=np.asarray(p.p_vl, np.float64)[alive][:, :n],
        l=np.exp(np.asarray(p.log_pl, np.float64))[:n],
        lvsq=np.asarray(p.lvsq, np.float64)[:n][:, alive],
        angles=np.asarray(p.angles, np.float64)[alive],
    )


def em_result_to_dict(res: EMResult, distribution: PDF | None = None) -> dict:
    """Masked slots -> the reference's compact result dict.

    VP slot indices in ``vp_assoc`` are renumbered to the compact order;
    outliers stay -1. An invalid result maps to the reference's empty dict
    (``vp_localisation.py:205-206``: vp=None etc.).
    """
    if not bool(res.valid):
        return {"vp_assoc": None, "vp": None, "counts": None,
                "count_id": None, "decision_metric": None, "iterations": 0,
                "distribution": None}

    alive = np.asarray(res.alive).astype(bool)
    slots = np.flatnonzero(alive)
    renumber = np.full(alive.shape[0], -1, np.int64)
    renumber[slots] = np.arange(slots.shape[0])

    assoc = np.asarray(res.vp_assoc)
    assoc_c = np.where(assoc >= 0, renumber[np.clip(assoc, 0, None)], -1)

    return {
        "vp": np.asarray(res.vp)[alive],
        "vp_assoc": assoc_c,
        "counts": np.asarray(res.counts)[alive],
        "counts_weighted": np.asarray(res.counts_weighted)[alive],
        "count_id": None,
        "decision_metric": np.asarray(res.decision_metric)[alive],
        "sigma": np.exp(np.asarray(res.log_sigma))[alive],
        "iterations": int(res.iterations),
        "distribution": distribution,
    }


def run_em_single(lines: np.ndarray, line_segments: np.ndarray,
                  cnn_prediction: np.ndarray, sphere_image: np.ndarray,
                  distance_measure: str = "angle", use_weights: bool = True,
                  do_split: bool = True, do_merge: bool = True,
                  n_pad: int = 512) -> dict:
    """Reference-style one-image EM (``run_em_single``): compact dict out.

    lines: (N, 3), line_segments: (N, 4) in the normalized frame,
    cnn_prediction: (20, 20), sphere_image: (S, S) Agg orientation.
    """
    cfg = EMConfig(distance_measure=distance_measure,
                   use_weights=use_weights, do_split=do_split,
                   do_merge=do_merge)
    n = lines.shape[0]
    if n > n_pad:
        raise ValueError(f"{n} lines exceed the n_pad bucket {n_pad}")
    l = np.zeros((n_pad, 3), np.float32)
    lp = np.zeros((n_pad, 4), np.float32)
    l[:n] = lines[:, :3]
    lp[:n] = line_segments[:, :4]
    lmask = np.arange(n_pad) < n
    lj, lpj, lmj = jnp.asarray(l), jnp.asarray(lp), jnp.asarray(lmask)
    res = expectation_maximisation(
        lj, lpj, jnp.asarray(cnn_prediction, dtype=jnp.float32),
        jnp.asarray(sphere_image, dtype=jnp.float32), lmj, cfg)
    dist = (_final_distribution(res, lj, lpj, lmj, cnn_prediction, cfg, n)
            if bool(res.valid) else None)
    out = em_result_to_dict(res, distribution=dist)
    if out["vp_assoc"] is not None:
        out["vp_assoc"] = out["vp_assoc"][:n]
    return out


def create_data_dict_single(image_rgb: np.ndarray,
                            cnn_input_size: int = 250,
                            n_pad: int = 512) -> dict:
    """In-memory single-image ingest (``create_data_dict_single``,
    ``evaluation.py:189-224`` of the reference): grayscale -> LSD ->
    homogeneous lines -> sphere image, returned as the reference's
    ``{'lines': datum, 'sphere_image': image}`` shape (no disk I/O)."""
    from ..data import io as dio
    from ..ops import sphere as sphere_mod
    from ..pipeline import pad_lines

    gray = dio.rgb2gray(image_rgb)
    datum = {"image_shape": gray.shape, "image": image_rgb}
    det = dio.detect_lsd_lines(gray)
    segments = det["segments"]

    lines = np.zeros((segments.shape[0], 3))
    if segments.shape[0]:
        p1 = np.concatenate([segments[:, 0:2],
                             np.ones((segments.shape[0], 1))], axis=1)
        p2 = np.concatenate([segments[:, 2:4],
                             np.ones((segments.shape[0], 1))], axis=1)
        lines = np.cross(p1, p2)
    datum["line_segments"] = segments
    datum["lines"] = lines

    l, _, lmask = pad_lines(segments, n_pad)
    sphere_image = np.asarray(sphere_mod.sphere_image_uint8(
        jnp.asarray(l), jnp.asarray(lmask), size=cnn_input_size))
    return {"lines": datum, "sphere_image": sphere_image}


def renew_cnn_result(params, mean, lines: np.ndarray,
                     image_size: int = 500):
    """Re-render the sphere image from ``lines`` and re-run the CNN
    (``renew_cnn_result``, ``evaluation.py:357-361`` of the reference).

    lines: (N, 3) homogeneous lines in the normalized frame. Returns
    ``(sphere_image, prediction)`` exactly like the reference — a fresh
    render + forward with no caching, for callers that changed the line
    set after the pickled CNN pass.
    """
    from ..models import cnn as cnn_mod
    from ..ops import sphere as sphere_mod

    n = np.asarray(lines).shape[0]
    n_pad = max(512, int(2 ** np.ceil(np.log2(max(n, 1)))))
    l = np.zeros((n_pad, 3), np.float32)
    l[:n] = np.asarray(lines)[:, :3]
    lmask = np.arange(n_pad) < n
    img = sphere_mod.sphere_image_uint8(jnp.asarray(l), jnp.asarray(lmask),
                                        size=image_size)
    x = cnn_mod.preprocess(img[None], jnp.asarray(mean, jnp.float32))
    prediction = np.asarray(cnn_mod.forward(params, x)[0])
    return np.asarray(img), prediction


def save_cnn_result(params, mean, datum: dict, file_for_basename: str,
                    sphere_size: int = 500, n_pad: int = 512) -> str:
    """CNN forward on a datum's sphere image + persist
    (``save_cnn_result``, ``evaluation.py:41-52`` of the reference; npz
    instead of pickle). Returns the written path."""
    import os

    from ..models import cnn as cnn_mod
    from ..ops import sphere as sphere_mod
    from ..pipeline import pad_lines

    l, _, lmask = pad_lines(np.asarray(datum["line_segments"]), n_pad)
    img = sphere_mod.sphere_image_uint8(jnp.asarray(l), jnp.asarray(lmask),
                                        size=sphere_size)
    x = cnn_mod.preprocess(img[None], jnp.asarray(mean, jnp.float32))
    prediction = np.asarray(cnn_mod.forward(params, x)[0])
    datum["prediction"] = prediction

    basename = os.path.splitext(file_for_basename)[0]
    out_path = f"{basename}.cnn_result.npz"
    np.savez(out_path, prediction=prediction,
             line_segments=np.asarray(datum["line_segments"]))
    return out_path
