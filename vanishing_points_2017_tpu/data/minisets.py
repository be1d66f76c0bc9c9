"""Format-faithful miniature YUD / ECD / HLW datasets.

The real datasets are external downloads absent from CI, so the three
real-format code paths (``.mat`` camera/VP parsing with the reference's
hard-coded (13, -11) principal point, ECD ``*hor.mat`` pixel-frame horizon
conversion, HLW ``metadata.csv`` + ``split/test.txt``) could never execute
end-to-end. These generators materialise a tiny dataset ON DISK in each
dataset's exact layout from synthetic Manhattan scenes with exact GT
horizons, so ``benchmark.py --yud/--ecd/--hlw --dataset_dir <mini>`` runs
the complete driver: JPEG decode -> (ECD/HLW) resize-to-800 -> LSD ->
fused device stage -> GT parsing -> horizon error -> AUC.

GT is written by INVERTING each adapter's transform (cited per generator),
so the adapter must reproduce the known normalized-frame horizon exactly —
that inversion is itself asserted by ``tests/test_minisets.py``.
"""

from __future__ import annotations

import os

import numpy as np

from ..models import synth

# the YUD camera constants the adapter (and the reference,
# /root/reference/benchmark.py:82-90) applies
YUD_F_OVER_PS = 675.0
YUD_PP = np.array([13.0, -11.0])


def render_scene_image_wh(scene, width: int, height: int, line_width: int = 2,
                          rng: np.random.Generator | None = None
                          ) -> np.ndarray:
    """Non-square variant of ``datasets.render_scene_image``: draws the
    normalized-frame segments (centre origin, +y up, long axis [-1, 1])."""
    from .datasets import draw_lines

    arr = np.full((height, width), 220, np.uint8)
    s = max(width, height) / 2.0
    seg = np.asarray(scene.segments).reshape(-1, 4)
    xy = np.stack([seg[:, 0] * s + width / 2.0, -seg[:, 1] * s + height / 2.0,
                   seg[:, 2] * s + width / 2.0, -seg[:, 3] * s + height / 2.0],
                  axis=1)
    draw_lines(arr, xy, 40, line_width)
    arr = arr.astype(np.float64)
    if rng is not None:
        arr = np.clip(arr + rng.normal(0, 3.0, arr.shape), 0, 255)
    return arr.astype(np.uint8)


def _save_jpeg(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(arr, "L").convert("RGB").save(path, quality=92)


def _scenes(count: int, seed: int):
    rng = np.random.default_rng(seed)
    return [synth.make_scene(rng, lines_per_vp=int(rng.integers(25, 45)),
                             outliers=int(rng.integers(5, 15)))
            for _ in range(count)], rng


def make_mini_yud(root: str, n_eval: int = 2, seed: int = 101) -> list:
    """York Urban layout: P10NN/P10NN.jpg + *GroundTruthVP_CamParams.mat,
    cameraParameters.mat at the root; 640x480 images; the first 25 are the
    train/val split the protocol skips.

    GT inversion (of ``datasets.yud_records`` = reference
    ``benchmark.py:82-90,142-167``): the adapter computes
    t = S K vp / (K vp)_z with S = 2/640 and K carrying the hard-coded
    (13, -11) principal point; we store vp = K^-1 (320 x, 320 y, 1) for a
    normalized-frame VP (x, y), columns (horizon1, zenith, horizon2).
    """
    import scipy.io as sio

    n_total = 25 + n_eval
    scenes, rng = _scenes(n_total, seed)
    os.makedirs(root, exist_ok=True)
    sio.savemat(os.path.join(root, "cameraParameters.mat"),
                {"focal": np.array([[YUD_F_OVER_PS]]),
                 "pixelSize": np.array([[1.0]]),
                 "pp": np.array([[307.0, 251.0]])})  # ignored, like the ref

    k_mat = np.array([[YUD_F_OVER_PS, 0, YUD_PP[0]],
                      [0, YUD_F_OVER_PS, YUD_PP[1]],
                      [0, 0, 1.0]])
    k_inv = np.linalg.inv(k_mat)

    for i, scene in enumerate(scenes):
        name = f"P{1001 + i}"
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        img = render_scene_image_wh(scene, 640, 480, rng=rng)
        _save_jpeg(img, os.path.join(d, f"{name}.jpg"))

        zenith = int(np.argmax(np.abs(scene.vps[:, 1])))
        hor = [k for k in range(3) if k != zenith]
        cols = [hor[0], zenith, hor[1]]
        vp = np.zeros((3, 3))
        for c, k in enumerate(cols):
            v = scene.vps[k].astype(np.float64)
            t_px = np.array([320.0 * v[0] / v[2], 320.0 * v[1] / v[2], 1.0])
            cam = k_inv @ t_px
            vp[:, c] = cam / np.linalg.norm(cam)
        sio.savemat(os.path.join(d, f"{name}GroundTruthVP_CamParams.mat"),
                    {"vp": vp})
    return scenes


def make_mini_ecd(root: str, n_eval: int = 1, seed: int = 202) -> list:
    """Eurasian Cities layout: NNNN.jpg + NNNNhor.mat at the root; original
    size 1024x768 (exercises the resize-to-800 path); first 25 skipped.

    GT inversion (of ``datasets.ecd_records`` = reference
    ``benchmark.py:169-203``): ``horizon`` is the line in top-left-origin,
    y-DOWN pixel coords of the ORIGINAL image; built by mapping two
    normalized-frame horizon points through px = x s + w/2, py = -y s + h/2.
    """
    import scipy.io as sio

    w, h = 1024, 768
    s = max(w, h) / 2.0
    n_total = 25 + n_eval
    scenes, rng = _scenes(n_total, seed)
    os.makedirs(root, exist_ok=True)

    for i, scene in enumerate(scenes):
        name = f"{i + 1:04d}"
        img = render_scene_image_wh(scene, w, h, rng=rng)
        _save_jpeg(img, os.path.join(root, f"{name}.jpg"))

        th = scene.horizon.astype(np.float64)
        pts = []
        for x in (-0.5, 0.5):
            p = np.cross(th, np.array([-1.0, 0.0, x]))  # vertical at x
            p = p / p[2]
            pts.append(np.array([p[0] * s + w / 2.0, -p[1] * s + h / 2.0,
                                 1.0]))
        sio.savemat(os.path.join(root, f"{name}hor.mat"),
                    {"horizon": np.cross(pts[0], pts[1])})
    return scenes


def make_mini_hlw(root: str, n_eval: int = 3, seed: int = 303) -> list:
    """HLW layout: images/<name>.jpg, split/test.txt, metadata.csv; original
    size 900x600; no skip. Metadata coords are centre-origin y-UP scaled by
    the ORIGINAL dims (``datasets.hlw_records`` divides by scale_orig/2 =
    reference ``benchmark.py:92-99,205-220``).
    """
    import csv

    w, h = 900, 600
    s = max(w, h) / 2.0
    scenes, rng = _scenes(n_eval, seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "split"), exist_ok=True)

    rows, names = [], []
    for i, scene in enumerate(scenes):
        name = f"hlw_{i:04d}.jpg"
        names.append(name)
        img = render_scene_image_wh(scene, w, h, rng=rng)
        _save_jpeg(img, os.path.join(root, "images", name))

        th = scene.horizon.astype(np.float64)
        pts = []
        for x in (-0.5, 0.5):
            p = np.cross(th, np.array([-1.0, 0.0, x]))
            p = p / p[2]
            pts.append((p[0] * s, p[1] * s))  # centre-origin, y-up
        rows.append([name, h, w, pts[0][0], pts[0][1], pts[1][0], pts[1][1]])

    with open(os.path.join(root, "metadata.csv"), "w", newline="") as fh:
        csv.writer(fh).writerows(rows)
    with open(os.path.join(root, "split", "test.txt"), "w") as fh:
        fh.write("\n".join(names) + "\n")
    return scenes
