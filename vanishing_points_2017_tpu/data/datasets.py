"""Dataset adapters: YUD, ECD, HLW ground truth + a synthetic benchmark.

Re-derivation of the reference benchmark's dataset handling
(``benchmark.py:39-99, 142-220`` of fkluger/vanishing_points_2017):

* **YUD** (York Urban): images ``P*/P*.jpg``; camera intrinsics from
  ``cameraParameters.mat`` with the reference's HARD-CODED principal point
  (13, -11) and scale 2/640 (``benchmark.py:88-89`` — a quirk to keep);
  per-image ``*GroundTruthVP_CamParams.mat`` gives 3 orthogonal VPs, the
  horizon is VP1 x VP3. First 25 images are train/val and skipped.
* **ECD** (Eurasian Cities): images ``*.jpg``; ``*hor.mat`` / ``*VP.mat``
  ground truth in pixel coords, converted to the normalized centre-origin
  y-up frame. First 25 skipped; images resized to fit 800x800.
* **HLW** (Horizon Lines in the Wild): test list ``split/test.txt``;
  ``metadata.csv`` rows matched by basename give two horizon points scaled
  by the ORIGINAL image size. Resized to 800.
* **synthetic**: rendered Manhattan scenes with exact GT horizons — the
  datasets above are external downloads, so this adapter makes the
  benchmark runnable (and CI-testable) without them.

Each adapter yields records: {name, image_path | image, target_size,
true_horizon(normalized) or None}.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from . import io as dio


@dataclasses.dataclass
class Record:
    name: str
    image_path: str | None = None
    image: np.ndarray | None = None  # inline image (synthetic)
    true_horizon: np.ndarray | None = None  # normalized homogeneous line
    # GT may need the image dims; adapters that can, fill it eagerly.


def horizon_from_points(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    return np.cross(p1, p2)


def normalized_horizon_error(est_horizon: np.ndarray,
                             true_horizon: np.ndarray,
                             width: int, height: int) -> float:
    """Max horizon deviation at x = +-1, normalized by image height
    (``benchmark.py:245-257``)."""
    def at(h, x):
        p = np.cross(h, np.array([1.0 * x, 0.0, 1.0]))
        return p / p[2]

    scale = max(width, height)
    e1 = abs(at(est_horizon, 1)[1] - at(true_horizon, 1)[1])
    e2 = abs(at(est_horizon, -1)[1] - at(true_horizon, -1)[1])
    return max(e1, e2) / 2.0 * scale / height


# ---------------------------------------------------------------- YUD

def yud_records(root: str) -> tuple[list[Record], int]:
    """Returns (records, start_skip)."""
    import scipy.io as sio

    cam = sio.loadmat(os.path.join(root, "cameraParameters.mat"))
    f = cam["focal"][0, 0]
    ps = cam["pixelSize"][0, 0]
    # the reference ignores cam['pp'] and hard-codes (13, -11)
    k_mat = np.array([[f / ps, 0, 13], [0, f / ps, -11], [0, 0, 1]])
    s_mat = np.array([[2.0 / 640, 0, 0], [0, 2.0 / 640, 0], [0, 0, 1]])

    records = []
    for img_path in sorted(glob.glob(os.path.join(root, "P*", "P*.jpg"))):
        image_id = os.path.splitext(os.path.basename(img_path))[0]
        gt_path = os.path.join(os.path.dirname(img_path),
                               f"{image_id}GroundTruthVP_CamParams.mat")
        true_h = None
        if os.path.isfile(gt_path):
            vp = np.asarray(sio.loadmat(gt_path)["vp"], np.float64)
            tv = k_mat @ vp
            tv = tv / tv[2:3, :]
            tv = s_mat @ tv
            t1 = tv[:, 0] / tv[2, 0]
            t3 = tv[:, 2] / tv[2, 2]
            true_h = np.cross(t1, t3)
        records.append(Record(name=image_id, image_path=img_path,
                              true_horizon=true_h))
    return records, 25


# ---------------------------------------------------------------- ECD

def ecd_records(root: str) -> tuple[list[Record], int]:
    import scipy.io as sio

    records = []
    for img_path in sorted(glob.glob(os.path.join(root, "*.jpg"))):
        base = os.path.splitext(img_path)[0]
        true_h = None
        hor_path, vp_path = f"{base}hor.mat", f"{base}VP.mat"
        if os.path.isfile(hor_path):
            img = dio.load_image(img_path)
            h, w = img.shape[0], img.shape[1]
            scale = max(w, h)
            hor = np.squeeze(sio.loadmat(hor_path)["horizon"]).astype(np.float64)
            # intersect with pixel verticals x = w and x = 0, then normalize
            p1 = np.cross(hor, np.array([-1.0, 0.0, float(w)]))
            p2 = np.cross(hor, np.array([-1.0, 0.0, 0.0]))
            p1, p2 = p1 / p1[2], p2 / p2[2]
            for p in (p1, p2):
                p[0] = (p[0] - w / 2.0) / (scale / 2.0)
                p[1] = -(p[1] - h / 2.0) / (scale / 2.0)
            true_h = np.cross(p1, p2)
        records.append(Record(name=os.path.basename(base),
                              image_path=img_path, true_horizon=true_h))
    return records, 25


# ---------------------------------------------------------------- HLW

def hlw_records(root: str) -> tuple[list[Record], int]:
    import csv

    meta = {}
    with open(os.path.join(root, "metadata.csv")) as fh:
        for row in csv.reader(fh):
            key = os.path.splitext(os.path.basename(row[0]))[0]
            meta[key] = row

    records = []
    with open(os.path.join(root, "split", "test.txt")) as fh:
        names = [ln.strip() for ln in fh if ln.strip()]
    for name in names:
        img_path = os.path.join(root, "images", name)
        key = os.path.splitext(os.path.basename(name))[0]
        true_h = None
        if key in meta:
            row = meta[key]
            h_orig, w_orig = float(row[1]), float(row[2])
            scale_orig = max(w_orig, h_orig)
            p1 = np.array([float(row[3]), float(row[4]), 1.0])
            p2 = np.array([float(row[5]), float(row[6]), 1.0])
            p1[0:2] /= scale_orig / 2.0
            p2[0:2] /= scale_orig / 2.0
            true_h = np.cross(p1, p2)
        records.append(Record(name=key, image_path=img_path,
                              true_horizon=true_h))
    return records, 0


# ---------------------------------------------------------- synthetic

def _round_up(f: np.ndarray) -> np.ndarray:
    """Round half away from zero (the rasteriser's ROUND_UP)."""
    return (np.sign(f) * np.floor(np.abs(f) + 0.5)).astype(np.int64)


def _round_down(f: np.ndarray) -> np.ndarray:
    """Round half toward zero (the rasteriser's ROUND_DOWN)."""
    return (np.sign(f) * np.ceil(np.abs(f) - 0.5)).astype(np.int64)


def draw_lines(img: np.ndarray, xy: np.ndarray, ink: int,
               width: int = 2) -> None:
    """Draw thick straight lines into the (H, W) uint8 ``img`` in place.

    xy: (N, 4) endpoints (x1, y1, x2, y2) in pixels, truncated toward
    zero. Each line is the quadrilateral of PIL's ``ImageDraw.line(width=
    width)``, filled scanline by scanline with its rounding rules, so the
    pixels equal PIL's (tests/test_render.py compares them) without
    needing PIL. Vectorized over lines and scanlines.
    """
    if width < 2:
        raise ValueError("width < 2 is PIL's thin-line algorithm; not drawn")
    h, w = img.shape
    p = np.trunc(np.asarray(xy, np.float64)).astype(np.int64).reshape(-1, 4)
    x0, y0, x1, y1 = p.T
    dx, dy = x1 - x0, y1 - y0
    spans = []  # (row, first column, last column), inclusive

    dot = (dx == 0) & (dy == 0)
    spans.append((y0[dot], x0[dot], x0[dot]))
    x0, y0, x1, y1, dx, dy = (a[~dot] for a in (x0, y0, x1, y1, dx, dy))
    big = np.hypot(dx, dy)
    small = (width - 1) / 2.0
    r_max = _round_up(np.float64(small)) / big
    r_min = _round_down(np.float64(small)) / big
    dxmin, dxmax = _round_down(r_min * dy), _round_down(r_max * dy)
    dymin, dymax = _round_down(r_min * dx), _round_down(r_max * dx)
    vx = np.stack([x0 - dxmin, x1 - dxmin, x1 + dxmax, x0 + dxmax], 1)
    vy = np.stack([y0 + dymax, y1 + dymax, y1 - dymin, y0 - dymin], 1)
    ex0, ey0 = vx, vy                                       # (L, 4) edges
    ex1, ey1 = np.roll(vx, -1, 1), np.roll(vy, -1, 1)
    e_ymin, e_ymax = np.minimum(ey0, ey1), np.maximum(ey0, ey1)
    flat = e_ymin == e_ymax
    # horizontal edges are drawn as they are
    spans.append((e_ymin[flat], np.minimum(ex0, ex1)[flat],
                  np.maximum(ex0, ex1)[flat]))
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = np.where(flat, 0.0, (ex1 - ex0).astype(np.float32)
                         / (ey1 - ey0).astype(np.float32)).astype(np.float32)
    e_ymin_s = np.where(flat, np.iinfo(np.int64).max, e_ymin)
    e_ymax_s = np.where(flat, np.iinfo(np.int64).min, e_ymax)
    top = np.clip(np.minimum(vy.min(1), h - 1), 0, None)
    bot = np.minimum(vy.max(1), h)

    # one entry per (line, scanline)
    n_rows = np.maximum(bot - top + 1, 0)
    li = np.repeat(np.arange(len(top)), n_rows)
    y = top[li] + (np.arange(li.size) - np.repeat(np.cumsum(n_rows) - n_rows,
                                                  n_rows))
    hit = (e_ymin_s[li] <= y[:, None]) & (y[:, None] <= e_ymax_s[li])
    xs = ((y[:, None] - ey0[li]).astype(np.float32) * slope[li]
          + ex0[li].astype(np.float32))
    # an edge ending on this scanline counts twice (consistent polygons)
    dup = hit & (y[:, None] == e_ymax_s[li]) & (y[:, None] < bot[li, None])
    cand = np.concatenate([np.where(hit, xs, np.inf),
                           np.where(dup, xs, np.inf)], 1)
    cand.sort(axis=1)
    count = hit.sum(1) + dup.sum(1)
    for k in range(1, cand.shape[1], 2):
        ok = k < count
        a, b = _round_up(cand[ok, k - 1]), _round_down(cand[ok, k])
        spans.append((y[ok], a, b))

    rows, first, last = (np.concatenate(c) for c in zip(*spans))
    ok = (rows >= 0) & (rows < h) & (last >= 0) & (first < w)
    rows, first = rows[ok], np.maximum(first[ok], 0)
    last = np.minimum(last[ok], w - 1)
    ok = first <= last
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (rows[ok], first[ok]), 1)
    np.add.at(diff, (rows[ok], last[ok] + 1), -1)
    img[np.cumsum(diff[:, :w], axis=1) > 0] = ink


def render_scene_image(scene, size: int = 640, line_width: int = 2,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Draw the scene's segments as dark lines on a light background so the
    real LSD detector can re-extract them."""
    from .minisets import render_scene_image_wh

    return render_scene_image_wh(scene, size, size, line_width, rng)


def synthetic_records(count: int = 25, seed: int = 7,
                      size: int = 640) -> tuple[list[Record], int]:
    from ..models import synth

    rng = np.random.default_rng(seed)
    records = []
    for i in range(count):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(25, 60)),
                                 outliers=int(rng.integers(5, 25)))
        img = render_scene_image(scene, size=size, rng=rng)
        records.append(Record(name=f"synthetic_{i:04d}", image=img,
                              true_horizon=scene.horizon.astype(np.float64)))
    return records, 0


DATASETS = {
    "york": (yud_records, None),       # native resolution
    "eurasian": (ecd_records, 800),    # resize to fit 800x800
    "horizon": (hlw_records, 800),
    "synthetic": (synthetic_records, None),
}


def get_data_list(source_folder: str, destination_folder: str, name: str,
                  dataset_name: str | None = None,
                  distance_measure: str = "angle", use_weights: bool = True,
                  do_split: bool = True, do_merge: bool = True,
                  update: bool = False) -> dict:
    """Manifest builder mirroring the reference's ``get_data_list``
    (``evaluation.py:55-118``): encodes the EM config into the dataset name
    (config => cache identity), globs the image list per dataset convention,
    and persists the manifest (JSON here, pickle there) for reuse unless
    ``update``.
    """
    import json

    fullname = (f"{name}_{distance_measure}_"
                f"{'' if use_weights else 'no'}weights_"
                f"{'' if do_split else 'no'}split_"
                f"{'' if do_merge else 'no'}merge")
    manifest_path = os.path.join(destination_folder, f"{fullname}.json")

    if os.path.isfile(manifest_path) and not update:
        with open(manifest_path) as fh:
            return json.load(fh)

    if dataset_name == "york":
        image_files = glob.glob(os.path.join(source_folder, "P*", "P*.jpg"))
    elif dataset_name == "eurasian":
        image_files = glob.glob(os.path.join(source_folder, "*.jpg"))
    elif dataset_name == "horizon":
        with open(os.path.join(source_folder, "split", "test.txt")) as fh:
            image_files = [os.path.join(source_folder, "images", ln.strip())
                           for ln in fh if ln.strip()]
    else:
        image_files = []
        for ext in ("*.jpg", "*.png", "*.pgm"):
            image_files += glob.glob(os.path.join(source_folder, ext))
    image_files.sort()

    dest = os.path.join(destination_folder, fullname)
    dataset = {
        "source_folder": source_folder,
        "destination_folder": dest,
        "name": fullname,
        "distance_measure": distance_measure,
        "use_weights": use_weights,
        "do_split": do_split,
        "do_merge": do_merge,
        "image_files": image_files,
        "cache_files": [os.path.join(
            dest, os.path.splitext(os.path.basename(f))[0] + ".result.npz")
            for f in image_files],
    }
    os.makedirs(dest, exist_ok=True)
    with open(manifest_path, "w") as fh:
        json.dump(dataset, fh, indent=1)
    return dataset
