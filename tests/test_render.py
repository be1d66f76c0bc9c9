"""The numpy line rasteriser of the synthetic scenes against PIL's
``ImageDraw.line``, which drew them before: every pixel must agree, so
every image, and every number pinned on one, is unchanged. PIL is needed
only here."""

import numpy as np
import pytest

from vanishing_points_2017_tpu.data import datasets, minisets
from vanishing_points_2017_tpu.models import synth


def _pil_lines(h, w, xy, width):
    from PIL import Image, ImageDraw

    im = Image.new("L", (w, h), color=220)
    draw = ImageDraw.Draw(im)
    for x1, y1, x2, y2 in xy:
        draw.line([(x1, y1), (x2, y2)], fill=40, width=width)
    return np.asarray(im)


@pytest.mark.parametrize("seed,size", [(0, 640), (2, 640), (3, 320),
                                       (7, 128), (11, 256), (0, 800)])
def test_render_scene_image_matches_pil(seed, size):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(seed)
    scene = synth.make_scene(rng, lines_per_vp=40, outliers=8)
    s = size / 2.0
    seg = scene.segments
    xy = [(a * s + s, -b * s + s, c * s + s, -d * s + s)
          for a, b, c, d in seg]
    want = _pil_lines(size, size, xy, 2)
    got = datasets.render_scene_image(scene, size=size)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h,seed", [(640, 480, 101), (1024, 768, 202),
                                      (900, 600, 303)])
def test_render_scene_image_wh_matches_pil(w, h, seed):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(seed)
    scene = synth.make_scene(rng, lines_per_vp=30, outliers=10)
    s = max(w, h) / 2.0
    xy = [(a * s + w / 2.0, -b * s + h / 2.0, c * s + w / 2.0,
           -d * s + h / 2.0) for a, b, c, d in scene.segments]
    np.testing.assert_array_equal(
        minisets.render_scene_image_wh(scene, w, h), _pil_lines(h, w, xy, 2))


@pytest.mark.parametrize("width", [2, 3, 5])
def test_draw_lines_matches_pil_on_random_lines(width):
    """Lines partly or wholly off the image, short, axis-parallel."""
    pytest.importorskip("PIL")
    rng = np.random.default_rng(width)
    xy = rng.uniform(-60, 260, size=(300, 4))
    xy[:20, 2] = xy[:20, 0]                   # vertical
    xy[20:40, 3] = xy[20:40, 1]               # horizontal
    xy[40:60, 2:] = xy[40:60, :2] + rng.uniform(-2, 2, (20, 2))  # short
    got = np.full((180, 200), 220, np.uint8)
    datasets.draw_lines(got, xy, 40, width)
    np.testing.assert_array_equal(got, _pil_lines(180, 200, xy, width))
