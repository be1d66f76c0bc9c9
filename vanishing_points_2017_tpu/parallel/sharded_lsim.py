"""Line-axis sharding of the O(N^2) similarity kernels.

The reference has no sequences/attention; its quadratic-cost axis is N =
number of line segments, kept tractable with CPU process pools
(``calc_lsim``/``line_rating_knn``, ``vp_localisation.py:34-108`` of
fkluger/vanishing_points_2017; SURVEY §2.10/§5). The scaling story for
very large N is the same pattern as blockwise/ring attention
applied to the lsim matrix instead: shard the ROW block of the N x N
similarity computation across the mesh's ``dp`` axis and all-gather the
(small) segment array so each device computes its (N/d, N) strip.

On a single chip the dense kernels in ``ops/lines.py`` are faster; this
module exists for the multi-chip regime (N in the tens of thousands, e.g.
whole-panorama line sets) and as the framework's demonstrated
context-parallel pattern.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import lines as lineops
from ..ops.lines import HIGHEST


def _lsim_strip(lp_strip: jnp.ndarray, mask_strip: jnp.ndarray,
                lp_all: jnp.ndarray, mask_all: jnp.ndarray,
                row0: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """(N/d, N) strip of the similarity matrix; diagonal zeroed globally."""
    n_rows, n = lp_strip.shape[0], lp_all.shape[0]
    # pairwise pieces between the strip rows and all columns
    d1 = lineops.segment_point_distance(lp_strip[:, None, :],
                                        lp_all[None, :, 0:2])
    d2 = lineops.segment_point_distance(lp_strip[:, None, :],
                                        lp_all[None, :, 2:4])
    d3 = lineops.segment_point_distance(lp_all[None, :, :],
                                        lp_strip[:, None, 0:2])
    d4 = lineops.segment_point_distance(lp_all[None, :, :],
                                        lp_strip[:, None, 2:4])
    dist = jnp.minimum(jnp.minimum(d1, d2), jnp.minimum(d3, d4))

    v_s = lp_strip[:, 0:2] - lp_strip[:, 2:4]
    v_a = lp_all[:, 0:2] - lp_all[:, 2:4]
    ns = jnp.linalg.norm(v_s, axis=-1)
    na = jnp.linalg.norm(v_a, axis=-1)
    vs = v_s / jnp.where(ns == 0, 1.0, ns)[:, None]
    va = v_a / jnp.where(na == 0, 1.0, na)[:, None]
    dot = jnp.abs(jnp.matmul(vs, va.T, precision=HIGHEST))
    cross = jnp.abs(vs[:, None, 0] * va[None, :, 1]
                    - vs[:, None, 1] * va[None, :, 0])
    dphi = jnp.arctan2(cross, dot)
    cosang = jnp.cos(jnp.clip(9.0 * dphi, -jnp.pi / 2, jnp.pi / 2))

    ls = lineops.line_length(lp_strip)
    la = lineops.line_length(lp_all)
    s = sigma * jnp.minimum(ls[:, None], la[None, :])
    s2 = jnp.where(s == 0, 1.0, 2.0 * s * s)
    prox = jnp.where(s == 0, 0.0, jnp.exp(-(dist * dist) / s2))

    sim = cosang * prox
    rows = row0 + jnp.arange(n_rows)
    cols = jnp.arange(n)
    off_diag = rows[:, None] != cols[None, :]
    valid = mask_strip[:, None] & mask_all[None, :] & off_diag
    return jnp.where(valid, sim, 0.0)


@functools.partial(jax.jit, static_argnames=("mesh", "sigma"))
def calc_lsim_sharded(lp: jnp.ndarray, mask: jnp.ndarray, mesh: Mesh,
                      sigma: float = 1.0) -> jnp.ndarray:
    """N-axis sharded lsim over the mesh's dp axis.

    lp: (N, 4) with N divisible by the dp size. Returns the full (N, N)
    matrix, row-sharded over dp (each device holds its strip; XLA
    all-gathers lp, which is tiny next to the N x N output).
    """
    dp = mesh.shape["dp"]
    n = lp.shape[0]
    if n % dp:
        raise ValueError(f"N={n} not divisible by dp={dp}")

    def strip_fn(lp_strip, mask_strip, lp_all, mask_all):
        idx = jax.lax.axis_index("dp")
        row0 = idx * (n // dp)
        return _lsim_strip(lp_strip, mask_strip, lp_all, mask_all, row0,
                           sigma)

    return jax.shard_map(
        strip_fn, mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P(None, None), P(None)),
        out_specs=P("dp", None),
    )(lp, mask, lp, mask)
