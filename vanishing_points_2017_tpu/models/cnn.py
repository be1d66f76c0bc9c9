"""AlexNet-variant VP-grid CNN, as a pure jittable JAX function.

Re-implementation of the reference's Caffe network
(``cnn/deploy.prototxt`` / ``train/train_val.prototxt`` of
fkluger/vanishing_points_2017): 1x500x500 grayscale sphere image in, 20x20
sigmoid probability grid out.

Layer stack (SURVEY §2.3): conv1 96@11x11/4 -> LRN -> maxpool3/2 ->
conv2 256@5x5 pad2 group2 -> LRN -> pool -> conv3 384@3x3 pad1 ->
conv4 384@3x3 pad1 group2 -> conv5 256@3x3 pad1 group2 -> pool ->
fc6 4096 -> drop -> fc7 4096 -> drop -> fc8 400 -> reshape 20x20 ->
sigmoid. ReLU after every conv/fc except fc8.

Caffe-parity details that matter for converted weights:

* Pooling uses Caffe's CEIL output-size rule — pool5 on 30x30 yields 15x15
  (the last window hangs over the edge); implemented with explicit
  asymmetric padding of -inf.
* LRN is ACROSS_CHANNELS: out = in / (1 + (alpha/n) * sum_win in^2)^beta
  with n = 5, alpha = 1e-4, beta = 0.75.
* The fc6 flatten follows Caffe's NCHW memory order (C, H, W); activations
  here are NHWC and are transposed before the reshape.
* Grouped convs (group=2) map to ``feature_group_count=2`` — HWIO weights
  with I = in_channels / 2.

Data layout is NHWC; weights HWIO. ``compute_dtype`` lets the conv and fc
stack run in bfloat16 while params stay float32: on the GPU cuDNN and
cuBLAS multiply bf16 operands on the tensor cores and accumulate in float32,
and each layer's output is rounded to bf16 (``PipelineConfig.cnn_dtype``).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

GRID = 20
INPUT_SIZE = 500

# (name, out_ch, kernel, stride, pad, groups, bias_init, weight_std)
_CONV_SPECS = [
    ("conv1", 96, 11, 4, 0, 1, 0.0, 0.01),
    ("conv2", 256, 5, 1, 2, 2, 0.1, 0.01),
    ("conv3", 384, 3, 1, 1, 1, 0.0, 0.01),
    ("conv4", 384, 3, 1, 1, 2, 0.1, 0.01),
    ("conv5", 256, 3, 1, 1, 2, 0.1, 0.01),
]
# (name, out_dim, bias_init, weight_std)
_FC_SPECS = [
    ("fc6", 4096, 0.1, 0.005),
    ("fc7", 4096, 0.1, 0.005),
    ("fc8_20x20", GRID * GRID, 0.0, 0.01),
]
def _ceil_pool(n: int, k: int = 3, s: int = 2) -> int:
    return -(-(n - k) // s) + 1


def pool5_side(input_size: int = INPUT_SIZE) -> int:
    """Spatial side of the pool5 output for a given input size.

    500 -> conv1/4 -> 123 -> pool -> 61 -> pool -> 30 -> pool5 -> 15.
    """
    c1 = (input_size - 11) // 4 + 1
    return _ceil_pool(_ceil_pool(_ceil_pool(c1)))


def fc6_in(input_size: int = INPUT_SIZE) -> int:
    side = pool5_side(input_size)
    return 256 * side * side


FC6_IN = fc6_in(INPUT_SIZE)  # 256 x 15 x 15 = 57600 at the canonical 500


def caffe_max_pool(x: jnp.ndarray, window: int, stride: int) -> jnp.ndarray:
    """Max pool with Caffe's ceil output-size semantics (NHWC)."""
    h, w = x.shape[1], x.shape[2]
    out_h = -(-(h - window) // stride) + 1  # ceil
    out_w = -(-(w - window) // stride) + 1
    pad_h = max((out_h - 1) * stride + window - h, 0)
    pad_w = max((out_w - 1) * stride + window - w, 0)
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, stride, stride, 1),
        padding=((0, 0), (0, pad_h), (0, pad_w), (0, 0)))


def lrn_across_channels(x: jnp.ndarray, local_size: int = 5,
                        alpha: float = 1e-4, beta: float = 0.75,
                        k: float = 1.0) -> jnp.ndarray:
    """Caffe ACROSS_CHANNELS local response normalization (NHWC)."""
    half = (local_size - 1) // 2
    sq = (x * x).astype(jnp.float32)
    ssum = jax.lax.reduce_window(
        sq, 0.0, jax.lax.add,
        window_dimensions=(1, 1, 1, local_size),
        window_strides=(1, 1, 1, 1),
        padding=((0, 0), (0, 0), (0, 0), (half, half)))
    scale = (k + (alpha / local_size) * ssum) ** beta
    return (x.astype(jnp.float32) / scale).astype(x.dtype)


def _conv(x, w, b, stride, pad, groups, compute_dtype):
    # inputs cast to compute_dtype (bf16 products, float32 accumulation in
    # cuDNN); the output keeps that dtype so the conv transpose in the backward pass sees matching dtypes,
    # then the bias add upcasts to float32
    y = jax.lax.conv_general_dilated(
        x.astype(compute_dtype), w.astype(compute_dtype),
        window_strides=(stride, stride),
        padding=((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups)
    return y.astype(jnp.float32) + b[None, None, None, :]


def init_params(rng: jax.Array, dtype=jnp.float32,
                input_size: int = INPUT_SIZE,
                fc_width: int | None = None) -> dict[str, Any]:
    """Gaussian fillers exactly per ``train/train_val.prototxt``.

    ``input_size`` != 500 shrinks fc6 accordingly and ``fc_width``
    overrides the 4096-neuron fc6/fc7 width (both useful for fast tests
    — ``forward`` is shape-driven); the canonical network is 500/4096.
    """
    params: dict[str, Any] = {}
    in_ch = 1
    for name, out_ch, k, _s, _p, g, bias, std in _CONV_SPECS:
        rng, sub = jax.random.split(rng)
        w = jax.random.normal(sub, (k, k, in_ch // g, out_ch), dtype) * std
        params[name] = {"w": w, "b": jnp.full((out_ch,), bias, dtype)}
        in_ch = out_ch
    in_dim = fc6_in(input_size)
    for name, out_dim, bias, std in _FC_SPECS:
        if fc_width is not None and name != "fc8_20x20":
            out_dim = fc_width
        rng, sub = jax.random.split(rng)
        w = jax.random.normal(sub, (in_dim, out_dim), dtype) * std
        params[name] = {"w": w, "b": jnp.full((out_dim,), bias, dtype)}
        in_dim = out_dim
    return params


@functools.partial(jax.jit,
                   static_argnames=("train", "compute_dtype", "logits"))
def forward(params: dict[str, Any], x: jnp.ndarray, *, train: bool = False,
            rng: jax.Array | None = None,
            compute_dtype=jnp.float32, logits: bool = False) -> jnp.ndarray:
    """x: (B, 500, 500, 1) mean-subtracted float input.

    Returns (B, 20, 20) sigmoid grid (or fc8 logits reshaped when
    ``logits=True``, for the sigmoid-cross-entropy training loss).
    Row b of the grid corresponds to beta index b (same contract as the
    reference's ``sigout`` consumed by ``find_initial_vps``).
    """
    h = x
    for name, _out, _k, stride, pad, groups, _b, _std in _CONV_SPECS:
        p = params[name]
        h = _conv(h, p["w"], p["b"], stride, pad, groups, compute_dtype)
        h = jax.nn.relu(h)
        if name in ("conv1", "conv2"):
            h = lrn_across_channels(h)
            h = caffe_max_pool(h, 3, 2)
    h = caffe_max_pool(h, 3, 2)  # pool5

    # Caffe flattens NCHW; transpose so converted fc6 weights line up
    h = jnp.transpose(h, (0, 3, 1, 2)).reshape(h.shape[0], -1)

    for i, (name, _out, _b, _std) in enumerate(_FC_SPECS):
        p = params[name]
        hc = h.astype(compute_dtype)
        if "u" in p:  # low-rank factorized layer: w = u @ v (models/factorize)
            h = (hc @ p["u"].astype(compute_dtype)) @ p["v"].astype(compute_dtype)
        else:
            h = hc @ p["w"].astype(compute_dtype)
        h = h.astype(jnp.float32) + p["b"]
        if name != "fc8_20x20":
            h = jax.nn.relu(h)
            if train:
                rng, sub = jax.random.split(rng)
                keep = jax.random.bernoulli(sub, 0.5, h.shape)
                h = jnp.where(keep, h / 0.5, 0.0)

    out = h.reshape(-1, GRID, GRID)
    return out if logits else jax.nn.sigmoid(out)


def preprocess(sphere_images: jnp.ndarray, mean: jnp.ndarray) -> jnp.ndarray:
    """uint8/float (B, S, S) sphere images + (S, S) mean -> NHWC input.

    Matches ``caffe_forward``'s mean-blob subtraction
    (``evaluation.py:35``)."""
    x = sphere_images.astype(jnp.float32) - mean.astype(jnp.float32)[None]
    return x[..., None]
