"""Vanishing-point detection and horizon estimation on an NVIDIA GPU.

A brand-new JAX/XLA implementation of the capabilities of the GCPR 2017
vanishing-point detector (Kluger et al., "Deep Learning for Vanishing Point
Detection Using an Inverse Gnomonic Projection", arXiv:1707.02427; reference
implementation fkluger/vanishing_points_2017).

Pipeline: image -> LSD line segments -> inverse-gnomonic "sphere image" ->
AlexNet-style CNN emitting a 20x20 VP probability grid -> EM-based VP
refinement with split/merge moves -> horizon estimation -> horizon-error AUC.

Unlike the reference (Python 2 + Caffe + ImageMagick + matplotlib-Agg glued
through on-disk pickles), the hot path here is fused, jit-compiled XLA:
the sphere renderer, the CNN forward pass and the batched EM all run on
device with static shapes, vmapped over image batches and shardable over
a mesh of GPUs. The native components are a C++ LSD extension bound via
ctypes (mirroring the reference's C/Cython LSD submodule) and the on-device
detector's CUDA connected-components kernel, called through ``jax.ffi``.
"""

__version__ = "0.1.0"
