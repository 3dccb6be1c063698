"""PyTorch / CUDA port of ``im23d_tpu`` for NVIDIA Hopper (H100).

The JAX package ``im23d_tpu`` is the reference; module paths here mirror it
so each counterpart is easy to find.  Public functions keep the JAX layouts
(NHWC images, (z, y, x) point order, wxyz quaternions).  Every Pallas kernel
on a ported path is a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``); on CPU tensors the wrappers run
the plain PyTorch version that sits beside each kernel.

This package never imports ``jax`` or ``im23d_tpu``.
"""
