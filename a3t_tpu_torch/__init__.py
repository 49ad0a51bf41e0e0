"""a3t_tpu_torch: the A3T speech-editing system in PyTorch for NVIDIA Hopper.

A port of ``a3t_tpu`` (JAX on a TPU) that keeps its module layout.  It
imports ``torch`` and never JAX or ``a3t_tpu``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written CUDA
kernels in ``csrc/`` are built with ``nvcc`` at first use.
"""
