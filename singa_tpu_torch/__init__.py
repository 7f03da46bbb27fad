"""PyTorch/CUDA port of singa_tpu.

Mirrors the JAX package's layout (``singa_tpu_torch/equivariant/attention.py``
is the counterpart of ``singa_tpu/equivariant/attention.py`` and so on) and
imports nothing of it. The hand-written Hopper kernels live in ``ops/cuda``
(Python wrappers) and ``csrc`` (CUDA sources, built at first use).
"""
