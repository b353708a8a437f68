"""PyTorch + CUDA port of the paired short-read mapper.

Mirrors the layout of the JAX package ``bbmap_tpu`` (the reference it is
held against) and reuses its jax-free host modules (``bbmap_tpu.core``,
``bbmap_tpu.io``, ``bbmap_tpu.index.build``, ``bbmap_tpu.align.seed`` ...).
The DP score and fill passes run as hand-written CUDA kernels
(``csrc/msa_dp.cu``) on the card; everything else on the device path is
PyTorch tensor code. This package never imports jax.
"""
