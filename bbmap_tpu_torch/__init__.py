"""PyTorch + CUDA port of the paired short-read mapper and the long-read
mapper.

Mirrors the layout of the JAX package ``bbmap_tpu`` (the reference it is
held against) module by module, and keeps its own copies of the host
modules it needs (``core``, ``io``, ``index.build``, ``align.seed``,
``ops.msa_ref``, ``ops.gref``, ``utils``): nothing here imports jax or
``bbmap_tpu``. ``convert`` carries the reference's state objects into the
port's classes. The DP score and fill passes and the traceback walk run as
hand-written CUDA kernels (``csrc/``) on the card; everything else on the
device path is PyTorch tensor code.
"""
