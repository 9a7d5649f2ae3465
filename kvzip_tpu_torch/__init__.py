"""kvzip_tpu_torch: the KVzip engine in PyTorch and CUDA for NVIDIA Hopper.

A port of ``kvzip_tpu`` (the JAX reference, which stays beside it): chunked
prefill, reconstruction scoring, pair pruning into the pool layout and
greedy decode over the compressed cache, with hand-written CUDA kernels for
the attention ops (``ops/``, ``csrc/``). Imports neither JAX nor
``kvzip_tpu``.
"""
