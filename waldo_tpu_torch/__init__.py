"""waldo_tpu_torch: WALDO layered video prediction in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of the JAX package ``waldo_tpu`` that keeps its module names and its
channel-last public layouts. Entry points run on CUDA unless the caller
passes ``device="cpu"``; on the CPU every kernel is replaced by its plain
PyTorch version.
"""
