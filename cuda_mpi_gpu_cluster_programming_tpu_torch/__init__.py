"""PyTorch/CUDA port of the AlexNet Blocks 1-2 staged-parallelism framework.

A second package beside ``cuda_mpi_gpu_cluster_programming_tpu`` (JAX on a
TPU, kept as the reference). It runs the single-device Blocks 1-2 forward on
one NVIDIA H100: the reference-op tier (``v1_jit``, PyTorch library ops) and
the kernel tier (``v3_pallas``, hand-written CUDA C++ kernels for sm_90a in
``csrc/``: conv+bias+ReLU, max-pool, LRN). It imports neither JAX nor the
JAX package. Entry point: ``python -m cuda_mpi_gpu_cluster_programming_tpu_torch.run``.
"""
