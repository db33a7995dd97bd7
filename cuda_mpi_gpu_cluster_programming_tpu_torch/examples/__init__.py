"""Example entry points of the port (``python -m cuda_mpi_gpu_cluster_programming_tpu_torch.examples.<name>``)."""
