"""Layer ops: the reference tier and the CUDA kernel tier."""
