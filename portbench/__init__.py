"""The benchmark of soda_tpu_torch, the PyTorch and CUDA port (see README.md)."""
