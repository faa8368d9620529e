"""repro_torch — the heterogeneous BLAS-offload substrate on PyTorch + CUDA.

The PyTorch port of :mod:`repro` (the JAX/Pallas reference, which stays
beside it unchanged).  Same layout, same names, one module per twin:

  repro_torch.core      — BLAS seam, offload cluster, cost model, accounting
  repro_torch.kernels   — hand-written CUDA kernels for Hopper (+ plain
                          PyTorch versions)
  repro_torch.models    — dense decoder (every matmul through the seam)
  repro_torch.configs   — architecture configs
  repro_torch.launch    — serve entry point

Importing this package needs neither a GPU nor ``nvcc``: kernels are built
on first use, inside the call that launches them.
"""

__version__ = "0.1.0"
