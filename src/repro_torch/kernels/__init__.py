"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``sm_90a``).

Each kernel lives in ``csrc/<name>.cu`` behind a plain C interface, is
built by ``nvcc`` at first use (:mod:`repro_torch.kernels._build`) and is
called through ``ctypes`` by its wrapper module, which also holds the
kernel's launch counter.  :mod:`repro_torch.kernels.ref` has the plain
PyTorch version of each; :mod:`repro_torch.kernels.ops` is the lowering
table the offload seam fetches kernels from.
"""
