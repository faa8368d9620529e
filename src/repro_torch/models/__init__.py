"""repro_torch.models — dense decoder; every matmul goes through repro_torch.core.blas."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
