"""repro_torch.optim — optimizers, schedules, gradient compression."""

from repro_torch.optim.adamw import (OptState, adamw, adamw8bit,
                                     clip_by_global_norm, make_optimizer)
from repro_torch.optim.compression import (compress_decompress,
                                           compressed_psum, init_error_buffer)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = [
    "OptState",
    "adamw",
    "adamw8bit",
    "clip_by_global_norm",
    "make_optimizer",
    "compress_decompress",
    "compressed_psum",
    "init_error_buffer",
    "constant",
    "warmup_cosine",
]
