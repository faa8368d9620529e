"""The paper's own 'architecture': a bare float64 GEMM workload.

Used by the paper-reproduction measurement (Fig. 3, ``tools/paper_fig3_h100.py``) —
not part of the assigned 10-arch pool, so it is registered under
``paper-gemm`` for the offload benchmarks only.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

# Problem sizes the paper sweeps in Figure 3.
PAPER_SIZES = (16, 32, 64, 128)
PAPER_DTYPE = "float64"

CONFIG = register(
    ArchConfig(
        name="paper-gemm",
        family="dense",
        num_layers=1,
        d_model=128,
        num_heads=1,
        num_kv_heads=1,
        head_dim=128,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        num_microbatches=1,
    )
)
