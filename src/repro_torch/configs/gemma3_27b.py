"""Gemma-3 27B (dense, 5:1 local:global attention, 128k context).

[hf:google/gemma-3-27b-it — per-layer pattern from the gemma3 family card]
62 layers, d_model 5376, GQA 32/16, local window 1024, local RoPE theta 10k
vs global 1M.  Layer i is local iff i % 6 < 5 — expressed as per-layer
window/theta *data* scanned with the (uniform) stack.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,  # gemma3 uses 128 irrespective of d_model/heads
        d_ff=21504,
        vocab_size=262144,
        local_global_period=6,
        local_window=1024,
        rope_theta=1.0e6,
        local_rope_theta=1.0e4,
        tie_embeddings=True,
        num_microbatches=4,
    )
)
