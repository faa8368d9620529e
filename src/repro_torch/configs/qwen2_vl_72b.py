"""Qwen2-VL 72B (VLM: qwen2-72b backbone + M-RoPE). [arXiv:2409.12191]

Backbone identical to qwen2-72b; positions arrive as 3 streams (temporal /
height / width) for multimodal RoPE.  The ViT frontend is a stub:
``input_specs`` provides precomputed patch+text embeddings (B, S, 8192)
plus the (3, B, S) position tensor.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        mrope=True,
        embed_inputs=False,
        rope_theta=1.0e6,
        zero1=True,
        num_microbatches=8,
    )
)
