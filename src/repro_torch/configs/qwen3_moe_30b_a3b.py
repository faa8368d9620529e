"""Qwen3-30B-A3B (MoE: 128 experts, top-8, 3B active). [hf:Qwen/Qwen3-30B-A3B]

48 layers, d_model 2048, GQA 32/4, expert FFN width 768, vocab 151936.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,  # qwen3 uses head_dim 128 (not d_model/heads)
        d_ff=768,
        moe_d_ff=768,
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        moe_layer_period=1,
        rope_theta=1.0e6,
        num_microbatches=4,
    )
)
