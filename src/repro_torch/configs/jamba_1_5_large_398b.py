"""Jamba 1.5 Large (398B, hybrid Mamba+attention 1:7, MoE 16e top-2).

[arXiv:2403.19887 / 2408.12570; hf:ai21labs/AI21-Jamba-1.5-Large]
72 layers = 9 super-blocks of 8; attention at in-block offset 4 (1:7 ratio);
MoE FFN every 2nd layer (16 experts, top-2).  GQA 64 q heads / 8 kv heads.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=65536,
        num_experts=16,
        experts_per_token=2,
        moe_d_ff=24576,
        moe_layer_period=2,
        attn_layer_period=8,
        attn_layer_offset=4,
        ssm_state_dim=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        ssm_num_groups=8,
        rope_theta=1.0e6,  # attn layers are NoPE in Jamba; RoPE kept for zoo uniformity
        fsdp=True,
        num_microbatches=8,
        optimizer="adamw8bit",
    )
)
