"""Snowflake Arctic (480B, dense-MoE hybrid: 128 experts top-2 + dense residual).

[hf:Snowflake/snowflake-arctic-base]
35 layers, d_model 7168, GQA 56/8, expert FFN 4864, dense residual FFN in
parallel with the MoE path every layer.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        moe_d_ff=4864,
        vocab_size=32000,
        num_experts=128,
        experts_per_token=2,
        moe_layer_period=1,
        dense_residual=True,
        rope_theta=1.0e6,
        fsdp=True,
        num_microbatches=8,
        optimizer="adamw8bit",
    )
)
