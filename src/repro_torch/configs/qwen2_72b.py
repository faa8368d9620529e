"""Qwen2-72B (dense, GQA 64/8, QKV bias). [arXiv:2407.10671; hf:Qwen/Qwen2-72B]"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1.0e6,
        zero1=True,
        num_microbatches=8,
    )
)
