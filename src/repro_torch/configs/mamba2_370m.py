"""Mamba-2 370M (attention-free SSM, SSD form). [arXiv:2405.21060]

48 layers, d_model 1024, state dim 128, head dim 64 (32 heads at expand=2),
vocab 50280.  SSD = chunked matmuls — the best GEMM-offload fit in the pool.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state_dim=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        ssm_num_groups=1,
        tie_embeddings=True,
        num_microbatches=1,
    )
)
