"""Yi-6B (llama-arch dense, GQA 32/4). [arXiv:2403.04652; hf:01-ai/Yi-6B]"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5.0e6,
        num_microbatches=2,
    )
)
