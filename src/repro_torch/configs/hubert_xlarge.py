"""HuBERT X-Large (encoder-only audio transformer). [arXiv:2106.07447]

48 layers, d_model 1280, 16 heads (MHA), d_ff 5120, GELU + LayerNorm,
bidirectional.  The conv waveform frontend is a stub: ``input_specs``
provides precomputed frame embeddings (B, S, 1280); the 504-unit head
predicts masked-frame cluster ids.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        mlp_kind="gelu",
        norm_kind="layernorm",
        embed_inputs=False,
        rope_theta=1.0e4,
        num_microbatches=2,
    )
)
