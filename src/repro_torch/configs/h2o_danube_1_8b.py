"""H2O-Danube 1.8B (llama+mistral mix, sliding-window attention).

[arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base]
24 layers, d_model 2560, GQA 32/8, SWA window 4096 — the rolling KV cache
makes the 524k long-context decode cell runnable (DESIGN.md §5).
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        sliding_window=4096,
        rope_theta=1.0e4,
        num_microbatches=2,
    )
)
