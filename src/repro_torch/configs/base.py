"""Architecture config schema + input-shape definitions for all assigned cells."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

GLOBAL_WINDOW = 1 << 30  # "window" value meaning full attention


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture. All fields static; models are built purely from this."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attn-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # expert hidden width (0 -> d_ff)
    moe_layer_period: int = 1      # every k-th layer is MoE (jamba: 2)
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # "auto": shard_map explicit-collective dispatch when a compatible mesh
    # is ambient (minimal EP all-to-all volume), falling back to "grouped".
    # "grouped": group-local GSPMD dispatch. "global": mesh-wide sort (the
    # naive baseline, kept for §Perf comparison).
    moe_dispatch: str = "auto"
    dispatch_groups: int = 16      # = data-axis size on the production mesh
    # True: every routed copy reaches its expert (no capacity, no drop):
    # rows sorted by expert, per-expert offsets on the card, the ragged
    # grouped expert GEMM (granite-4.0-h: the published model drops none).
    moe_dropless: bool = False

    # --- attention ---------------------------------------------------------
    causal: bool = True            # False for encoder-only (hubert)
    sliding_window: int = 0        # uniform SWA window (danube); 0 = none
    local_global_period: int = 0   # gemma3: 6 -> 5 local + 1 global per period
    local_window: int = 0          # gemma3 local window
    qkv_bias: bool = False         # qwen2 / qwen2-vl
    rope_theta: float = 1.0e6
    local_rope_theta: float = 0.0  # gemma3 local layers use a different theta
    mrope: bool = False            # qwen2-vl M-RoPE (3 position streams)
    position_embedding: str = "rope"  # rope | nope (granite-4.0-h: none)
    attention_multiplier: float = 0.0  # softmax scale; 0 -> head_dim**-0.5

    # --- hybrid (jamba) ----------------------------------------------------
    attn_layer_period: int = 0     # jamba: 8
    attn_layer_offset: int = 0     # jamba: attn at layer i % period == offset

    # --- SSM (mamba2 / jamba mamba layers) ----------------------------------
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    ssm_num_groups: int = 1

    # --- misc ---------------------------------------------------------------
    # "eager": every block op dispatches through the seam one call at a
    # time.  "graph": block forwards are captured as lazy `hnp` expression
    # graphs (models/forward.py) — elementwise epilogues fuse into their
    # producer launches, independent same-shape projections batch into one
    # gemm_batched, and intermediates stay device-resident across the block.
    forward_mode: str = "eager"    # eager | graph
    mlp_kind: str = "swiglu"       # swiglu | gelu
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1.0e-6
    # Granite's multipliers: the embedding is scaled by embedding_multiplier,
    # each residual branch by residual_multiplier, the logits divided by
    # logits_scaling.  At 1.0 each launches nothing.
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    tie_embeddings: bool = False
    embed_inputs: bool = True      # False: input_specs provides embeddings (audio/vlm stub frontend)
    dtype: str = "bfloat16"
    # training memory knobs (used by launch/steps)
    num_microbatches: int = 4
    accum_dtype: str = "float32"   # gradient-accumulation dtype
    optimizer: str = "adamw"       # adamw | adamw8bit (blockwise int8 moments)
    remat: bool = True
    fsdp: bool = False             # ZeRO-3: shard params/moments over 'data' too
    zero1: bool = False            # ZeRO-1: shard only optimizer moments over 'data'

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.position_embedding not in ("rope", "nope"):
            raise ValueError(
                f"position_embedding {self.position_embedding!r} is not "
                f"'rope' or 'nope'")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # --- derived ------------------------------------------------------------
    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attn_free(self) -> bool:
        return self.num_heads == 0

    @property
    def subquadratic(self) -> bool:
        """Supports the 524k long-context decode cell (see DESIGN.md §5)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0 and self.local_global_period == 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state_dim else 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'mamba' for layer i."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_layer_period:
            return "attn" if i % self.attn_layer_period == self.attn_layer_offset else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return bool(self.num_experts) and (i % self.moe_layer_period == self.moe_layer_period - 1)

    def layer_window(self, i: int, seq_len: int) -> int:
        """Effective attention window for layer i (GLOBAL_WINDOW = full)."""
        if self.local_global_period:
            return self.local_window if (i % self.local_global_period) < (self.local_global_period - 1) else GLOBAL_WINDOW
        if self.sliding_window:
            return self.sliding_window
        return GLOBAL_WINDOW

    def layer_rope_theta(self, i: int) -> float:
        if self.local_global_period and self.local_rope_theta:
            is_local = (i % self.local_global_period) < (self.local_global_period - 1)
            return self.local_rope_theta if is_local else self.rope_theta
        return self.rope_theta

    @property
    def uniform_stack(self) -> bool:
        """True if every layer has the same pytree structure (scan over L)."""
        if self.family == "hybrid":
            return False
        if self.num_experts and self.moe_layer_period != 1:
            return False
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d = self.d_model
        n = 0
        if self.embed_inputs:
            n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for i in range(self.num_layers):
            if self.layer_kind(i) == "attn":
                hd = self.head_dim
                n += d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads
                n += hd * self.num_heads * d
            else:
                di, g, ns = self.d_inner, self.ssm_num_groups, self.ssm_state_dim
                n += d * (2 * di + 2 * g * ns + self.ssm_num_heads) + di * d
            if self.family == "ssm":
                continue  # mamba2: mixer only
            if self.layer_is_moe(i):
                mult = 3 if self.mlp_kind == "swiglu" else 2
                n += self.num_experts * mult * d * self.moe_d_ff + d * self.num_experts
                if self.dense_residual:
                    n += (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
            else:
                n += (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only) — for 6ND."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2) if self.embed_inputs else 0
        for i in range(self.num_layers):
            if self.layer_kind(i) == "attn":
                hd = self.head_dim
                n += d * hd * (self.num_heads + 2 * self.num_kv_heads) + hd * self.num_heads * d
            else:
                di, g, ns = self.d_inner, self.ssm_num_groups, self.ssm_state_dim
                n += d * (2 * di + 2 * g * ns + self.ssm_num_heads) + di * d
            if self.family == "ssm":
                continue
            mult = 3 if self.mlp_kind == "swiglu" else 2
            if self.layer_is_moe(i):
                n += self.experts_per_token * mult * d * self.moe_d_ff + d * self.num_experts
                if self.dense_residual:
                    n += mult * d * self.d_ff
            else:
                n += mult * d * self.d_ff
        return n

    # --- reduced config for CPU smoke tests ---------------------------------
    def reduced(self) -> "ArchConfig":
        """Same family/topology, tiny dims — one forward/train step on CPU."""
        period = max(self.attn_layer_period, self.local_global_period,
                     self.moe_layer_period, 1)
        layers = max(2, min(2 * period, 8 if period == 1 else 2 * period))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=96 if self.num_experts else 0,
            dispatch_groups=2,
            ssm_state_dim=16 if self.ssm_state_dim else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
            sliding_window=8 if self.sliding_window else 0,
            local_window=8 if self.local_window else 0,
            num_microbatches=1,
            dtype="float32",
        )


# Fields of the port's ArchConfig that the reference's has not, each with the
# default that keeps every registered architecture as the reference has it
# (granite-4.0-h sets them from its configuration file).
PORT_ONLY_FIELDS = {
    "moe_dropless": False,
    "position_embedding": "rope",
    "attention_multiplier": 0.0,
    "embedding_multiplier": 1.0,
    "residual_multiplier": 1.0,
    "logits_scaling": 1.0,
}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) — the DESIGN.md §5 applicability matrix."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "524k decode needs sub-quadratic attention (full-attention arch)"
    if shape.name == "long_500k" and cfg.local_global_period:
        return False, "global layers are full attention; arch context capped at 128k"
    return True, ""
