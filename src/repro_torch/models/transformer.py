"""Stack assembly: pre-norm residual blocks, looped over layers.

The dense **uniform** stack only: every layer has the same structure.
Parameters are a list of per-layer dicts (the reference stacks them on a
leading (L, …) axis for ``lax.scan``; :func:`repro_torch.convert.params_from_jax`
splits that axis).  Per-layer data (attention window, RoPE theta) is a
Python list the layer loop walks beside the parameters.

The loop is eager, so each layer writes its own trace records with
``count = 1``; the reference traces its scan body once and writes one
record per op with ``count = num_layers``.  Count-weighted totals agree.

MoE, SSM and hybrid stacks, and ``forward_mode="graph"``, raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, GLOBAL_WINDOW
from repro_torch.models import attention as A
from repro_torch.models import layers as L

__all__ = [
    "init_stack",
    "init_decode_cache",
    "decode_stack",
]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.forward_mode == "graph":
        raise NotImplementedError(
            "forward_mode='graph' arrives with the hnp frontend slice")
    if cfg.family == "ssm" or not cfg.uniform_stack:
        raise NotImplementedError(
            f"{cfg.family} stacks (Mamba / hybrid) arrive with the SSM slice")
    if cfg.num_experts:
        raise NotImplementedError("MoE FFNs arrive with the MoE slice")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, dtype, *, device):
    return {
        "norm1": L.init_norm(cfg.d_model, dtype, device=device,
                             kind=cfg.norm_kind),
        "mixer": A.init_attention(gen, cfg, dtype, device=device),
        "norm2": L.init_norm(cfg.d_model, dtype, device=device,
                             kind=cfg.norm_kind),
        "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, cfg.mlp_kind,
                          device=device),
    }


# ---------------------------------------------------------------------------
# per-layer static data (windows / rope thetas)
# ---------------------------------------------------------------------------

def _layer_data(cfg: ArchConfig, seq_len: int) -> Tuple[List[int], List[float]]:
    """Every layer's window (GLOBAL_WINDOW = full) and RoPE theta, with the
    reference's int32 / float32 rounding."""
    windows = [int(min(cfg.layer_window(i, seq_len), GLOBAL_WINDOW))
               for i in range(cfg.num_layers)]
    thetas = [float(np.float32(cfg.layer_rope_theta(i)))
              for i in range(cfg.num_layers)]
    return windows, thetas


# ---------------------------------------------------------------------------
# stack init
# ---------------------------------------------------------------------------

def init_stack(gen: torch.Generator, cfg: ArchConfig, dtype, *,
               device) -> List[Dict[str, Any]]:
    _check_supported(cfg)
    return [_init_block(gen, cfg, dtype, device=device)
            for _ in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# decode cache + one-token decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
                      device) -> Dict[str, torch.Tensor]:
    """KV cache with a leading layer axis: k/v each (L, B, Hkv, S, hd)."""
    _check_supported(cfg)
    eff = cache_len
    if cfg.sliding_window:
        eff = min(cache_len, cfg.sliding_window)  # rolling SWA buffer
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, eff, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _decode_block(p, x, cache_slices, cache_index, cfg, *, window, rope_theta):
    """One layer of single-token decode. Returns (x, new_cache_slices)."""
    h = L.apply_norm(x, p["norm1"], cfg.norm_eps, cfg.norm_kind)
    mix, (k_new, v_new) = A.decode_attention_block(
        p["mixer"], h, (cache_slices["k"], cache_slices["v"]),
        cache_index, cfg, window=window, rope_theta=rope_theta,
    )
    x = x + mix
    h = L.apply_norm(x, p["norm2"], cfg.norm_eps, cfg.norm_kind)
    x = x + L.mlp_apply(p["ffn"], h, cfg.mlp_kind)
    return x, {"k": k_new, "v": v_new}


def decode_stack(params, cache, x, cache_index, cfg: ArchConfig):
    """x: (B, 1, D).  Loops the layers, each writing its slice of the
    stacked cache in place; returns (x, cache)."""
    _check_supported(cfg)
    windows, thetas = _layer_data(cfg, 0)
    for i, lp in enumerate(params):
        csl = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _ = _decode_block(lp, x, csl, cache_index, cfg,
                             window=windows[i], rope_theta=thetas[i])
    return x, cache
