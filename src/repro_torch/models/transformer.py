"""Stack assembly: pre-norm residual blocks, looped over layers.

**Uniform** stacks only: every layer has the same structure — a dense
decoder (attention + FFN), an MoE decoder (attention + the MoE FFN of
``models/moe.py``, arctic's dense residual FFN beside it) or a Mamba-2
SSM stack (``family == "ssm"``: mixer only, no second norm and no FFN).
Parameters are a list of per-layer dicts (the reference stacks them on a
leading (L, …) axis for ``lax.scan``; :func:`repro_torch.convert.params_from_jax`
splits that axis).  Per-layer data (attention window, RoPE theta) is a
Python list the layer loop walks beside the parameters.

The loop is eager, so each layer writes its own trace records with
``count = 1``; the reference traces its scan body once and writes one
record per op with ``count = num_layers``.  Count-weighted totals agree.

``cfg.forward_mode = "graph"`` captures each block of the forward as an
``hnp`` graph (``models/forward.py``), and in decode the dense FFN with the
residual fused into its launch; an MoE FFN runs eagerly in both modes
(its sort and scatter are no graph), as in the reference.  An MoE stack's
forward returns the sum of its layers' router aux losses, as the
reference's scan carries it.  The decode caches (k/v, or the SSM and conv
states) are written in place, layer by layer.  Hybrid stacks (jamba:
Mamba layers beside attention and MoE layers, in period-8 super-blocks)
raise ``NotImplementedError`` naming the jamba slice that brings them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, GLOBAL_WINDOW
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

__all__ = [
    "init_stack",
    "apply_stack",
    "init_decode_cache",
    "decode_stack",
]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.forward_mode not in ("eager", "graph"):
        raise ValueError(f"unknown forward_mode {cfg.forward_mode!r}")
    if not cfg.uniform_stack:
        raise NotImplementedError(
            f"{cfg.family} stacks (Mamba beside attention and MoE layers in "
            f"super-blocks) arrive with the jamba slice")


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, dtype, *, device):
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg.d_model, dtype,
                                              device=device,
                                              kind=cfg.norm_kind)}
    if cfg.layer_kind(0) == "attn":
        p["mixer"] = A.init_attention(gen, cfg, dtype, device=device)
    else:
        p["mixer"] = S.init_mamba(gen, cfg, dtype, device=device)
    if cfg.family != "ssm":
        p["norm2"] = L.init_norm(cfg.d_model, dtype, device=device,
                                 kind=cfg.norm_kind)
        if cfg.layer_is_moe(0):
            p["ffn"] = M.init_moe(gen, cfg, dtype, device=device)
        else:
            p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                  cfg.mlp_kind, device=device)
    return p


def _apply_block(p, x, cfg: ArchConfig, *, positions, window, rope_theta):
    """One pre-norm residual block (training / prefill): attention + FFN
    (dense or MoE), or the Mamba mixer alone for an SSM stack.  Returns
    ``(x, aux_loss)``: the MoE router's loss, else 0."""
    kind = cfg.layer_kind(0)
    is_moe = cfg.layer_is_moe(0)
    if cfg.forward_mode == "graph":
        # Whole-block graph capture: the hnp scheduler fuses elementwise
        # epilogues, batches independent projections and threads residency
        # across the block (models/forward.py).  Same descriptors, same math.
        from repro_torch.models import forward as F

        return F.graph_block(
            p, x, cfg, kind, is_moe,
            positions=positions, window=window, rope_theta=rope_theta,
        )
    h = L.apply_norm(x, p["norm1"], cfg.norm_eps, cfg.norm_kind)
    if kind == "attn":
        x = x + A.attention_block(p["mixer"], h, cfg, positions=positions,
                                  window=window, rope_theta=rope_theta)
    else:
        x = x + S.mamba_block(p["mixer"], h, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        return x, aux
    h = L.apply_norm(x, p["norm2"], cfg.norm_eps, cfg.norm_kind)
    if is_moe:
        f, aux = M.moe_ffn(p["ffn"], h, cfg)
    else:
        f = L.mlp_apply(p["ffn"], h, cfg.mlp_kind)
    return x + f, aux


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
# stack apply (training / prefill)
# ---------------------------------------------------------------------------

def apply_stack(params, x, cfg: ArchConfig, *, positions):
    """x: (B, S, D); positions: (B, S) int.  Loops the layers, each with its
    window and RoPE theta; returns ``(x, aux_loss)`` — the sum of the
    layers' MoE router losses in layer order (0 for a dense or SSM
    stack)."""
    _check_supported(cfg)
    windows, thetas = _layer_data(cfg, x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params):
        x, a = _apply_block(lp, x, cfg, positions=positions,
                            window=windows[i], rope_theta=thetas[i])
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# decode cache + one-token decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
                      device) -> Dict[str, torch.Tensor]:
    """Decode cache with a leading layer axis: k/v each (L, B, Hkv, S, hd)
    for a dense stack; for an SSM stack the states ``ssm`` (L, B, H, N, P)
    in fp32 and ``conv`` (L, B, K−1, F) in ``dtype``."""
    _check_supported(cfg)
    if cfg.family == "ssm":
        ssm_shape, conv_shape = S.mamba_state_shapes(cfg, batch)
        n = cfg.num_layers
        return {
            "ssm": torch.zeros((n, *ssm_shape), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((n, *conv_shape), dtype=dtype, device=device),
        }
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
    if cfg.family == "ssm":
        mix, (ssm_new, conv_new) = S.decode_mamba_block(
            p["mixer"], h, (cache_slices["ssm"], cache_slices["conv"]), cfg)
        return x + mix, {"ssm": ssm_new, "conv": conv_new}
    mix, (k_new, v_new) = A.decode_attention_block(
        p["mixer"], h, (cache_slices["k"], cache_slices["v"]),
        cache_index, cfg, window=window, rope_theta=rope_theta,
    )
    x = x + mix
    h = L.apply_norm(x, p["norm2"], cfg.norm_eps, cfg.norm_kind)
    if cfg.layer_is_moe(0):
        # Eager in both modes, as the reference decodes an MoE layer.
        f, _ = M.moe_ffn(p["ffn"], h, cfg)
        return x + f, {"k": k_new, "v": v_new}
    if cfg.forward_mode == "graph":
        # Decode's graph half: the attention mutates the cache eagerly, the
        # dense FFN is captured (residual fused into its launch).
        from repro_torch.models import forward as F

        return F.graph_ffn(p["ffn"], h, cfg, residual=x), \
            {"k": k_new, "v": v_new}
    x = x + L.mlp_apply(p["ffn"], h, cfg.mlp_kind)
    return x, {"k": k_new, "v": v_new}


def decode_stack(params, cache, x, cache_index, cfg: ArchConfig):
    """x: (B, 1, D).  Loops the layers, each writing its slice of the
    stacked cache in place; returns (x, cache)."""
    _check_supported(cfg)
    windows, thetas = _layer_data(cfg, 0)
    for i, lp in enumerate(params):
        csl = {name: buf[i] for name, buf in cache.items()}
        x, _ = _decode_block(lp, x, csl, cache_index, cfg,
                             window=windows[i], rope_theta=thetas[i])
    return x, cache
