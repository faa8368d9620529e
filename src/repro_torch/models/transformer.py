"""Stack assembly: pre-norm residual blocks, looped over layers.

Two stack layouts, as in the reference:

* **uniform** — every layer has the same structure: a dense decoder
  (attention + FFN), an MoE decoder (attention + the MoE FFN of
  ``models/moe.py``, arctic's dense residual FFN beside it), an encoder
  (hubert: LayerNorm, GELU, bidirectional attention) or a Mamba-2 SSM stack
  (``family == "ssm"``: mixer only, no second norm and no FFN).  Parameters
  are a list of per-layer dicts (the reference stacks them on a leading
  (L, …) axis for ``lax.scan``; :func:`repro_torch.convert.params_from_jax`
  splits that axis).  Per-layer data (attention window, RoPE theta: gemma3's
  5:1 local:global pattern, danube's sliding window) is a Python list the
  layer loop walks beside the parameters.
* **hybrid** (jamba, granite-4.0-h) — layers repeat with period P
  (``attn_layer_period``: jamba 8, granite 10): the parameters are a list
  of super-block dicts ``{"sub0": …, "sub{P-1}": …}``.  Sub-layer ``j`` is
  attention when ``j % P == attn_layer_offset`` and Mamba otherwise; its
  FFN is MoE when ``cfg.layer_is_moe(j)`` (jamba every second sub-layer,
  granite every one, with its shared expert as ``dense_residual``'s FFN
  and dropless routing, ``models/moe.py``).  Every attention sub-layer
  runs with no window; it rotates by ``cfg.rope_theta``, as the
  reference's does, unless ``cfg.position_embedding == "nope"``
  (granite: no position embedding, softmax scale
  ``cfg.attention_multiplier``; ``models/attention.py``).

Each residual branch is scaled by ``cfg.residual_multiplier`` before its
add, in prefill and decode alike, where it is not 1 (granite: 0.22;
:func:`_residual`); at 1 nothing more is launched.  The embedding's and the
logits' multipliers are ``models/model.py``'s.  ``forward_mode="graph"``
refuses a configuration that sets any of these fields
(``configs/base.py::PORT_ONLY_FIELDS``): the graph captures the
reference's block, which has none of them.

The loop is eager, so each layer writes its own trace records with
``count = 1``; the reference traces its scan body once and writes one
record per op with ``count = num_layers`` (uniform) or ``num_layers / P``
(hybrid, per sub-layer).  Count-weighted totals agree.

``cfg.forward_mode = "graph"`` captures each block of the forward as an
``hnp`` graph (``models/forward.py``), and in a uniform decode the dense
FFN with the residual fused into its launch; an MoE FFN runs eagerly in
both modes (its sort and scatter are no graph), and a hybrid decode keeps
every FFN eager, as the reference does.  The forward returns the sum of the
MoE router losses in layer order (0 without MoE layers).  The decode caches
(k/v, the SSM and conv states) are written in place, layer by layer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, GLOBAL_WINDOW, PORT_ONLY_FIELDS
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.obs.spans import measured

__all__ = [
    "init_stack",
    "apply_stack",
    "init_decode_cache",
    "decode_stack",
]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.forward_mode not in ("eager", "graph"):
        raise ValueError(f"unknown forward_mode {cfg.forward_mode!r}")
    if cfg.forward_mode == "graph":
        changed = sorted(f for f, default in PORT_ONLY_FIELDS.items()
                         if getattr(cfg, f) != default)
        if changed:
            raise ValueError(
                f"{cfg.name}: forward_mode='graph' captures the reference's "
                f"block, which has no {', '.join(changed)}; run this "
                f"configuration with forward_mode='eager'")


def _residual(x, f, cfg: ArchConfig):
    """``x + f``, the branch scaled by ``cfg.residual_multiplier`` first
    (granite-4.0-h; at 1.0 nothing more is launched)."""
    rm = cfg.residual_multiplier
    return x + (f if rm == 1.0 else f * rm)


def _period(cfg: ArchConfig) -> int:
    """Sub-layers per super-block of a hybrid stack."""
    return cfg.attn_layer_period or cfg.moe_layer_period


def _decode_period(cfg: ArchConfig) -> int:
    """The hybrid decode's period: ``attn_layer_period``.  The reference's
    hybrid decode divides by it, so a non-uniform stack without one (MoE
    every k-th layer and no attention period) has no decode there; the
    port raises instead of guessing one."""
    if not cfg.attn_layer_period:
        raise ValueError(
            f"{cfg.name}: a non-uniform stack (moe_layer_period="
            f"{cfg.moe_layer_period}) needs attn_layer_period > 0 to decode; "
            f"the reference's hybrid decode divides by attn_layer_period == 0")
    return cfg.attn_layer_period


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str,
                is_moe: bool, dtype, *, device):
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg.d_model, dtype,
                                              device=device,
                                              kind=cfg.norm_kind)}
    if kind == "attn":
        p["mixer"] = A.init_attention(gen, cfg, dtype, device=device)
    else:
        p["mixer"] = S.init_mamba(gen, cfg, dtype, device=device)
    if cfg.family != "ssm":
        p["norm2"] = L.init_norm(cfg.d_model, dtype, device=device,
                                 kind=cfg.norm_kind)
        if is_moe:
            p["ffn"] = M.init_moe(gen, cfg, dtype, device=device)
        else:
            p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                  cfg.mlp_kind, device=device)
    return p


def _apply_block(p, x, cfg: ArchConfig, kind: str, is_moe: bool, *,
                 positions, window, rope_theta):
    """One pre-norm residual block (training / prefill): attention or the
    Mamba mixer, then the FFN (dense or MoE; none in an SSM stack).
    Returns ``(x, aux_loss)``: the MoE router's loss, else 0.  Under
    ``torch.profiler`` a block is one ``layer:<kind>`` range."""
    with measured("layer", kind):
        if cfg.forward_mode == "graph":
            # Whole-block graph capture: the hnp scheduler fuses
            # elementwise epilogues, batches independent projections and
            # threads residency across the block (models/forward.py).
            # Same descriptors, same math.
            from repro_torch.models import forward as F

            return F.graph_block(
                p, x, cfg, kind, is_moe,
                positions=positions, window=window, rope_theta=rope_theta,
            )
        h = L.apply_norm(x, p["norm1"], cfg.norm_eps, cfg.norm_kind)
        # The mixer's output is a temporary: held in a name, it would stay
        # alive through the FFN below (a (B, S, D) tensor more at the peak).
        if kind == "attn":
            x = _residual(x, A.attention_block(
                p["mixer"], h, cfg, positions=positions, window=window,
                rope_theta=rope_theta), cfg)
        else:
            x = _residual(x, S.mamba_block(p["mixer"], h, cfg), cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "ssm":
            return x, aux
        h = L.apply_norm(x, p["norm2"], cfg.norm_eps, cfg.norm_kind)
        if is_moe:
            f, aux = M.moe_ffn(p["ffn"], h, cfg)
        else:
            f = L.mlp_apply(p["ffn"], h, cfg.mlp_kind)
        return _residual(x, f, cfg), aux


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
    """Per-layer dicts (uniform), or per-super-block dicts of ``sub{j}``
    blocks (hybrid)."""
    _check_supported(cfg)
    if cfg.uniform_stack:
        kind, is_moe = cfg.layer_kind(0), cfg.layer_is_moe(0)
        return [_init_block(gen, cfg, kind, is_moe, dtype, device=device)
                for _ in range(cfg.num_layers)]
    period = _period(cfg)
    return [{f"sub{j}": _init_block(gen, cfg, cfg.layer_kind(j),
                                    cfg.layer_is_moe(j), dtype, device=device)
             for j in range(period)}
            for _ in range(cfg.num_layers // period)]


# ---------------------------------------------------------------------------
# stack apply (training / prefill)
# ---------------------------------------------------------------------------

def apply_stack(params, x, cfg: ArchConfig, *, positions):
    """x: (B, S, D); positions: (B, S) int, or (3, B, S) for M-RoPE.  Loops
    the layers (a hybrid stack: the super-blocks' sub-layers in order), each
    with its window and RoPE theta; returns ``(x, aux_loss)`` — the sum of
    the MoE router losses in layer order (0 for a stack without MoE
    layers)."""
    _check_supported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.uniform_stack:
        kind, is_moe = cfg.layer_kind(0), cfg.layer_is_moe(0)
        windows, thetas = _layer_data(cfg, x.shape[1])
        for i, lp in enumerate(params):
            x, a = _apply_block(lp, x, cfg, kind, is_moe,
                                positions=positions, window=windows[i],
                                rope_theta=thetas[i])
            aux = aux + a
        return x, aux
    for sb in params:
        for j in range(_period(cfg)):
            x, a = _apply_block(sb[f"sub{j}"], x, cfg, cfg.layer_kind(j),
                                cfg.layer_is_moe(j), positions=positions,
                                window=None, rope_theta=cfg.rope_theta)
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# decode cache + one-token decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype, *,
                      device) -> Dict[str, torch.Tensor]:
    """Decode cache with a leading layer axis: k/v each (L, B, Hkv, S, hd)
    for a uniform attention stack (S the window for a sliding-window arch:
    a rolling buffer); for an SSM stack the states ``ssm`` (L, B, H, N, P)
    in fp32 and ``conv`` (L, B, K−1, F) in ``dtype``.  A hybrid stack has
    one attention and P − 1 Mamba sub-layers a super-block: k/v (n_sb, B,
    Hkv, cache_len, hd), no rolling buffer, ``ssm`` (n_sb, P − 1, B, H, N,
    P) in fp32 and ``conv`` (n_sb, P − 1, B, K−1, F)."""
    _check_supported(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    if not cfg.uniform_stack:
        period = _decode_period(cfg)
        n_sb = cfg.num_layers // period
        ssm_shape, conv_shape = S.mamba_state_shapes(cfg, batch)
        kv = (n_sb, batch, hkv, cache_len, hd)
        return {
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "ssm": torch.zeros((n_sb, period - 1, *ssm_shape),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((n_sb, period - 1, *conv_shape), dtype=dtype,
                                device=device),
        }
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
    shape = (cfg.num_layers, batch, hkv, eff, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _decode_block(p, x, cache_slices, cache_index, cfg, *, window, rope_theta):
    """One layer of a uniform stack's single-token decode. Returns (x,
    new_cache_slices)."""
    h = L.apply_norm(x, p["norm1"], cfg.norm_eps, cfg.norm_kind)
    if cfg.family == "ssm":
        mix, (ssm_new, conv_new) = S.decode_mamba_block(
            p["mixer"], h, (cache_slices["ssm"], cache_slices["conv"]), cfg)
        return _residual(x, mix, cfg), {"ssm": ssm_new, "conv": conv_new}
    mix, (k_new, v_new) = A.decode_attention_block(
        p["mixer"], h, (cache_slices["k"], cache_slices["v"]),
        cache_index, cfg, window=window, rope_theta=rope_theta,
    )
    x = _residual(x, mix, cfg)
    h = L.apply_norm(x, p["norm2"], cfg.norm_eps, cfg.norm_kind)
    if cfg.layer_is_moe(0):
        # Eager in both modes, as the reference decodes an MoE layer.
        f, _ = M.moe_ffn(p["ffn"], h, cfg)
        return _residual(x, f, cfg), {"k": k_new, "v": v_new}
    if cfg.forward_mode == "graph":
        # Decode's graph half: the attention mutates the cache eagerly, the
        # dense FFN is captured (residual fused into its launch).
        from repro_torch.models import forward as F

        return F.graph_ffn(p["ffn"], h, cfg, residual=x), \
            {"k": k_new, "v": v_new}
    x = _residual(x, L.mlp_apply(p["ffn"], h, cfg.mlp_kind), cfg)
    return x, {"k": k_new, "v": v_new}


def _decode_super_block(sb, x, csl, cache_index, cfg: ArchConfig):
    """One hybrid super-block of single-token decode: the attention
    sub-layer on the block's k/v, each Mamba sub-layer on its slot ``mi``
    of the block's SSM and conv states (written in place), every FFN eager
    in both modes (as the reference decodes a hybrid stack)."""
    mi = 0
    for j in range(cfg.attn_layer_period):
        sub = sb[f"sub{j}"]
        h = L.apply_norm(x, sub["norm1"], cfg.norm_eps, cfg.norm_kind)
        if cfg.layer_kind(j) == "attn":
            mix, _ = A.decode_attention_block(
                sub["mixer"], h, (csl["k"], csl["v"]), cache_index, cfg,
                rope_theta=cfg.rope_theta)
        else:
            mix, _ = S.decode_mamba_block(
                sub["mixer"], h, (csl["ssm"][mi], csl["conv"][mi]), cfg)
            mi += 1
        x = _residual(x, mix, cfg)
        h = L.apply_norm(x, sub["norm2"], cfg.norm_eps, cfg.norm_kind)
        if cfg.layer_is_moe(j):
            f, _ = M.moe_ffn(sub["ffn"], h, cfg)
        else:
            f = L.mlp_apply(sub["ffn"], h, cfg.mlp_kind)
        x = _residual(x, f, cfg)
    return x


def decode_stack(params, cache, x, cache_index, cfg: ArchConfig):
    """x: (B, 1, D).  Loops the layers (or super-blocks), each writing its
    slice of the stacked cache in place; returns (x, cache)."""
    _check_supported(cfg)
    if not cfg.uniform_stack:
        _decode_period(cfg)
        for i, sb in enumerate(params):
            csl = {name: buf[i] for name, buf in cache.items()}
            x = _decode_super_block(sb, x, csl, cache_index, cfg)
        return x, cache
    windows, thetas = _layer_data(cfg, 0)
    for i, lp in enumerate(params):
        csl = {name: buf[i] for name, buf in cache.items()}
        x, _ = _decode_block(lp, x, csl, cache_index, cfg,
                             window=windows[i], rope_theta=thetas[i])
    return x, cache
