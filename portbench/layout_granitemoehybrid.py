"""The parameter tree of granite-4.0-h (``model_type`` ``granitemoehybrid``)
as the program's ``Model.forward`` takes it, and the weight rules of the
leaves ``weights.RULES`` lacks.

The program runs the configuration as its hybrid stack: super-blocks of
``attn_layer_period`` (10) sub-layers ``sub0`` … ``sub9``, sub-layer 5 an
attention layer and the rest Mamba-2 mixers, every sub-layer's FFN the MoE
(router, the expert stacks ``we_gate`` / ``we_up`` (E, d, f) and
``we_down`` (E, f, d), and the shared expert under ``dense``).  Embeddings
are tied: there is no ``head``.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.weights import Spec

__all__ = ["RULES", "layout"]


def _fan_in_mid(t: torch.Tensor) -> None:
    """An expert stack (E, fan-in, fan-out): N(0, 1/fan_in) along axis 1."""
    t.mul_(t.shape[1] ** -0.5)


def _fan_in(t: torch.Tensor) -> None:
    t.mul_(t.shape[0] ** -0.5)


RULES = {
    "router": ("normal", _fan_in),
    "we_gate": ("normal", _fan_in_mid),
    "we_up": ("normal", _fan_in_mid),
    "we_down": ("normal", _fan_in_mid),
}


def _mixer(config: Dict, dt) -> Dict:
    d = config["hidden_size"]
    di = config["mamba_expand"] * d
    gn = config["mamba_n_groups"] * config["mamba_d_state"]
    h, f32 = di // config["mamba_d_head"], torch.float32
    return {"wz": Spec((d, di), dt), "wx": Spec((d, di), dt),
            "wb": Spec((d, gn), dt), "wc": Spec((d, gn), dt),
            "wdt": Spec((d, h), dt), "dt_bias": Spec((h,), f32),
            "a_log": Spec((h,), f32), "d_skip": Spec((h,), f32),
            "conv_w": Spec((config["mamba_d_conv"], di + 2 * gn), dt),
            "conv_b": Spec((di + 2 * gn,), dt),
            "norm": {"scale": Spec((di,), dt)}, "wo": Spec((di, d), dt)}


def _attention(config: Dict, dt) -> Dict:
    d, hd = config["hidden_size"], config["head_dim"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    return {"wq": Spec((d, hq * hd), dt), "wk": Spec((d, hkv * hd), dt),
            "wv": Spec((d, hkv * hd), dt), "wo": Spec((hq * hd, d), dt)}


def _moe(config: Dict, dt) -> Dict:
    d, f = config["hidden_size"], config["intermediate_size"]
    e, fs = config["num_local_experts"], config["shared_intermediate_size"]
    return {"router": Spec((d, e), torch.float32),
            "we_gate": Spec((e, d, f), dt), "we_up": Spec((e, d, f), dt),
            "we_down": Spec((e, f, d), dt),
            "dense": {"w_gate": Spec((d, fs), dt), "w_up": Spec((d, fs), dt),
                      "w_down": Spec((fs, d), dt)}}


def layout(config: Dict) -> Dict:
    d, dt = config["hidden_size"], getattr(torch, config["torch_dtype"])
    period, kinds = config["attn_layer_period"], config["layer_types"]
    if len(kinds) != config["num_hidden_layers"] \
            or len(kinds) % period:
        raise ValueError(f"{config['name']}: {len(kinds)} layer types for "
                         f"{config['num_hidden_layers']} layers in periods "
                         f"of {period}")
    norm = {"scale": Spec((d,), dt)}

    def block(kind):
        mixer = _attention(config, dt) if kind == "attention" \
            else _mixer(config, dt)
        return {"norm1": norm, "mixer": mixer, "norm2": norm,
                "ffn": _moe(config, dt)}

    stack = [{f"sub{j}": block(kinds[i + j]) for j in range(period)}
             for i in range(0, len(kinds), period)]
    return {"stack": stack, "final_norm": norm,
            "embed": Spec((config["vocab_size"], d), dt)}
