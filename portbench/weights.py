"""Weights made on the card from the seed, in a few large calls.

The tree's layout (names, shapes, dtypes) is the one the program's
``Model.forward`` takes, written out here from the configuration file for
each family (:func:`layout`; a test holds it to the program's own parameter
specs).  Working it out from the program's specs on meta tensors would cost
every run the import of torch's meta machinery, seconds of set-up.  Every
leaf is a view into one flat buffer per dtype, each leaf starting on a
256-byte boundary; the buffers are filled by a handful of ``randn`` / ``rand``
calls on a generator on the card, and each leaf is then scaled in place by
the rule for its name (:data:`RULES`; a family brought in a module of its own
adds rules for its own leaves, :func:`rules`).  The same seed gives the
same tree.
"""

from __future__ import annotations

import importlib
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

__all__ = ["RULES", "Spec", "layout", "make_params", "rules"]


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def numel(self) -> int:
        return math.prod(self.shape)

_ALIGN = 256                     # bytes
_FILL_CHUNK = 1 << 30            # elements a randn call


def _fan_in(t: torch.Tensor) -> None:
    t.mul_(t.shape[0] ** -0.5)


def _embed(t: torch.Tensor) -> None:
    t.mul_(t.shape[1] ** -0.5)


def _near_one(t: torch.Tensor) -> None:
    t.mul_(0.1).add_(1.0)


def _times(s: float) -> Callable[[torch.Tensor], None]:
    return lambda t: t.mul_(s)


def _a_log(t: torch.Tensor) -> None:
    """From uniform [0, 1): log A with A uniform in [1, 16)."""
    t.mul_(15.0).add_(1.0).log_()


def _dt_bias(t: torch.Tensor) -> None:
    """From uniform [0, 1): the inverse softplus of dt, with dt
    log-uniform in [1e-3, 1e-1) (Mamba-2's initialisation)."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(t * (hi - lo) + lo).clamp_min(1e-4)
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


# leaf name -> (draw, rule): "normal" leaves start N(0, 1), "uniform" ones
# U[0, 1).  Dense weights are (in, out): N(0, 1/fan_in).
RULES: Dict[str, Tuple[str, Callable[[torch.Tensor], None]]] = {
    **{name: ("normal", _fan_in) for name in (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head",
        "wz", "wx", "wb", "wc", "wdt")},
    "embed": ("normal", _embed),
    "scale": ("normal", _near_one),
    "d_skip": ("normal", _near_one),
    "conv_w": ("normal", _times(0.2)),
    "conv_b": ("normal", _times(0.1)),
    "a_log": ("uniform", _a_log),
    "dt_bias": ("uniform", _dt_bias),
}


def _dense_decoder(config: Dict) -> Dict:
    from portbench.work import padded_vocab

    d, dt = config["hidden_size"], getattr(torch, config["torch_dtype"])
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // hq
    ff, v = config["intermediate_size"], padded_vocab(config)
    norm = {"scale": Spec((d,), dt)}
    layer = {"norm1": norm,
             "mixer": {"wq": Spec((d, hq * hd), dt),
                       "wk": Spec((d, hkv * hd), dt),
                       "wv": Spec((d, hkv * hd), dt),
                       "wo": Spec((hq * hd, d), dt)},
             "norm2": norm,
             "ffn": {"w_gate": Spec((d, ff), dt), "w_up": Spec((d, ff), dt),
                     "w_down": Spec((ff, d), dt)}}
    return {"stack": [layer] * config["num_hidden_layers"],
            "final_norm": norm, "embed": Spec((v, d), dt),
            "head": Spec((d, v), dt)}


def _mamba2(config: Dict) -> Dict:
    from portbench.work import padded_vocab

    d, dt = config["d_model"], getattr(torch, config["torch_dtype"])
    di = config["expand"] * d
    gn = config["ngroups"] * config["d_state"]
    h, f32 = di // config["headdim"], torch.float32
    mixer = {"wz": Spec((d, di), dt), "wx": Spec((d, di), dt),
             "wb": Spec((d, gn), dt), "wc": Spec((d, gn), dt),
             "wdt": Spec((d, h), dt), "dt_bias": Spec((h,), f32),
             "a_log": Spec((h,), f32), "d_skip": Spec((h,), f32),
             "conv_w": Spec((config["d_conv"], di + 2 * gn), dt),
             "conv_b": Spec((di + 2 * gn,), dt),
             "norm": {"scale": Spec((di,), dt)}, "wo": Spec((di, d), dt)}
    return {"stack": [{"norm1": {"scale": Spec((d,), dt)}, "mixer": mixer}]
            * config["n_layer"],
            "final_norm": {"scale": Spec((d,), dt)},
            "embed": Spec((padded_vocab(config), d), dt)}


_LAYOUTS = {"dense_decoder": _dense_decoder, "mamba2": _mamba2}


def layout(config: Dict) -> Dict:
    """The parameter tree ``Model.forward`` takes for ``config``, with a
    :class:`Spec` at each leaf.  A family that is not here adds a module
    ``layout_<family>.py`` beside this one with a ``layout(config)``."""
    fn = _LAYOUTS.get(config["family"])
    if fn is None:
        fn = importlib.import_module(
            f"portbench.layout_{config['family']}").layout
    return fn(config)


def rules(config: Dict) -> Dict:
    """The weight rules for ``config``'s leaves: :data:`RULES`, and beside
    them the ``RULES`` of a family's ``layout_<family>.py`` where it has
    any (a leaf name in both takes the family's rule)."""
    if config["family"] in _LAYOUTS:
        return RULES
    own = getattr(importlib.import_module(
        f"portbench.layout_{config['family']}"), "RULES", {})
    return {**RULES, **own}


def _leaves(tree, path=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, values: Dict[tuple, torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def make_params(specs, seed: int, device, rules: Dict = RULES) -> Dict:
    """A tree shaped like ``specs`` (:class:`Spec` leaves, as
    :func:`layout` gives) with the values of ``rules`` (:func:`rules` of
    the configuration), made on ``device`` from ``seed``."""
    leaves = _leaves(specs)
    gen = torch.Generator(device=device)
    groups: Dict[Tuple[torch.dtype, str], List[Tuple[tuple, Any]]] = {}
    for path, spec in leaves:
        name = path[-1]
        if name not in rules:
            raise KeyError(f"no weight rule for leaf {'/'.join(map(str, path))}")
        groups.setdefault((spec.dtype, rules[name][0]), []).append((path, spec))
    values: Dict[tuple, torch.Tensor] = {}
    for i, ((dtype, draw), members) in enumerate(sorted(
            groups.items(), key=lambda kv: (str(kv[0][0]), kv[0][1]))):
        align = _ALIGN // torch.empty((), dtype=dtype).element_size()
        offsets, total = [], 0
        for _, spec in members:
            offsets.append(total)
            total += -(-spec.numel() // align) * align
        flat = torch.empty(total, dtype=dtype, device=device)
        gen.manual_seed((seed ^ (i * 0x9E3779B97F4A7C15)) & ((1 << 63) - 1))
        for start in range(0, total, _FILL_CHUNK):
            part = flat[start:start + _FILL_CHUNK]
            if draw == "normal":
                torch.randn(part.shape, generator=gen, dtype=dtype,
                            device=device, out=part)
            else:
                torch.rand(part.shape, generator=gen, dtype=dtype,
                           device=device, out=part)
        for (path, spec), off in zip(members, offsets):
            leaf = flat[off:off + spec.numel()].view(spec.shape)
            rules[path[-1]][1](leaf)
            values[path] = leaf
    return _rebuild(specs, values)
