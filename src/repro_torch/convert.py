"""Convert the JAX reference's parameters into the port's layout.

The reference's ``Model.init_params`` returns a pytree whose ``"stack"``
leaves carry a leading layer axis (``init_stack`` builds them with
``vmap``, ``src/repro/models/transformer.py``).  The port keeps one dict per
layer, so :func:`params_from_jax` splits that axis.  The caller hands over
numpy arrays (``jax.tree.map(np.asarray, params)``); nothing here imports
JAX.

bf16 converts bit-exactly: ``np.asarray`` of a JAX bf16 array is an
``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects, so its
bits travel as uint16 and are viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a) -> torch.Tensor:
    """One numpy array (bf16 included) -> a CPU tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def _split_layers(stack: Dict[str, Any]) -> List[Dict[str, Any]]:
    leaves: List[np.ndarray] = []
    _tree(stack, leaves.append)
    n = {np.asarray(a).shape[0] for a in leaves}
    if len(n) != 1:
        raise ValueError(f"stack leaves disagree on the layer axis: {sorted(n)}")
    return [_tree(stack, lambda a, i=i: tensor_from_numpy(np.asarray(a)[i]))
            for i in range(n.pop())]


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, Any]:
    """Reference param pytree (numpy leaves) -> port params (CPU tensors):
    the same names, with ``"stack"`` a list of per-layer dicts."""
    out = {k: _tree(v, tensor_from_numpy)
           for k, v in params_np.items() if k != "stack"}
    out["stack"] = _split_layers(params_np["stack"])
    return out
