"""AdamW (+ blockwise-int8 moment variant) over the port's param trees.

The reference's hand-rolled optimizer (``src/repro/optim/adamw.py``) with
its defaults (b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1, global-norm
clip 1.0), fp32 moments, and its float32 operations in its order, leaf by
leaf in the reference's leaf order (:mod:`repro_torch.tree`).

``init(params) -> OptState`` and ``update(grads, state, params) ->
(new_params, new_state)`` are functional, as the reference's are: they
return new tensors and leave their arguments untouched.  The step counter
is a 0-dim int32 tensor created on the CPU; the learning rate and bias
corrections of a step are host scalars computed from it.

The 8-bit variant stores both moments as int8 with per-block fp32 scales
(blocks of up to ``QBLOCK`` elements along the last axis), v on a sqrt
scale.  It exists for the largest MoE configs, whose fp32 moments alone
exceed their memory (jamba-1.5-large-398b, arctic-480b select it).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.optim.schedules import constant

__all__ = ["OptState", "QTensor", "QBLOCK", "adamw", "adamw8bit",
           "clip_by_global_norm", "make_optimizer"]

QBLOCK = 256  # quantization block (elements)


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled so their global L2 norm is at most max_norm, the
    norm)``: the sum of squares in fp32, each leaf scaled in fp32 and
    rounded once to its dtype."""
    flat = tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree.tree_map(lambda g: (g.float() * scale.to(g.device)
                                    ).to(g.dtype), grads), gn


def _corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """Adam's bias corrections ``1 - b ** t`` in float32."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return float(1.0 - b1 ** t), float(1.0 - b2 ** t)


def _step(state: OptState) -> Tuple[int, torch.Tensor]:
    step = state.step + 1
    return int(step), step


def _adam_math(p, g, m, v, *, b1, b2, eps, weight_decay, lr_t, c1, c2):
    gf = g.float()
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * torch.square(gf)
    mh = m2 / c1
    vh = v2 / c2
    delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
    return (p.float() - lr_t * delta).to(p.dtype), m2, v2


# ---------------------------------------------------------------------------
# fp32-moment AdamW
# ---------------------------------------------------------------------------

def adamw(
    lr: Callable[[int], float] | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
):
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=tree.tree_map(zeros, params),
                        nu=tree.tree_map(zeros, params))

    def update(grads, state: OptState, params) -> Tuple[Any, OptState]:
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        t, step = _step(state)
        c1, c2 = _corrections(b1, b2, t)
        kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  lr_t=lr_fn(t), c1=c1, c2=c2)
        out = [_adam_math(p, g, m, v, **kw) for p, g, m, v in zip(
            tree.leaves(params), tree.leaves(grads), tree.leaves(state.mu),
            tree.leaves(state.nu))]
        return (tree.unflatten(params, (o[0] for o in out)),
                OptState(step=step,
                         mu=tree.unflatten(params, (o[1] for o in out)),
                         nu=tree.unflatten(params, (o[2] for o in out))))

    return init, update


# ---------------------------------------------------------------------------
# blockwise int8 moments
# ---------------------------------------------------------------------------

class QTensor(NamedTuple):
    q: torch.Tensor       # int8, the moment's shape
    scale: torch.Tensor   # fp32, (..., last_dim / qblock): axis-aligned blocks


def _is_qt(x) -> bool:
    return isinstance(x, QTensor)


def _qblock_for(last_dim: int) -> int:
    """Largest power-of-two block <= QBLOCK dividing the last dim (blocks
    are axis-aligned: the last dim is split, the leaf never flattened)."""
    for cand in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if last_dim % cand == 0:
            return cand
    return 1


def _quantize(x: torch.Tensor) -> QTensor:
    if x.ndim == 0:
        x = x.reshape(1)
    last = x.shape[-1]
    qb = _qblock_for(last)
    g = x.reshape(*x.shape[:-1], last // qb, qb)
    scale = torch.amax(torch.abs(g), dim=-1) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(g / safe[..., None]), -127, 127).to(torch.int8)
    return QTensor(q=q.reshape(x.shape), scale=scale)


def _dequantize(qt: QTensor, shape) -> torch.Tensor:
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    qb = last // qt.scale.shape[-1]
    g = qt.q.reshape(*shape[:-1], last // qb, qb).float()
    return (g * qt.scale[..., None]).reshape(shape)


def adamw8bit(
    lr: Callable[[int], float] | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
):
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params) -> OptState:
        qz = lambda p: _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device))
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=tree.tree_map(qz, params),
                        nu=tree.tree_map(qz, params))

    def update(grads, state: OptState, params) -> Tuple[Any, OptState]:
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
        t, step = _step(state)
        c1, c2 = _corrections(b1, b2, t)
        kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                  lr_t=lr_fn(t), c1=c1, c2=c2)

        def upd(p, g, mq, vq):
            m = _dequantize(mq, p.shape)
            # v is stored on a sqrt scale: int8-linear quantization of the
            # raw second moment distorts small v badly (1/sqrt(v) amplifies).
            v = torch.square(_dequantize(vq, p.shape))
            p2, m2, v2 = _adam_math(p, g, m, v, **kw)
            return p2, _quantize(m2), _quantize(torch.sqrt(v2))

        out = [upd(p, g, m, v) for p, g, m, v in zip(
            tree.leaves(params), tree.leaves(grads),
            tree.leaves(state.mu, _is_qt), tree.leaves(state.nu, _is_qt))]
        return (tree.unflatten(params, (o[0] for o in out)),
                OptState(step=step,
                         mu=tree.unflatten(params, (o[1] for o in out)),
                         nu=tree.unflatten(params, (o[2] for o in out))))

    return init, update


def make_optimizer(cfg, lr):
    """Optimizer factory keyed by ``cfg.optimizer``."""
    if cfg.optimizer == "adamw8bit":
        return adamw8bit(lr)
    return adamw(lr)
