"""Mixture-of-Experts FFN with sort-based, capacity-grouped dispatch.

Token copies are sorted by assigned expert, packed into a static-capacity
(E, C, d) buffer, run through the grouped expert FFN (the BLAS seam's
registered ``moe_expert_ffn`` descriptor: on the kernel path three launches
of the batched GEMM kernel, experts as the batch) and gathered back
weighted by the router gates.  The twin of the reference's
``src/repro/models/moe.py``.

On one card there is no mesh: ``moe_dispatch="auto"`` takes the grouped
path, as the reference does with no ambient mesh; its expert-parallel
``shard_map`` form and the sharding constraints (the identity on one
device) arrive with the distributed layer.

Three decisions keep the port's answers those of the reference, and its
repeated runs equal:

* the sorts are stable (``jnp.argsort``'s default), so the rank within an
  expert, and with it which copies drop at capacity, is the reference's;
* top-k breaks ties toward the lower expert index, as ``lax.top_k`` does
  (a stable descending sort, not ``torch.topk``);
* the unpack is a gather followed by a sum over each token's k copies in
  a fixed order (ascending expert id, the order of the sorted copies the
  reference scatter-adds in), never an atomic scatter-add, whose order on
  the card changes from run to run.  The pack writes each kept copy to
  its own slot (dropped copies to one spare zero row), which is exact.

Each eager dispatch writes a :class:`MoEStepTrace` and the
``moe.tokens_routed`` / ``moe.tokens_dropped{expert=}`` counters.  The
port's layer loop is eager, so every MoE layer of a forward or decode step
keeps these books and reads its (G, E) histogram back to the host (the
reference's jitted scans write none).

Arctic's "dense residual" variant runs a standard dense FFN in parallel
and sums the outputs.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blas
from repro_torch.models import layers as L
from repro_torch.obs import metrics as _metrics

__all__ = [
    "MoEStepTrace",
    "expert_capacity",
    "init_moe",
    "last_moe_step",
    "moe_ffn",
    "moe_ffn_placed",
    "moe_step_trace",
]


@dataclasses.dataclass(frozen=True)
class MoEStepTrace:
    """One eager MoE dispatch step's routing outcome: per-expert routed and
    dropped copy counts, the capacity they were clamped to, and the step's
    ``drop_rate``."""

    counts: Tuple[int, ...]     # routed token copies per expert
    capacity: int               # per-(group,expert) slot clamp
    dropped: Tuple[int, ...]    # copies past capacity, per expert
    tokens_routed: int
    tokens_dropped: int
    drop_rate: float            # tokens_dropped / tokens_routed


_MOE_STEPS: collections.deque = collections.deque(maxlen=256)


def last_moe_step() -> Optional[MoEStepTrace]:
    """The most recent MoE step record (None before any dispatch)."""
    return _MOE_STEPS[-1] if _MOE_STEPS else None


def moe_step_trace() -> List[MoEStepTrace]:
    """Recent MoE step records, oldest first (bounded window)."""
    return list(_MOE_STEPS)


def _note_moe_step(counts: torch.Tensor, cap: int) -> None:
    """Record the route/pack histogram and the dropped-token books.

    ``counts`` is the per-(group,)expert histogram; reading it back to the
    host waits for the device (one sync per MoE layer)."""
    c = np.atleast_2d(counts.cpu().numpy().astype(np.int64))   # (G, E)
    hist = c.sum(axis=0)
    dropped = np.maximum(c - int(cap), 0).sum(axis=0)
    routed = int(hist.sum())
    tot_drop = int(dropped.sum())
    _MOE_STEPS.append(MoEStepTrace(
        counts=tuple(int(v) for v in hist),
        capacity=int(cap),
        dropped=tuple(int(v) for v in dropped),
        tokens_routed=routed,
        tokens_dropped=tot_drop,
        drop_rate=(tot_drop / routed) if routed else 0.0,
    ))
    _metrics.counter("moe.tokens_routed").inc(routed)
    for e_i, d_i in enumerate(dropped):
        if d_i:
            _metrics.counter("moe.tokens_dropped", expert=str(e_i)).inc(
                int(d_i))


def expert_capacity(num_tokens: int, cfg) -> int:
    """Static per-expert slot count (ceil to a multiple of 8)."""
    ideal = num_tokens * cfg.experts_per_token / cfg.num_experts
    cap = int(math.ceil(ideal * cfg.capacity_factor / 8.0) * 8)
    return max(cap, 8)


def init_moe(gen: torch.Generator, cfg, dtype, *, device):
    """Router (d, E) in fp32 and the expert stacks (E, d, f), (E, f, d) in
    ``dtype`` with the reference's distributions, one tensor at a time
    (an expert stack is drawn in fp32 and cast once); arctic's parallel
    dense FFN under ``"dense"``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    scale = d ** -0.5

    def stack(shape, s):
        w = torch.randn(*shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(s).to(dtype)

    p = {
        "router": L.init_dense(gen, d, e, torch.float32, device=device,
                               scale=scale),
        "we_gate": stack((e, d, f), scale),
        "we_up": stack((e, d, f), scale),
        "we_down": stack((e, f, d), f ** -0.5),
    }
    if cfg.dense_residual:
        p["dense"] = L.init_mlp(gen, d, cfg.d_ff, dtype, cfg.mlp_kind,
                                device=device)
    return p


def _top_k_gates(logits: torch.Tensor, k: int):
    """Softmax-then-topk router (qwen/jamba convention), renormalized.  Ties
    go to the lower expert index, as ``lax.top_k`` orders them."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx


def _router(p, xf: torch.Tensor, cfg):
    """Logits, renormalized top-k gates, and the Switch-style aux loss.

    Router math stays fp32; the returned gates are cast to the payload
    dtype, as in the reference."""
    k, e = cfg.experts_per_token, cfg.num_experts
    logits = blas.matmul(xf, p["router"].to(xf.dtype), out_dtype=torch.float32)
    gates, idx = _top_k_gates(logits, k)
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux_loss = e * torch.sum(me * ce)
    return gates.to(xf.dtype), idx, aux_loss


def _expert_mlp(p, eb: torch.Tensor) -> torch.Tensor:
    """(E, ..., d) -> (E, ..., d): one seam dispatch for the whole grouped
    expert FFN (gate/up/silu/down)."""
    return blas.moe_expert_ffn(eb, p["we_gate"], p["we_up"], p["we_down"])


def _combine(contrib: torch.Tensor, order: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """Sum each token's k weighted expert outputs in a fixed order.

    ``contrib`` (G, t·k, d) is in sorted-copy order and ``order`` (G, t·k)
    the stable sort's permutation (sorted position -> flat copy index
    token·k + j).  The reference scatter-adds the sorted copies into a
    zero buffer, which for one token adds its copies by ascending expert
    id; the same adds run here over a gather, so the sum is the same on
    every run (no atomics).  Returns (G, t, d)."""
    g_ = order.shape[0]
    gi = torch.arange(g_, device=order.device)[:, None]
    pos = torch.arange(t * k, device=order.device).expand(g_, t * k)
    inv = torch.empty_like(order)
    inv[gi, order] = pos                                 # copy -> sorted pos
    # A token's copies in sorted order: its k sorted positions, ascending.
    tok_pos = torch.sort(inv.reshape(g_, t, k), dim=-1).values
    parts = contrib[gi, tok_pos.reshape(g_, t * k)].reshape(g_, t, k, -1)
    out = torch.zeros_like(parts[:, :, 0])
    for j in range(k):
        out = out + parts[:, :, j]
    return out


def _moe_global(p, xf, gates, idx, cfg):
    """Mesh-wide sort dispatch — the naive baseline."""
    t, d = xf.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    cap = expert_capacity(t, cfg)

    flat_expert = idx.reshape(t * k)
    flat_gate = gates.reshape(t * k)
    order = torch.argsort(flat_expert, stable=True)          # GLOBAL sort
    sorted_expert = flat_expert[order]
    sorted_token = order // k
    sorted_gate = flat_gate[order]

    counts = torch.bincount(flat_expert, minlength=e)
    _note_moe_step(counts, cap)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=xf.device) - starts[sorted_expert]
    keep = rank < cap
    slot = torch.where(keep, sorted_expert * cap + rank,
                       torch.full_like(rank, e * cap))

    # Kept copies own their slots; dropped ones all write zeros to the
    # spare row e·cap.
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[sorted_token] * keep[:, None].to(xf.dtype)
    y = _expert_mlp(p, buf[: e * cap].reshape(e, cap, d))
    y_flat = torch.cat([y.reshape(e * cap, d),
                        torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    contrib = y_flat[slot] * (sorted_gate * keep).to(y.dtype)[:, None]
    return _combine(contrib[None], order[None], t, k)[0]


def _dispatch_groups(t: int, cfg) -> int:
    """Largest power-of-two group count from ``cfg.dispatch_groups`` that
    divides ``t`` (shared by the grouped path and the placement-aware
    wrapper so their capacity arithmetic never drifts)."""
    g_ = cfg.dispatch_groups if cfg.dispatch_groups > 0 else 1
    while t % g_:
        g_ //= 2
    return max(g_, 1)


def _moe_grouped(p, xf, gates, idx, cfg, expert_fn=None):
    """Group-local dispatch: tokens split into G groups; the sort, the
    rank / capacity books and both data moves are per group.

    ``expert_fn`` (default :func:`_expert_mlp`) is the grouped-FFN seam
    call; the placement-aware path substitutes a placed dispatch with the
    same lowering, so the output is bit for bit the same either way."""
    t, d = xf.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    g_ = _dispatch_groups(t, cfg)
    tg = t // g_
    cap_g = expert_capacity(tg, cfg)                      # per-group capacity
    dev = xf.device

    xg = xf.reshape(g_, tg, d)
    flat_expert = idx.reshape(g_, tg * k)
    flat_gate = gates.reshape(g_, tg * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)   # per group
    sorted_expert = torch.gather(flat_expert, -1, order)
    sorted_token = order // k                             # (G, Tg·k)
    sorted_gate = torch.gather(flat_gate, -1, order)

    counts = torch.zeros((g_, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_expert, torch.ones_like(flat_expert))
    _note_moe_step(counts, cap_g)
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = (torch.arange(tg * k, device=dev)[None]
            - torch.gather(starts, -1, sorted_expert))
    keep = rank < cap_g
    # Dropped copies: the reference clamps them onto a real slot and adds
    # zeros there; here they write zeros to a spare row e·Cg, and every
    # kept copy writes its own slot.
    slot = torch.where(keep, sorted_expert * cap_g + rank,
                       torch.full_like(rank, e * cap_g))
    keep_f = keep.to(xf.dtype)

    gi = torch.arange(g_, device=dev)[:, None]
    buf = torch.zeros((g_, e * cap_g + 1, d), dtype=xf.dtype, device=dev)
    buf[gi, slot] = xg[gi, sorted_token] * keep_f[..., None]

    # (G, E·Cg, d) -> (E, G, Cg, d): experts lead.  The sharding
    # constraints the reference places around this transpose are the
    # identity on one device.
    ebuf = buf[:, : e * cap_g].reshape(g_, e, cap_g, d).transpose(0, 1)
    y = (expert_fn or _expert_mlp)(p, ebuf)               # (E, G, Cg, d)
    y_flat = y.transpose(0, 1).reshape(g_, e * cap_g, d)

    slot_c = torch.clamp(slot, max=e * cap_g - 1)
    w = (sorted_gate * keep).to(y_flat.dtype)
    contrib = y_flat[gi, slot_c] * w[..., None]
    out = _combine(contrib, order, tg, k)                 # (G, Tg, d)
    return out.reshape(t, d)


def moe_ffn(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Static-capacity dispatch.

    Dispatch mode (``cfg.moe_dispatch``):
      "auto"    — the grouped path (one card has no mesh);
      "grouped" — group-local dispatch;
      "global"  — one sort over every token (the naive baseline).
    """
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    mode = cfg.moe_dispatch
    if mode not in ("auto", "grouped", "global"):
        raise ValueError(f"unknown moe_dispatch {mode!r}")
    gates, idx, aux_loss = _router(p, xf, cfg)
    if mode == "global":
        out = _moe_global(p, xf, gates, idx, cfg)
    else:
        out = _moe_grouped(p, xf, gates, idx, cfg)
    if cfg.dense_residual:
        out = out + L.mlp_apply(p["dense"], xf, cfg.mlp_kind)
    return out.reshape(b, s, d), aux_loss


def _host_histogram(idx: torch.Tensor, e: int) -> List[int]:
    """Per-expert routed-copy counts as host ints (placement decisions are
    host-side)."""
    flat = idx.reshape(-1).cpu().numpy()
    return [int(v) for v in np.bincount(flat, minlength=e)[:e]]


def _expert_mlp_placed(p, eb, plan):
    """The grouped-FFN seam call with per-expert placed accounting: same
    op, same lowering, one dispatch — only the launch bookkeeping fans out
    (``dispatch_placed(..., placement=plan)``)."""
    out, _ = blas.moe_expert_ffn_placed(
        eb, p["we_gate"], p["we_up"], p["we_down"], placement=plan)
    return out


def moe_ffn_placed(
    p, x: torch.Tensor, cfg, policy=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Placement-aware grouped MoE dispatch.  x: (B, S, D) -> (out, aux).

    With ``policy`` (a
    :class:`repro_torch.core.placement.ExpertPlacementPolicy`) attached and
    enabled, the route stage's per-expert token histogram feeds
    ``policy.step`` (hot experts migrate / replicate between modeled
    lanes, charged on the stream clocks) and the grouped-FFN dispatch fans
    out per expert onto the lanes their weight handles live on.  The math
    is the static grouped dispatch verbatim: with or without the policy
    the output equals ``moe_ffn(..., moe_dispatch="grouped")`` bit for
    bit; only the accounting changes.

    The layer's dropped-token books come from the histogram via
    ``_note_moe_step``; the policy's plan is built with ``record=False``
    so the same drop is never counted twice."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, idx, aux_loss = _router(p, xf, cfg)
    expert_fn = None
    if policy is not None and policy.enabled and policy.attached:
        hist = _host_histogram(idx, cfg.num_experts)
        policy.step(hist)
        g_ = _dispatch_groups(b * s, cfg)
        cap = expert_capacity((b * s) // g_, cfg) * g_
        plan = policy.plan(hist, capacity=cap, record=False)

        def expert_fn(pp, eb):
            return _expert_mlp_placed(pp, eb, plan)

    out = _moe_grouped(p, xf, gates, idx, cfg, expert_fn=expert_fn)
    if cfg.dense_residual:
        out = out + L.mlp_apply(p["dense"], xf, cfg.mlp_kind)
    return out.reshape(b, s, d), aux_loss
