"""Graph-captured block forwards — the dense decoder on lazy ``hnp`` graphs.

``cfg.forward_mode = "graph"`` routes every transformer block through this
module instead of the eager per-op seam calls.  Each block's forward is
built as one ``repro_torch.hnp`` expression graph inside an
``hnp.offload_region()``, so the graph scheduler — not the call order —
decides the launches:

* elementwise epilogues (residual adds) **fuse** into their producer's
  launch — no extra dispatch record, no staging for the chain's
  intermediates;
* attention intermediates **stay device-resident** across the block: each
  launch carries its exact ``resident_fraction``, so a qkv projection
  consumed by the attention launch on the same device never pays the
  host<->device staging region.

Everything heavy dispatches through the same registered ``OffloadOp``
descriptors as the eager path (``qkv_project``, ``attention``,
``mlp_block``, ``matmul``, ``rmsnorm_scale``), so eager and graph forwards
agree per backend.  RoPE runs eagerly between forces; the region shares
residency across those forces.

The reference traces one block under ``lax.scan`` and so writes one
``GraphReport`` per forward; the port's eager layer loop captures one per
layer.  Mamba and MoE blocks arrive with the SSM and MoE slices.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Tuple

import torch

from repro_torch.models import layers as L

__all__ = [
    "LAST_REPORTS",
    "capture_reports",
    "graph_block",
    "graph_ffn",
]

# GraphReports of recently captured blocks, appended at capture time (once
# per block run).  Benchmarks and tests read fusion / batching / staging
# off these; ``capture_reports()`` scopes and clears the list.  Outside a
# capture scope only the most recent reports are kept, so a long-running
# graph-mode process (serving loop) does not accumulate them unboundedly.
LAST_REPORTS: List[Any] = []
_MAX_REPORTS = 64
_CAPTURING = False


def _record_report(report) -> None:
    LAST_REPORTS.append(report)
    if not _CAPTURING and len(LAST_REPORTS) > _MAX_REPORTS:
        del LAST_REPORTS[: -_MAX_REPORTS]


@contextlib.contextmanager
def capture_reports():
    """Collect the GraphReports of every block captured inside the scope."""
    global _CAPTURING
    LAST_REPORTS.clear()
    _CAPTURING = True
    try:
        yield LAST_REPORTS
    finally:
        _CAPTURING = False


def _hnp():
    import repro_torch.hnp as hnp  # lazy: models import without the frontend

    return hnp


def _force(x):
    """Force a LazyArray in place and return its tensor value."""
    return x.block().node.value if hasattr(x, "block") else x


def _graph_norm(xa, p, cfg, kind: str):
    """RMSNorm as the registered ``rmsnorm_scale`` descriptor (one recorded
    host launch, graph-capturable)."""
    if kind != "rmsnorm":
        raise NotImplementedError(
            "layer_norm arrives with the encoder (hubert) configs")
    return _hnp().rmsnorm_scale(xa, p["scale"], eps=cfg.norm_eps)


def _graph_attention(p, h, shape, cfg, positions, window, rope_theta):
    """QKV projection -> RoPE (eager) -> attention -> out projection."""
    hnp = _hnp()
    from repro_torch.models.attention import split_qkv

    if cfg.mrope:
        raise NotImplementedError("M-RoPE arrives with the qwen2-vl config")
    b, s, _ = shape
    qkv = hnp.qkv_project(
        h, p["wq"], p["wk"], p["wv"],
        bq=p.get("bq"), bk=p.get("bk"), bv=p.get("bv"),
    )
    q, k, v = split_qkv(_force(qkv), cfg)  # resident for the region
    rope_theta = rope_theta if rope_theta is not None else cfg.rope_theta
    q = L.rope(q, positions, rope_theta)
    k = L.rope(k, positions, rope_theta)
    out = hnp.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=window,
    )
    o2 = out.transpose(0, 2, 1, 3).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return hnp.matmul(o2, p["wo"])


def _graph_mamba(*args, **kwargs):
    raise NotImplementedError("graph-mode Mamba blocks arrive with the SSM slice")


def _graph_moe(*args, **kwargs):
    raise NotImplementedError("graph-mode MoE FFNs arrive with the MoE slice")


def graph_block(
    p,
    x: torch.Tensor,
    cfg,
    kind: str,
    is_moe: bool,
    *,
    positions,
    window=None,
    rope_theta=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm residual block as a captured ``hnp`` graph.

    Mirrors ``transformer._apply_block`` exactly (same descriptors, same
    math); returns ``(x, aux_loss)``.
    """
    if kind != "attn":
        _graph_mamba()
    if is_moe:
        _graph_moe()
    hnp = _hnp()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with hnp.offload_region(f"{kind}-block") as region:
        _record_report(region.report)
        xa = hnp.array(x)
        h1 = _graph_norm(xa, p["norm1"], cfg, cfg.norm_kind)
        mix = _graph_attention(
            p["mixer"], h1, x.shape, cfg, positions, window, rope_theta
        )
        xres = xa + mix           # residual fuses into the mixer's launch
        h2 = _graph_norm(xres, p["norm2"], cfg, cfg.norm_kind)
        f = hnp.mlp_block(
            h2, p["ffn"]["w_up"], p["ffn"]["w_down"],
            gate=p["ffn"].get("w_gate"),
            b_up=p["ffn"].get("b_up"), b_down=p["ffn"].get("b_down"),
            kind=cfg.mlp_kind,
        )
        out = xres + f            # residual fuses into the mlp launch
        return _force(out), aux


def graph_ffn(p, x: torch.Tensor, cfg, *, residual=None) -> torch.Tensor:
    """Dense FFN alone as a captured graph (decode path: the attention half
    mutates the KV cache eagerly, the FFN is the graph-captured half).

    ``residual`` (the block input, pre-norm) is added as a graph node so it
    fuses into the FFN launch; when None the bare FFN output is returned."""
    hnp = _hnp()
    with hnp.offload_region("ffn-block") as region:
        _record_report(region.report)
        f = hnp.mlp_block(
            hnp.array(x), p["w_up"], p["w_down"], gate=p.get("w_gate"),
            b_up=p.get("b_up"), b_down=p.get("b_down"), kind=cfg.mlp_kind,
        )
        if residual is not None:
            f = hnp.array(residual) + f
        return _force(f)
