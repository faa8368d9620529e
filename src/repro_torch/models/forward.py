"""Graph-captured block forwards — dense, MoE and Mamba blocks on lazy
``hnp`` graphs.

``cfg.forward_mode = "graph"`` routes every transformer block through this
module instead of the eager per-op seam calls.  Each block's forward is
built as one ``repro_torch.hnp`` expression graph inside an
``hnp.offload_region()``, so the graph scheduler — not the call order —
decides the launches:

* elementwise epilogues (residual adds) **fuse** into their producer's
  launch — no extra dispatch record, no staging for the chain's
  intermediates;
* independent same-shape projections (a Mamba block's z/x and B/C pairs)
  **batch** into one ``gemm_batched`` launch each;
* intermediates **stay device-resident** across the block: each launch
  carries its exact ``resident_fraction``, so a qkv projection consumed by
  the attention launch on the same device never pays the host<->device
  staging region.

Everything heavy dispatches through the same registered ``OffloadOp``
descriptors as the eager path (``qkv_project``, ``attention``,
``ssd_scan``, ``mlp_block``, ``matmul``, ``rmsnorm_scale``), so eager and
graph forwards agree per backend.  RoPE and the Mamba conv run eagerly
between forces; the region shares residency across those forces.

The reference traces one block under ``lax.scan`` and so writes one
``GraphReport`` per forward; the port's eager layer loop captures one per
layer.  An MoE FFN's sort and scatter are no lazy graph: the block forces
its input and runs ``moe_ffn`` eagerly, then adds the residual as a graph
node, as the reference does.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F

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
    """Norm as a graph node: RMSNorm is the registered ``rmsnorm_scale``
    descriptor (one recorded host launch, graph-capturable); LayerNorm (the
    audio encoder's) runs eagerly on the forced value and is re-wrapped."""
    hnp = _hnp()
    if kind == "rmsnorm":
        return hnp.rmsnorm_scale(xa, p["scale"], eps=cfg.norm_eps)
    return hnp.array(L.layer_norm(_force(xa), p, cfg.norm_eps))


def _graph_attention(p, h, shape, cfg, positions, window, rope_theta):
    """QKV projection -> RoPE / M-RoPE (eager) -> attention -> out
    projection."""
    hnp = _hnp()
    from repro_torch.models.attention import rotate_qk, split_qkv

    b, s, _ = shape
    qkv = hnp.qkv_project(
        h, p["wq"], p["wk"], p["wv"],
        bq=p.get("bq"), bk=p.get("bk"), bv=p.get("bv"),
    )
    q, k, v = split_qkv(_force(qkv), cfg)  # resident for the region
    rope_theta = rope_theta if rope_theta is not None else cfg.rope_theta
    q, k = rotate_qk(q, k, cfg, positions, rope_theta)
    out = hnp.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=window,
    )
    o2 = out.transpose(0, 2, 1, 3).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return hnp.matmul(o2, p["wo"])


def _graph_mamba(p, h, shape, cfg, out_dtype):
    """Projections (z/x and B/C pairs batch into gemm_batched) -> conv
    (eager) -> ``ssd_scan`` with the SiLU gate fused into its launch ->
    gated-norm -> out projection."""
    hnp = _hnp()
    from repro_torch.models.ssm import conv_and_inputs

    b, s, d = shape
    h2 = h.reshape(b * s, d)
    za = hnp.matmul(h2, p["wz"])       # same shape as wx -> one gemm_batched
    xa = hnp.matmul(h2, p["wx"])
    ba = hnp.matmul(h2, p["wb"])       # same shape as wc -> one gemm_batched
    ca = hnp.matmul(h2, p["wc"])
    dta = hnp.matmul(h2, p["wdt"], out_dtype=torch.float32)
    hnp.block_all(za, xa, ba, ca, dta)  # one wave: independent GEMMs batch

    def val3(t):
        return _force(t).reshape(b, s, -1)

    z, xin, b_, c_, dt = val3(za), val3(xa), val3(ba), val3(ca), val3(dta)
    xh, dt_f, a, bg, cg = conv_and_inputs(p, xin, b_, c_, dt, cfg)

    ya = hnp.ssd_scan(
        hnp.array(xh), dt_f, a, bg, cg, p["d_skip"], chunk=cfg.ssm_chunk
    )
    gate = F.silu(z.float())
    hp = (cfg.ssm_num_heads, cfg.ssm_head_dim)
    ya = ya * hnp.array(gate.reshape(b, s, *hp))  # fuses into the ssd launch
    yn = ya.reshape(b, s, cfg.d_inner).astype(out_dtype)
    yn = hnp.rmsnorm_scale(yn, p["norm"]["scale"], eps=cfg.norm_eps)
    return hnp.matmul(yn, p["wo"])


def _graph_moe(p, h, cfg):
    """MoE FFN: the sort/scatter routing is not expressible as a lazy graph,
    so it runs eagerly on the forced activations — its router matmul and
    the whole grouped expert FFN still dispatch through their registered
    descriptors, so the trace stays uniform."""
    from repro_torch.models import moe as M

    return M.moe_ffn(p, _force(h), cfg)


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
    math); returns ``(x, aux_loss)``.  An SSM stack's block is the Mamba
    mixer alone (no second norm, no FFN).
    """
    hnp = _hnp()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with hnp.offload_region(f"{kind}-block") as region:
        _record_report(region.report)
        xa = hnp.array(x)
        h1 = _graph_norm(xa, p["norm1"], cfg, cfg.norm_kind)
        if kind == "attn":
            mix = _graph_attention(
                p["mixer"], h1, x.shape, cfg, positions, window, rope_theta
            )
        else:
            mix = _graph_mamba(p["mixer"], h1, x.shape, cfg, x.dtype)
        xres = xa + mix           # residual fuses into the mixer's launch
        if cfg.family == "ssm":
            return _force(xres), aux
        h2 = _graph_norm(xres, p["norm2"], cfg, cfg.norm_kind)
        if is_moe:
            f, aux = _graph_moe(p["ffn"], h2, cfg)
            return _force(xres + hnp.array(f)), aux
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
