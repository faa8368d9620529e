"""The check's timing code, and the library of ``tools/*_times.py``:
device milliseconds by CUDA events with operands rotated past L2
(:func:`_rotation`, :func:`_time`), each kernel's bytes / FLOPs bound, the
card's name and power limit, and every ``time_*`` the kernels line and the
tools call with any source tree's kernel wrappers.  It also holds the
seeds and shapes those tools read (from ``smoke.shapes``).
"""

from __future__ import annotations

import itertools
import math
import subprocess
import sys

from smoke.common import attn_operands, b_operand, fail
# ARCH, SSM_ARCH, FWD_BATCH, FWD_SEQ, JAMBA_F32_FWD_SEQ and zoo_configs
# are here for the tools.
from smoke.shapes import (ARCH, CONV_MAX_ULPS, CONV_TIME_SHAPES, DANUBE_LONG,
                          DECODE_TIME_SHAPES, F32_FWD_BATCH, F32_FWD_SEQ,
                          F32_SQUARE_NS, FWD_BATCH, FWD_SEQ, GEMMA_LONG,
                          GRANITE_D, GRANITE_EXPERTS, GRANITE_F, GRANITE_ROWS,
                          HBM_BYTES_PER_S, JAMBA_F32_FWD_SEQ, PEAK_FLOPS, SEED,
                          SSM_ARCH, SSM_FWD_BATCH, SSM_FWD_SEQ, ZOO_FWD,
                          f32_forward_gemm_shapes, grouped_counts,
                          moe_expert_shapes, moe_groups, moe_layers,
                          zoo_attention_cases, zoo_configs)


def attn_work(b, hq, hkv, sq, skv, d, causal, window, itemsize):
    """(bytes, flops) of one attention call: q, k, v read once and the
    output written once; 4·D FLOPs per live (query, key) pair."""
    live = 0
    for i in range(sq):
        q_pos = skv - sq + i
        hi = q_pos + 1 if causal else skv
        lo = max(0, q_pos - window + 1) if window is not None else 0
        live += max(0, min(hi, skv) - lo)
    nbytes = itemsize * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
    return float(nbytes), 4.0 * b * hq * live * d


def grouped_operands(gen, k, n):
    """Rows (GRANITE_ROWS, k) sorted by expert, the (E, k, n) stack and the
    (E+1,) int32 offsets of :func:`grouped_counts`, bf16, on the card."""
    import torch

    dev = torch.device("cuda")
    offsets = torch.tensor([0, *itertools.accumulate(grouped_counts())],
                           dtype=torch.int32, device=dev)
    a = torch.randn(GRANITE_ROWS, k, generator=gen, device=dev).to(
        torch.bfloat16)
    b = (torch.randn(GRANITE_EXPERTS, k, n, generator=gen, device=dev)
         * k ** -0.5).to(torch.bfloat16)
    return a, b, offsets


def time_zoo(zoo, randn):
    """Phase 11 at the zoo's shapes: flash attention in bf16 on ``wgmma``
    at D 80 (danube's 1 x 8192 sliding window, hubert's bidirectional 2 x
    512) and at gemma3's windowed 2 x 2048, on the model's
    transposed views, beside SDPA with the same mask (GQA); flash decode
    at D 80 past the rolling buffer's wrap (danube) and on gemma3's long
    step (a local layer's [2977, 4001) and a global layer's [0, 4001))
    beside SDPA; the SSD chunk kernel at jamba's forward shape; the
    batched GEMM at jamba's expert shapes beside ``torch.bmm``.  Returns
    {name: row}."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm_batched
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag

    rows = {}
    layers = {"danube-swa": zoo["danube"].num_layers,
              "hubert-bidir": zoo["hubert"].num_layers,
              "gemma3-local": sum(zoo["gemma3"].layer_window(i, 0) < 1 << 30
                                  for i in range(zoo["gemma3"].num_layers)),
              "jamba/qwen2": None}
    for tag, b, hq, hkv, s, d, causal, window in zoo_attention_cases(zoo):
        if tag != "jamba/qwen2":
            rows[f"flash_attention:{tag}"] = time_zoo_attention(
                flash_attention, randn, b, hq, hkv, s, d, causal, window,
                layers[tag])
    g, dn = zoo["gemma3"], zoo["danube"]
    gb, gs, gi = GEMMA_LONG
    for name, cfg, shapes in (
            ("gemma3", g, [("gemma3-long-local", gb, gs, gi + 1,
                            gi - g.local_window + 1),
                           ("gemma3-long-global", gb, gs, gi + 1)]),
            ("danube", dn, [("danube-long-wrapped", DANUBE_LONG[0],
                             DANUBE_LONG[1], DANUBE_LONG[1])])):
        dec = time_flash_decode(flash_decode, cfg.num_heads,
                                cfg.num_kv_heads, cfg.head_dim, randn,
                                shapes=shapes)
        for tag, row in dec.items():
            rows[f"flash_decode:{tag}"] = row
    j = zoo["jamba"]
    n_mamba = sum(j.layer_kind(i) == "mamba" for i in range(j.num_layers))
    rows["ssd_chunk_diag:jamba-forward"] = time_ssd(
        ssd_chunk_diag, j, randn, batch=ZOO_FWD[0], seq=ZOO_FWD[1],
        launches=n_mamba)
    moe_rows, moe_tot = time_moe_gemms(gemm_batched, j, randn)
    rows["gemm_batched:jamba-experts"] = {"shapes": moe_rows,
                                          "per_path": moe_tot}
    torch.cuda.empty_cache()
    return rows


def time_zoo_attention(flash_attention, randn, b, hq, hkv, s, d, causal,
                       window, launches):
    """Flash attention (any tree's wrapper) in bf16 on the model's
    transposed (B, S, H, D) views over operands rotated past L2: kernel,
    plain version and SDPA with the same mask (GQA) in ms per launch,
    beside the bound, with the routes the timed launches took."""
    import torch

    from repro_torch.kernels.ref import attention_ref

    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, flops = attn_work(b, hq, hkv, s, s, d, causal, window, 2)
    ops = _rotation(lambda: attn_operands(randn, b, hq, hkv, s, s, d, bf16,
                                          True), nbytes)
    pos = torch.arange(s, device="cuda")
    rel = pos[:, None] - pos[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device="cuda")
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    kw = dict(causal=causal, window=window)
    before = dict(flash_attention.route_launches)
    t_k = _time(lambda t: flash_attention(*t, **kw), ops, iters=10)
    took = {r: n - before[r] for r, n in
            flash_attention.route_launches.items() if n != before[r]}
    t_p = _time(lambda t: attention_ref(*t, **kw), ops, iters=3)
    t_l = _time(lambda t: sdpa(*t, attn_mask=mask, enable_gqa=True), ops,
                iters=10)
    return {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": causal,
            "window": window, "dtype": "bfloat16", "routes": took,
            "launches_per_forward": launches, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_l, "library": "SDPA, GQA, the same mask",
            "bound_ms": _bound_ms(nbytes, flops, "bfloat16"),
            "bound_by": _bound_by(nbytes, flops, "bfloat16"),
            "TFLOPs": flops / t_k / 1e9, "vs_library": t_k / t_l}


def time_grouped():
    """The ragged grouped GEMM on phase 10g's operands (GRANITE_ROWS rows
    sorted by expert, :func:`grouped_counts`), gate / up (4096 -> 768, two
    launches a layer) and down (768 -> 4096, one): kernel, plain version
    (``gemm_grouped_ref``, one f32 product an expert) and
    ``torch._grouped_mm`` on the same offsets (None where the installed
    torch lacks it) in ms a launch, beside the bound (the rows, each
    expert's weights and the outputs once; 2·R·k·n FLOPs) and TFLOP/s.
    An expert stack is 0.45 GB, past L2 without a rotation.  Returns
    ``(rows, totals over a layer's launches)``."""
    import torch

    from repro_torch.kernels.gemm import gemm_grouped
    from repro_torch.kernels.ref import gemm_grouped_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    rows = []
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes", "flops",
                         "launches"), 0.0)
    for shape, k, n, count in (("gate/up", GRANITE_D, GRANITE_F, 2),
                               ("down", GRANITE_F, GRANITE_D, 1)):
        a, b, offsets = grouped_operands(gen, k, n)
        t_k = _time(lambda w: gemm_grouped(a, w, offsets), [b], iters=20)
        t_p = _time(lambda w: gemm_grouped_ref(a, w, offsets), [b], iters=3)
        t_l = None
        if grouped_mm is not None:
            ends = offsets[1:].contiguous()
            try:
                t_l = _time(lambda w: grouped_mm(a, w, offs=ends), [b],
                            iters=20)
            except (RuntimeError, TypeError):     # not on this build
                t_l = None
        nbytes = 2.0 * (GRANITE_ROWS * (k + n) + GRANITE_EXPERTS * k * n)
        flops = 2.0 * GRANITE_ROWS * k * n
        rows.append({"shape": shape, "rows": GRANITE_ROWS,
                     "experts": GRANITE_EXPERTS, "k": k, "n": n,
                     "launches_per_layer": count, "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_l,
                     "bound_ms": _bound_ms(nbytes, flops, "bfloat16"),
                     "TFLOPs": flops / t_k / 1e9})
        tot["ms"] += count * t_k
        tot["plain_ms"] += count * t_p
        tot["library_ms"] = (None if t_l is None or tot["library_ms"] is None
                             else tot["library_ms"] + count * t_l)
        tot["bytes"] += count * nbytes
        tot["flops"] += count * flops
        tot["launches"] += count
        del a, b, offsets
        torch.cuda.empty_cache()
    tot["bound_ms"] = _bound_ms(tot["bytes"], tot["flops"], "bfloat16")
    tot["bound_by"] = _bound_by(tot["bytes"], tot["flops"], "bfloat16")
    tot["launches"] = int(tot["launches"])
    return rows, tot


def time_moe_gemms(gemm_batched, moe_cfg, randn):
    """The batched GEMM (any tree's wrapper) at qwen3-moe's four expert
    shapes (``moe_expert_shapes``), bf16, over expert stacks rotated past
    L2 (each stack is 0.2-0.4 GB): kernel, plain version
    (``moe_gemm_ref``) and ``torch.bmm`` in ms per launch beside the bound
    (A, B read once and C written once; 2·m·n·k FLOPs an expert), GB/s and
    the bound's share; and per decode step / forward the totals over its
    launches.  Returns ``(rows, {"decode": {...}, "forward": {...}})``."""
    import torch

    from repro_torch.kernels.ref import moe_gemm_ref

    bf16 = torch.bfloat16
    rows = []
    tot = {path: dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes",
                                "flops", "launches"), 0.0)
           for path in ("decode", "forward")}
    for tag, e, m, k, n, count in moe_expert_shapes(moe_cfg):
        a = randn(e, m, k, dtype=bf16)
        ws = _rotation(lambda: randn(e, k, n, dtype=bf16), e * k * n * 2)
        t_k = _time(lambda w: gemm_batched(a, w), ws, iters=20)
        t_p = _time(lambda w: moe_gemm_ref(a, w), ws, iters=5)
        t_l = _time(lambda w: torch.bmm(a, w), ws, iters=20)
        nbytes = 2.0 * e * (m * k + k * n + m * n)
        flops = 2.0 * e * m * n * k
        bound = _bound_ms(nbytes, flops, "bfloat16")
        rows.append({"shape": tag, "experts": e, "m": m, "k": k, "n": n,
                     "launches": count, "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_l, "library": "torch.bmm",
                     "bound_ms": bound,
                     "bound_by": _bound_by(nbytes, flops, "bfloat16"),
                     "GBps": nbytes / t_k / 1e6, "bound_share": bound / t_k,
                     "TFLOPs": flops / t_k / 1e9})
        t = tot[tag.split(":")[0]]
        for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("bytes", nbytes), ("flops", flops)):
            t[key] += count * v
        t["launches"] += count
        del ws
    for t in tot.values():
        t["bound_ms"] = _bound_ms(t["bytes"], t["flops"], "bfloat16")
        t["bound_by"] = _bound_by(t["bytes"], t["flops"], "bfloat16")
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["vs_library"] = t["ms"] / t["library_ms"]
    # The layout copy before the gate / up GEMMs: the packed (G, E·C, d)
    # buffer transposed to (E, G, C, d) is a view that the expert GEMM's
    # (E, G·C, d) operand cannot alias, so it is copied once a layer.
    e, d = moe_cfg.num_experts, moe_cfg.d_model
    for path, (g, cap) in moe_groups(moe_cfg).items():
        m = g * cap
        bufs = _rotation(lambda: randn(g, e * cap + 1, d, dtype=bf16),
                         g * e * cap * d * 2)
        views = [b[:, : e * cap].reshape(g, e, cap, d).transpose(0, 1)
                 for b in bufs]
        t_c = _time(lambda v: v.reshape(e, m, d), views)
        nbytes = 2.0 * 2 * e * m * d
        tot[path]["layout_copy"] = {
            "ms": t_c, "ms_per_pass": moe_layers(moe_cfg) * t_c,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "GBps": nbytes / t_c / 1e6}
        del bufs, views
    return rows, tot


def time_flash_decode(flash_decode, hq, hkv, d, randn, dtype="bfloat16",
                      shapes=None):
    """Each shape ``(tag, B, S, hi[, lo])`` of ``shapes`` (default
    DECODE_TIME_SHAPES; slots [lo, hi) valid, lo 0 unless given) in
    ``dtype``: ``flash_decode`` (any tree's wrapper), its plain version
    and SDPA (GQA, the same slot mask) in ms per launch over caches
    rotated past L2, beside the bound (q read and the output written once,
    the valid K and V slots read once, 4·D FLOPs per q head and slot; f32:
    the larger of the bytes and 3xTF32 work, the CUDA cores' fp32 bound
    beside).  Returns ``{tag: {...}}``."""
    import torch

    from repro_torch.kernels.ref import decode_attention_ref

    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    item = dt.itemsize
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for tag, b, s, valid, *start in shapes or DECODE_TIME_SHAPES:
        first = start[0] if start else 0
        q = randn(b, hq, d, dtype=dt)
        kvs = _rotation(lambda: (randn(b, hkv, s, d, dtype=dt),
                                 randn(b, hkv, s, d, dtype=dt)),
                        2 * b * hkv * s * d * item)
        lo = torch.full((b,), first, dtype=torch.int32, device=dev)
        hi = torch.full((b,), valid, dtype=torch.int32, device=dev)
        slot = torch.arange(s, device=dev)
        slot_ok = ((slot >= first) & (slot < valid))[None, None, None]
        q4 = q[:, :, None, :]
        t_k = _time(lambda kv: flash_decode(q, kv[0], kv[1], lo, hi), kvs)
        t_p = _time(lambda kv: decode_attention_ref(q, kv[0], kv[1], lo, hi),
                    kvs, iters=10)
        t_l = _time(lambda kv: sdpa(q4, kv[0], kv[1], attn_mask=slot_ok,
                                    enable_gqa=True), kvs)
        live = valid - first
        nbytes = item * (2.0 * b * hq * d + 2.0 * b * hkv * live * d)
        flops = 4.0 * b * hq * live * d
        bounds = (f32_bounds(nbytes, flops) if dtype == "float32" else
                  {"bound_ms": _bound_ms(nbytes, flops, dtype),
                   "bound_by": _bound_by(nbytes, flops, dtype)})
        out[tag] = {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "S": s,
                    "valid": valid, "lo": first, "dtype": dtype, "ms": t_k,
                    "plain_ms": t_p, "library_ms": t_l,
                    "library": "SDPA, GQA, slot mask", **bounds,
                    "bound_share": bounds["bound_ms"] / t_k,
                    "GBps": nbytes / t_k / 1e6, "vs_library": t_k / t_l}
        del kvs
    return out


def f32_bounds(nbytes, flops):
    """An fp32-accurate kernel's bounds in ms: the bytes over the memory
    rate; its products as 3xTF32 on the tensor cores (three TF32 products
    a product over the 495 TFLOP/s TF32 peak); and as fp32 FMAs on the
    CUDA cores (67 TFLOP/s).  ``bound_ms`` is the least time fp32-accurate
    work can take on this card: the larger of the bytes and the 3xTF32
    work."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_3x = 1e3 * 3 * flops / PEAK_FLOPS["tf32"]
    t_fp32 = 1e3 * flops / PEAK_FLOPS["float32"]
    return {"bound_ms": max(t_bytes, t_3x),
            "bound_by": "bytes" if t_bytes >= t_3x else "operations",
            "bytes_bound_ms": t_bytes, "tf32x3_bound_ms": t_3x,
            "fp32_fma_bound_ms": max(t_bytes, t_fp32)}


def time_f32_gemms(gemm, cfg, ssm_cfg, randn):
    """The GEMM (any tree's wrapper) on f32 operands with m > 16: square n
    F32_SQUARE_NS (Fig. 3's n and the crossover sweep's) and every GEMM of
    the yi-6b (m 128) and mamba2-370m (m 512) f32 forwards
    (``f32_forward_gemm_shapes``), over operands rotated past L2: kernel,
    plain version and ``torch.matmul`` (TF32 off: cuBLAS fp32) in ms per
    launch, the route each launch took, the tree's tf32x3 plan where it
    has one, TFLOP/s, beside ``f32_bounds``; and per forward the totals.
    Returns ``(rows, {"yi": {...}, "mamba": {...}})``."""
    import torch

    from repro_torch.kernels.ref import gemm_ref

    f32 = torch.float32
    mod = sys.modules[gemm.__module__]
    plan_of = getattr(mod, "tf32x3_plan", None)
    shapes = [(f"square:{n}", n, n, n, 1, "mn") for n in F32_SQUARE_NS]
    shapes += f32_forward_gemm_shapes(cfg, ssm_cfg)
    rows = []
    tot = {key: dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes",
                               "flops", "launches"), 0.0)
           for key in ("yi", "mamba")}
    for tag, m, k, n, count, lay in shapes:
        ops = _rotation(lambda: (randn(m, k), b_operand(randn, k, n, lay,
                                                        f32)),
                        4.0 * (m * k + k * n))
        iters = 40 if m * n * k <= 2 ** 28 else 10
        before = dict(gemm.route_launches)
        t_k = _time(lambda t: gemm(*t), ops, iters)
        took = {r: c - before[r] for r, c in gemm.route_launches.items()
                if c != before[r]}
        t_p = _time(lambda t: gemm_ref(*t), ops, iters)
        t_l = _time(lambda t: torch.matmul(*t), ops, iters)
        nbytes, flops = 4.0 * (m * k + k * n + m * n), 2.0 * m * n * k
        row = {"shape": tag, "m": m, "k": k, "n": n, "b_major": lay,
               "launches_per_forward": count, "routes": took, "ms": t_k,
               "plain_ms": t_p, "library_ms": t_l,
               "library": "torch.matmul fp32 (TF32 off)",
               **f32_bounds(nbytes, flops), "TFLOPs": flops / t_k / 1e9,
               "vs_library": t_k / t_l}
        if plan_of is not None:
            a, b = ops[0]
            row["plan"] = plan_of(m, n, k, f32, (0, *a.stride()),
                                  (0, *b.stride()), a.data_ptr(),
                                  b.data_ptr(), mod.tf32x3_capacity(
                                      a.device.index))._asdict()
        rows.append(row)
        key = tag.split(":")[0]
        if key in tot:
            t = tot[key]
            for name, v in (("ms", t_k), ("plain_ms", t_p),
                            ("library_ms", t_l), ("bytes", nbytes),
                            ("flops", flops), ("launches", 1)):
                t[name] += count * v
        del ops
    for t in tot.values():
        t.update(f32_bounds(t["bytes"], t["flops"]))
        t["TFLOPs"] = t["flops"] / t["ms"] / 1e9
        t["vs_library"] = t["ms"] / t["library_ms"]
    return rows, tot


def time_f32_attention(flash_attention, cfg, randn, b=F32_FWD_BATCH,
                       s=F32_FWD_SEQ, launches=None):
    """Flash attention (any tree's wrapper) on f32 operands at an f32
    forward's shape (by default yi-6b's, F32_FWD_BATCH x F32_FWD_SEQ,
    causal GQA, D 128: the ``tf32x3`` route; ``simt`` before it): kernel,
    plain version and SDPA in f32 (``is_causal``, GQA; TF32 off) in ms per
    launch over operands rotated past L2, beside ``f32_bounds``.
    ``launches``: the forward's attention launches (default: a layer
    each)."""
    import torch

    from repro_torch.kernels.ref import attention_ref

    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    nbytes, flops = attn_work(b, hq, hkv, s, s, d, True, None, 4)
    ops = _rotation(lambda: attn_operands(randn, b, hq, hkv, s, s, d,
                                          torch.float32, False), nbytes)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    before = dict(flash_attention.route_launches)
    t_k = _time(lambda t: flash_attention(*t, causal=True), ops)
    took = {r: c - before[r] for r, c in flash_attention.route_launches.items()
            if c != before[r]}
    t_p = _time(lambda t: attention_ref(*t, causal=True), ops)
    t_l = _time(lambda t: sdpa(*t, is_causal=True, enable_gqa=True), ops)
    bounds = f32_bounds(nbytes, flops)
    return {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d, "causal": True,
            "dtype": "float32", "routes": took,
            "launches_per_forward": launches or cfg.num_layers, "ms": t_k,
            "plain_ms": t_p, "library_ms": t_l,
            "library": "SDPA f32, GQA, is_causal (TF32 off)", **bounds,
            "bound_share": bounds["bound_ms"] / t_k,
            "vs_library": t_k / t_l, "TFLOPs": flops / t_k / 1e9}


def ssd_work(bh, nc, q, p, n, itemsize=4):
    """(bytes, tensor FLOPs, CUDA-core ops) of one SSD chunk launch: x,
    dta, b, c read once and y written once; per live pair (j <= i) 2N
    FLOPs of scores and 2P of the product with X, on the tensor cores,
    plus 1 of decay on the CUDA cores."""
    live = bh * nc * q * (q + 1) // 2
    nbytes = float(itemsize * bh * nc * q * (2 * p + 2 * n + 1))
    tensor = live * (2.0 * n + 2.0 * p)
    return nbytes, tensor, tensor + live


def ssd_bounds(nbytes, tensor_flops, ops):
    """The SSD's bound in ms: the larger of its bytes over the memory rate
    and its 3xTF32 tensor work (three products a product) over the TF32
    peak — the least time fp32-accurate work can take on this card — and,
    beside it, the same work as fp32 FMAs on the CUDA cores."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_tensor = 1e3 * 3 * tensor_flops / PEAK_FLOPS["tf32"]
    return {"bound_ms": max(t_bytes, t_tensor),
            "bound_by": "bytes" if t_bytes >= t_tensor else "operations",
            "bytes_bound_ms": t_bytes, "tensor_3xtf32_bound_ms": t_tensor,
            "fp32_fma_bound_ms": max(t_bytes,
                                     1e3 * ops / PEAK_FLOPS["float32"])}


def time_ssd(ssd_chunk_diag, ssm_cfg, randn, batch=SSM_FWD_BATCH,
             seq=SSM_FWD_SEQ, launches=None):
    """``ssd_chunk_diag`` (any tree's wrapper) at a forward's shape (default
    mamba2-370m's 4 x 1024; ``launches`` a forward, default one a layer),
    fp32 operands with the model's decay (log-decays from
    dt ≈ 0.7), over inputs rotated past L2: kernel, plain version and the
    library yardstick (two fp32 cuBLAS bmm around a masked exp) in ms per
    launch, beside the bounds (``ssd_bounds``), with the routes the timed
    launches took where the tree counts them."""
    import torch

    from repro_torch.kernels.ref import ssd_chunk_diag_ref

    dev = torch.device("cuda")
    ps, ns = ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state_dim
    qs = min(ssm_cfg.ssm_chunk, seq)
    ncs, bhs = seq // qs, batch * ssm_cfg.ssm_num_heads
    nbytes, tensor, ops = ssd_work(bhs, ncs, qs, ps, ns)
    ins = _rotation(lambda: (
        randn(bhs, ncs, qs, ps),
        torch.cumsum(-randn(bhs, ncs, qs).abs() * 0.7, dim=-1),
        randn(bhs, ncs, qs, ns), randn(bhs, ncs, qs, ns)), nbytes)
    causal_q = (torch.arange(qs, device=dev)[None, :]
                <= torch.arange(qs, device=dev)[:, None])
    zero = torch.zeros((), device=dev)

    def two_bmm(t):
        """The library yardstick: two fp32 cuBLAS bmm (TF32 off) around a
        masked exp."""
        x, dta, b, c = t
        sc = torch.bmm(c.view(-1, qs, ns), b.view(-1, qs, ns).transpose(1, 2))
        dd = dta.view(-1, qs)
        dec = torch.where(causal_q, torch.exp(dd[:, :, None] - dd[:, None, :]),
                          zero)
        return torch.bmm(sc * dec, x.view(-1, qs, ps))

    counts = getattr(ssd_chunk_diag, "route_launches", None)
    before = dict(counts) if counts is not None else None
    t_k = _time(lambda t: ssd_chunk_diag(*t), ins, iters=20)
    routes = ({r: n - before[r] for r, n in counts.items()}
              if counts is not None else "not counted")
    t_p = _time(lambda t: ssd_chunk_diag_ref(*t), ins, iters=10)
    t_l = _time(two_bmm, ins, iters=10)
    return {"BH": bhs, "C": ncs, "Q": qs, "P": ps, "N": ns,
            "dtype": "float32",
            "launches_per_forward": launches or ssm_cfg.num_layers,
            "routes": routes, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "library": "2 x torch.bmm fp32 + masked exp",
            **ssd_bounds(nbytes, tensor, ops), "bytes": nbytes,
            "tensor_GFLOP": tensor / 1e9,
            "TFLOPs": tensor / t_k / 1e9, "GBps": nbytes / t_k / 1e6}


# granite-4.0-h-small's Mamba-2 mixer: (B, S, H, G, P, N, Q).
GRANITE_SSD = (4, 4096, 128, 1, 64, 128, 256)


def ssd_core_work(bsz, s, h, g, p, n, q):
    """(bytes, tensor FLOPs) of the whole SSD core at its least: x read and
    y written once (f32), B, C and dt read once; the products as the core
    needs them, S = C·Bᵀ once a group over each chunk's live pairs, P·X
    over the live pairs a head, the chunk states and their term in the
    outputs (Q·N·P a chunk and head each)."""
    nc = s // q
    live = nc * q * (q + 1) // 2
    nbytes = 4.0 * (2 * bsz * s * h * p + 2 * bsz * s * g * n + bsz * s * h)
    tensor = 2.0 * bsz * (g * live * n + h * live * p
                          + 2 * h * nc * q * n * p)
    return nbytes, tensor


def time_ssd_core(randn, shape=GRANITE_SSD, iters=10):
    """The Mamba-2 mixer's SSD core as the model runs it, in any tree:
    ``models/ssm.py::ssd_inputs`` on views of a conv-output-shaped (B, S,
    F) f32 buffer, then ``blas.ssd_scan`` under the kernels' policy (a tree
    that repeats B and C per head pays that here), in device ms a call by
    CUDA events, beside the plain composition (the host lowering's torch
    ops on the card), the bound (``ssd_bounds`` of :func:`ssd_core_work`),
    the device ms and launches of each kernel family over one profiled call
    (``smoke.common.profile``), and the core's route counts where the tree
    has them: there every timed call must take the ``chunked`` route."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.models.ssm import ssd_inputs
    from smoke.common import profile

    bsz, s, h, g, p, n, q = shape
    cfg = type("Mixer", (), dict(ssm_num_heads=h, ssm_head_dim=p,
                                 ssm_num_groups=g, ssm_state_dim=n))
    dev = torch.device("cuda")
    buf = torch.nn.functional.silu(randn(bsz, s, h * p + 2 * g * n))
    xin, b_, c_ = (buf[..., :h * p], buf[..., h * p:h * p + g * n],
                   buf[..., h * p + g * n:])
    dt = randn(bsz, s, h)
    params = {"dt_bias": torch.zeros(h, device=dev),
              "a_log": torch.zeros(h, device=dev)}
    d_skip = torch.ones(h, device=dev)

    calls = [0]

    def core(use_kernels=True):
        calls[0] += 1 if use_kernels else 0
        with offload_policy(mode="device", use_kernels=use_kernels), \
                torch.no_grad():
            xh, dt_f, a, bh, ch = ssd_inputs(params, xin, b_, c_, dt, cfg)
            return blas.ssd_scan(xh, dt_f, a, bh, ch, d_skip, chunk=q)

    counts = getattr(getattr(kss, "ssd_scan", None), "route_launches", None)
    before = dict(counts) if counts is not None else None
    t_k = _time(lambda _: core(), [None], iters=iters)
    routes = ({r: k - before[r] for r, k in counts.items()}
              if counts is not None else "not counted")
    if counts is not None and routes != {"chunked": calls[0], "composed": 0}:
        fail(f"SSD core at {shape}: {calls[0]} timed calls took {routes}, "
             f"not all the chunked route")
    t_p = _time(lambda _: core(False), [None], iters=2)
    prof = profile(core)
    nbytes, tensor = ssd_core_work(*shape)
    return {"B": bsz, "S": s, "H": h, "G": g, "P": p, "N": n, "Q": q,
            "dtype": "float32", "routes": routes, "ms": t_k, "plain_ms": t_p,
            "device_ms_by_kernel": prof["device_ms_by_kernel"],
            "device_launches_by_kernel": prof.get("device_launches_by_kernel"),
            **ssd_bounds(nbytes, tensor, tensor), "bytes": nbytes,
            "tensor_GFLOP": tensor / 1e9, "TFLOPs": tensor / t_k / 1e9}


def time_conv(causal_conv_silu, randn):
    """The mixer's causal conv + SiLU (``kernels/ssd_scan.py::
    causal_conv_silu``) in bf16 at ``CONV_TIME_SHAPES``, over inputs
    rotated past L2: the kernel and its plain version (``causal_conv_silu_
    ref``: the torch composition the mixer ran before the kernel, ≈ 20
    launches) in ms a launch, beside the bytes bound (each projection read
    once, the f32 output written once), the kernel's GB/s and its share of
    the bound, and the routes the timed launches took.  Before timing, on
    the first rotated input at each shape, the kernel's pre-activation
    must equal the plain version's bit for bit and its SiLU output lie
    within ``CONV_MAX_ULPS`` f32 ulp of the plain one (the row's ``ulps``
    and ``max_abs_err``)."""
    import torch

    from repro_torch.kernels.ref import causal_conv_silu_ref

    rows = []
    for tag, b, s, di, gn, k, count in CONV_TIME_SHAPES:
        f = di + 2 * gn
        nbytes = b * s * f * (2 + 4)
        ins = _rotation(lambda: (
            randn(b, s, di, dtype=torch.bfloat16),
            randn(b, s, gn, dtype=torch.bfloat16),
            randn(b, s, gn, dtype=torch.bfloat16),
            (0.2 * randn(k, f)).to(torch.bfloat16),
            (0.1 * randn(f)).to(torch.bfloat16)), b * s * f * 2)
        pre = causal_conv_silu(*ins[0], silu=False)
        pre_plain = causal_conv_silu_ref(*ins[0], silu=False)
        if not torch.equal(pre, pre_plain):
            fail(f"causal conv at {tag}: pre-activation differs from the "
                 f"plain version's in "
                 f"{int((pre != pre_plain).sum())} of {pre.numel()} values")
        del pre, pre_plain
        got = causal_conv_silu(*ins[0])
        want = causal_conv_silu_ref(*ins[0])
        ulps = (got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs().max().item()
        max_abs_err = (got - want).abs().max().item()
        del got, want
        if ulps > CONV_MAX_ULPS:
            fail(f"causal conv at {tag}: SiLU output {ulps} f32 ulp from "
                 f"the plain version's (max abs err {max_abs_err}), want "
                 f"<= {CONV_MAX_ULPS}")
        before = dict(causal_conv_silu.route_launches)
        t_k = _time(lambda t: causal_conv_silu(*t), ins, iters=20)
        routes = {r: n - before[r]
                  for r, n in causal_conv_silu.route_launches.items()}
        t_p = _time(lambda t: causal_conv_silu_ref(*t), ins, iters=5)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        rows.append({"shape": tag, "B": b, "S": s, "F": f, "K": k,
                     "dtype": "bfloat16", "launches_per_forward": count,
                     "routes": routes, "ulps": ulps,
                     "max_abs_err": max_abs_err, "ms": t_k, "plain_ms": t_p,
                     "bound_ms": bound, "bound_by": "bytes",
                     "bound_share": bound / t_k, "GBps": nbytes / t_k / 1e6})
        del ins
        torch.cuda.empty_cache()
    return rows


def _card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, one line."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    if smi.returncode != 0 or not smi.stdout.strip():
        return f"nvidia-smi failed: {smi.stderr.strip()}"
    return smi.stdout.strip().splitlines()[0]


def _rotation(make, nbytes: float):
    """Enough copies of an operand that cycling through them overflows the
    50 MB L2, as a decode step's per-layer weights and caches do."""
    return [make() for _ in range(max(2, min(256, math.ceil(200e6 / nbytes))))]


def _time(fn, operands, iters: int = 40) -> float:
    """Device milliseconds per call: warm up, park the GPU on a spin kernel
    while the host queues ``iters`` calls, then time them back to back with
    CUDA events (so host launch overhead does not count)."""
    import torch

    for i in range(3):
        fn(operands[i % len(operands)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        fn(operands[i % len(operands)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float, dtype: str) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def _bound_by(nbytes: float, flops: float, dtype: str) -> str:
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_FLOPS[dtype]
            else "operations")
