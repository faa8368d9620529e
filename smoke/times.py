"""Phase 11 (``time``): each kernel at its path's shapes beside its
bound, its plain version and one library call (CUDA events, operands
rotated past L2; ``smoke.timing``), and the kernels line that puts each
kernel's times beside the launches, routes and errors the other phases
kept.
"""

from __future__ import annotations

from smoke.common import attn_operands, b_operand, emit, fail
from smoke.shapes import (BATCH, FWD_BATCH, FWD_SEQ, HBM_BYTES_PER_S, HNP_ROWS,
                          LONG_CACHE, LONG_INDEX, PEAK_FLOPS, SSM_FWD_BATCH,
                          SSM_FWD_SEQ,
                          forward_gemm_shapes, graph_stack_shapes,
                          moe_serve_gemm_shapes, serve_gemm_shapes,
                          ssm_serve_gemm_shapes)
from smoke.timing import (_bound_by, _bound_ms, _rotation, _time, attn_work,
                          time_conv, time_f32_attention, time_f32_gemms,
                          time_flash_decode, time_grouped, time_moe_gemms,
                          time_ssd, time_ssd_core, time_zoo)


def run_times(cfg, ssm_cfg, moe_cfg, zoo, randn, tally):
    """Phase 11: each kernel at its path's shapes and at the zoo's
    (``time_zoo``); returns the kernels line: each kernel's times beside
    what the phases kept in ``tally`` of its launches, routes and
    errors."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched, gemm_route
    from repro_torch.kernels.ref import (attention_ref, gemm_batched_ref,
                                         gemm_ref)
    from repro_torch.kernels.ssd_scan import causal_conv_silu, ssd_chunk_diag

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    launches, routes, max_abs = tally.launches, tally.routes, tally.max_abs

    def time_serve_gemms(shapes):
        """Each decode-step GEMM over rotated weights (each 4 MB or more,
        which L2's 50 MB would otherwise hold): kernel, plain version and
        ``torch.matmul`` (bf16 out) ms, bound, GB/s and the bound's share;
        and the per-step totals."""
        rows, tot = [], dict.fromkeys(
            ("ms", "plain_ms", "library_ms", "bytes", "flops"), 0.0)
        for name, m, k, n, count, lay, out in shapes:
            ot = getattr(torch, out)
            a = randn(m, k, dtype=bf16)
            ws = _rotation(lambda: b_operand(randn, k, n, lay, bf16),
                           k * n * 2)
            t_k = _time(lambda w: gemm(a, w, out_dtype=ot), ws)
            t_p = _time(lambda w: gemm_ref(a, w, out_dtype=ot), ws)
            t_l = _time(lambda w: torch.matmul(a, w), ws)
            nbytes = 2.0 * (m * k + k * n) + ot.itemsize * m * n
            flops = 2.0 * m * n * k
            bound = _bound_ms(nbytes, flops, "bfloat16")
            rows.append({"shape": name, "m": m, "k": k, "n": n,
                         "b_major": lay, "out": out,
                         "launches_per_step": count, "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": bound, "GBps": nbytes / t_k / 1e6,
                         "bound_share": bound / t_k})
            for key, t in (("ms", t_k), ("plain_ms", t_p),
                           ("library_ms", t_l)):
                tot[key] += count * t
            tot["bytes"] += count * nbytes
            tot["flops"] += count * flops
            del ws
        step = {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "library_ms": tot["library_ms"],
                "bound_ms": _bound_ms(tot["bytes"], tot["flops"], "bfloat16"),
                "launches": sum(r["launches_per_step"] for r in rows),
                "GB": tot["bytes"] / 1e9}
        step["bound_share"] = step["bound_ms"] / step["ms"]
        step["vs_library"] = step["ms"] / step["library_ms"]
        return rows, step, tot

    per_shape, per_step, tot = time_serve_gemms(
        [(name, m, k, n, count, "mn", "bfloat16")
         for name, m, k, n, count in serve_gemm_shapes(cfg)])
    emit({"gemm_shapes": per_shape, "per_step": per_step})
    ssm_shapes, ssm_step, _ = time_serve_gemms(ssm_serve_gemm_shapes(ssm_cfg))
    emit({"ssm_gemm_shapes": ssm_shapes, "per_step": ssm_step})
    moe_gemms, moe_step, _ = time_serve_gemms(moe_serve_gemm_shapes(moe_cfg))
    emit({"moe_gemm_shapes": moe_gemms, "per_step": moe_step})

    # The skinny kernel's time against k at yi-6b's qkv width, beside
    # torch.matmul's: the step from k/2 to k is B's streaming rate, what is
    # left at k the fixed cost of a launch.
    n = serve_gemm_shapes(cfg)[0][3]
    sweep = []
    for k in (1024, 2048, 4096, 8192):
        a = randn(BATCH, k, dtype=bf16)
        ws = _rotation(lambda: randn(k, n, dtype=bf16), k * n * 2)
        sweep.append((k, _time(lambda w: gemm(a, w), ws),
                      _time(lambda w: torch.matmul(a, w), ws)))
        del ws
    (k1, t1, l1), (k2, t2, l2) = sweep[-2], sweep[-1]
    step_bytes = 2.0 * (k2 - k1) * n
    emit({"skinny_k_sweep": {
        "m": BATCH, "n": n, "ms": {k: t for k, t, _ in sweep},
        "library_ms": {k: t for k, _, t in sweep},
        "streaming_TBps": step_bytes / (t2 - t1) / 1e9,
        "library_streaming_TBps": step_bytes / (l2 - l1) / 1e9,
        "fixed_ms": t1 - (t2 - t1), "library_fixed_ms": l1 - (l2 - l1)}})

    # The forwards' GEMMs (yi-6b at m = 2 x 512 rows, mamba2-370m at 4 x
    # 1024; the tied head's B K-major), per forward, with the route each
    # takes.  mamba2-370m's dt projection writes f32 in the model; timed
    # here in bf16.
    def route_of(a, w):
        return gemm_route(a.shape[0], w.shape[1], a.shape[1], 1, a.dtype,
                          (0, *a.stride()), (0, *w.stride()), a.data_ptr(),
                          w.data_ptr())

    fwd_shapes = {"yi": [], "mamba": []}
    fwd_tot = {key: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bytes": 0.0, "flops": 0.0} for key in fwd_shapes}
    for tag, m, k, n, count, lay in forward_gemm_shapes(cfg, ssm_cfg):
        key, name = tag.split(":")
        a = randn(m, k, dtype=bf16)
        ws = _rotation(lambda: b_operand(randn, k, n, lay, bf16), k * n * 2)
        t_k = _time(lambda w: gemm(a, w), ws, iters=10)
        t_p = _time(lambda w: gemm_ref(a, w), ws, iters=10)
        t_l = _time(lambda w: torch.matmul(a, w), ws, iters=10)
        nbytes = 2.0 * (m * k + k * n + m * n)
        flops = 2.0 * m * n * k
        fwd_shapes[key].append({
            "shape": name, "m": m, "k": k, "n": n, "b_major": lay,
            "route": route_of(a, ws[0]), "launches_per_forward": count,
            "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": _bound_ms(nbytes, flops, "bfloat16"),
            "TFLOPs": flops / t_k / 1e9})
        ftot = fwd_tot[key]
        ftot["ms"] += count * t_k
        ftot["plain_ms"] += count * t_p
        ftot["library_ms"] += count * t_l
        ftot["bytes"] += count * nbytes
        ftot["flops"] += count * flops
        del ws
    per_forward = {key: {
        "ms": ft["ms"], "plain_ms": ft["plain_ms"],
        "library_ms": ft["library_ms"],
        "bound_ms": _bound_ms(ft["bytes"], ft["flops"], "bfloat16"),
        "TFLOPs": ft["flops"] / ft["ms"] / 1e9}
        for key, ft in fwd_tot.items()}
    emit({"forward_gemm_shapes": fwd_shapes["yi"],
          "per_forward": per_forward["yi"]})

    # Decode attention at the last serve step (every layer) and on a
    # 4096-slot cache (B 8 and B 1).
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers
    dec = time_flash_decode(flash_decode, hq, hkv, d, randn)
    for row in dec.values():
        row["launches_per_step"] = L
    emit({"flash_decode_shapes": dec})
    d_serve = dec["serve"]

    # Flash attention at the forward's shape: one launch per layer, on
    # (B, H, S, D) tensors and on the model's transposed (B, S, H, D)
    # views; SDPA with the explicit right-aligned mask and with
    # is_causal=True (the same mask here, Sq == Skv).
    s = FWD_SEQ
    qkv_bytes = 2 * FWD_BATCH * (hq + 2 * hkv) * s * d
    qkv = _rotation(lambda: attn_operands(randn, FWD_BATCH, hq, hkv, s, s, d,
                                          bf16, False), qkv_bytes)
    qkv_views = _rotation(lambda: attn_operands(randn, FWD_BATCH, hq, hkv, s,
                                                s, d, bf16, True), qkv_bytes)
    causal = (torch.arange(s, device=dev)[None, :]
              <= torch.arange(s, device=dev)[:, None])   # right-aligned
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def time_attention(operands):
        """Kernel ms per launch on ``operands``; fails unless every timed
        launch took the tensor-core route."""
        before = dict(flash_attention.route_launches)
        t = _time(lambda t: flash_attention(*t, causal=True), operands)
        moved = {r: n - before[r]
                 for r, n in flash_attention.route_launches.items()}
        if any(n for r, n in moved.items() if r != "wgmma"):
            fail(f"prefill attention timed off the wgmma route: {moved}")
        return t

    t_ak = time_attention(qkv)
    t_akv = time_attention(qkv_views)
    t_ap = _time(lambda t: attention_ref(*t, causal=True), qkv)
    t_al = _time(lambda t: sdpa(*t, attn_mask=causal, enable_gqa=True), qkv)
    t_alc = _time(lambda t: sdpa(*t, is_causal=True, enable_gqa=True), qkv)
    a_bytes, a_flops = attn_work(FWD_BATCH, hq, hkv, s, s, d, True, None, 2)
    emit({"flash_attention_shape": {
        "B": FWD_BATCH, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
        "causal": True, "route": "wgmma", "launches_per_forward": L,
        "ms": t_ak, "views_ms": t_akv, "plain_ms": t_ap,
        "library_ms": t_al, "library_causal_ms": t_alc,
        "library": "SDPA, GQA: explicit mask / is_causal=True",
        "bound_ms": _bound_ms(a_bytes, a_flops, "bfloat16"),
        "bytes_bound_ms": 1e3 * a_bytes / HBM_BYTES_PER_S,
        "flop_bound_ms": 1e3 * a_flops / PEAK_FLOPS["bfloat16"],
        "TFLOPs": a_flops / t_ak / 1e9, "views_TFLOPs": a_flops / t_akv / 1e9}})
    del qkv, qkv_views

    # Batched GEMM at the hnp wave's stacked shape: one launch.
    kv_n = hkv * d
    xs = randn(2, HNP_ROWS, cfg.d_model, dtype=bf16)
    ws = _rotation(lambda: randn(2, cfg.d_model, kv_n, dtype=bf16),
                   2 * cfg.d_model * kv_n * 2)
    t_bk = _time(lambda w: gemm_batched(xs, w), ws)
    t_bp = _time(lambda w: gemm_batched_ref(xs, w), ws)
    t_bl = _time(lambda w: torch.bmm(xs, w), ws)
    b_bytes = 2.0 * 2 * (HNP_ROWS * cfg.d_model + cfg.d_model * kv_n
                         + HNP_ROWS * kv_n)
    b_flops = 2.0 * 2 * HNP_ROWS * cfg.d_model * kv_n
    emit({"gemm_batched_shape": {
        "batch": 2, "m": HNP_ROWS, "k": cfg.d_model, "n": kv_n,
        "launches_per_wave": 1, "ms": t_bk, "plain_ms": t_bp,
        "library_ms": t_bl,
        "bound_ms": _bound_ms(b_bytes, b_flops, "bfloat16"),
        "bytes_bound_ms": 1e3 * b_bytes / HBM_BYTES_PER_S,
        "flop_bound_ms": 1e3 * b_flops / PEAK_FLOPS["bfloat16"],
        "TFLOPs": b_flops / t_bk / 1e9}})
    del ws

    # SSD chunk kernel at the 4 x 1024 forward's shape, a launch (the
    # forward runs the whole core instead; phase 2 checks the kernel).
    ssd = time_ssd(ssd_chunk_diag, ssm_cfg, randn)
    emit({"ssd_chunk_diag_shape": ssd})
    # The whole SSD core (the chunked route's three kernels) as a mixer
    # runs it, a call: at mamba2-370m's 4 x 1024 forward and at granite's
    # mixer.
    ssd_core = time_ssd_core(randn, shape=(
        SSM_FWD_BATCH, SSM_FWD_SEQ, ssm_cfg.ssm_num_heads,
        ssm_cfg.ssm_num_groups, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state_dim,
        ssm_cfg.ssm_chunk))
    ssd_core_granite = time_ssd_core(randn)
    emit({"ssd_core_forward": ssd_core, "ssd_core_granite": ssd_core_granite})
    core_n = launches["ssm-forward"]["ssd_scan"]

    emit({"ssm_forward_gemm_shapes": fwd_shapes["mamba"],
          "per_forward": {**per_forward["mamba"],
                          "ssd_ms": core_n * ssd_core["ms"]}})

    # The batched GEMM in mamba2-370m's graph-mode forward: z/x and B/C
    # stacked, one launch each per layer.
    g_tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
             "flops": 0.0}
    g_shapes = []
    for tag, z, m, k, n, count in graph_stack_shapes(cfg, ssm_cfg):
        if not tag.startswith("mamba-graph"):
            continue
        xs = randn(z, m, k, dtype=bf16)
        ws = _rotation(lambda: randn(z, k, n, dtype=bf16), z * k * n * 2)
        t_k = _time(lambda w: gemm_batched(xs, w), ws, iters=10)
        t_p = _time(lambda w: gemm_batched_ref(xs, w), ws, iters=10)
        t_l = _time(lambda w: torch.bmm(xs, w), ws, iters=10)
        nbytes = 2.0 * z * (m * k + k * n + m * n)
        flops = 2.0 * z * m * n * k
        g_shapes.append({"shape": tag, "batch": z, "m": m, "k": k, "n": n,
                         "launches_per_forward": count, "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": _bound_ms(nbytes, flops, "bfloat16"),
                         "TFLOPs": flops / t_k / 1e9})
        g_tot["ms"] += count * t_k
        g_tot["plain_ms"] += count * t_p
        g_tot["library_ms"] += count * t_l
        g_tot["bytes"] += count * nbytes
        g_tot["flops"] += count * flops
        del ws
    emit({"ssm_graph_gemm_batched_shapes": g_shapes})

    moe_shapes, moe_tot = time_moe_gemms(gemm_batched, moe_cfg, randn)
    emit({"moe_gemm_batched_shapes": moe_shapes, "per_path": moe_tot})
    per_moe = {}
    for path, key in (("decode", "moe-serve"), ("forward", "moe-forward")):
        t = moe_tot[path]
        per_moe[path] = {
            "launches": launches[key]["gemm_batched"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"]}

    # The f32 GEMM route (tf32x3) at square n and at the f32 forwards'
    # shapes; f32 flash attention (tf32x3) at the yi-6b f32 forward's shape
    # and flash decode (simt) at the f32 long-cache step, beside SDPA in f32.
    f32_rows, f32_tot = time_f32_gemms(gemm, cfg, ssm_cfg, randn)
    emit({"f32_gemm_shapes": f32_rows, "per_forward": f32_tot})
    f32_attn = time_f32_attention(flash_attention, cfg, randn)
    f32_dec = time_flash_decode(
        flash_decode, hq, hkv, d, randn, "float32",
        [("long-f32", BATCH, LONG_CACHE, LONG_INDEX + 1)])["long-f32"]
    emit({"f32_flash_attention_shape": f32_attn,
          "f32_flash_decode_shape": f32_dec})
    if any(set(r["routes"]) != {"tf32x3"} for r in f32_rows):
        fail(f"f32 GEMMs timed off the tf32x3 route: "
             f"{[(r['shape'], r['routes']) for r in f32_rows]}")
    t3_launches = {path: r["gemm"]["tf32x3"] + r["gemm_batched"]["tf32x3"]
                   for path, r in routes.items()}

    # The ragged grouped GEMM at granite-4.0-h-small's prefill expert
    # products, on phase 10g's counts.
    grouped_shapes, grouped_tot = time_grouped()
    emit({"gemm_grouped_shapes": grouped_shapes, "per_layer": grouped_tot})
    # The Mamba-2 conv + SiLU at granite's prefill and mamba2-370m's
    # forward.
    conv_rows = time_conv(causal_conv_silu, randn)
    emit({"causal_conv_silu_shapes": conv_rows})
    conv_granite, conv_ssm = conv_rows
    conv_n = launches["ssm-forward-conv"]["eager"]
    if any(r["routes"]["f32"] or not r["routes"]["bf16"] for r in conv_rows):
        fail(f"causal conv timed off the bf16 route: "
             f"{[(r['shape'], r['routes']) for r in conv_rows]}")

    per = "decode_step"
    kernels = [
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "tile_source": "src/repro_torch/kernels/csrc/gemm_wgmma.cuh",
         "replaces": "src/repro/kernels/gemm.py:32",
         "launches": launches["serve"]["gemm"], "path": "serve",
         "max_abs_err": max_abs["gemm"],
         "ms": tot["ms"], "plain_ms": tot["plain_ms"],
         "bound_ms": _bound_ms(tot["bytes"], tot["flops"], "bfloat16"),
         "bound_by": _bound_by(tot["bytes"], tot["flops"], "bfloat16"),
         "library_ms": tot["library_ms"], "per": per,
         "forward_launches": launches["forward"]["gemm"],
         "forward_max_abs_err": max_abs["gemm:forward"],
         "forward_ms": per_forward["yi"]["ms"],
         "forward_plain_ms": per_forward["yi"]["plain_ms"],
         "forward_library_ms": per_forward["yi"]["library_ms"],
         "forward_bound_ms": per_forward["yi"]["bound_ms"],
         "ssm_forward_ms": per_forward["mamba"]["ms"],
         "ssm_forward_plain_ms": per_forward["mamba"]["plain_ms"],
         "ssm_forward_library_ms": per_forward["mamba"]["library_ms"],
         "ssm_forward_bound_ms": per_forward["mamba"]["bound_ms"],
         "serve_cluster_launches": launches["serve-cluster"]["gemm"],
         "paper_fig3_launches": launches["paper-fig3"]["gemm"],
         "ssm_serve_launches": launches["ssm-serve"]["gemm"],
         "ssm_serve_max_abs_err": max_abs["gemm:ssm-serve"],
         "ssm_serve_ms": ssm_step["ms"],
         "ssm_serve_plain_ms": ssm_step["plain_ms"],
         "ssm_serve_library_ms": ssm_step["library_ms"],
         "ssm_serve_bound_ms": ssm_step["bound_ms"],
         "moe_serve_launches": launches["moe-serve"]["gemm"],
         "moe_serve_max_abs_err": max_abs["gemm:moe"],
         "moe_serve_ms": moe_step["ms"],
         "moe_serve_plain_ms": moe_step["plain_ms"],
         "moe_serve_library_ms": moe_step["library_ms"],
         "moe_serve_bound_ms": moe_step["bound_ms"],
         "moe_forward_launches": launches["moe-forward"]["gemm"],
         "hnp_validated_launches": launches["hnp-validated"]["gemm"],
         "train_launches": launches["train"]["gemm"],
         "train_max_abs_err": max(max_abs["gemm:train"],
                                  max_abs["gemm:train-step"]),
         "route_launches": {path: r["gemm"] for path, r in routes.items()},
         "grouped_launches": {path: r["grouped"]["gemm"]
                              for path, r in routes.items()}},
        {"name": "gemm_tf32x3", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "tile_source": "src/repro_torch/kernels/csrc/gemm_tf32x3.cuh",
         "replaces": "src/repro/kernels/gemm.py:32",
         "launches": routes["float32"]["gemm"]["tf32x3"], "path": "float32",
         "max_abs_err": max_abs["gemm:tf32x3"],
         "train_backward_max_abs_err": max_abs["gemm:train-f32"],
         "ms": f32_tot["yi"]["ms"], "plain_ms": f32_tot["yi"]["plain_ms"],
         "bound_ms": f32_tot["yi"]["bound_ms"],
         "bound_by": f32_tot["yi"]["bound_by"],
         "library_ms": f32_tot["yi"]["library_ms"],
         "per": "f32 forward (yi-6b, 1 x 128)",
         "tf32x3_bound_ms": f32_tot["yi"]["tf32x3_bound_ms"],
         "fp32_fma_bound_ms": f32_tot["yi"]["fp32_fma_bound_ms"],
         "bytes_bound_ms": f32_tot["yi"]["bytes_bound_ms"],
         "ssm_forward_ms": f32_tot["mamba"]["ms"],
         "ssm_forward_library_ms": f32_tot["mamba"]["library_ms"],
         "ssm_forward_bound_ms": f32_tot["mamba"]["bound_ms"],
         "square_ms": {r["n"]: r["ms"] for r in f32_rows
                       if r["shape"].startswith("square:")},
         "square_library_ms": {r["n"]: r["library_ms"] for r in f32_rows
                               if r["shape"].startswith("square:")},
         "route_launches": {path: n for path, n in t3_launches.items()
                            if n}},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:32",
         "launches": launches["serve"]["flash_decode"], "path": "serve",
         "max_abs_err": max_abs["flash_decode"],
         "ms": L * d_serve["ms"], "plain_ms": L * d_serve["plain_ms"],
         "bound_ms": L * d_serve["bound_ms"],
         "bound_by": d_serve["bound_by"],
         "library_ms": L * d_serve["library_ms"], "per": per,
         "long_cache_launches": launches["long-decode"]["flash_decode"],
         "serve_cluster_launches": launches["serve-cluster"]["flash_decode"],
         "moe_serve_launches": launches["moe-serve"]["flash_decode"],
         "long_cache_per_launch": {tag: {key: dec[tag][key] for key in (
             "B", "S", "valid", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_share")} for tag in ("long", "long-b1")},
         "f32_long_cache_per_launch": {key: f32_dec[key] for key in (
             "B", "S", "valid", "ms", "plain_ms", "library_ms", "bound_ms",
             "fp32_fma_bound_ms")},
         "route_launches": {path: r["flash_decode"]
                            for path, r in routes.items()
                            if any(r["flash_decode"].values())}},
        {"name": "gemm_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "tile_source": "src/repro_torch/kernels/csrc/gemm_wgmma.cuh",
         "replaces": "src/repro/kernels/gemm.py:105",
         "launches": launches["hnp"]["gemm_batched"], "path": "hnp",
         "max_abs_err": max_abs["gemm_batched"],
         "ms": t_bk, "plain_ms": t_bp,
         "bound_ms": _bound_ms(b_bytes, b_flops, "bfloat16"),
         "bound_by": _bound_by(b_bytes, b_flops, "bfloat16"),
         "library_ms": t_bl, "per": "hnp_wave",
         "forward_launches": launches["ssm-forward-graph"]["gemm_batched"],
         "forward_max_abs_err": max_abs["gemm_batched:forward"],
         "forward_ms": g_tot["ms"], "forward_plain_ms": g_tot["plain_ms"],
         "forward_library_ms": g_tot["library_ms"],
         "forward_bound_ms": _bound_ms(g_tot["bytes"], g_tot["flops"],
                                       "bfloat16"),
         "forward_path": "ssm-forward-graph",
         "moe_max_abs_err": max_abs["gemm_batched:moe"],
         "moe_decode_step": per_moe["decode"],
         "moe_forward": per_moe["forward"],
         "hnp_validated_launches": launches["hnp-validated"]["gemm_batched"],
         "route_launches": {path: r["gemm_batched"]
                            for path, r in routes.items()},
         "grouped_launches": {path: r["grouped"]["gemm_batched"]
                              for path, r in routes.items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37",
         "launches": launches["forward"]["flash_attention"],
         "path": "forward", "max_abs_err": max_abs["flash_attention"],
         "ms": L * t_ak, "plain_ms": L * t_ap,
         "bound_ms": _bound_ms(L * a_bytes, L * a_flops, "bfloat16"),
         "bound_by": _bound_by(a_bytes, a_flops, "bfloat16"),
         "library_ms": L * t_al, "library_causal_ms": L * t_alc,
         "views_ms": L * t_akv, "per": "forward",
         "moe_forward_launches": launches["moe-forward"]["flash_attention"],
         "train_launches": launches["train"]["flash_attention"],
         "train_max_abs_err": max_abs["flash_attention:train"],
         "f32_forward_per_launch": {key: f32_attn[key] for key in (
             "S", "routes", "ms", "plain_ms", "library_ms", "bound_ms",
             "fp32_fma_bound_ms")},
         "tile_source": "src/repro_torch/kernels/csrc/attn_wgmma.cuh",
         "routes": {"wgmma": "src/repro_torch/kernels/csrc/attn_wgmma.cuh",
                    "tf32x3": "src/repro_torch/kernels/csrc/attn_tf32x3.cuh",
                    "simt": "src/repro_torch/kernels/csrc/flash_attention.cu"},
         "route_launches": {path: r["flash_attention"]
                            for path, r in routes.items()
                            if any(r["flash_attention"].values())}},
        {"name": "ssd_chunk_diag", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "tile_source": "src/repro_torch/kernels/csrc/ssd_mma.cuh",
         "replaces": "src/repro/kernels/ssd_scan.py:37",
         "launches": launches["check"]["ssd_chunk_diag"],
         "path": "check", "max_abs_err": max_abs["ssd_chunk_diag"],
         "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
         "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
         "fp32_fma_bound_ms": ssd["fp32_fma_bound_ms"],
         "library_ms": ssd["library_ms"],
         "per": "launch at mamba2-370m's 4 x 1024 forward shape",
         "route_launches": {path: r["ssd_chunk_diag"]
                            for path, r in routes.items()
                            if any(r["ssd_chunk_diag"].values())}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "tile_source": "src/repro_torch/kernels/csrc/ssd_mma.cuh",
         "replaces": None,
         "kernels": ["ssd_state_kernel", "ssd_pass_kernel",
                     "ssd_mma_kernel (ChunkArgs)"],
         "launches": core_n,
         "path": "ssm-forward", "max_abs_err": max_abs["ssd_scan"],
         "ms": core_n * ssd_core["ms"],
         "plain_ms": core_n * ssd_core["plain_ms"],
         "bound_ms": core_n * ssd_core["bound_ms"],
         "bound_by": ssd_core["bound_by"], "library_ms": None,
         "per": "forward", "ms_per_call": ssd_core["ms"],
         "device_ms_by_kernel": ssd_core["device_ms_by_kernel"],
         "granite_ms_per_call": ssd_core_granite["ms"],
         "granite_plain_ms_per_call": ssd_core_granite["plain_ms"],
         "granite_bound_ms_per_call": ssd_core_granite["bound_ms"],
         "granite_device_ms_by_kernel":
         ssd_core_granite["device_ms_by_kernel"],
         "granite_per": "granite-4.0-h-small mixer, 4 x 4096 tokens",
         "route_launches": {path: r["ssd_scan"]
                            for path, r in routes.items()
                            if any(r["ssd_scan"].values())}},
        {"name": "gemm_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "tile_source": "src/repro_torch/kernels/csrc/gemm_grouped.cuh",
         "replaces": None,
         "launches": launches["grouped"]["gemm_grouped"], "path": "grouped",
         "max_abs_err": max_abs["gemm_grouped"],
         "ms": grouped_tot["ms"], "plain_ms": grouped_tot["plain_ms"],
         "bound_ms": grouped_tot["bound_ms"],
         "bound_by": grouped_tot["bound_by"],
         "library_ms": grouped_tot["library_ms"],
         "library": "torch._grouped_mm",
         "per": "granite-4.0-h dropless MoE layer, 4 x 4096 tokens",
         "launches_per_layer": grouped_tot["launches"],
         "ms_per_launch": {r["shape"]: r["ms"] for r in grouped_shapes}},
        {"name": "causal_conv_silu", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "tile_source": "src/repro_torch/kernels/csrc/mamba_conv.cuh",
         "replaces": None,
         "launches": conv_n, "graph_launches":
         launches["ssm-forward-conv"]["graph"], "path": "ssm-forward",
         "max_abs_err": max(r["max_abs_err"] for r in conv_rows),
         "ulps": max(r["ulps"] for r in conv_rows),
         "ms": conv_n * conv_ssm["ms"],
         "plain_ms": conv_n * conv_ssm["plain_ms"],
         "bound_ms": conv_n * conv_ssm["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "per": "forward",
         "granite_ms": conv_granite["launches_per_forward"]
         * conv_granite["ms"],
         "granite_plain_ms": conv_granite["launches_per_forward"]
         * conv_granite["plain_ms"],
         "granite_bound_ms": conv_granite["launches_per_forward"]
         * conv_granite["bound_ms"],
         "granite_per": "granite-4.0-h-small forward, 18 mixers of "
                        "4 x 4096 tokens",
         "ms_per_launch": {r["shape"]: r["ms"] for r in conv_rows},
         "plain_ms_per_launch": {r["shape"]: r["plain_ms"]
                                 for r in conv_rows},
         "bound_ms_per_launch": {r["shape"]: r["bound_ms"]
                                 for r in conv_rows}},
    ]
    zoo_lines = zoo_kernel_lines(launches, routes, max_abs,
                                 time_zoo(zoo, randn))
    for row in kernels:
        if row["name"] in zoo_lines:
            row["zoo"] = zoo_lines[row["name"]]
        if row["name"] in tally.COUNTED:
            row["distributed_launches"] = {
                path: n[row["name"]] for path, n in launches.items()
                if path.startswith("distributed")}
    return kernels


ZOO_PATHS = ("jamba-serve", "jamba-serve-graph", "jamba-forward",
             "jamba-float32", "gemma3-serve", "gemma3-forward",
             "gemma3-long-decode", "danube-serve", "danube-forward",
             "danube-long-decode", "hubert-forward", "qwen2-serve",
             "qwen2-vl-forward")


def zoo_kernel_lines(launches, routes, max_abs, times):
    """Per kernel of the kernels line: its launches on each zoo path
    (counted; a serve path's over the whole run of PROMPT_LEN + MAX_NEW
    steps), its routes there, its max abs error at the zoo's shapes
    against its plain version (phase 2) and its measured rows
    (``time_zoo``)."""
    out = {}
    for name in ("gemm", "gemm_tf32x3", "flash_decode", "gemm_batched",
                 "flash_attention", "ssd_chunk_diag"):
        fn = "gemm" if name == "gemm_tf32x3" else name
        line = {"launches": {}, "routes": {}}
        for path in ZOO_PATHS:
            if path not in routes:
                continue
            r = routes[path][fn]
            if name == "gemm_tf32x3":
                n = r.get("tf32x3", 0) + routes[path]["gemm_batched"].get(
                    "tf32x3", 0)
            else:
                n = (launches[path][fn] if path in launches
                     else sum(r.values()))
            if n:
                line["launches"][path] = n
                line["routes"][path] = r
        if name != "gemm_tf32x3":
            line["max_abs_err"] = max_abs[f"{fn}:zoo"]
        line["times"] = {k.split(":", 1)[1]: v for k, v in times.items()
                         if k.split(":", 1)[0] == name}
        out[name] = line
    return out
