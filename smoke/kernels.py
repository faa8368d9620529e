"""Phases 1 (``build``) and 2 (``check``): every CUDA source built, then
every kernel against its plain PyTorch version at the reference tests'
shapes and at every shape the later phases launch, each launch on the
route its operands name.
"""

from __future__ import annotations

import time

from smoke.common import (_rel_err, _row_rel_err, attn_operands, attn_route,
                          b_operand, decode_route_of, emit, fail)
from smoke.shapes import (BATCH, F32_FWD_BATCH, F32_FWD_SEQ, FWD_BATCH,
                          FWD_SEQ, JAMBA_F32_FWD_SEQ, SIMT_ATTN_CASES, SSD_TOL,
                          SCAN_CHECK_CASES, T3_RAGGED, TEST_ATTN_CASES,
                          TEST_DECODE_CASES,
                          TEST_GEMM_BATCHED, TEST_GEMM_SHAPES, TEST_SSD_CASES,
                          TOL, WGMMA_RAGGED, f32_attention_cases,
                          f32_forward_gemm_shapes, forward_gemm_shapes,
                          graph_stack_shapes, moe_expert_shapes,
                          moe_serve_gemm_shapes, serve_gemm_shapes,
                          ssm_serve_gemm_shapes, zoo_attention_cases,
                          zoo_decode_cases, zoo_forward_rows, zoo_gemm_shapes,
                          zoo_ssd_shapes)


def run_build():
    """Phase 1: nvcc (sm_90a) on every CUDA source of
    ``src/repro_torch/kernels/csrc``, one process a source, all started
    together; ptxas's registers and spills."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs),
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in logs.items()}})


def check_kernels(cfg, ssm_cfg, moe_cfg, randn, zoo, tally):
    """Phase 2: every kernel against its plain version; keeps the max abs
    errors at the main paths' shapes (bf16) in ``tally.max_abs``, the
    zoo's (``zoo_configs``, ``check_zoo_kernels``) under ``<kernel>:zoo``,
    and the launches it made under the path ``check``."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import (cluster_capacity, decode_plan,
                                                  flash_decode)
    from repro_torch.kernels.gemm import gemm, gemm_batched
    from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                         gemm_batched_ref, gemm_ref,
                                         moe_gemm_ref, ssd_chunk_diag_ref,
                                         ssd_scan_ref)
    from repro_torch.kernels.ssd_scan import (scan_route, ssd_chunk_diag,
                                              ssd_route, ssd_scan)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    max_abs = {"gemm": 0.0, "flash_decode": 0.0, "gemm_batched": 0.0,
               "flash_attention": 0.0, "ssd_chunk_diag": 0.0, "ssd_scan": 0.0,
               "gemm:forward": 0.0, "gemm_batched:forward": 0.0,
               "gemm:ssm-serve": 0.0, "gemm:moe": 0.0,
               "gemm_batched:moe": 0.0, "gemm:tf32x3": 0.0,
               **{f"{k}:zoo": 0.0 for k in ("gemm", "gemm_batched",
                                            "flash_attention", "flash_decode",
                                            "ssd_chunk_diag")}}
    checks = []
    start = tally.counts()

    def record(kernel, case, dt, err, abs_err, main_shape, scale="max",
               tol=TOL, main_dtype=torch.bfloat16, key=None):
        """One check against its bar; ``main_shape`` checks in the main
        path's dtype feed the max abs error under ``key`` (default: the
        kernel's)."""
        dname = str(dt).removeprefix("torch.")
        checks.append({"kernel": kernel, "case": case, "dtype": dname,
                       "err": err, "tol": tol[dname], "scale": scale})
        if main_shape and dt == main_dtype:
            key = key or kernel
            max_abs[key] = max(max_abs[key], abs_err)
        if not err <= tol[dname]:
            fail(f"{kernel} {case} {dname}: err {err} > {tol[dname]}")

    def on_route(fn, route, call):
        """``call()``, failing unless it launched ``fn`` once on ``route``."""
        before = dict(fn.route_launches)
        out = call()
        torch.cuda.synchronize()
        if fn.route_launches != {**before, route: before[route] + 1}:
            fail(f"{fn.__name__} did not take the {route} route: "
                 f"{before} -> {fn.route_launches}")
        return out

    check_zoo_kernels(zoo, randn, record, on_route)

    gemm_cases = [(m, n, k, "test") for m, n, k in TEST_GEMM_SHAPES] + [
        (m, n, k, "serve:" + name)
        for name, m, k, n, _ in serve_gemm_shapes(cfg)]
    for m, n, k, tag in gemm_cases:
        for dt in (torch.float32, torch.bfloat16):
            a, b = randn(m, k, dtype=dt), randn(k, n, dtype=dt)
            if dt == torch.float32:        # every f32 GEMM: skinny / tf32x3
                got = on_route(gemm, "skinny" if m <= 16 else "tf32x3",
                               lambda: gemm(a, b))
            else:
                got = gemm(a, b)
                torch.cuda.synchronize()
            record("gemm", f"{tag} {m}x{k}@{k}x{n}", dt,
                   *_rel_err(got, gemm_ref(a, b)), tag != "test")
    # The skinny route (m <= 16): every decode GEMM of the three models
    # (the mamba2-370m head's B K-major, its dt projection and qwen3-moe's
    # router written f32) at the serving batch and at m = 16, each launch
    # on ``skinny``; then a graph-mode stack at m = 8 against its single
    # launches, bit for bit.
    sk_cases = [(name, k, n, "mn", "bfloat16")
                for name, _, k, n, _ in serve_gemm_shapes(cfg)]
    sk_cases += [("mamba:" + name, k, n, lay, out)
                 for name, _, k, n, _, lay, out in ssm_serve_gemm_shapes(ssm_cfg)]
    sk_cases += [("moe:" + name, k, n, lay, out)
                 for name, _, k, n, _, lay, out in moe_serve_gemm_shapes(moe_cfg)]
    path_key = {"mamba": "gemm:ssm-serve", "moe": "gemm:moe"}
    for name, k, n, lay, out in sk_cases:
        for m in (BATCH, 16):
            ot = getattr(torch, out)
            a, b = randn(m, k, dtype=bf16), b_operand(randn, k, n, lay, bf16)
            got = on_route(gemm, "skinny", lambda: gemm(a, b, out_dtype=ot))
            err, abs_err = _rel_err(got, gemm_ref(a, b,
                                                  out_dtype=torch.float32))
            record("gemm", f"skinny serve:{name} {m}x{k}@{k}x{n} B "
                   f"{lay}-major out {out}", bf16, err, abs_err, m == BATCH,
                   tol={"bfloat16": TOL[out]},
                   key=path_key.get(name.split(":")[0]) if ":" in name
                   else None)
            del a, b, got
    d, di = ssm_cfg.d_model, ssm_cfg.d_inner
    a = randn(2, BATCH, d, dtype=bf16)
    b = randn(2, d, di, dtype=bf16)
    got = on_route(gemm_batched, "skinny", lambda: gemm_batched(a, b))
    singles = torch.stack([on_route(gemm, "skinny", lambda i=i: gemm(a[i], b[i]))
                           for i in range(2)])
    if not torch.equal(got, singles):
        fail("gemm_batched skinny stack differs from its single launches")
    checks.append({"kernel": "gemm_batched", "case": f"skinny 2x{BATCH}x{d}"
                   f"@2x{d}x{di} == single launches", "err": 0.0, "tol": 0.0})
    # bf16 inputs accumulate in fp32: test_gemm_fp32_accumulation_bf16_inputs,
    # with its bar (bf16 accumulation would stall far below k * 1e-4).
    k = 4096
    a = torch.full((8, k), 0.01, dtype=torch.bfloat16, device=dev)
    b = torch.full((k, 8), 0.01, dtype=torch.bfloat16, device=dev)
    acc = gemm(a, b, out_dtype=torch.float32)[0, 0].item()
    err = abs(acc - k * 1e-4) / (k * 1e-4)
    if not err < 0.02:
        fail(f"gemm bf16 inputs do not accumulate in fp32: {acc}")
    checks.append({"kernel": "gemm", "case": "bf16 fp32-accumulation k=4096",
                   "err": err, "tol": 0.02})

    # The tensor-core route: every forward GEMM shape of the three models
    # (qwen3-moe's outside the experts: its router written f32, held to the
    # f32 bar), then ragged shapes with both B layouts and both output
    # dtypes.
    wg_cases = [(m, n, k, lay, tag, bf16, "bfloat16") for tag, m, k, n, _, lay
                in forward_gemm_shapes(cfg, ssm_cfg)]
    wg_cases += [(m, n, k, lay, "moe:" + name, getattr(torch, out), out)
                 for name, m, k, n, _, lay, out
                 in moe_serve_gemm_shapes(moe_cfg, FWD_BATCH * FWD_SEQ)]
    wg_cases += [(m, n, k, lay, "ragged", out, "bfloat16")
                 for m, n, k in WGMMA_RAGGED
                 for lay in ("mn", "k") for out in (bf16, torch.float32)]
    # An odd n (unaligned C rows: scalar stores) needs a K-major B.
    wg_cases += [(100, 33, 1016, "k", "ragged", out, "bfloat16")
                 for out in (bf16, torch.float32)]
    for m, n, k, lay, tag, out, bar in wg_cases:
        a, b = randn(m, k, dtype=bf16), b_operand(randn, k, n, lay, bf16)
        got = on_route(gemm, "wgmma", lambda: gemm(a, b, out_dtype=out))
        err, abs_err = _rel_err(got, gemm_ref(a, b, out_dtype=torch.float32))
        record("gemm", f"wgmma {tag} {m}x{k}@{k}x{n} B {lay}-major "
               f"out {str(out)[6:]}", bf16, err, abs_err, tag != "ragged",
               tol={"bfloat16": TOL[bar]},
               key="gemm:moe" if tag.startswith("moe:") else "gemm:forward")
        del a, b, got
    # fp32 accumulation on the tensor cores, at m = 128.
    k = 4096
    a = torch.full((128, k), 0.01, dtype=bf16, device=dev)
    b = torch.full((k, 128), 0.01, dtype=bf16, device=dev)
    acc = on_route(gemm, "wgmma",
                   lambda: gemm(a, b, out_dtype=torch.float32))
    err = ((acc - k * 1e-4).abs().max() / (k * 1e-4)).item()
    if not err < 0.02:
        fail(f"gemm wgmma route does not accumulate in fp32: {err}")
    checks.append({"kernel": "gemm", "case": "wgmma bf16 fp32-accumulation "
                   "m=128 k=4096", "err": err, "tol": 0.02})

    batched = [(z, 96, 64, 80, "test") for z in TEST_GEMM_BATCHED] + [
        (z, m, k, n, tag)
        for tag, z, m, k, n, _ in graph_stack_shapes(cfg, ssm_cfg)]
    for z, m, k, n, tag in batched:
        for dt in (torch.float32, torch.bfloat16):
            a, b = randn(z, m, k, dtype=dt), randn(z, k, n, dtype=dt)
            if dt == torch.float32:
                got = on_route(gemm_batched, "tf32x3",
                               lambda: gemm_batched(a, b))
            else:
                got = gemm_batched(a, b)
                torch.cuda.synchronize()
            record("gemm_batched", f"{tag} {z}x{m}x{k}@{z}x{k}x{n}", dt,
                   *_rel_err(got, gemm_batched_ref(a, b)), tag != "test",
                   key=None if tag == "hnp-wave" else "gemm_batched:forward")
    # A stacked launch on the tensor cores equals its single launches bit
    # for bit (graph mode stacks what eager mode runs one by one), at the
    # stacks of the main paths and at a ragged K-major one.
    stacks = [(z, m, k, n, "mn", tag)
              for tag, z, m, k, n, _ in graph_stack_shapes(cfg, ssm_cfg)]
    stacks.append((2, 1000, 8 * 131, 5128, "k", "ragged"))
    for z, m, k, n, lay, tag in stacks:
        a, b = randn(z, m, k, dtype=bf16), b_operand(randn, k, n, lay, bf16, z)
        got = on_route(gemm_batched, "wgmma", lambda: gemm_batched(a, b))
        singles = torch.stack([on_route(gemm, "wgmma",
                                        lambda i=i: gemm(a[i], b[i]))
                               for i in range(z)])
        if not torch.equal(got, singles):
            fail(f"gemm_batched {tag} differs from its single launches")
        checks.append({"kernel": "gemm_batched", "case": f"wgmma {tag} "
                       f"{z}x{m}x{k}@{z}x{k}x{n} B {lay}-major == single "
                       "launches", "err": 0.0, "tol": 0.0})
        del a, b, got, singles

    # The expert GEMMs of qwen3-moe (the moe_gemm row): bf16 on the tensor
    # cores (wgmma), f32 on them by 3xTF32 (tf32x3), against moe_gemm_ref;
    # weights scaled as the model draws them.  Then the decode step's gate GEMM in one launch
    # against its 128 single launches, bit for bit.
    for tag, e, m, k, n, _ in moe_expert_shapes(moe_cfg):
        for dt in (torch.float32, bf16):
            a = randn(e, m, k, dtype=dt)
            b = (randn(e, k, n) * k ** -0.5).to(dt)
            route = "wgmma" if dt == bf16 else "tf32x3"
            got = on_route(gemm_batched, route, lambda: gemm_batched(a, b))
            record("gemm_batched", f"moe {tag} {e}x{m}x{k}@{e}x{k}x{n} "
                   f"{route}", dt, *_rel_err(got, moe_gemm_ref(a, b)), True,
                   key="gemm_batched:moe")
            del a, b, got
    tag, e, m, k, n, _ = moe_expert_shapes(moe_cfg)[0]
    a, b = randn(e, m, k, dtype=bf16), randn(e, k, n, dtype=bf16)
    got = on_route(gemm_batched, "wgmma", lambda: gemm_batched(a, b))
    singles = torch.stack([gemm(a[i], b[i]) for i in range(e)])
    torch.cuda.synchronize()
    if not torch.equal(got, singles):
        fail(f"gemm_batched moe {tag} differs from its single launches")
    checks.append({"kernel": "gemm_batched", "case": f"wgmma moe {tag} "
                   f"{e}x{m}x{k}@{e}x{k}x{n} == single launches",
                   "err": 0.0, "tol": 0.0})
    del a, b, got, singles

    # The f32 tensor-core route (tf32x3, m > 16): Fig. 3's n, ragged shapes
    # with A row- and column-major and B MN- and K-major, a misaligned
    # operand (4-byte copies), and every GEMM of the yi-6b (m 128) and
    # mamba2-370m (m 512) f32 forwards (k up to 11008), each at the f32
    # bar; then stacks (qwen3-moe's 128 f32 experts; a broadcast A) against
    # their single launches and a repeat, bit for bit.
    f32 = torch.float32
    t3_cases = [(n, n, n, "row", "mn", "fig3") for n in (32, 64, 128)]
    t3_cases += [(m, n, k, al, bl, "ragged") for m, n, k in T3_RAGGED
                 for al in ("row", "col") for bl in ("mn", "k")]
    t3_cases += [(m, n, k, "row", lay, "f32-forward:" + tag)
                 for tag, m, k, n, _, lay in f32_forward_gemm_shapes(cfg,
                                                                     ssm_cfg)]
    for m, n, k, al, bl, tag in t3_cases:
        a = randn(m, k) if al == "row" else randn(k, m).T
        b = b_operand(randn, k, n, bl, f32)
        got = on_route(gemm, "tf32x3", lambda: gemm(a, b))
        record("gemm", f"tf32x3 {tag} {m}x{k}@{k}x{n} A {al}-major B "
               f"{bl}-major", f32, *_rel_err(got, gemm_ref(a, b)),
               tag.startswith("f32-forward"), main_dtype=f32,
               key="gemm:tf32x3")
        del a, b, got
    flat = randn(130 * 518 + 1)
    a = flat[1:].view(130, 518)[:, :515]       # base 4 bytes off, odd stride
    b = randn(515, 91)[:, :90]
    got = on_route(gemm, "tf32x3", lambda: gemm(a, b))
    record("gemm", "tf32x3 misaligned 130x515@515x90 (4-byte copies)", f32,
           *_rel_err(got, gemm_ref(a, b)), False)
    tag, e, m, k, n, _ = moe_expert_shapes(moe_cfg)[0]
    t3_stacks = [(f"moe {tag}", randn(e, m, k), randn(e, k, n) * k ** -0.5)]
    m, k, n = F32_FWD_BATCH * F32_FWD_SEQ, cfg.d_model, cfg.d_model
    t3_stacks.append(("broadcast A yi-wo", randn(m, k).expand(2, m, k),
                      randn(2, k, n)))
    for tag, a, b in t3_stacks:
        z, m, k = a.shape
        n = b.shape[2]
        got = on_route(gemm_batched, "tf32x3", lambda: gemm_batched(a, b))
        again = on_route(gemm_batched, "tf32x3", lambda: gemm_batched(a, b))
        singles = torch.stack([on_route(gemm, "tf32x3",
                                        lambda i=i: gemm(a[i], b[i]))
                               for i in range(z)])
        if not (torch.equal(got, singles) and torch.equal(got, again)):
            fail(f"gemm_batched tf32x3 {tag}: stack or repeat differs")
        record("gemm_batched", f"tf32x3 {tag} {z}x{m}x{k}@{z}x{k}x{n}", f32,
               *_rel_err(got, gemm_batched_ref(a, b)), False)
        checks.append({"kernel": "gemm_batched", "case": f"tf32x3 {tag} "
                       f"{z}x{m}x{k}@{z}x{k}x{n} == single launches, "
                       "== repeat", "err": 0.0, "tol": 0.0})
        del a, b, got, again, singles
    # The CUDA-core tile keeps the bf16 GEMMs wgmma cannot take: a
    # column-major A, and a k off TMA's 8-element unit read through an odd
    # row stride.
    for tag, a, b in (
            ("col-major A", randn(96, 200, dtype=bf16).T,
             randn(96, 136, dtype=bf16)),
            ("k % 8 != 0, odd row stride", randn(200, 141, dtype=bf16)[:, :100],
             randn(100, 136, dtype=bf16))):
        got = on_route(gemm, "tiled", lambda: gemm(a, b))
        record("gemm", f"tiled {tag} {a.shape[0]}x{a.shape[1]}@"
               f"{b.shape[0]}x{b.shape[1]}", bf16,
               *_rel_err(got, gemm_ref(a, b)), False)

    for case in TEST_DECODE_CASES:
        b = len(case["bounds"])
        for dt in (torch.float32, torch.bfloat16):
            q = randn(b, case["hq"], case["d"], dtype=dt)
            k = randn(b, case["hkv"], case["s"], case["d"], dtype=dt)
            v = randn(b, case["hkv"], case["s"], case["d"], dtype=dt)
            lo = torch.tensor([x for x, _ in case["bounds"]],
                              dtype=torch.int32, device=dev)
            hi = torch.tensor([y for _, y in case["bounds"]],
                              dtype=torch.int32, device=dev)
            route = (decode_route_of(dt) if case["d"] % 16 == 0
                     else "simt")
            got = on_route(flash_decode, route,
                           lambda: flash_decode(q, k, v, lo, hi))
            again = on_route(flash_decode, route,
                             lambda: flash_decode(q, k, v, lo, hi))
            plan = decode_plan(b, case["hq"], case["hkv"], case["s"],
                               case["d"], dt, route,
                               cluster_capacity(route, dt, case["d"], 0))
            tag = (f"B{b} Hq{case['hq']} Hkv{case['hkv']} S{case['s']} "
                   f"D{case['d']} {route} splits {plan.splits}")
            if not torch.equal(got, again):
                fail(f"flash_decode {tag}: a repeat launch differs")
            record("flash_decode", tag, dt,
                   *_rel_err(got, decode_attention_ref(q, k, v, lo, hi)),
                   case["d"] == cfg.head_dim)
            masked = [i for i, (x, y) in enumerate(case["bounds"]) if y <= x]
            if masked and got[masked].abs().max().item() != 0.0:
                fail(f"flash_decode {tag}: fully masked row is not 0")

    masked_rows = 0
    for case in TEST_ATTN_CASES:
        kw = dict(causal=case["causal"], window=case.get("window"))
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = attn_operands(randn, case["b"], case["hq"],
                                    case["hkv"], case["sq"], case["skv"],
                                    case["d"], dt, case.get("view", False))
            route = attn_route(dt, case["d"])
            got = on_route(flash_attention, route,
                           lambda: flash_attention(q, k, v, **kw))
            want = attention_ref(q, k, v, **kw)
            tag = (f"{case.get('tag', 'test')} B{case['b']} Hq{case['hq']} "
                   f"Hkv{case['hkv']} Sq{case['sq']} Skv{case['skv']} "
                   f"D{case['d']} causal={case['causal']} "
                   f"window={case.get('window')} "
                   f"{'BSHD views' if case.get('view') else 'BHSD'} {route}")
            record("flash_attention", tag, dt, *_row_rel_err(got, want),
                   case.get("tag") == "prefill", scale="row max")
            dead = want.float().abs().amax(dim=-1) == 0
            if dead.any():
                masked_rows += int(dead.sum())
                if got[dead].abs().max().item() != 0.0:
                    fail(f"flash_attention {tag}: fully masked row is not 0")
    if masked_rows == 0:
        fail("flash_attention: no fully masked row was checked")
    for case in SIMT_ATTN_CASES:
        dt = getattr(torch, case["dtype"])
        q, k, v = attn_operands(randn, case["b"], case["hq"], case["hkv"],
                                case["sq"], case["skv"], case["d"], dt, True)
        flat = randn(k.numel() + 1, dtype=dt)
        k = flat[1:].view(k.shape)          # 2 / 4 bytes off 16-byte alignment
        kw = dict(causal=case["causal"], window=case.get("window"))
        got = on_route(flash_attention, "simt",
                       lambda: flash_attention(q, k, v, **kw))
        record("flash_attention", f"misaligned k B{case['b']} Hq{case['hq']} "
               f"Hkv{case['hkv']} Sq{case['sq']} Skv{case['skv']} "
               f"D{case['d']} BSHD views simt", dt,
               *_row_rel_err(got, attention_ref(q, k, v, **kw)), False,
               scale="row max")

    # The f32 forwards' attention at their own shapes on tf32x3, as
    # (B, H, S, D) tensors and as the model's transposed views, each
    # launched twice and equal bit for bit.
    for tag, b, hq, hkv, s, d in f32_attention_cases(cfg, moe_cfg, zoo):
        for view in (False, True):
            q, k, v = attn_operands(randn, b, hq, hkv, s, s, d,
                                    torch.float32, view)
            got = on_route(flash_attention, "tf32x3",
                           lambda: flash_attention(q, k, v, causal=True))
            again = on_route(flash_attention, "tf32x3",
                             lambda: flash_attention(q, k, v, causal=True))
            case = (f"{tag} B{b} Hq{hq} Hkv{hkv} S{s} D{d} causal "
                    f"{'BSHD views' if view else 'BHSD'} tf32x3")
            if not torch.equal(got, again):
                fail(f"flash_attention {case}: a repeat launch differs")
            record("flash_attention", case, torch.float32,
                   *_row_rel_err(got, attention_ref(q, k, v, causal=True)),
                   False, scale="row max")
            del q, k, v, got, again

    # SSD chunk term.  The model path hands the kernel fp32 operands; its
    # log-decays are cumulative sums of dt·a with a = -1 and dt ≈ 0.7
    # (softplus of the random projections), reaching ≈ -180 over a chunk
    # of 256: the mamba shapes use that decay, the test shapes the
    # reference test's (0.1).
    min_log_decay = 0.0
    for bh, nc, q, p, n, tag in TEST_SSD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            decay = 0.1 if tag == "test" else 0.7
            x = randn(bh, nc, q, p, dtype=dt)
            dta = torch.cumsum(-randn(bh, nc, q).abs() * decay,
                               dim=-1).to(dt)
            b, c = randn(bh, nc, q, n, dtype=dt), randn(bh, nc, q, n, dtype=dt)
            case = f"{tag} BH{bh} C{nc} Q{q} P{p} N{n}"
            before = dict(ssd_chunk_diag.route_launches)
            got = ssd_chunk_diag(x, dta, b, c)
            torch.cuda.synchronize()
            route = ssd_route(dt, p, n, [t.data_ptr()
                                         for t in (x, dta, b, c, got)])
            moved = {r: k - before[r]
                     for r, k in ssd_chunk_diag.route_launches.items()}
            if route != "mma" or moved != {"simt": 0, "mma": 1}:
                fail(f"ssd_chunk_diag {case} {dt}: off the mma route "
                     f"({route}, {moved})")
            if not torch.isfinite(got).all():
                fail(f"ssd_chunk_diag {case}: output not finite")
            if tag == "forward" and not torch.equal(
                    got, ssd_chunk_diag(x, dta, b, c)):
                fail(f"ssd_chunk_diag {case} {dt}: a repeat launch differs")
            min_log_decay = min(min_log_decay, dta.float().min().item())
            record("ssd_chunk_diag", case, dt,
                   *_row_rel_err(got, ssd_chunk_diag_ref(x, dta, b, c)),
                   tag == "forward", scale="row max", tol=SSD_TOL,
                   main_dtype=torch.float32)
    # tests/test_kernels.py:172-181: position t ignores inputs past t.
    x, b, c = randn(1, 1, 16, 8), randn(1, 1, 16, 4), randn(1, 1, 16, 4)
    dta = torch.cumsum(-randn(1, 1, 16).abs() * 0.1, dim=-1)
    x2 = x.clone()
    x2[:, :, 10:, :] = 123.0
    y1, y2 = ssd_chunk_diag(x, dta, b, c), ssd_chunk_diag(x2, dta, b, c)
    torch.cuda.synchronize()
    err = ((y1[:, :, :10] - y2[:, :, :10]).abs().max()
           / y1[:, :, :10].abs().max()).item()
    checks.append({"kernel": "ssd_chunk_diag", "case": "causality",
                   "dtype": "float32", "err": err, "tol": 1e-5})
    if not err <= 1e-5:
        fail(f"ssd_chunk_diag is not causal: {err}")
    # The whole SSD core on the chunked route: x, B and C read in place
    # from a conv-output-shaped (B, S, F) f32 buffer, B and C once a group;
    # one launch of each of its three kernels, a repeat gives the same bits,
    # every row within the SSD bar of the plain core's (TF32 off).
    for bsz, s, h, g, p, n, q, tag in SCAN_CHECK_CASES:
        buf = torch.nn.functional.silu(randn(bsz, s, h * p + 2 * g * n))
        x = buf[..., :h * p].view(bsz, s, h, p)
        b = buf[..., h * p:h * p + g * n].view(bsz, s, g, n)
        c = buf[..., h * p + g * n:].view(bsz, s, g, n)
        dt = torch.nn.functional.softplus(randn(bsz, s, h) - 1.0)
        # d_skip 0: the SSD term alone, which the 3xTF32 products compute
        # (where D·x cancels a row's SSD term, the plain core in f32 itself
        # errs by more than the bar); the D skip is checked on its own.
        a, d = -torch.exp(0.5 * randn(h)), torch.zeros(h, device=dev)
        case = f"{tag} B{bsz} S{s} H{h} G{g} P{p} N{n} Q{q}"
        before = dict(ssd_scan.kernel_launches)
        got = ssd_scan(x, dt, a, b, c, d, chunk=q)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in ssd_scan.kernel_launches.items()}
        if scan_route(x, dt, b, c, q) != "chunked" \
                or set(moved.values()) != {1}:
            fail(f"ssd_scan {case}: off the chunked route ({moved})")
        if not torch.isfinite(got).all():
            fail(f"ssd_scan {case}: output not finite")
        if not torch.equal(got, ssd_scan(x, dt, a, b, c, d, chunk=q)):
            fail(f"ssd_scan {case}: a repeat call differs")
        record("ssd_scan", case, torch.float32,
               *_row_rel_err(got, ssd_scan_ref(x, dt, a, b, c, d, q)),
               tag != "test", scale="row max", tol=SSD_TOL,
               main_dtype=torch.float32)
        # The D skip: D·x added once in fp32, within the two sums' rounding.
        d = randn(h)
        dx = d[None, None, :, None] * x
        yd = ssd_scan(x, dt, a, b, c, d, chunk=q)
        eps = torch.finfo(torch.float32).eps
        if not ((yd - got - dx).abs()
                <= 2 * eps * (got.abs() + dx.abs() + yd.abs())).all():
            fail(f"ssd_scan {case}: the D skip is not D·x")
        del buf, x, b, c, got, yd, dx
        torch.cuda.empty_cache()
    emit({"phase": "check", "checks": checks,
          "flash_decode_clusters_per_wave": {
              f"{route} {str(dt)[6:]} D{cfg.head_dim}": cluster_capacity(
                  route, dt, cfg.head_dim, 0)
              for route, dt in (("mma", bf16), ("simt", torch.float32))},
          "flash_attention_masked_rows_exactly_zero": masked_rows,
          "ssd_min_log_decay": min_log_decay,
          "ssd_forward_repeat_bit_equal": True})
    tally.max_abs.update(max_abs)
    tally.keep("check", {k: n - start[k] for k, n in tally.counts().items()})


def check_zoo_kernels(zoo, randn, record, on_route):
    """Phase 2 at the zoo's shapes: every GEMM of each model on ``skinny``
    (m = 8, 16) for the decoders and on ``wgmma`` at its forward's rows,
    jamba's at m = 512 on ``tf32x3`` in f32; the expert GEMMs of jamba
    (8 experts, d 8192, f 24576; decode and forward groups) on ``wgmma``
    and of its f32 twin on ``tf32x3``; flash attention on the model's
    transposed views (D 80 and 128 on ``wgmma``); flash decode
    on ``mma``, each launch repeated bit for bit; the SSD chunk kernel at
    jamba's shapes on ``mma``."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched
    from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                         gemm_ref, moe_gemm_ref,
                                         ssd_chunk_diag_ref)
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    seen = set()
    for key, cfg in zoo.items():
        if cfg.dtype != "bfloat16":
            continue
        ms = [(zoo_forward_rows(key), "wgmma")]
        if cfg.causal and cfg.embed_inputs:
            ms += [(BATCH, "skinny"), (16, "skinny")]
        for name, k, n, lay, out in zoo_gemm_shapes(cfg):
            for m, route in ms:
                if (m, k, n, lay, out) in seen:
                    continue
                seen.add((m, k, n, lay, out))
                ot = getattr(torch, out)
                a, b = randn(m, k, dtype=bf16), b_operand(randn, k, n, lay,
                                                          bf16)
                got = on_route(gemm, route, lambda: gemm(a, b, out_dtype=ot))
                err, abs_err = _rel_err(got, gemm_ref(a, b, out_dtype=f32))
                record("gemm", f"{route} {key}:{name} {m}x{k}@{k}x{n} B "
                       f"{lay}-major out {out}", bf16, err, abs_err, True,
                       tol={"bfloat16": TOL[out]}, key="gemm:zoo")
                del a, b, got
    m = JAMBA_F32_FWD_SEQ
    for name, k, n, lay, _ in zoo_gemm_shapes(zoo["jamba-f32"]):
        a, b = randn(m, k), b_operand(randn, k, n, lay, f32)
        got = on_route(gemm, "tf32x3", lambda: gemm(a, b))
        record("gemm", f"tf32x3 jamba-f32:{name} {m}x{k}@{k}x{n}", f32,
               *_rel_err(got, gemm_ref(a, b)), False)
        del a, b, got

    for key, route, dt in (("jamba", "wgmma", bf16),
                           ("jamba-f32", "tf32x3", f32)):
        for tag, e, m, k, n, _ in moe_expert_shapes(zoo[key]):
            if key == "jamba-f32" and not tag.startswith("decode"):
                continue        # its forward is 1 x 512, not FWD_BATCH x FWD_SEQ
            a = randn(e, m, k, dtype=dt)
            b = (randn(e, k, n) * k ** -0.5).to(dt)
            got = on_route(gemm_batched, route, lambda: gemm_batched(a, b))
            record("gemm_batched", f"{key} moe {tag} {e}x{m}x{k}@{e}x{k}x{n} "
                   f"{route}", dt, *_rel_err(got, moe_gemm_ref(a, b)),
                   dt == bf16, key="gemm_batched:zoo")
            del a, b, got

    for tag, b, hq, hkv, s, d, causal, window in zoo_attention_cases(zoo):
        q, k, v = attn_operands(randn, b, hq, hkv, s, s, d, bf16, True)
        route = attn_route(bf16, d)
        kw = dict(causal=causal, window=window)
        got = on_route(flash_attention, route,
                       lambda: flash_attention(q, k, v, **kw))
        want = attention_ref(q, k, v, **kw)
        record("flash_attention", f"{tag} B{b} Hq{hq} Hkv{hkv} S{s} D{d} "
               f"causal={causal} window={window} BSHD views {route}", bf16,
               *_row_rel_err(got, want), True, scale="row max",
               key="flash_attention:zoo")
        del q, k, v, got, want

    for tag, b, hq, hkv, s, d, lo_, hi_ in zoo_decode_cases(zoo):
        q = randn(b, hq, d, dtype=bf16)
        k, v = randn(b, hkv, s, d, dtype=bf16), randn(b, hkv, s, d, dtype=bf16)
        lo = torch.full((b,), lo_, dtype=torch.int32, device=dev)
        hi = torch.full((b,), hi_, dtype=torch.int32, device=dev)
        got = on_route(flash_decode, "mma",
                       lambda: flash_decode(q, k, v, lo, hi))
        again = on_route(flash_decode, "mma",
                         lambda: flash_decode(q, k, v, lo, hi))
        case = f"{tag} B{b} Hq{hq} Hkv{hkv} S{s} D{d} [{lo_}, {hi_}) mma"
        if not torch.equal(got, again):
            fail(f"flash_decode {case}: a repeat launch differs")
        record("flash_decode", case, bf16,
               *_rel_err(got, decode_attention_ref(q, k, v, lo, hi)), True,
               key="flash_decode:zoo")
        del q, k, v

    for tag, bh, nc, q, p, n in zoo_ssd_shapes(zoo):
        x = randn(bh, nc, q, p)
        dta = torch.cumsum(-randn(bh, nc, q).abs() * 0.7, dim=-1)
        b, c = randn(bh, nc, q, n), randn(bh, nc, q, n)
        got = on_route(ssd_chunk_diag, "mma",
                       lambda: ssd_chunk_diag(x, dta, b, c))
        if not torch.equal(got, ssd_chunk_diag(x, dta, b, c)):
            fail(f"ssd_chunk_diag {tag}: a repeat launch differs")
        record("ssd_chunk_diag", f"{tag} BH{bh} C{nc} Q{q} P{p} N{n}", f32,
               *_row_rel_err(got, ssd_chunk_diag_ref(x, dta, b, c)), True,
               scale="row max", tol=SSD_TOL, main_dtype=f32,
               key="ssd_chunk_diag:zoo")
        del x, dta, b, c, got
    torch.cuda.empty_cache()
