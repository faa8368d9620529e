#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. build   — compile every CUDA kernel of the serve path with nvcc
             (sm_90a) from ``src/repro_torch/kernels/csrc``;
2. check   — each kernel against its plain PyTorch version on the card, at
             the reference tests' shapes and at yi-6b's serve shapes;
3. serve   — yi-6b at full width (bf16, random weights from a seeded
             generator), 8 requests, through the offload seam with the
             kernels on; launch counters and trace backends prove the path
             ran the kernels; the plain torch ``device`` path serves the
             same requests for comparison;
4. time    — each kernel at the serve shapes beside its bound, its plain
             version and one library call (CUDA events).

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit from nvidia-smi.  Imports
nothing of JAX or of the JAX reference package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# yi-6b serve cell (configs/yi_6b.py at full width).
ARCH = "yi-6b"
BATCH = 8
PROMPT_LEN = 16
MAX_NEW = 16
CACHE_LEN = 64
SEED = 0

# H100 SXM data-sheet peaks (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:18
# First-step logits, kernel path against the plain path, x max |logit|.
# bf16: the larger of 2e-2 and twice the plain path's own floor (see
# phase 3).  f32 at the same widths: 1e-4, about 40x the 2.6e-6 measured on
# the H100 and well under what a TF32 or bf16-accumulating GEMM gives.
LOGIT_TOL = 2e-2
F32_LOGIT_TOL = 1e-4

# GEMM shapes of tests/test_kernels.py:25-30.
TEST_GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (200, 130, 96),
                    (8, 8, 8), (1, 256, 64)]
# Flash-decode cases of tests/test_kernels.py:120-123, the serve shape
# itself (cache of CACHE_LEN slots, bounds [0, index + 1) as decode steps
# give them), and the serve geometry at S = 300 with ragged bounds and one
# fully masked row.
TEST_DECODE_CASES = [
    dict(hq=4, hkv=2, s=64, d=16, bounds=[(0, 64), (5, 40), (10, 33)]),
    dict(hq=8, hkv=8, s=96, d=16, bounds=[(0, 96), (0, 1), (95, 96)]),
    dict(hq=32, hkv=4, s=CACHE_LEN, d=128,
         bounds=[(0, 1), (0, 2), (0, 16), (0, 17), (0, 31), (0, 32),
                 (0, 33), (0, 64)]),
    dict(hq=32, hkv=4, s=300, d=128,
         bounds=[(0, 300), (5, 40), (10, 33), (0, 1), (299, 300),
                 (100, 100), (37, 250), (0, 150)]),
]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def serve_gemm_shapes(cfg):
    """(name, m, k, n, launches per decode step) of every GEMM the decode
    step runs on the kernel (batch = m)."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.num_layers
    qkv_n = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    return [
        ("qkv_project", BATCH, d, qkv_n, L),
        ("wo", BATCH, cfg.num_heads * hd, d, L),
        ("mlp_gate_up", BATCH, d, cfg.d_ff, 2 * L),
        ("mlp_down", BATCH, cfg.d_ff, d, L),
        ("head", BATCH, d, cfg.vocab_size, 1),
    ]


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs the card")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    dev = torch.device("cuda")

    from repro_torch.configs import get_arch
    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.ref import decode_attention_ref, gemm_ref
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "built": sorted(logs),
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in logs.items()}})

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def rel_err(got, want):
        got, want = got.float(), want.float()
        scale = want.abs().max().item() or 1.0
        return (got - want).abs().max().item() / scale, \
            (got - want).abs().max().item()

    # ---- 2. kernels against their plain versions --------------------------
    cfg = get_arch(ARCH)
    gemm_serve = serve_gemm_shapes(cfg)
    max_abs = {"gemm": 0.0, "flash_decode": 0.0}
    checks = []
    gemm_cases = [(m, n, k, "test") for m, n, k in TEST_GEMM_SHAPES] + [
        (m, n, k, "serve:" + name) for name, m, k, n, _ in gemm_serve]
    for m, n, k, tag in gemm_cases:
        for dt in (torch.float32, torch.bfloat16):
            a, b = randn(m, k, dtype=dt), randn(k, n, dtype=dt)
            got = gemm(a, b)
            torch.cuda.synchronize()
            err, abs_err = rel_err(got, gemm_ref(a, b))
            dname = str(dt).removeprefix("torch.")
            checks.append({"kernel": "gemm", "case": f"{tag} {m}x{k}@{k}x{n}",
                           "dtype": dname, "err": err, "tol": TOL[dname]})
            if tag != "test" and dt == torch.bfloat16:
                max_abs["gemm"] = max(max_abs["gemm"], abs_err)
            if not err <= TOL[dname]:
                fail(f"gemm {tag} {m}x{k}@{k}x{n} {dname}: err {err} > "
                     f"{TOL[dname]}")
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
            got = flash_decode(q, k, v, lo, hi)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, lo, hi)
            err, abs_err = rel_err(got, want)
            dname = str(dt).removeprefix("torch.")
            tag = (f"B{b} Hq{case['hq']} Hkv{case['hkv']} S{case['s']} "
                   f"D{case['d']}")
            checks.append({"kernel": "flash_decode", "case": tag,
                           "dtype": dname, "err": err, "tol": TOL[dname]})
            if case["d"] == cfg.head_dim and dt == torch.bfloat16:
                max_abs["flash_decode"] = max(max_abs["flash_decode"], abs_err)
            if not err <= TOL[dname]:
                fail(f"flash_decode {tag} {dname}: err {err} > {TOL[dname]}")
            masked = [i for i, (x, y) in enumerate(case["bounds"]) if y <= x]
            if masked and got[masked].abs().max().item() != 0.0:
                fail(f"flash_decode {tag}: fully masked row is not 0")
    emit({"phase": "check", "checks": checks})

    # ---- 3. serve yi-6b at full width through the kernels ----------------
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=PROMPT_LEN)]
               for _ in range(BATCH)]
    steps = PROMPT_LEN + MAX_NEW
    kernel_policy = dict(mode="device", use_kernels=True, platform="h100-sxm")
    plain_policy = dict(mode="device", use_kernels=False, platform="h100-sxm")

    # Warm the plain path's allocator and the kernels' libraries once.
    with offload_policy(**kernel_policy), torch.no_grad():
        serve_batch(ARCH, prompts[:BATCH], smoke=False, max_new_tokens=1,
                    cache_len=CACHE_LEN, params=params, device=dev)
    gemm.launches = 0
    flash_decode.launches = 0
    with offload_policy(**kernel_policy), offload_trace() as trace:
        res_k = serve_batch(ARCH, prompts, smoke=False,
                            max_new_tokens=MAX_NEW, cache_len=CACHE_LEN,
                            params=params, device=dev)
    launches = {"gemm": gemm.launches, "flash_decode": flash_decode.launches}
    want_launches = {"gemm": steps * (5 * cfg.num_layers + 1),
                     "flash_decode": steps * cfg.num_layers}
    if launches != want_launches:
        fail(f"kernel launches {launches}, want {want_launches}")
    seam_ops = {"gemm", "qkv_project", "mlp_block", "attention"}
    backends = {}
    for r in trace.records:
        if r.op in seam_ops:
            backends.setdefault(r.op, set()).add(r.backend)
    if set(backends) != seam_ops or any(b != {"device-kernel"}
                                        for b in backends.values()):
        fail(f"seam ops not all on device-kernel: {backends}")

    with offload_policy(**plain_policy):
        res_p = serve_batch(ARCH, prompts, smoke=False,
                            max_new_tokens=MAX_NEW, cache_len=CACHE_LEN,
                            params=params, device=dev)
    agree = float((res_k.tokens == res_p.tokens).mean())

    # First step's logits, kernel path against the plain device path.  In
    # bf16 the two differ by about as much as the plain path differs from
    # itself with its fp32 GEMM sums taken in two halves (bf16 rounding
    # flips compound over 32 layers of random weights), so the bf16 bar is
    # the larger of LOGIT_TOL and twice that measured floor; f32 weights at
    # the same widths, where no bf16 rounding intervenes, are held to
    # F32_LOGIT_TOL, which catches a GEMM that is not true fp32.
    def first_logits(mdl, prm, pol, k_parts=1):
        cache = mdl.init_decode_cache(BATCH, CACHE_LEN, device=dev)
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            out, _ = mdl.decode_step(prm, cache, first, 0)
        return out.float()

    def logit_errs(mdl, prm):
        lk = first_logits(mdl, prm, kernel_policy)
        lp = first_logits(mdl, prm, plain_policy)
        lq = first_logits(mdl, prm, plain_policy, k_parts=2)
        if not (torch.isfinite(lk).all()
                and lk.shape == (BATCH, cfg.vocab_size)):
            fail(f"kernel logits not finite of shape "
                 f"{(BATCH, cfg.vocab_size)}")
        scale = lp.abs().max().item()
        return {"err": (lk - lp).abs().max().item() / scale,
                "floor": (lq - lp).abs().max().item() / scale,
                "argmax_agreement":
                    (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()}

    first = torch.tensor([[p[0]] for p in prompts], device=dev)
    logits_bf16 = logit_errs(model, params)
    bar = max(LOGIT_TOL, 2 * logits_bf16["floor"])
    if not logits_bf16["err"] <= bar:
        fail(f"bf16 first-step logits differ: {logits_bf16} > {bar}")
    del params
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model32.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    logits_f32 = logit_errs(model32, params32)
    if not logits_f32["err"] <= F32_LOGIT_TOL:
        fail(f"f32 first-step logits differ: {logits_f32} > {F32_LOGIT_TOL}")
    del params32
    torch.cuda.empty_cache()
    tok = res_k.tokens
    if tok.shape != (BATCH, MAX_NEW) or tok.min() < 0 or \
            tok.max() >= cfg.vocab_size:
        fail(f"served tokens malformed: shape {tok.shape}")
    serve = {
        "arch": ARCH, "params": n_params, "dtype": cfg.dtype, "batch": BATCH,
        "prompt_len": PROMPT_LEN, "max_new": MAX_NEW, "cache_len": CACHE_LEN,
        "init_s": init_s,
        "kernel": {"prefill_s": res_k.prefill_s, "decode_s": res_k.decode_s,
                   "tokens_per_s": res_k.tokens_per_s},
        "plain": {"prefill_s": res_p.prefill_s, "decode_s": res_p.decode_s,
                  "tokens_per_s": res_p.tokens_per_s},
        "launches": launches, "trace_backends": {
            k: sorted(v) for k, v in backends.items()},
        "first_step_logits": {"bfloat16": {**logits_bf16, "bar": bar},
                              "float32": {**logits_f32, "bar": F32_LOGIT_TOL}},
        "greedy_token_agreement": agree,
    }
    emit({"phase": "serve", **serve})

    # ---- 4. times at the serve shapes ------------------------------------
    bf16 = torch.bfloat16
    per_shape = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "flops": 0.0}
    for name, m, k, n, count in gemm_serve:
        a = randn(m, k, dtype=bf16)
        ws = _rotation(lambda: randn(k, n, dtype=bf16), k * n * 2)
        t_k = _time(lambda w: gemm(a, w), ws)
        t_p = _time(lambda w: gemm_ref(a, w), ws)
        t_l = _time(lambda w: torch.matmul(a, w), ws)
        nbytes = 2.0 * (m * k + k * n + m * n)
        flops = 2.0 * m * n * k
        per_shape.append({"shape": name, "m": m, "k": k, "n": n,
                          "launches_per_step": count, "ms": t_k,
                          "plain_ms": t_p, "library_ms": t_l,
                          "bound_ms": _bound_ms(nbytes, flops, "bfloat16"),
                          "GBps": nbytes / t_k / 1e6})
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l)):
            tot[key] += count * t
        tot["bytes"] += count * nbytes
        tot["flops"] += count * flops
        del ws
    emit({"gemm_shapes": per_shape})

    # Decode attention at the last serve step: cache_len slots, the first
    # prompt + new - 1 of them valid, for every layer.
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    valid = PROMPT_LEN + MAX_NEW - 1
    q = randn(BATCH, hq, d, dtype=bf16)
    kvs = _rotation(lambda: (randn(BATCH, hkv, CACHE_LEN, d, dtype=bf16),
                             randn(BATCH, hkv, CACHE_LEN, d, dtype=bf16)),
                    2 * BATCH * hkv * CACHE_LEN * d * 2)
    lo = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    hi = torch.full((BATCH,), valid, dtype=torch.int32, device=dev)
    slot_ok = (torch.arange(CACHE_LEN, device=dev) < valid)[None, None, None]
    t_dk = _time(lambda kv: flash_decode(q, kv[0], kv[1], lo, hi), kvs)
    t_dp = _time(lambda kv: decode_attention_ref(q, kv[0], kv[1], lo, hi), kvs)
    q4 = q[:, :, None, :]
    t_dl = _time(lambda kv: torch.nn.functional.scaled_dot_product_attention(
        q4, kv[0], kv[1], attn_mask=slot_ok, enable_gqa=True), kvs)
    d_bytes = 2.0 * (2 * BATCH * hq * d + 2 * BATCH * hkv * valid * d)
    d_flops = 4.0 * BATCH * hq * valid * d
    L = cfg.num_layers
    emit({"flash_decode_shape": {
        "B": BATCH, "Hq": hq, "Hkv": hkv, "D": d, "S": CACHE_LEN,
        "valid": valid, "launches_per_step": L, "ms": t_dk, "plain_ms": t_dp,
        "library_ms": t_dl,
        "bound_ms": _bound_ms(d_bytes, d_flops, "bfloat16")}})

    per = "decode_step"
    kernels = [
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm.py:32",
         "launches": launches["gemm"], "max_abs_err": max_abs["gemm"],
         "ms": tot["ms"], "plain_ms": tot["plain_ms"],
         "bound_ms": _bound_ms(tot["bytes"], tot["flops"], "bfloat16"),
         "bound_by": _bound_by(tot["bytes"], tot["flops"], "bfloat16"),
         "library_ms": tot["library_ms"], "per": per},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:32",
         "launches": launches["flash_decode"],
         "max_abs_err": max_abs["flash_decode"],
         "ms": L * t_dk, "plain_ms": L * t_dp,
         "bound_ms": _bound_ms(L * d_bytes, L * d_flops, "bfloat16"),
         "bound_by": _bound_by(d_bytes, d_flops, "bfloat16"),
         "library_ms": L * t_dl, "per": per},
    ]
    emit({"kernels": kernels})

    print(_card_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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


if __name__ == "__main__":
    main()
