#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. build    — compile every CUDA kernel (GEMM, flash decode, flash
              attention) with nvcc (sm_90a) from
              ``src/repro_torch/kernels/csrc``, one nvcc per source;
2. check    — each kernel against its plain PyTorch version on the card, at
              the reference tests' shapes and at yi-6b's shapes (decode,
              prefill, the stacked GEMMs of the hnp phase);
3. serve    — yi-6b at full width (bf16, random weights from a seeded
              generator), 8 requests, through the offload seam with the
              kernels on; launch counters and trace backends prove the path
              ran the kernels; the plain torch ``device`` path serves the
              same requests for comparison;
4. forward  — ``Model.forward`` of yi-6b at full width on 2 x 512 tokens,
              eager and graph (``hnp``) mode, on the kernels and on the
              plain path;
5. serve-graph — the serve run of phase 3 with ``forward_mode="graph"``;
              its greedy tokens must equal phase 3's, and its first-step
              logits eager mode's on the kernels;
6. float32  — first-step decode logits and last-position forward logits of
              the same model with f32 weights, kernels against plain;
7. hnp      — the paper's path: the reference quickstart's graph, then one
              wave of two same-shape GEMMs at yi-6b width stacked into one
              batched-GEMM launch;
8. time     — each kernel at its path's shapes beside its bound, its plain
              version and one library call (CUDA events).

Each path's launch counters are set to 0 just before it runs and read just
after.  The last line of stdout is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit from nvidia-smi, and the
one before that lists every kernel.  Imports nothing of JAX or of the JAX
reference package.
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
# yi-6b forward (prefill) cell: 2 sequences of 512 tokens; the f32 check
# runs 1 sequence of 128 tokens.
FWD_BATCH, FWD_SEQ = 2, 512
F32_FWD_BATCH, F32_FWD_SEQ = 1, 128
# hnp phase: the reference quickstart's shapes (examples/quickstart.py),
# then a wave of two GEMMs at yi-6b width: x (rows x d) @ wk, x @ wv.
HNP_ROWS = 1024

# H100 SXM data-sheet peaks (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # tests/test_kernels.py:18
# Flash attention holds each output row to the bar scaled by that row's
# max |plain|: a causal row averages up to S values of v and is far smaller
# than the first rows (a single v row), so one scale for the whole output
# would hide a fault in the late rows.
# Logits, kernel path against the plain path, x max |logit|.  bf16: the
# larger of 2e-2 and twice the plain path's own floor (its fp32 sums taken
# in two halves; see PERF.md).  f32 at the same widths: 1e-4, well under
# what a TF32 or bf16-accumulating kernel gives.
LOGIT_TOL = 2e-2
F32_LOGIT_TOL = 1e-4

# GEMM shapes of tests/test_kernels.py:25-30.
TEST_GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (200, 130, 96),
                    (8, 8, 8), (1, 256, 64)]
# Batched GEMM: tests/test_kernels.py:51-57 (bsz x 96x64 @ 64x80).
TEST_GEMM_BATCHED = [1, 3, 8]
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
# Flash attention: the six cases of tests/test_kernels.py:83-106 (D 32,
# B 2), the yi-6b prefill shape, and rows a window leaves empty (bidir.
# with window -5: the last six queries see no key) at D 80 and 128.
TEST_ATTN_CASES = [
    dict(b=2, sq=128, skv=128, hq=4, hkv=4, d=32, causal=True),
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=32, causal=True),
    dict(b=2, sq=96, skv=96, hq=4, hkv=2, d=32, causal=True, window=32),
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, d=32, causal=False),
    dict(b=2, sq=16, skv=128, hq=4, hkv=2, d=32, causal=True),
    dict(b=2, sq=100, skv=100, hq=4, hkv=2, d=32, causal=True),
    dict(b=FWD_BATCH, sq=FWD_SEQ, skv=FWD_SEQ, hq=32, hkv=4, d=128,
         causal=True, tag="prefill"),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=False, window=-5),
    dict(b=1, sq=200, skv=200, hq=8, hkv=1, d=128, causal=False, window=-5),
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
    t_start = time.perf_counter()

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched

    counters = {"gemm": gemm, "gemm_batched": gemm_batched,
                "flash_decode": flash_decode,
                "flash_attention": flash_attention}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs),
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in logs.items()}})

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    cfg = get_arch(ARCH)
    max_abs = check_kernels(cfg, randn)

    # ---- 3.-5. serve, forward, serve in graph mode (bf16) ---------------
    from repro_torch.models import build_model

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=PROMPT_LEN)]
               for _ in range(BATCH)]
    launches = {}
    serve = run_serve(cfg, model, params, prompts, "eager", zero_counts,
                      read_counts)
    serve["init_s"] = init_s
    serve["params"] = sum(t.numel() for t in _leaves(params))
    launches["serve"] = serve["launches"]
    emit({"phase": "serve", **serve})

    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(FWD_BATCH, FWD_SEQ))).to(dev)
    fwd = run_forward(cfg, model, params, tokens, zero_counts, read_counts)
    launches["forward"] = fwd["launches"]["eager"]
    emit({"phase": "forward", **fwd})

    serve_g = run_serve(cfg, model, params, prompts, "graph", zero_counts,
                        read_counts)
    serve_g["eager_tokens_per_s"] = serve["kernel"]["tokens_per_s"]
    # Both modes run the same kernels on the same operands.
    if serve_g.pop("tokens") != serve["tokens"]:
        fail("graph-mode serving gave other greedy tokens than eager mode")
    serve_g["greedy_tokens_equal_eager"] = True
    emit({"phase": "serve-graph", **serve_g})
    del params
    torch.cuda.empty_cache()

    # ---- 6. the same model with f32 weights -----------------------------
    run_f32(cfg, tokens, prompts)

    # ---- 7. hnp: the paper's path ---------------------------------------
    hnp_phase = run_hnp(cfg, randn, zero_counts, read_counts)
    launches["hnp"] = hnp_phase["launches"]
    max_abs["gemm_batched"] = max(max_abs["gemm_batched"],
                                  hnp_phase["wave"]["max_abs_err_vs_plain"])
    emit({"phase": "hnp", **hnp_phase})

    # ---- 8. times ---------------------------------------------------------
    kernels = run_times(cfg, randn, launches, max_abs)
    emit({"seconds_total": time.perf_counter() - t_start})
    emit({"kernels": kernels})

    print(_card_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def _rel_err(got, want):
    got, want = got.float(), want.float()
    scale = want.abs().max().item() or 1.0
    diff = (got - want).abs().max().item()
    return diff / scale, diff


def _row_rel_err(got, want):
    """Like ``_rel_err``, but each row (last axis) scaled by its own
    max |want|; rows that are all 0 (fully masked) are checked apart."""
    got, want = got.float(), want.float()
    scale = want.abs().amax(dim=-1)
    diff = (got - want).abs().amax(dim=-1)
    live = scale > 0
    return (diff[live] / scale[live]).max().item(), diff.max().item()


def check_kernels(cfg, randn):
    """Phase 2: every kernel against its plain version; returns the max
    abs errors at the main paths' shapes (bf16)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched
    from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                         gemm_batched_ref, gemm_ref)

    dev = torch.device("cuda")
    max_abs = {"gemm": 0.0, "flash_decode": 0.0, "gemm_batched": 0.0,
               "flash_attention": 0.0}
    checks = []

    def record(kernel, case, dt, err, abs_err, main_shape, scale="max"):
        dname = str(dt).removeprefix("torch.")
        checks.append({"kernel": kernel, "case": case, "dtype": dname,
                       "err": err, "tol": TOL[dname], "scale": scale})
        if main_shape and dt == torch.bfloat16:
            max_abs[kernel] = max(max_abs[kernel], abs_err)
        if not err <= TOL[dname]:
            fail(f"{kernel} {case} {dname}: err {err} > {TOL[dname]}")

    gemm_cases = [(m, n, k, "test") for m, n, k in TEST_GEMM_SHAPES] + [
        (m, n, k, "serve:" + name)
        for name, m, k, n, _ in serve_gemm_shapes(cfg)]
    for m, n, k, tag in gemm_cases:
        for dt in (torch.float32, torch.bfloat16):
            a, b = randn(m, k, dtype=dt), randn(k, n, dtype=dt)
            got = gemm(a, b)
            torch.cuda.synchronize()
            record("gemm", f"{tag} {m}x{k}@{k}x{n}", dt,
                   *_rel_err(got, gemm_ref(a, b)), tag != "test")
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

    d, kv_n = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
    batched = [(z, 96, 64, 80, "test") for z in TEST_GEMM_BATCHED] + [
        (2, HNP_ROWS, d, kv_n, "hnp-wave")]
    for z, m, k, n, tag in batched:
        for dt in (torch.float32, torch.bfloat16):
            a, b = randn(z, m, k, dtype=dt), randn(z, k, n, dtype=dt)
            got = gemm_batched(a, b)
            torch.cuda.synchronize()
            record("gemm_batched", f"{tag} {z}x{m}x{k}@{z}x{k}x{n}", dt,
                   *_rel_err(got, gemm_batched_ref(a, b)), tag != "test")

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
            tag = (f"B{b} Hq{case['hq']} Hkv{case['hkv']} S{case['s']} "
                   f"D{case['d']}")
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
            q = randn(case["b"], case["hq"], case["sq"], case["d"], dtype=dt)
            k = randn(case["b"], case["hkv"], case["skv"], case["d"], dtype=dt)
            v = randn(case["b"], case["hkv"], case["skv"], case["d"], dtype=dt)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_ref(q, k, v, **kw)
            tag = (f"{case.get('tag', 'test')} B{case['b']} Hq{case['hq']} "
                   f"Hkv{case['hkv']} Sq{case['sq']} Skv{case['skv']} "
                   f"D{case['d']} causal={case['causal']} "
                   f"window={case.get('window')}")
            record("flash_attention", tag, dt, *_row_rel_err(got, want),
                   case.get("tag") == "prefill", scale="row max")
            dead = want.float().abs().amax(dim=-1) == 0
            if dead.any():
                masked_rows += int(dead.sum())
                if got[dead].abs().max().item() != 0.0:
                    fail(f"flash_attention {tag}: fully masked row is not 0")
    if masked_rows == 0:
        fail("flash_attention: no fully masked row was checked")
    emit({"phase": "check", "checks": checks,
          "flash_attention_masked_rows_exactly_zero": masked_rows})
    return max_abs


def run_serve(cfg, model, params, prompts, forward_mode, zero_counts,
              read_counts):
    """Phases 3 and 5: serve the prompts on the kernels (counted) and on the
    plain path, and compare first-step bf16 logits: in eager mode the
    kernels' against the plain path's, in graph mode the graph model's
    against the eager model's, both on the kernels."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    steps = PROMPT_LEN + MAX_NEW
    kw = dict(smoke=False, cache_len=CACHE_LEN, params=params, device=dev,
              forward_mode=forward_mode)
    # Warm the plain path's allocator and the kernels' libraries once.
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        serve_batch(ARCH, prompts, max_new_tokens=1, **kw)
    zero_counts()
    with offload_policy(**KERNEL_POLICY), offload_trace() as trace:
        res_k = serve_batch(ARCH, prompts, max_new_tokens=MAX_NEW, **kw)
    launches = read_counts()
    want = {"gemm": steps * (5 * cfg.num_layers + 1), "gemm_batched": 0,
            "flash_decode": steps * cfg.num_layers, "flash_attention": 0}
    if launches != want:
        fail(f"serve ({forward_mode}) kernel launches {launches}, want {want}")
    backends = _backends(trace, {"gemm", "qkv_project", "mlp_block",
                                 "attention"})
    with offload_policy(**PLAIN_POLICY):
        res_p = serve_batch(ARCH, prompts, max_new_tokens=MAX_NEW, **kw)
    tok = res_k.tokens
    if tok.shape != (BATCH, MAX_NEW) or tok.min() < 0 or \
            tok.max() >= cfg.vocab_size:
        fail(f"served tokens malformed: shape {tok.shape}")
    out = {
        "arch": ARCH, "forward_mode": forward_mode, "dtype": cfg.dtype,
        "batch": BATCH, "prompt_len": PROMPT_LEN, "max_new": MAX_NEW,
        "cache_len": CACHE_LEN,
        "kernel": {"prefill_s": res_k.prefill_s, "decode_s": res_k.decode_s,
                   "tokens_per_s": res_k.tokens_per_s},
        "plain": {"prefill_s": res_p.prefill_s, "decode_s": res_p.decode_s,
                  "tokens_per_s": res_p.tokens_per_s},
        "launches": launches, "trace_backends": backends,
        "greedy_token_agreement": float((res_k.tokens == res_p.tokens).mean()),
        "tokens": tok.tolist(),
    }
    first = torch.tensor([[p[0]] for p in prompts], device=dev)

    def first_logits(pol, k_parts=1, mdl=model):
        cache = mdl.init_decode_cache(BATCH, CACHE_LEN, device=dev)
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            lg, _ = mdl.decode_step(params, cache, first, 0)
        return lg.float()

    if forward_mode == "eager":
        errs = _logit_errs(first_logits, (BATCH, cfg.vocab_size))
        bar = max(LOGIT_TOL, 2 * errs["floor"])
        if not errs["err"] <= bar:
            fail(f"bf16 first-step logits differ: {errs} > {bar}")
        out["first_step_logits"] = {"bfloat16": {**errs, "bar": bar}}
    else:
        graph = build_model(dataclasses.replace(cfg, forward_mode="graph"))
        lg = first_logits(KERNEL_POLICY, mdl=graph)
        le = first_logits(KERNEL_POLICY)
        if not (torch.isfinite(lg).all() and
                tuple(lg.shape) == (BATCH, cfg.vocab_size)):
            fail("graph-mode first-step logits not finite")
        err = (lg - le).abs().max().item() / le.abs().max().item()
        if not err <= LOGIT_TOL:
            fail(f"graph-mode first-step logits differ from eager: {err}")
        out["first_step_logits_graph_vs_eager"] = err
    return out


KERNEL_POLICY = dict(mode="device", use_kernels=True, platform="h100-sxm")
PLAIN_POLICY = dict(mode="device", use_kernels=False, platform="h100-sxm")


def _backends(trace, ops):
    """{op: backends} over the trace; fails unless every op in ``ops``
    appears and only on device-kernel."""
    backends = {}
    for r in trace.records:
        if r.op in ops:
            backends.setdefault(r.op, set()).add(r.backend)
    if set(backends) != ops or any(b != {"device-kernel"}
                                   for b in backends.values()):
        fail(f"seam ops not all on device-kernel: {backends}")
    return {k: sorted(v) for k, v in backends.items()}


def _logit_errs(logits_of, shape):
    """Kernel logits against the plain path's, relative to max |plain|, and
    the plain path's own floor (its fp32 sums in two halves)."""
    import torch

    lk = logits_of(KERNEL_POLICY)
    lp = logits_of(PLAIN_POLICY)
    lq = logits_of(PLAIN_POLICY, k_parts=2)
    if not (torch.isfinite(lk).all() and tuple(lk.shape) == shape):
        fail(f"kernel logits not finite of shape {shape}")
    scale = lp.abs().max().item()
    return {"err": (lk - lp).abs().max().item() / scale,
            "floor": (lq - lp).abs().max().item() / scale,
            "argmax_agreement":
                (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()}


def run_forward(cfg, model, params, tokens, zero_counts, read_counts):
    """Phase 4: Model.forward at full width, eager and graph mode."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    out = {"arch": ARCH, "dtype": cfg.dtype, "batch": FWD_BATCH,
           "seq": FWD_SEQ, "seconds": {}, "launches": {},
           "trace_backends": {}}
    last = {}
    for mode in ("eager", "graph"):
        mdl = build_model(dataclasses.replace(cfg, forward_mode=mode))
        with offload_policy(**KERNEL_POLICY), torch.no_grad():
            mdl.forward(params, tokens[:, :64])          # warm up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with offload_policy(**KERNEL_POLICY), offload_trace() as trace, \
                torch.no_grad():
            logits, aux = mdl.forward(params, tokens)
        torch.cuda.synchronize()
        out["seconds"][mode] = time.perf_counter() - t0
        counts = read_counts()
        out["launches"][mode] = counts
        if counts["flash_attention"] != cfg.num_layers or \
                counts["gemm"] != 5 * cfg.num_layers + 1 or \
                counts["gemm_batched"] or counts["flash_decode"]:
            fail(f"forward ({mode}) kernel launches {counts}")
        out["trace_backends"][mode] = _backends(
            trace, {"gemm", "qkv_project", "mlp_block", "attention"})
        want_shape = (FWD_BATCH, FWD_SEQ, cfg.vocab_size)
        if tuple(logits.shape) != want_shape or \
                not torch.isfinite(logits).all() or float(aux) != 0.0:
            fail(f"forward ({mode}) logits not finite of shape {want_shape}")
        last[mode] = logits[:, -1].float()
        del logits

    def last_logits(pol, k_parts=1):
        t0 = time.perf_counter()
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            out = model.forward(params, tokens)[0][:, -1].float()
        torch.cuda.synchronize()
        if pol is PLAIN_POLICY and k_parts == 1:
            seconds["plain"] = time.perf_counter() - t0
        return out

    seconds = out["seconds"]
    errs = _logit_errs(last_logits, (FWD_BATCH, cfg.vocab_size))
    bar = max(LOGIT_TOL, 2 * errs["floor"])
    if not errs["err"] <= bar:
        fail(f"bf16 forward logits differ: {errs} > {bar}")
    graph_vs_eager = ((last["graph"] - last["eager"]).abs().max().item()
                      / last["eager"].abs().max().item())
    if not graph_vs_eager <= LOGIT_TOL:
        fail(f"graph forward differs from eager: {graph_vs_eager}")
    out["last_logits"] = {"bfloat16": {**errs, "bar": bar},
                          "graph_vs_eager": graph_vs_eager}
    return out


def run_f32(cfg, tokens, prompts):
    """Phase 6: decode first-step and forward last-position logits with
    f32 weights at full width, kernels against plain, bar 1e-4."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model32.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    first = torch.tensor([[p[0]] for p in prompts], device=dev)
    toks = tokens[:F32_FWD_BATCH, :F32_FWD_SEQ]

    def first_logits(pol, k_parts=1):
        cache = model32.init_decode_cache(BATCH, CACHE_LEN, device=dev)
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            return model32.decode_step(params32, cache, first, 0)[0].float()

    def last_logits(pol, k_parts=1):
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            return model32.forward(params32, toks)[0][:, -1].float()

    out = {"decode_first_step": _logit_errs(first_logits,
                                            (BATCH, cfg.vocab_size)),
           "forward_last_position": _logit_errs(
               last_logits, (F32_FWD_BATCH, cfg.vocab_size)),
           "bar": F32_LOGIT_TOL, "forward_batch": F32_FWD_BATCH,
           "forward_seq": F32_FWD_SEQ}
    for name in ("decode_first_step", "forward_last_position"):
        if not out[name]["err"] <= F32_LOGIT_TOL:
            fail(f"f32 {name} logits differ: {out[name]} > {F32_LOGIT_TOL}")
    emit({"phase": "float32", **out})
    del params32
    torch.cuda.empty_cache()


def run_hnp(cfg, randn, zero_counts, read_counts):
    """Phase 7: the paper's path on the card — examples/quickstart.py's
    graph under mode="device", 2 modeled devices, cost-aware; then one wave
    of two same-shape GEMMs at yi-6b width, stacked into one launch."""
    import numpy as np
    import torch

    import repro_torch.hnp as hnp
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import engine, offload_policy
    from repro_torch.kernels.ref import gemm_batched_ref

    policy = dict(mode="device", num_devices=2, scheduler="cost-aware",
                  use_kernels=True, platform="h100-sxm")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 256)).astype(np.float32)
    w1 = rng.normal(size=(256, 512)).astype(np.float32)
    b1 = rng.normal(size=(512,)).astype(np.float32)
    w2 = rng.normal(size=(512, 128)).astype(np.float32)
    engine().reset()
    zero_counts()
    with offload_policy(**policy), offload_trace() as t:
        with hnp.offload_region("quickstart") as region:
            h = hnp.tanh(hnp.linear(hnp.array(x), w1, b1))
            y = h @ w2
            sim = hnp.syrk(y)
            y_np = hnp.asnumpy(y)
            sim_np = hnp.asnumpy(sim)
    quick_counts = read_counts()
    if y.node.value.device.type != "cuda":
        fail("hnp leaves did not land on the card")
    ref = (np.tanh(x.astype(np.float64) @ w1 + b1) @ w2)
    y_err = float(np.abs(y_np - ref).max() / np.abs(ref).max())
    sim_err = float(np.abs(sim_np - ref @ ref.T).max()
                    / np.abs(ref @ ref.T).max())
    if not (y_err <= TOL["float32"] and sim_err <= TOL["float32"]):
        fail(f"hnp quickstart values off: y {y_err}, syrk {sim_err}")
    if quick_counts["gemm"] != 2:
        fail(f"hnp quickstart launches {quick_counts}")
    quick = {
        "summary": region.report.summary(),
        "launches_by_node": [
            {"op": r.op, "backend": r.backend, "device_id": r.device_id,
             "resident_fraction": r.resident_fraction,
             "readback_bytes": r.readback_bytes, "fused": list(r.fused)}
            for r in region.report.launches],
        "records": [r.op for r in t.records], "kernel_launches": quick_counts,
        "max_rel_err_vs_float64": {"y": y_err, "syrk": sim_err},
    }

    # One wave of two independent same-shape GEMMs at yi-6b width.
    d, n = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
    bf16 = torch.bfloat16
    xa, wk, wv = randn(HNP_ROWS, d, dtype=bf16), randn(d, n, dtype=bf16), \
        randn(d, n, dtype=bf16)
    engine().reset()
    zero_counts()
    with offload_policy(**policy), offload_trace() as t:
        with hnp.offload_region("yi-kv-wave") as region:
            a = hnp.array(xa)
            yk, yv = a @ wk, a @ wv
            hnp.block_all(yk, yv)
            torch.cuda.synchronize()
            got = torch.stack([yk.node.value, yv.node.value])
    wave_counts = read_counts()
    ops = [r.op for r in t.records if r.op != "d2d_copy"]
    if ops != ["gemm_batched"] or wave_counts["gemm_batched"] != 1 or \
            wave_counts["gemm"] != 0:
        fail(f"hnp wave did not take one batched launch: {ops} "
             f"{wave_counts}")
    if not all(r.batched for r in region.report.launches):
        fail("hnp wave report is not batched")
    xf = xa.float().cpu().numpy().astype(np.float64)
    want = np.stack([xf @ w.float().cpu().numpy().astype(np.float64)
                     for w in (wk, wv)])
    got_np = got.float().cpu().numpy()
    err64 = float(np.abs(got_np - want).max() / np.abs(want).max())
    plain = gemm_batched_ref(torch.stack([xa, xa]), torch.stack([wk, wv]))
    err_plain, abs_plain = _rel_err(got, plain)
    if not (err64 <= TOL["bfloat16"] and err_plain <= TOL["bfloat16"]):
        fail(f"hnp wave values off: vs float64 {err64}, vs plain "
             f"{err_plain}")
    wave = {
        "summary": region.report.summary(), "records": ops,
        "shape": [2, HNP_ROWS, d, n], "dtype": "bfloat16",
        "kernel_launches": wave_counts,
        "gemm_batched_launched": wave_counts["gemm_batched"] == 1,
        "max_rel_err_vs_float64": err64, "max_rel_err_vs_plain": err_plain,
        "max_abs_err_vs_plain": abs_plain,
    }
    return {"quickstart": quick, "wave": wave, "launches": {
        k: quick_counts[k] + wave_counts[k] for k in quick_counts}}


def run_times(cfg, randn, launches, max_abs):
    """Phase 8: each kernel at its path's shapes; returns the kernels line."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched
    from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                         gemm_batched_ref, gemm_ref)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    per_shape = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "flops": 0.0}
    for name, m, k, n, count in serve_gemm_shapes(cfg):
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

    # The same GEMMs at the forward's m = 2 x 512 rows, per forward.
    fwd_shapes = []
    fwd_tot = {"ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for name, _, k, n, count in serve_gemm_shapes(cfg):
        m = FWD_BATCH * FWD_SEQ
        a = randn(m, k, dtype=bf16)
        ws = _rotation(lambda: randn(k, n, dtype=bf16), k * n * 2)
        t_k = _time(lambda w: gemm(a, w), ws, iters=10)
        t_l = _time(lambda w: torch.matmul(a, w), ws, iters=10)
        nbytes = 2.0 * (m * k + k * n + m * n)
        flops = 2.0 * m * n * k
        fwd_shapes.append({"shape": name, "m": m, "k": k, "n": n,
                           "launches_per_forward": count, "ms": t_k,
                           "library_ms": t_l,
                           "bound_ms": _bound_ms(nbytes, flops, "bfloat16"),
                           "TFLOPs": flops / t_k / 1e9})
        fwd_tot["ms"] += count * t_k
        fwd_tot["library_ms"] += count * t_l
        fwd_tot["bytes"] += count * nbytes
        fwd_tot["flops"] += count * flops
        del ws
    emit({"forward_gemm_shapes": fwd_shapes, "per_forward": {
        "ms": fwd_tot["ms"], "library_ms": fwd_tot["library_ms"],
        "bound_ms": _bound_ms(fwd_tot["bytes"], fwd_tot["flops"],
                              "bfloat16")}})

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
    del kvs

    # Flash attention at the forward's shape: one launch per layer.
    s = FWD_SEQ
    qkv = _rotation(lambda: (randn(FWD_BATCH, hq, s, d, dtype=bf16),
                             randn(FWD_BATCH, hkv, s, d, dtype=bf16),
                             randn(FWD_BATCH, hkv, s, d, dtype=bf16)),
                    2 * FWD_BATCH * (hq + 2 * hkv) * s * d)
    causal = (torch.arange(s, device=dev)[None, :]
              <= torch.arange(s, device=dev)[:, None])   # right-aligned
    t_ak = _time(lambda t: flash_attention(*t, causal=True), qkv)
    t_ap = _time(lambda t: attention_ref(*t, causal=True), qkv)
    t_al = _time(lambda t: torch.nn.functional.scaled_dot_product_attention(
        *t, attn_mask=causal, enable_gqa=True), qkv)
    a_bytes, a_flops = attn_work(FWD_BATCH, hq, hkv, s, s, d, True, None, 2)
    emit({"flash_attention_shape": {
        "B": FWD_BATCH, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
        "causal": True, "launches_per_forward": L, "ms": t_ak,
        "plain_ms": t_ap, "library_ms": t_al,
        "bound_ms": _bound_ms(a_bytes, a_flops, "bfloat16"),
        "bytes_bound_ms": 1e3 * a_bytes / HBM_BYTES_PER_S,
        "flop_bound_ms": 1e3 * a_flops / PEAK_FLOPS["bfloat16"],
        "TFLOPs": a_flops / t_ak / 1e9}})
    del qkv

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

    per = "decode_step"
    return [
        {"name": "gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm.py:32",
         "launches": launches["serve"]["gemm"], "path": "serve",
         "max_abs_err": max_abs["gemm"],
         "ms": tot["ms"], "plain_ms": tot["plain_ms"],
         "bound_ms": _bound_ms(tot["bytes"], tot["flops"], "bfloat16"),
         "bound_by": _bound_by(tot["bytes"], tot["flops"], "bfloat16"),
         "library_ms": tot["library_ms"], "per": per},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:32",
         "launches": launches["serve"]["flash_decode"], "path": "serve",
         "max_abs_err": max_abs["flash_decode"],
         "ms": L * t_dk, "plain_ms": L * t_dp,
         "bound_ms": _bound_ms(L * d_bytes, L * d_flops, "bfloat16"),
         "bound_by": _bound_by(d_bytes, d_flops, "bfloat16"),
         "library_ms": L * t_dl, "per": per},
        {"name": "gemm_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm.py:105",
         "launches": launches["hnp"]["gemm_batched"], "path": "hnp",
         "max_abs_err": max_abs["gemm_batched"],
         "ms": t_bk, "plain_ms": t_bp,
         "bound_ms": _bound_ms(b_bytes, b_flops, "bfloat16"),
         "bound_by": _bound_by(b_bytes, b_flops, "bfloat16"),
         "library_ms": t_bl, "per": "hnp_wave"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37",
         "launches": launches["forward"]["flash_attention"],
         "path": "forward", "max_abs_err": max_abs["flash_attention"],
         "ms": L * t_ak, "plain_ms": L * t_ap,
         "bound_ms": _bound_ms(L * a_bytes, L * a_flops, "bfloat16"),
         "bound_by": _bound_by(a_bytes, a_flops, "bfloat16"),
         "library_ms": L * t_al, "per": "forward"},
    ]


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
