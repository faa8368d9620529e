#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py [--out-dir DIR]

Files too long for standard output (the cluster run's Chrome trace, the
Fig. 3 rows) go to ``DIR`` (default ``artifacts/``, git-ignored).

Phases, in order; any failure exits non-zero and nothing is caught:

1. build    — compile every CUDA kernel (GEMM, flash decode, flash
              attention, SSD chunk) with nvcc (sm_90a) from
              ``src/repro_torch/kernels/csrc``, one nvcc per source, all
              started together;
2. check    — each kernel against its plain PyTorch version on the card, at
              the reference tests' shapes, at yi-6b's shapes (decode,
              prefill, the forward's GEMMs, the stacked GEMMs of the hnp
              phase) and at mamba2-370m's (the forward's GEMMs and their
              graph-mode stacks, the SSD chunk term of a 4 x 1024 and of a
              16-token forward); the GEMM's tensor-core route also at
              ragged shapes with both layouts of B, its fp32 accumulation,
              and each stacked launch bit for bit against its single
              launches; the skinny route at every decode GEMM of both
              models (mamba2-370m's K-major head and f32-output dt
              projection included) at m = 8 and 16, and a stacked decode
              launch bit for bit against its single launches; flash
              attention on both routes (bf16 at D 64 / 128
              on the tensor cores, f32 and other head dims on the CUDA
              cores), the prefill shape also as the model's transposed
              (B, S, H, D) views; flash decode on both routes (bf16 on
              the tensor cores, f32 on the CUDA cores), also on 4096- and
              4099-slot caches split across a cluster, each launch
              repeated bit for bit; the SSD chunk kernel on its
              tensor-core route (``mma``) at every case, the forward's
              shape repeated bit for bit; the batched GEMM at qwen3-moe's
              four expert shapes (128 experts, m 64 / 128, 2048 -> 768 and
              768 -> 2048) in bf16 and f32 against ``moe_gemm_ref``, and
              one 128-expert launch bit for bit against its single
              launches; the GEMM at qwen3-moe's other shapes (qkv, wo,
              the router written f32, the head) on ``skinny`` at m = 8 and
              16 and on ``wgmma`` at the forward's m = 1024;
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
              logits eager mode's on the kernels; then long-decode: one
              decode step at cache index 4000 of a 4096-slot cache filled
              from the seeded generator (yi-6b's published context), so
              flash decode runs split across clusters, kernels against
              the plain path;
5a. serve-cluster — ``serve_cluster`` on the same yi-6b weights: 4 request
              batches of the phase-3 shape over 4 modeled devices, (a)
              cost-aware with pinned KV caches, (b) round-robin with caches
              drained to host; every batch's greedy tokens must equal
              ``serve_batch``'s, (a) must decode where its caches live (no
              d2d, no re-stage), (b) must re-stage, every launch of (a) on
              ``skinny`` / ``mma`` (161 and 32 a step), every record on its
              batch's lane; wall seconds, the card's busy time (profiled run
              (b)) and the modeled makespan;
5b. trace-export — run (a) again under a ``SpanTracer``: its Chrome trace
              must validate, every ticket of the run (kept by the flight
              recorder) must have its span; written gzipped to
              ``DIR/serve_cluster_trace.json.gz``;
6. float32  — first-step decode logits and last-position forward logits of
              the same model with f32 weights, kernels against plain, and
              the long-cache decode step of phase 5 with these weights;
7. hnp      — the paper's path: the reference quickstart's graph, then one
              wave of two same-shape GEMMs at yi-6b width stacked into one
              batched-GEMM launch;
7a. paper-fig3 — the paper's Fig. 3 on the card
              (``tools/paper_fig3_h100.py``): host numpy against
              ``blas.gemm`` offloaded, n 16 to 128, f64 / f32 / bf16, copy /
              launch / compute split, each result within its bar of numpy's
              f64 product and on its backend and route (f64 the plain
              ``device`` path, f32 ``skinny`` / ``tiled``, bf16 ``skinny`` /
              ``wgmma``), and the crossover n; written to
              ``DIR/paper_fig3.json``;
8. ssm-forward — the SSM path: ``Model.forward`` of mamba2-370m at full
              width (bf16, random weights) on 4 x 1024 tokens, eager and
              graph mode, on the kernels (48 SSD launches per forward) and
              on the plain path; the profiled eager forward's device time
              by kernel name (top 15, with launches);
9. ssm-serve — mamba2-370m served at full width, 8 requests of 16 + 16
              tokens, kernels against the plain path (decode is the
              one-step recurrence: GEMM kernel only);
10. ssm-float32 — the same model with f32 weights: last-position forward
              logits at 1 x 512 (two chunks), kernels against plain; and the
              decode recurrence against the chunked SSD on the kernels (the
              serve prefill's last logits against the forward's);
10a. moe-serve — qwen3-moe-30b-a3b at full width (bf16, 30,531,911,680
              parameters built on the card from a seeded generator), 8
              requests of 16 + 16 tokens, kernels against the plain path:
              a decode step launches the batched GEMM 144 times (gate, up,
              down of 128 experts a layer, m = 64: ``wgmma``), the GEMM 145
              times (qkv, wo, router a layer and the head: ``skinny``) and
              flash decode 48 times (``mma``); the first step profiled, also
              with the MoE books' host read-back turned off (idle share and
              the host's wait in runtime syncs, each profile); the MoE books
              (routed, dropped, drop rate);
10b. moe-serve-graph — the same serve with ``forward_mode="graph"``: its
              greedy tokens must equal 10a's;
10c. moe-forward — ``Model.forward`` on 2 x 512 tokens, eager and graph,
              kernels against plain: 144 batched GEMMs (m = 128) and 48
              flash attention launches, all ``wgmma``; the drop rate;
10f. moe-layer — layer 0's expert FFN at full width, kernels against plain
              on identical inputs (no routing decision can differ), 2e-2 x
              max |plain|: ``blas.moe_expert_ffn`` on a full expert buffer
              at the decode step's and the forward's groups, and the
              grouped dispatch with one shared routing at 8 and 1024
              tokens;
10e. moe-placed — one qwen3 MoE layer at full width with an
              ``ExpertPlacementPolicy`` over 4 modeled lanes fed a Zipf(1.2)
              histogram stream: ``moe_ffn_placed`` must equal
              ``moe_ffn(moe_dispatch="grouped")`` bit for bit on the
              kernels (run before 10d, on 10a's weights);
10d. moe-float32 — 2 layers at published widths in f32 (the depth cut):
              first decode step and last-position logits of a 1 x 128
              forward, kernels against plain, 1e-4 x max |logit|, and the
              count of routing decisions the two paths make differently;
11. time    — each kernel at its path's shapes beside its bound, its plain
              version and one library call (CUDA events); the decode GEMMs
              of both models over rotated weights with GB/s, the bound's
              share and per-step totals, and the skinny kernel against k
              (streaming rate and fixed cost beside torch.matmul's); flash
              attention also on the transposed views and beside SDPA's
              is_causal; flash decode at the serve step's cache and at a
              4096-slot cache (B 8 and B 1) beside SDPA; the SSD chunk
              kernel beside its bytes / 3xTF32 bound and the CUDA cores'
              fp32 bound; the batched GEMM at qwen3-moe's four expert
              shapes beside torch.bmm and its bound; qwen3-moe's decode
              GEMMs outside the experts (qkv, wo, router, head).

Each path's launch counters are set to 0 just before it runs and read just
after; the GEMM's, flash attention's and flash decode's route counters
too: every bf16 forward and hnp-wave GEMM and every bf16 forward attention
launch must have taken the tensor-core route (``wgmma``), every serving
GEMM the skinny one, every bf16 decode attention launch the tensor-core
one (``mma``), the f32 forward's and decode's attention the CUDA-core
one (``simt``), and every SSD launch of the phase-2 checks and of the
forwards (eager, graph, f32) the tensor-core one (``mma``).  The last
line of stdout is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit from nvidia-smi, and the one before that
lists every kernel.  Imports nothing of JAX or of the JAX
reference package.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "artifacts"

# yi-6b serve cell (configs/yi_6b.py at full width).
ARCH = "yi-6b"
BATCH = 8
PROMPT_LEN = 16
MAX_NEW = 16
CACHE_LEN = 64
SEED = 0
# Long-cache decode (phases 5 and 6): yi-6b's published 4096-token
# context, one step at cache index 4000 (slots [0, 4001) valid).
LONG_CACHE, LONG_INDEX = 4096, 4000
# Cluster serving (phase 5a): CLUSTER_BATCHES request batches of the serve
# cell's shape over CLUSTER_DEVICES modeled devices.
CLUSTER_DEVICES, CLUSTER_BATCHES = 4, 4
# yi-6b forward (prefill) cell: 2 sequences of 512 tokens; the f32 check
# runs 1 sequence of 128 tokens.
FWD_BATCH, FWD_SEQ = 2, 512
F32_FWD_BATCH, F32_FWD_SEQ = 1, 128
# hnp phase: the reference quickstart's shapes (examples/quickstart.py),
# then a wave of two GEMMs at yi-6b width: x (rows x d) @ wk, x @ wv.
HNP_ROWS = 1024

# mamba2-370m (configs/mamba2_370m.py at full width): forward on 4 x 1024
# tokens (bf16); the f32 forward check runs 1 x 512 (two 256-token chunks);
# serving uses the yi-6b cell's requests (BATCH x PROMPT_LEN + MAX_NEW).
SSM_ARCH = "mamba2-370m"
SSM_FWD_BATCH, SSM_FWD_SEQ = 4, 1024
SSM_F32_FWD_SEQ = 512
# SSD chunk kernel: tests/test_kernels.py:162-169's bar (1e-4, f32) per
# output row; bf16 operands round once, as the other kernels' 2e-2.
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The serve prefill (token-by-token recurrence) against Model.forward (the
# chunked SSD) at full width, f32, x max |logit|: both sum in fp32 in other
# orders (see PERF.md for the prediction).
DECODE_VS_FORWARD_TOL = 1e-3
# (BH, C, Q, P, N, tag): tests/test_kernels.py:162's three shapes, the
# 4 x 1024 forward's (BH 4 x 32 heads, 4 chunks of 256) and the 16-token
# forward's (BH 8 x 32, one 16-row chunk).
TEST_SSD_CASES = [(4, 2, 32, 16, 8, "test"), (2, 8, 64, 32, 16, "test"),
                  (1, 1, 8, 8, 8, "test"),
                  (SSM_FWD_BATCH * 32, SSM_FWD_SEQ // 256, 256, 64, 128,
                   "forward"),
                  (BATCH * 32, 1, PROMPT_LEN, 64, 128, "16-token")]

# qwen3-moe-30b-a3b (configs/qwen3_moe_30b_a3b.py at full width): served
# with the yi-6b cell's requests, forward on FWD_BATCH x FWD_SEQ tokens; the
# f32 check cuts the depth to MOE_F32_LAYERS (the f32 model at 48 layers
# would not fit the card) and runs a 1 x F32_FWD_SEQ forward; the placed
# layer runs MOE_PLACED_STEPS Zipf(MOE_PLACED_ZIPF) histograms over
# MOE_PLACED_LANES modeled lanes before its step.
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PARAMS = 30_531_911_680
MOE_F32_LAYERS = 2
MOE_PLACED_LANES, MOE_PLACED_ZIPF, MOE_PLACED_STEPS = 4, 1.2, 16

# H100 SXM data-sheet peaks (dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

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
# The GEMM's tensor-core route (bf16, m > 16) at ragged shapes: m, n and k
# off the 128 / 128 / 64 tile (k a multiple of 8, as TMA needs), a narrow n
# (the 64-wide tile), each with B row-major ("mn") and K-major ("k").
WGMMA_RAGGED = [(17, 72, 104), (100, 32, 1016), (1000, 5128, 8 * 131),
                (200, 136, 96)]
# Batched GEMM: tests/test_kernels.py:51-57 (bsz x 96x64 @ 64x80).
TEST_GEMM_BATCHED = [1, 3, 8]
# Flash-decode cases of tests/test_kernels.py:120-123, the serve shape
# itself (cache of CACHE_LEN slots, bounds [0, index + 1) as decode steps
# give them), the serve geometry at S = 300 with ragged bounds and one
# fully masked row, and on 4096- and 4099-slot caches (8 splits): the long
# step's bounds, a rolling window (lo > 0, hi = S), an empty row, rows
# that leave whole splits empty, ragged rows.
TEST_DECODE_CASES = [
    dict(hq=4, hkv=2, s=64, d=16, bounds=[(0, 64), (5, 40), (10, 33)]),
    dict(hq=8, hkv=8, s=96, d=16, bounds=[(0, 96), (0, 1), (95, 96)]),
    dict(hq=32, hkv=4, s=CACHE_LEN, d=128,
         bounds=[(0, 1), (0, 2), (0, 16), (0, 17), (0, 31), (0, 32),
                 (0, 33), (0, 64)]),
    dict(hq=32, hkv=4, s=300, d=128,
         bounds=[(0, 300), (5, 40), (10, 33), (0, 1), (299, 300),
                 (100, 100), (37, 250), (0, 150)]),
    *[dict(hq=32, hkv=4, s=s, d=128,
           bounds=[(0, LONG_INDEX + 1), (s // 3, s), (2048, 2048),
                   (s - 40, s - 3), (5, 200), (2041, 2057), (37, s - 11),
                   (0, s)])
      for s in (LONG_CACHE, LONG_CACHE + 3)],
]
# Flash-decode shapes timed in phase 11 and by tools/flash_decode_times.py:
# (tag, B, S, valid slots): yi-6b's last serve step (a cache of CACHE_LEN
# slots, PROMPT_LEN + MAX_NEW - 1 valid) and its published 4096-token
# context (4095 valid) at B 8 and at B 1 (one long request).
DECODE_TIME_SHAPES = [("serve", BATCH, CACHE_LEN, PROMPT_LEN + MAX_NEW - 1),
                      ("long", BATCH, LONG_CACHE, LONG_CACHE - 1),
                      ("long-b1", 1, LONG_CACHE, LONG_CACHE - 1)]
# Flash attention: the six cases of tests/test_kernels.py:83-106 (D 32,
# B 2), the yi-6b prefill shape (as (B, H, S, D) tensors and as the
# model's transposed (B, S, H, D) views), and rows a window leaves empty
# (bidir. with window -5: the last six queries see no key) at D 80 and 128;
# then D 64 (the tensor-core route's other tile): causal GQA, ragged with a
# window, empty rows, and a kv loop (5 tiles) that wraps its 3-stage ring.  bf16 at D 64 / 128 must take the ``wgmma``
# route, everything else ``simt``.
TEST_ATTN_CASES = [
    dict(b=2, sq=128, skv=128, hq=4, hkv=4, d=32, causal=True),
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=32, causal=True),
    dict(b=2, sq=96, skv=96, hq=4, hkv=2, d=32, causal=True, window=32),
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, d=32, causal=False),
    dict(b=2, sq=16, skv=128, hq=4, hkv=2, d=32, causal=True),
    dict(b=2, sq=100, skv=100, hq=4, hkv=2, d=32, causal=True),
    dict(b=FWD_BATCH, sq=FWD_SEQ, skv=FWD_SEQ, hq=32, hkv=4, d=128,
         causal=True, tag="prefill"),
    dict(b=FWD_BATCH, sq=FWD_SEQ, skv=FWD_SEQ, hq=32, hkv=4, d=128,
         causal=True, tag="prefill", view=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=False, window=-5),
    dict(b=1, sq=200, skv=200, hq=8, hkv=1, d=128, causal=False, window=-5),
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=64, causal=True),
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=64, causal=True, window=20),
    dict(b=2, sq=200, skv=200, hq=4, hkv=4, d=64, causal=False, window=-5,
         view=True),
    dict(b=1, sq=600, skv=600, hq=4, hkv=2, d=64, causal=True),
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


def ssm_serve_gemm_shapes(ssm_cfg):
    """(name, m, k, n, launches per decode step, B layout, out dtype) of
    every GEMM mamba2-370m's decode step runs on the kernel (m = batch):
    z, x, B, C, dt (written f32) and out per layer, and the tied head's
    ``embed.T`` (K-major)."""
    d, di, L = ssm_cfg.d_model, ssm_cfg.d_inner, ssm_cfg.num_layers
    gn = ssm_cfg.ssm_num_groups * ssm_cfg.ssm_state_dim
    return [("wz/wx", BATCH, d, di, 2 * L, "mn", "bfloat16"),
            ("wb/wc", BATCH, d, gn, 2 * L, "mn", "bfloat16"),
            ("wdt", BATCH, d, ssm_cfg.ssm_num_heads, L, "mn", "float32"),
            ("wo", BATCH, di, d, L, "mn", "bfloat16"),
            ("head", BATCH, d, ssm_cfg.vocab_size, 1, "k", "bfloat16")]


def moe_serve_gemm_shapes(moe_cfg, m=BATCH):
    """(name, m, k, n, launches per decode step or forward, B layout, out
    dtype) of qwen3-moe's GEMMs outside the experts: qkv, wo and the router
    (written f32) a layer, and the untied head."""
    d, hd, L = moe_cfg.d_model, moe_cfg.head_dim, moe_cfg.num_layers
    qkv_n = (moe_cfg.num_heads + 2 * moe_cfg.num_kv_heads) * hd
    return [("qkv_project", m, d, qkv_n, L, "mn", "bfloat16"),
            ("wo", m, moe_cfg.num_heads * hd, d, L, "mn", "bfloat16"),
            ("router", m, d, moe_cfg.num_experts, L, "mn", "float32"),
            ("head", m, d, moe_cfg.vocab_size, 1, "mn", "bfloat16")]


def forward_gemm_shapes(cfg, ssm_cfg):
    """(tag, m, k, n, launches per forward, B layout) of every GEMM of the
    yi-6b forward (m = 2 x 512) and of the mamba2-370m forward (m = 4 x
    1024; its tied head multiplies by ``embed.T``, a K-major B)."""
    m = FWD_BATCH * FWD_SEQ
    yi = [(f"yi:{name}", m, k, n, count, "mn")
          for name, _, k, n, count in serve_gemm_shapes(cfg)]
    ms, Ls = SSM_FWD_BATCH * SSM_FWD_SEQ, ssm_cfg.num_layers
    d, di = ssm_cfg.d_model, ssm_cfg.d_inner
    gn = ssm_cfg.ssm_num_groups * ssm_cfg.ssm_state_dim
    ssm = [("mamba:wz/wx", ms, d, di, 2 * Ls, "mn"),
           ("mamba:wb/wc", ms, d, gn, 2 * Ls, "mn"),
           ("mamba:wdt", ms, d, ssm_cfg.ssm_num_heads, Ls, "mn"),
           ("mamba:wo", ms, di, d, Ls, "mn"),
           ("mamba:head", ms, d, ssm_cfg.vocab_size, 1, "k")]
    return yi + ssm


def graph_stack_shapes(cfg, ssm_cfg):
    """(tag, batch, m, k, n, launches per forward or wave) of the stacked
    GEMMs: mamba2-370m's graph-mode z/x and B/C stacks and the hnp wave."""
    ms, Ls = SSM_FWD_BATCH * SSM_FWD_SEQ, ssm_cfg.num_layers
    d = ssm_cfg.d_model
    gn = ssm_cfg.ssm_num_groups * ssm_cfg.ssm_state_dim
    return [("mamba-graph:z/x", 2, ms, d, ssm_cfg.d_inner, Ls),
            ("mamba-graph:B/C", 2, ms, d, gn, Ls),
            ("hnp-wave", 2, HNP_ROWS, cfg.d_model,
             cfg.num_kv_heads * cfg.head_dim, 1)]


def moe_groups(moe_cfg):
    """{path: (groups, capacity)} of the MoE dispatch for a decode step of
    BATCH tokens and a FWD_BATCH x FWD_SEQ forward (``models/moe.py``'s
    arithmetic)."""
    from repro_torch.models.moe import _dispatch_groups, expert_capacity

    out = {}
    for path, t in (("decode", BATCH), ("forward", FWD_BATCH * FWD_SEQ)):
        g = _dispatch_groups(t, moe_cfg)
        out[path] = (g, expert_capacity(t // g, moe_cfg))
    return out


def moe_expert_shapes(moe_cfg):
    """(tag, E, m, k, n, launches per decode step or forward) of the expert
    GEMMs, m = groups x capacity: gate and up (d -> f), down (f -> d)."""
    e, d, f = moe_cfg.num_experts, moe_cfg.d_model, moe_cfg.moe_d_ff
    L = moe_cfg.num_layers
    out = []
    for path, (g, cap) in moe_groups(moe_cfg).items():
        out += [(f"{path}:gate/up", e, g * cap, d, f, 2 * L),
                (f"{path}:down", e, g * cap, f, d, L)]
    return out


def b_operand(randn, k, n, layout, dtype, batch=None):
    """B as [k, n] (or [batch, k, n]): row-major for ``"mn"``, the
    transpose of a row-major [n, k] for ``"k"``."""
    lead = () if batch is None else (batch,)
    if layout == "mn":
        return randn(*lead, k, n, dtype=dtype)
    return randn(*lead, n, k, dtype=dtype).transpose(-1, -2)


def _routed():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag

    return {"gemm": gemm, "gemm_batched": gemm_batched,
            "flash_attention": flash_attention, "flash_decode": flash_decode,
            "ssd_chunk_diag": ssd_chunk_diag}


def zero_routes():
    for fn in _routed().values():
        fn.route_launches.update(dict.fromkeys(fn.route_launches, 0))


def read_routes():
    """{"gemm": {route: launches}, "gemm_batched": {...},
    "flash_attention": {...}, "flash_decode": {...}, "ssd_chunk_diag":
    {...}} since the last ``zero_routes``."""
    return {k: dict(fn.route_launches) for k, fn in _routed().items()}


def require_route(label, routes, route, decode=None, batched=None):
    """Fail unless every GEMM and flash-attention launch in ``routes`` took
    ``route``, every flash-decode launch ``decode``, every SSD chunk launch
    ``mma`` and every batched GEMM launch ``batched`` (default ``route``;
    a path that launches no attention or SSD passes on the GEMMs)."""
    want = {"flash_decode": decode, "ssd_chunk_diag": "mma",
            "gemm_batched": batched or route}
    stray = {k: {r: n for r, n in v.items() if r != want.get(k, route) and n}
             for k, v in routes.items()}
    if any(stray.values()):
        fail(f"{label}: kernel launches off the {route} / {decode} / mma "
             f"routes: {routes}")


def decode_route_of(dtype):
    """Flash decode's route for the models' (aligned, D 128) operands."""
    import torch

    return "mma" if dtype in ("bfloat16", torch.bfloat16) else "simt"


def attn_operands(randn, b, hq, hkv, sq, skv, d, dtype, view):
    """q, k, v as (B, H, S, D) tensors, or (``view``) as transposed views
    of (B, S, H, D) storage, as the model hands them over."""
    def make(h, s):
        if view:
            return randn(b, s, h, d, dtype=dtype).transpose(1, 2)
        return randn(b, h, s, d, dtype=dtype)

    return make(hq, sq), make(hkv, skv), make(hkv, skv)


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
    global OUT_DIR
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one H100.")
    ap.add_argument("--out-dir", type=pathlib.Path, default=OUT_DIR,
                    help="where the long outputs go (default: artifacts/)")
    OUT_DIR = ap.parse_args().out_dir.resolve()
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
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag

    counters = {"gemm": gemm, "gemm_batched": gemm_batched,
                "flash_decode": flash_decode,
                "flash_attention": flash_attention,
                "ssd_chunk_diag": ssd_chunk_diag}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        zero_routes()

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
    ssm_cfg = get_arch(SSM_ARCH)
    moe_cfg = get_arch(MOE_ARCH)
    max_abs = check_kernels(cfg, ssm_cfg, moe_cfg, randn)

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
    launches, routes = {}, {}
    serve = run_serve(cfg, model, params, prompts, "eager", zero_counts,
                      read_counts)
    serve["init_s"] = init_s
    serve["params"] = sum(t.numel() for t in _leaves(params))
    launches["serve"] = serve["launches"]
    routes["serve"] = serve["routes"]
    emit({"phase": "serve", **serve})

    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(FWD_BATCH, FWD_SEQ))).to(dev)
    fwd = run_forward(cfg, model, params, tokens, zero_counts, read_counts)
    launches["forward"] = fwd["launches"]["eager"]
    routes["forward"] = fwd["routes"]["eager"]
    routes["forward-graph"] = fwd["routes"]["graph"]
    emit({"phase": "forward", **fwd})

    serve_g = run_serve(cfg, model, params, prompts, "graph", zero_counts,
                        read_counts)
    serve_g["eager_tokens_per_s"] = serve["kernel"]["tokens_per_s"]
    # Both modes run the same kernels on the same operands.
    if serve_g.pop("tokens") != serve["tokens"]:
        fail("graph-mode serving gave other greedy tokens than eager mode")
    serve_g["greedy_tokens_equal_eager"] = True
    emit({"phase": "serve-graph", **serve_g})
    long_decode = run_long_decode(cfg, model, params, prompts, zero_counts,
                                  read_counts)
    launches["long-decode"] = long_decode["launches"]
    routes["long-decode"] = long_decode["routes"]
    cluster = run_serve_cluster(cfg, params, prompts, serve["tokens"],
                                zero_counts, read_counts)
    launches["serve-cluster"] = cluster["launches"]
    routes["serve-cluster"] = cluster["routes"]
    del params
    torch.cuda.empty_cache()

    # ---- 6. the same model with f32 weights -----------------------------
    routes["float32"], routes["long-decode-f32"] = run_f32(
        cfg, tokens, prompts, zero_counts, read_counts)

    # ---- 7. hnp: the paper's path ---------------------------------------
    hnp_phase = run_hnp(cfg, randn, zero_counts, read_counts)
    launches["hnp"] = hnp_phase["launches"]
    routes["hnp-wave"] = hnp_phase["wave"]["routes"]
    max_abs["gemm_batched"] = max(max_abs["gemm_batched"],
                                  hnp_phase["wave"]["max_abs_err_vs_plain"])
    emit({"phase": "hnp", **hnp_phase})
    fig3 = run_paper_fig3(zero_counts, read_counts)
    launches["paper-fig3"] = fig3["launches"]
    routes["paper-fig3"] = fig3["routes"]

    # ---- 8.-10. the SSM path: mamba2-370m at full width -------------------
    ssm_model = build_model(ssm_cfg)
    t0 = time.perf_counter()
    ssm_params = ssm_model.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    ssm_init_s = time.perf_counter() - t0
    ssm_tokens = torch.from_numpy(rng.integers(
        0, ssm_cfg.vocab_size, size=(SSM_FWD_BATCH, SSM_FWD_SEQ))).to(dev)
    ssm_fwd = run_forward(ssm_cfg, ssm_model, ssm_params, ssm_tokens,
                          zero_counts, read_counts)
    ssm_fwd["init_s"] = ssm_init_s
    ssm_fwd["params"] = sum(t.numel() for t in _leaves(ssm_params))
    launches["ssm-forward"] = ssm_fwd["launches"]["eager"]
    launches["ssm-forward-graph"] = ssm_fwd["launches"]["graph"]
    routes["ssm-forward"] = ssm_fwd["routes"]["eager"]
    routes["ssm-forward-graph"] = ssm_fwd["routes"]["graph"]
    emit({"phase": "ssm-forward", **ssm_fwd})
    ssm_prompts = [[int(t) for t in rng.integers(1, ssm_cfg.vocab_size,
                                                 size=PROMPT_LEN)]
                   for _ in range(BATCH)]
    ssm_serve = run_serve(ssm_cfg, ssm_model, ssm_params, ssm_prompts,
                          "eager", zero_counts, read_counts)
    ssm_serve.pop("tokens")
    launches["ssm-serve"] = ssm_serve["launches"]
    routes["ssm-serve"] = ssm_serve["routes"]
    emit({"phase": "ssm-serve", **ssm_serve})
    del ssm_params
    torch.cuda.empty_cache()
    run_ssm_f32(ssm_cfg, ssm_tokens, ssm_prompts)

    # ---- 10a.-10f. MoE: qwen3-moe-30b-a3b at full width --------------------
    run_moe(moe_cfg, rng, zero_counts, read_counts, launches, routes)

    # ---- 11. times --------------------------------------------------------
    kernels = run_times(cfg, ssm_cfg, moe_cfg, randn, launches, routes,
                        max_abs)
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


def check_kernels(cfg, ssm_cfg, moe_cfg, randn):
    """Phase 2: every kernel against its plain version; returns the max
    abs errors at the main paths' shapes (bf16)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import (cluster_capacity, decode_plan,
                                                  flash_decode)
    from repro_torch.kernels.gemm import gemm, gemm_batched
    from repro_torch.kernels.ref import (attention_ref, decode_attention_ref,
                                         gemm_batched_ref, gemm_ref,
                                         moe_gemm_ref, ssd_chunk_diag_ref)
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag, ssd_route

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    max_abs = {"gemm": 0.0, "flash_decode": 0.0, "gemm_batched": 0.0,
               "flash_attention": 0.0, "ssd_chunk_diag": 0.0,
               "gemm:forward": 0.0, "gemm_batched:forward": 0.0,
               "gemm:ssm-serve": 0.0, "gemm:moe": 0.0,
               "gemm_batched:moe": 0.0}
    checks = []

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
    # cores, f32 on the CUDA cores, against moe_gemm_ref; weights scaled as
    # the model draws them.  Then the decode step's gate GEMM in one launch
    # against its 128 single launches, bit for bit.
    for tag, e, m, k, n, _ in moe_expert_shapes(moe_cfg):
        for dt in (torch.float32, bf16):
            a = randn(e, m, k, dtype=dt)
            b = (randn(e, k, n) * k ** -0.5).to(dt)
            route = "wgmma" if dt == bf16 else "tiled"
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
            route = ("wgmma" if dt == bf16 and case["d"] in (64, 128)
                     else "simt")
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
    emit({"phase": "check", "checks": checks,
          "flash_decode_clusters_per_wave": {
              f"{route} {str(dt)[6:]} D{cfg.head_dim}": cluster_capacity(
                  route, dt, cfg.head_dim, 0)
              for route, dt in (("mma", bf16), ("simt", torch.float32))},
          "flash_attention_masked_rows_exactly_zero": masked_rows,
          "ssd_min_log_decay": min_log_decay,
          "ssd_forward_repeat_bit_equal": True})
    return max_abs


def expected(cfg, path, mode):
    """(kernel launches, seam ops that must all be on device-kernel) of one
    decode step (``path="serve"``) or one forward (``"forward"``).

    yi-6b: per layer qkv, wo, gate, up, down GEMMs and one attention
    launch (flash decode in a step, flash attention in a forward).
    mamba2-370m: per layer six GEMMs (z, x, B, C, dt, out) and, in a
    forward, one SSD chunk launch; graph mode stacks z/x and B/C into one
    batched launch each; decode is the one-step recurrence (no SSD
    launch).  qwen3-moe: per layer qkv, wo and the router on the GEMM,
    the expert FFN's gate, up and down on the batched GEMM (experts the
    batch), one attention launch; graph mode runs the MoE FFN eagerly, so
    its counts are eager mode's.  All: plus the head GEMM."""
    L = cfg.num_layers
    counts = dict.fromkeys(("gemm", "gemm_batched", "flash_decode",
                            "flash_attention", "ssd_chunk_diag"), 0)
    if cfg.num_experts:
        attn = "flash_decode" if path == "serve" else "flash_attention"
        return ({**counts, "gemm": 3 * L + 1, "gemm_batched": 3 * L,
                 attn: L},
                {"gemm", "qkv_project", "attention", "moe_expert_ffn"})
    if cfg.family == "ssm":
        if path == "serve":
            return {**counts, "gemm": 6 * L + 1}, {"gemm"}
        if mode == "graph":
            return ({**counts, "gemm": 2 * L + 1, "gemm_batched": 2 * L,
                     "ssd_chunk_diag": L}, {"gemm", "gemm_batched", "ssd_scan"})
        return ({**counts, "gemm": 6 * L + 1, "ssd_chunk_diag": L},
                {"gemm", "ssd_scan"})
    attn = "flash_decode" if path == "serve" else "flash_attention"
    return ({**counts, "gemm": 5 * L + 1, attn: L},
            {"gemm", "qkv_project", "mlp_block", "attention"})


def run_serve(cfg, model, params, prompts, forward_mode, zero_counts,
              read_counts, books=None):
    """Phases 3, 5, 9, 10a and 10b: serve the prompts on the kernels
    (counted; its metrics into the registry ``books`` when given) and on
    the plain path, and compare first-step bf16 logits: in eager mode the
    kernels' against the plain path's, in graph mode the graph model's
    against the eager model's, both on the kernels."""
    import contextlib

    import torch

    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import build_model
    from repro_torch.obs import metrics

    dev = torch.device("cuda")
    arch = cfg.name
    steps = PROMPT_LEN + MAX_NEW
    kw = dict(smoke=False, cache_len=CACHE_LEN, params=params, device=dev,
              forward_mode=forward_mode)
    # Warm the plain path's allocator and the kernels' libraries once.
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        serve_batch(arch, prompts, max_new_tokens=1, **kw)
    zero_counts()
    with offload_policy(**KERNEL_POLICY), offload_trace() as trace, \
            (metrics.collect(books) if books is not None
             else contextlib.nullcontext()):
        res_k = serve_batch(arch, prompts, max_new_tokens=MAX_NEW, **kw)
    launches = read_counts()
    routes = read_routes()
    per_step, ops = expected(cfg, "serve", forward_mode)
    want = {k: steps * v for k, v in per_step.items()}
    if launches != want:
        fail(f"{arch} serve ({forward_mode}) kernel launches {launches}, "
             f"want {want}")
    # The expert GEMMs have m = groups x capacity (64), not the batch.
    require_route(f"{arch} serve ({forward_mode})", routes, "skinny",
                  decode=decode_route_of(cfg.dtype),
                  batched="wgmma" if cfg.num_experts else None)
    backends = _backends(trace, ops)
    with offload_policy(**PLAIN_POLICY):
        res_p = serve_batch(arch, prompts, max_new_tokens=MAX_NEW, **kw)
    tok = res_k.tokens
    if tok.shape != (BATCH, MAX_NEW) or tok.min() < 0 or \
            tok.max() >= cfg.vocab_size:
        fail(f"{arch} served tokens malformed: shape {tok.shape}")
    out = {
        "arch": arch, "forward_mode": forward_mode, "dtype": cfg.dtype,
        "batch": BATCH, "prompt_len": PROMPT_LEN, "max_new": MAX_NEW,
        "cache_len": CACHE_LEN,
        "kernel": {"prefill_s": res_k.prefill_s, "decode_s": res_k.decode_s,
                   "tokens_per_s": res_k.tokens_per_s},
        "plain": {"prefill_s": res_p.prefill_s, "decode_s": res_p.decode_s,
                  "tokens_per_s": res_p.tokens_per_s},
        "launches": launches, "routes": routes, "trace_backends": backends,
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
        out["profile_first_step"] = _profile(
            lambda: first_logits(KERNEL_POLICY))
        errs = _logit_errs(first_logits, (BATCH, cfg.vocab_size))
        bar = max(LOGIT_TOL, 2 * errs["floor"])
        if not errs["err"] <= bar:
            fail(f"{arch} bf16 first-step logits differ: {errs} > {bar}")
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


KERNEL_FAMILIES = {"gemm": ("gemm_wgmma", "gemm_tiled", "gemm_skinny"),
                   "flash_attention": ("flash_attention_kernel",
                                       "attn_wgmma"),
                   "flash_decode": ("flash_decode_",),
                   "ssd_chunk_diag": ("ssd_chunk_kernel", "ssd_mma_kernel")}


# CUDA runtime calls in which the host can wait for the card; the
# profiler records them as host events.  A read-back to the host is a
# cudaMemcpyAsync and a cudaStreamSynchronize.
HOST_WAITS = ("cudaStreamSynchronize", "cudaMemcpyAsync",
              "cudaDeviceSynchronize")


def _profile(fn, cuda_only=False):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity, or the
    card's alone for a long run) after a synchronize.  Returns the host-clock wall time of the profiled run,
    the device time of its kernels by family (the port's kernels by name,
    everything else as "other": torch's elementwise kernels, cuBLAS), and
    the device's idle share 1 - busy / wall, and the top 15 device kernels
    by name (ms, launches); "not measured" when the profiler records no
    device activity.  With CPU activity also the host's ms and calls in
    each of HOST_WAITS, and the read-backs' share of them
    (``host_sync_wait_ms``: stream syncs and copies; the closing device
    synchronize apart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if not cuda_only:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by = {name: 0.0 for name in (*KERNEL_FAMILIES, "other")}
    launches = dict.fromkeys(by, 0)
    gemm_tiles = dict.fromkeys(KERNEL_FAMILIES["gemm"], 0.0)
    names = {}
    waits = {name: {"ms": 0.0, "calls": 0} for name in HOST_WAITS}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name in waits:
                waits[ev.name]["ms"] += ev.time_range.elapsed_us() / 1e3
                waits[ev.name]["calls"] += 1
            continue
        fam = next((f for f, keys in KERNEL_FAMILIES.items()
                    if any(k in ev.name for k in keys)), "other")
        ms = ev.time_range.elapsed_us() / 1e3
        by[fam] += ms
        launches[fam] += 1
        for tile in gemm_tiles:
            if tile in ev.name:
                gemm_tiles[tile] += ms
        row = names.setdefault(ev.name[:160], [0.0, 0])
        row[0] += ms
        row[1] += 1
    busy = sum(by.values())
    if busy == 0.0:
        return {"wall_ms": wall_ms, "device": "not measured"}
    extra = {}
    if not cuda_only:
        extra["host_waits"] = waits
        extra["host_sync_wait_ms"] = (
            waits["cudaStreamSynchronize"]["ms"]
            + waits["cudaMemcpyAsync"]["ms"]
            if any(w["calls"] for w in waits.values()) else "not measured")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms, **extra,
            "device_ms_by_kernel": by, "device_launches_by_kernel": launches,
            "gemm_device_ms_by_tile": gemm_tiles,
            "top_kernels": [{"name": k, "ms": v[0], "launches": v[1]}
                            for k, v in sorted(names.items(),
                                               key=lambda kv: -kv[1][0])[:15]]}


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
    """Phases 4 and 8: Model.forward at full width, eager and graph mode
    on the kernels (counted), and on the plain path."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    arch = cfg.name
    bsz, seq = tokens.shape
    out = {"arch": arch, "dtype": cfg.dtype, "batch": bsz, "seq": seq,
           "seconds": {}, "launches": {}, "routes": {}, "trace_backends": {}}
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
        runs = [time.perf_counter() - t0]
        counts = read_counts()
        out["launches"][mode] = counts
        out["routes"][mode] = read_routes()
        require_route(f"{arch} forward ({mode})", out["routes"][mode],
                      "wgmma")
        for _ in range(2):           # two more, uncounted, for the spread
            t0 = time.perf_counter()
            with offload_policy(**KERNEL_POLICY), torch.no_grad():
                mdl.forward(params, tokens)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        out["seconds"][mode] = sorted(runs)[1]
        out.setdefault("seconds_runs", {})[mode] = runs
        want, ops = expected(cfg, "forward", mode)
        if counts != want:
            fail(f"{arch} forward ({mode}) kernel launches {counts}, want "
                 f"{want}")
        out["trace_backends"][mode] = _backends(trace, ops)
        want_shape = (bsz, seq, cfg.vocab_size)
        # The aux loss is the MoE routers' (a positive sum), else 0.
        aux_ok = (math.isfinite(float(aux)) and float(aux) > 0
                  if cfg.num_experts else float(aux) == 0.0)
        if tuple(logits.shape) != want_shape or \
                not torch.isfinite(logits).all() or not aux_ok:
            fail(f"{arch} forward ({mode}) logits not finite of shape "
                 f"{want_shape}, or aux loss {float(aux)} wrong")
        out.setdefault("aux_loss", {})[mode] = float(aux)
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

    def eager_forward():
        with offload_policy(**KERNEL_POLICY), torch.no_grad():
            model.forward(params, tokens)

    out["profile_eager"] = _profile(eager_forward)
    errs = _logit_errs(last_logits, (bsz, cfg.vocab_size))
    bar = max(LOGIT_TOL, 2 * errs["floor"])
    if not errs["err"] <= bar:
        fail(f"{arch} bf16 forward logits differ: {errs} > {bar}")
    graph_vs_eager = ((last["graph"] - last["eager"]).abs().max().item()
                      / last["eager"].abs().max().item())
    if not graph_vs_eager <= LOGIT_TOL:
        fail(f"{arch} graph forward differs from eager: {graph_vs_eager}")
    out["last_logits"] = {"bfloat16": {**errs, "bar": bar},
                          "graph_vs_eager": graph_vs_eager}
    return out


def run_long_decode(cfg, model, params, prompts, zero_counts, read_counts):
    """One decode step of the model at full width at cache index
    LONG_INDEX on a LONG_CACHE-slot cache whose every layer's K and V are
    drawn from a generator seeded with SEED, the prompts' first tokens as
    input: kernels (counted: each layer's flash decode split across a
    cluster, on its dtype's route) against the plain path.  Logits bar:
    1e-4 x max |logit| in f32, max(2e-2, 2 x floor) in bf16."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels.flash_decode import cluster_capacity, decode_plan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = model.init_decode_cache(BATCH, LONG_CACHE, device=dev)
    for buf in base.values():
        for layer in buf:
            layer.copy_(torch.randn(layer.shape, generator=gen, device=dev))
    first = torch.tensor([[p[0]] for p in prompts], device=dev)

    def logits_of(pol, k_parts=1):
        cache = {name: buf.clone() for name, buf in base.items()}
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            return model.decode_step(params, cache, first,
                                     LONG_INDEX)[0].float()

    zero_counts()
    errs = _logit_errs(logits_of, (BATCH, cfg.vocab_size))
    launches, routes = read_counts(), read_routes()
    per_step, _ = expected(cfg, "serve", "eager")
    if launches != per_step:
        fail(f"long-cache decode step kernel launches {launches}, want "
             f"{per_step}")
    route = decode_route_of(cfg.dtype)
    require_route("long-cache decode step", routes, "skinny", decode=route)
    f32 = cfg.dtype == "float32"
    bar = F32_LOGIT_TOL if f32 else max(LOGIT_TOL, 2 * errs["floor"])
    if not errs["err"] <= bar:
        fail(f"{cfg.dtype} long-cache decode logits differ: {errs} > {bar}")
    dt = getattr(torch, cfg.dtype)
    plan = decode_plan(BATCH, cfg.num_heads, cfg.num_kv_heads, LONG_CACHE,
                       cfg.head_dim, dt, route,
                       cluster_capacity(route, dt, cfg.head_dim, 0))
    out = {"phase": "long-decode", "arch": cfg.name, "dtype": cfg.dtype,
           "batch": BATCH, "cache_len": LONG_CACHE, "cache_index": LONG_INDEX,
           "plan": plan._asdict(), "launches": launches, "routes": routes,
           "logits": {**errs, "bar": bar}}
    emit(out)
    del base
    torch.cuda.empty_cache()
    return out


def run_f32(cfg, tokens, prompts, zero_counts, read_counts):
    """Phase 6: decode first-step and forward last-position logits with
    f32 weights at full width, kernels against plain, bar 1e-4, and the
    long-cache decode step at that bar.  Every attention launch of the f32
    forward and decode must take the CUDA-core route (``simt``: true
    fp32); returns the route counts of the phase's short and long-cache
    decode steps."""
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

    zero_routes()
    out = {"decode_first_step": _logit_errs(first_logits,
                                            (BATCH, cfg.vocab_size)),
           "forward_last_position": _logit_errs(
               last_logits, (F32_FWD_BATCH, cfg.vocab_size)),
           "bar": F32_LOGIT_TOL, "forward_batch": F32_FWD_BATCH,
           "forward_seq": F32_FWD_SEQ, "routes": read_routes()}
    attn = out["routes"]["flash_attention"]
    if attn != {"simt": cfg.num_layers, "wgmma": 0}:
        fail(f"f32 forward attention off the simt route: {attn}")
    dec = out["routes"]["flash_decode"]
    if dec != {"simt": cfg.num_layers, "mma": 0}:
        fail(f"f32 decode attention off the simt route: {dec}")
    for name in ("decode_first_step", "forward_last_position"):
        if not out[name]["err"] <= F32_LOGIT_TOL:
            fail(f"f32 {name} logits differ: {out[name]} > {F32_LOGIT_TOL}")
    emit({"phase": "float32", **out})
    long32 = run_long_decode(model32.cfg, model32, params32, prompts,
                             zero_counts, read_counts)
    del params32
    torch.cuda.empty_cache()
    return out["routes"], long32["routes"]


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
    wave_routes = read_routes()
    require_route("hnp wave", wave_routes, "wgmma")
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
        "kernel_launches": wave_counts, "routes": wave_routes,
        "gemm_batched_launched": wave_counts["gemm_batched"] == 1,
        "max_rel_err_vs_float64": err64, "max_rel_err_vs_plain": err_plain,
        "max_abs_err_vs_plain": abs_plain,
    }
    return {"quickstart": quick, "wave": wave, "launches": {
        k: quick_counts[k] + wave_counts[k] for k in quick_counts}}


def run_serve_cluster(cfg, params, prompts, tokens0, zero_counts,
                      read_counts):
    """Phases 5a and 5b: ``serve_cluster`` on the serve phase's weights,
    CLUSTER_BATCHES batches (the first the serve phase's prompts) over
    CLUSTER_DEVICES modeled devices, run (a) cost-aware with pinned caches
    (counted) and run (b) round-robin with caches drained to host
    (profiled); then run (a) again traced (``run_trace_export``)."""
    import numpy as np
    import torch

    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_batch, serve_cluster

    dev = torch.device("cuda")
    extra = np.random.default_rng(SEED + 1)
    batches = [prompts] + [
        [[int(t) for t in extra.integers(1, cfg.vocab_size, size=PROMPT_LEN)]
         for _ in range(BATCH)] for _ in range(CLUSTER_BATCHES - 1)]
    kw = dict(smoke=False, cache_len=CACHE_LEN, max_new_tokens=MAX_NEW,
              params=params, device=dev)
    want = [np.asarray(tokens0)]
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        want += [serve_batch(cfg.name, b, **kw).tokens for b in batches[1:]]

    def cluster_run(scheduler, pin, label):
        pol = dict(KERNEL_POLICY, num_devices=CLUSTER_DEVICES,
                   scheduler=scheduler)
        t0 = time.perf_counter()
        with offload_policy(**pol), offload_trace() as trace:
            res = serve_cluster(cfg.name, batches, pin_caches=pin, **kw)
        wall = time.perf_counter() - t0
        for i, (r, w) in enumerate(zip(res.results, want, strict=True)):
            if not np.array_equal(r.tokens, w):
                fail(f"serve-cluster {label}: batch {i} greedy tokens differ "
                     "from serve_batch's")
        return res, wall, trace

    def summary(res, wall):
        return {"prefill_placements": res.prefill_placements,
                "placements": res.placements,
                "cache_devices": res.cache_devices, "wall_s": wall,
                "tokens": res.total_tokens,
                "decode_tokens_per_s_by_batch": [r.tokens_per_s
                                                 for r in res.results],
                "prefill_s_by_batch": [r.prefill_s for r in res.results],
                "modeled": {"makespan_s": res.makespan_s,
                            "tokens_per_s": res.tokens_per_s,
                            "per_device_s": res.per_device_s,
                            "d2d_s": res.d2d_s,
                            "restage_s": res.restage_s}}

    zero_counts()
    res_a, wall_a, trace_a = cluster_run("cost-aware", True, "(a)")
    launches, routes = read_counts(), read_routes()
    per_step, ops = expected(cfg, "serve", "eager")
    steps = PROMPT_LEN + MAX_NEW
    want_launches = {k: CLUSTER_BATCHES * steps * v
                     for k, v in per_step.items()}
    if launches != want_launches:
        fail(f"serve-cluster kernel launches {launches}, want "
             f"{want_launches}")
    require_route("serve-cluster", routes, "skinny",
                  decode=decode_route_of(cfg.dtype))
    backends = _backends(trace_a, ops)
    if res_a.placements != res_a.cache_devices or res_a.d2d_s != 0.0 or \
            res_a.restage_s != 0.0:
        fail(f"serve-cluster (a) moved a pinned cache: {summary(res_a, 0)}")
    # Every seam record lies on its batch's lane: prefill steps on the
    # prefill placement, decode steps on the decode placement.
    per_step_records = sum(1 for r in trace_a.records if r.op in ops) // (
        CLUSTER_BATCHES * steps)
    lanes = [r.device_id for r in trace_a.records if r.op in ops]
    want_lanes = []
    for i in range(CLUSTER_BATCHES):
        want_lanes += [res_a.prefill_placements[i]] * (
            PROMPT_LEN * per_step_records)
    for i in range(CLUSTER_BATCHES):
        want_lanes += [res_a.placements[i]] * (MAX_NEW * per_step_records)
    if lanes != want_lanes:
        fail("serve-cluster (a): seam records off their batches' lanes")
    if len(set(res_a.placements)) != CLUSTER_DEVICES:
        fail(f"serve-cluster (a) left a lane idle: {res_a.placements}")

    out_b = {}

    def run_b():
        out_b["res"], out_b["wall"], _ = cluster_run("round-robin", False,
                                                     "(b)")

    profile_b = _profile(run_b, cuda_only=True)
    res_b = out_b["res"]
    if not res_b.restage_s > 0.0 or res_b.cache_devices != \
            [-1] * CLUSTER_BATCHES:
        fail(f"serve-cluster (b) paid no host re-stage: "
             f"{summary(res_b, 0)}")
    emit({"phase": "serve-cluster", "arch": cfg.name, "dtype": cfg.dtype,
          "devices": CLUSTER_DEVICES, "batches": CLUSTER_BATCHES,
          "batch": BATCH, "prompt_len": PROMPT_LEN, "max_new": MAX_NEW,
          "cache_len": CACHE_LEN, "launches": launches, "routes": routes,
          "trace_backends": backends, "greedy_tokens_equal_serve_batch": True,
          "records_per_step": per_step_records,
          "a_cost_aware_pinned": summary(res_a, wall_a),
          "b_round_robin_unpinned": {**summary(res_b, out_b["wall"]),
                                     "profiled": profile_b}})
    run_trace_export(cfg, batches, want, kw)
    return {"launches": launches, "routes": routes}


def run_trace_export(cfg, batches, want, kw):
    """Phase 5b: run (a) of ``run_serve_cluster`` under a ``SpanTracer``
    with a flight recorder that keeps every ticket; the Chrome trace must
    validate and every ticket must have its span (``ticket_spans`` of the
    recorded tickets against the tracer's ticket spans)."""
    import types

    import numpy as np

    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_cluster
    from repro_torch.obs import flight, metrics, spans, trace_export

    def tickets_issued():
        return sum(v for k, v in metrics.snapshot().items()
                   if k.startswith("stream.tickets{"))

    pol = dict(KERNEL_POLICY, num_devices=CLUSTER_DEVICES,
               scheduler="cost-aware")
    flight.configure(1 << 22)
    issued = tickets_issued()
    t0 = time.perf_counter()
    with offload_policy(**pol), spans.span_trace("serve-cluster") as tr:
        res = serve_cluster(cfg.name, batches, pin_caches=True, **kw)
    wall = time.perf_counter() - t0
    issued = tickets_issued() - issued
    recorded = flight.capture()["tickets"]
    flight.configure(flight.DEFAULT_CAPACITY)
    for i, (r, w) in enumerate(zip(res.results, want, strict=True)):
        if not np.array_equal(r.tokens, w):
            fail(f"trace-export: batch {i} greedy tokens differ")
    streams = {int(d): [types.SimpleNamespace(**t) for t in ts]
               for d, ts in recorded.items()}
    n_tickets = sum(len(v) for v in streams.values())
    if n_tickets != issued:
        fail(f"trace-export: the flight recorder kept {n_tickets} of "
             f"{issued} tickets")
    t_spans = trace_export.ticket_spans(streams)

    def key(attrs, dev):
        return (dev, attrs["kind"], attrs["op"], attrs["shape_key"],
                attrs["issue_s"], attrs["complete_s"])

    compute = [s for s in t_spans if s.lane.endswith("/compute")]
    if len(compute) != n_tickets:
        fail(f"trace-export: ticket_spans gave {len(compute)} compute "
             f"windows for {n_tickets} tickets")
    traced = {key(s.attrs, s.device_id) for s in tr.spans
              if s.attrs.get("ticket")}
    missing = {key(s.attrs, s.attrs["device_id"]) for s in compute} - traced
    if missing:
        fail(f"trace-export: {len(missing)} tickets have no traced span, "
             f"e.g. {sorted(missing)[:3]}")
    trace = trace_export.chrome_trace(tr, meta={"otherData": {
        "arch": cfg.name, "devices": CLUSTER_DEVICES,
        "scheduler": "cost-aware", "time": "modeled"}})
    errors = trace_export.validate_chrome_trace(trace)
    if errors:
        fail(f"trace-export: invalid Chrome trace: {errors[:5]}")
    path = OUT_DIR / "serve_cluster_trace.json.gz"
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    summary = trace_export.summarize(tr.spans, top=2).splitlines()
    emit({"phase": "trace-export", "events": len(trace["traceEvents"]),
          "spans": len(tr.spans), "tickets": n_tickets,
          "tickets_with_span": n_tickets, "validator_errors": 0,
          "lanes": sorted(set(tr.lanes())), "wall_s": wall,
          "file": str(path), "file_bytes": path.stat().st_size,
          "modeled_self_time_top_by_lane": summary})


def run_paper_fig3(zero_counts, read_counts):
    """Phase 7a: the paper's Fig. 3 through ``tools/paper_fig3_h100.py``
    (whose ``run`` raises if a row misses its bar or its backend and
    route); its launches counted, every GEMM route reached."""
    spec = importlib.util.spec_from_file_location(
        "paper_fig3_h100", ROOT / "tools" / "paper_fig3_h100.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    zero_counts()
    result = tool.run()
    launches, routes = read_counts(), read_routes()
    used = {k for k, v in routes["gemm"].items() if v}
    if used != {"skinny", "tiled", "wgmma"} or launches["gemm"] == 0 or \
            any(launches[k] for k in launches if k != "gemm"):
        fail(f"paper-fig3 launches {launches} routes {routes}")
    path = OUT_DIR / "paper_fig3.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(tool.table(result), flush=True)
    emit({"phase": "paper-fig3", "rows": result["rows"],
          "crossover": result["crossover"],
          "host_blas": result["host_blas"], "launches": launches,
          "routes": routes, "file": str(path)})
    return {"launches": launches, "routes": routes}


def run_ssm_f32(cfg, tokens, prompts):
    """Phase 10: mamba2-370m with f32 weights at full width.  Last-position
    forward logits at 1 x 512 (two chunks, so the inter-chunk recurrence
    runs), kernels against plain, bar 1e-4; and the decode recurrence
    against the chunked SSD on the kernels: the serve prefill's last
    logits (token by token through the decode step) against
    Model.forward(prompts)[:, -1] (one 16-row chunk)."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model32.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    toks = tokens[:1, :SSM_F32_FWD_SEQ]

    def last_logits(pol, k_parts=1):
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            return model32.forward(params32, toks)[0][:, -1].float()

    zero_routes()
    fwd = _logit_errs(last_logits, (1, cfg.vocab_size))
    ssd_routes = read_routes()["ssd_chunk_diag"]
    if ssd_routes != {"simt": 0, "mma": cfg.num_layers}:
        fail(f"ssm f32 forward SSD off the mma route: {ssd_routes}")
    if not fwd["err"] <= F32_LOGIT_TOL:
        fail(f"ssm f32 forward logits differ: {fwd} > {F32_LOGIT_TOL}")

    ptoks = torch.tensor(prompts, device=dev)
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        full = model32.forward(params32, ptoks)[0][:, -1].float()
        cache = model32.init_decode_cache(BATCH, CACHE_LEN, device=dev)
        for t in range(PROMPT_LEN):
            dec, cache = model32.decode_step(params32, cache,
                                             ptoks[:, t:t + 1], t)
    dec = dec.float()
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        fail("ssm f32 decode / forward logits not finite")
    dvf = (dec - full).abs().max().item() / full.abs().max().item()
    if not dvf <= DECODE_VS_FORWARD_TOL:
        fail(f"ssm f32 decode differs from forward: {dvf} > "
             f"{DECODE_VS_FORWARD_TOL}")
    emit({"phase": "ssm-float32", "forward_last_position": fwd,
          "bar": F32_LOGIT_TOL, "forward_batch": 1,
          "ssd_routes": ssd_routes,
          "forward_seq": SSM_F32_FWD_SEQ,
          "decode_vs_forward": {
              "err": dvf, "bar": DECODE_VS_FORWARD_TOL,
              "argmax_agreement":
                  (dec.argmax(-1) == full.argmax(-1)).float().mean().item(),
              "batch": BATCH, "prompt_len": PROMPT_LEN}})
    del params32
    torch.cuda.empty_cache()


def run_moe(cfg, rng, zero_counts, read_counts, launches, routes):
    """Phases 10a-10f: qwen3-moe-30b-a3b at full width on the card."""
    import torch

    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.obs import metrics

    dev = torch.device("cuda")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    # ArchConfig.param_count() counts no norm scales (2 a layer, 1 final).
    n_norm = (2 * cfg.num_layers + 1) * cfg.d_model
    if not n_params - n_norm == cfg.param_count() == MOE_PARAMS:
        fail(f"{cfg.name} built {n_params} parameters ({n_norm} in norm "
             f"scales), want {MOE_PARAMS} and the norm scales")
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=PROMPT_LEN)]
               for _ in range(BATCH)]

    # ---- 10a. serve (eager) ---------------------------------------------
    books = metrics.MetricsRegistry()
    serve = run_serve(cfg, model, params, prompts, "eager", zero_counts,
                      read_counts, books=books)
    roll = books.rollup()
    routed = roll.get("moe.tokens_routed", 0.0)
    dropped = sum(v for k, v in roll.items()
                  if k.startswith("moe.tokens_dropped"))
    steps = PROMPT_LEN + MAX_NEW
    if routed != steps * cfg.num_layers * BATCH * cfg.experts_per_token:
        fail(f"{cfg.name} serve routed {routed} token copies")
    serve.update(init_s=init_s, params=n_params - n_norm,
                 norm_scale_params=n_norm,
                 max_memory_allocated_GB=torch.cuda.max_memory_allocated()
                 / 1e9,
                 moe_books={"tokens_routed": routed, "tokens_dropped": dropped,
                            "drop_rate": dropped / routed,
                            "experts_dropping": sum(
                                1 for k in roll
                                if k.startswith("moe.tokens_dropped"))})
    prof = serve["profile_first_step"]
    if "gemm_device_ms_by_tile" in prof:
        # In a decode step only the expert GEMMs take the tensor-core tile
        # (every other GEMM is skinny at m = 8).
        serve["expert_gemms_first_step"] = {
            "device_ms": prof["gemm_device_ms_by_tile"]["gemm_wgmma"],
            "launches": serve["launches"]["gemm_batched"] // steps,
            "bound_ms": _moe_bound_ms(cfg, "decode")}
    on = serve["profile_first_step"]
    off = serve["profile_first_step_books_off"] = _moe_books_off_profile(
        model, params, prompts)
    waits = [p_.get("host_sync_wait_ms") for p_ in (on, off)]
    serve["books_host_sync_wait_ms"] = (
        waits[0] - waits[1] if all(isinstance(w, float) for w in waits)
        else "not measured")
    launches["moe-serve"] = serve["launches"]
    routes["moe-serve"] = serve["routes"]
    emit({"phase": "moe-serve", **serve})

    # ---- 10b. serve (graph) ---------------------------------------------
    serve_g = run_serve(cfg, model, params, prompts, "graph", zero_counts,
                        read_counts)
    serve_g["eager_tokens_per_s"] = serve["kernel"]["tokens_per_s"]
    if serve_g.pop("tokens") != serve["tokens"]:
        fail(f"{cfg.name} graph-mode serving gave other greedy tokens than "
             "eager mode")
    serve_g["greedy_tokens_equal_eager"] = True
    routes["moe-serve-graph"] = serve_g["routes"]
    emit({"phase": "moe-serve-graph", **serve_g})

    # ---- 10c. forward (eager, graph) ------------------------------------
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(FWD_BATCH, FWD_SEQ))).to(dev)
    fwd = run_forward(cfg, model, params, tokens, zero_counts, read_counts)
    M._MOE_STEPS.clear()
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        model.forward(params, tokens)
    layers = M.moe_step_trace()
    if len(layers) != cfg.num_layers:
        fail(f"{cfg.name} forward kept {len(layers)} MoE books, want "
             f"{cfg.num_layers}")
    f_routed = sum(t.tokens_routed for t in layers)
    f_dropped = sum(t.tokens_dropped for t in layers)
    fwd["moe_books"] = {
        "capacity": layers[0].capacity, "tokens_routed": f_routed,
        "tokens_dropped": f_dropped, "drop_rate": f_dropped / f_routed,
        "drop_rate_by_layer": [t.drop_rate for t in layers]}
    launches["moe-forward"] = fwd["launches"]["eager"]
    routes["moe-forward"] = fwd["routes"]["eager"]
    routes["moe-forward-graph"] = fwd["routes"]["graph"]
    emit({"phase": "moe-forward", **fwd})

    # ---- 10f. layer 0's expert FFN, kernels against plain -----------------
    run_moe_layer(cfg, params["stack"][0]["ffn"], zero_counts, read_counts)

    # ---- 10e. one MoE layer placed over modeled lanes ---------------------
    placed = run_moe_placed(cfg, params["stack"][0]["ffn"], zero_counts,
                            read_counts)
    routes["moe-placed"] = placed["routes"]
    emit({"phase": "moe-placed", **placed})
    del params, model
    torch.cuda.empty_cache()

    # ---- 10d. float32 at two layers -------------------------------------
    routes["moe-float32"] = run_moe_f32(cfg, prompts, tokens)


def _moe_bound_ms(moe_cfg, path):
    """The bytes / FLOPs bound of one decode step's or forward's expert
    GEMMs, summed over their launches (``moe_expert_shapes``)."""
    nbytes = flops = 0.0
    for tag, e, m, k, n, count in moe_expert_shapes(moe_cfg):
        if tag.startswith(path):
            nbytes += count * 2.0 * e * (m * k + k * n + m * n)
            flops += count * 2.0 * e * m * n * k
    return _bound_ms(nbytes, flops, "bfloat16")


def _moe_books_off_profile(model, params, prompts):
    """The first decode step profiled as 10a profiles it, with
    ``_note_moe_step`` a no-op (for this measurement only): its idle share
    and its host waits in CUDA runtime syncs beside 10a's, the books'
    read-backs being the difference."""
    import torch

    from repro_torch.core.hero import offload_policy
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    first = torch.tensor([[p[0]] for p in prompts], device=dev)

    def step():
        cache = model.init_decode_cache(BATCH, CACHE_LEN, device=dev)
        with offload_policy(**KERNEL_POLICY), torch.no_grad():
            return model.decode_step(params, cache, first, 0)[0].float()

    note = M._note_moe_step
    M._note_moe_step = lambda counts, cap: None
    try:
        return _profile(step)
    finally:
        M._note_moe_step = note


def run_moe_layer(cfg, layer, zero_counts, read_counts):
    """Phase 10f: layer 0's expert FFN at full width in bf16, kernels against
    the plain path on identical inputs, so that no routing decision can
    differ between them: (a) ``blas.moe_expert_ffn`` on a full (E, G, C, d)
    buffer, handed over as the grouped dispatch hands it (a transposed
    view), at the decode step's and the forward's groups; (b)
    ``_moe_grouped`` with one routing (the plain path's router) shared by
    both paths, at BATCH and at FWD_BATCH x FWD_SEQ tokens: pack, the three
    expert GEMMs, the SiLU·up product and the fixed-order unpack.  Each
    within TOL["bfloat16"] x max |plain|, its three batched GEMMs on
    ``wgmma``."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    e, d = cfg.num_experts, cfg.d_model
    w = (layer["we_gate"], layer["we_up"], layer["we_down"])
    bar = TOL["bfloat16"]
    out = {"bar": bar, "expert_ffn": {}, "grouped": {}}

    def kernel_and_plain(kind, tag, fn):
        zero_counts()
        with offload_policy(**KERNEL_POLICY), torch.no_grad():
            got = fn()
        torch.cuda.synchronize()
        counts, routes = read_counts(), read_routes()
        with offload_policy(**PLAIN_POLICY), torch.no_grad():
            want = fn()
        if counts != {**dict.fromkeys(counts, 0), "gemm_batched": 3} or \
                routes["gemm_batched"]["wgmma"] != 3:
            fail(f"qwen3-moe layer {kind} {tag}: launches {counts}, "
                 f"routes {routes}")
        if not torch.isfinite(got).all():
            fail(f"qwen3-moe layer {kind} {tag}: output not finite")
        err, abs_err = _rel_err(got, want)
        if not err <= bar:
            fail(f"qwen3-moe layer {kind} {tag}: err {err} > {bar}")
        out[kind][tag] = {"err": err, "max_abs_err": abs_err}
        return out[kind][tag]

    for path, (g, cap) in moe_groups(cfg).items():
        buf = torch.randn(g, e * cap, d, generator=gen,
                          device=dev).to(torch.bfloat16)
        ebuf = buf.reshape(g, e, cap, d).transpose(0, 1)
        kernel_and_plain("expert_ffn", f"{path}: E {e} x G {g} x C {cap} x "
                         f"d {d}", lambda: blas.moe_expert_ffn(ebuf, *w))
    for path, t in (("decode", BATCH), ("forward", FWD_BATCH * FWD_SEQ)):
        xf = torch.randn(t, d, generator=gen, device=dev).to(torch.bfloat16)
        with offload_policy(**PLAIN_POLICY), torch.no_grad():
            gates, idx, _ = M._router(layer, xf, cfg)
        row = kernel_and_plain("grouped", f"{path}: T {t}",
                               lambda: M._moe_grouped(layer, xf, gates, idx,
                                                      cfg))
        row["drop_rate"] = M.last_moe_step().drop_rate
    emit({"phase": "moe-layer", **out})
    return out


def run_moe_placed(cfg, layer, zero_counts, read_counts):
    """Phase 10e: one MoE layer at full width, FWD_BATCH x FWD_SEQ hidden
    states, with an ``ExpertPlacementPolicy`` attached over
    MOE_PLACED_LANES modeled lanes and fed MOE_PLACED_STEPS Zipf
    histograms first: ``moe_ffn_placed`` must equal the grouped
    ``moe_ffn`` bit for bit, its expert FFN three ``wgmma`` launches of the
    batched GEMM, its books fanned out over more than one lane."""
    import random

    import torch

    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.core.placement import (ExpertPlacementPolicy,
                                            PlacementConfig, zipf_histogram)
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    gcfg = dataclasses.replace(cfg, moe_dispatch="grouped")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(FWD_BATCH, FWD_SEQ, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    copies = FWD_BATCH * FWD_SEQ * cfg.experts_per_token
    with offload_policy(**KERNEL_POLICY, num_devices=MOE_PLACED_LANES) \
            as cluster, torch.no_grad():
        want, want_aux = M.moe_ffn(layer, x, gcfg)
        pol = ExpertPlacementPolicy(PlacementConfig(
            num_experts=cfg.num_experts, d_model=cfg.d_model,
            d_ff=cfg.moe_d_ff), cluster)
        pol.attach()
        stream = random.Random(SEED)
        for _ in range(MOE_PLACED_STEPS):
            pol.step(zipf_histogram(stream, cfg.num_experts, MOE_PLACED_ZIPF,
                                    copies))
        zero_counts()
        with offload_trace() as trace:
            got, aux = M.moe_ffn_placed(layer, x, gcfg, policy=pol)
        torch.cuda.synchronize()
        counts, routes = read_counts(), read_routes()
        lanes = sorted({r.device_id for r in trace.records
                        if r.note.startswith("expert-placed")})
        backends = sorted({r.backend for r in trace.records
                           if r.op == "moe_expert_ffn"})
    if not (torch.equal(got, want) and torch.equal(aux, want_aux)):
        fail("moe_ffn_placed differs from the grouped moe_ffn on the card")
    if counts["gemm_batched"] != 3 or routes["gemm_batched"]["wgmma"] != 3:
        fail(f"placed expert FFN launches {counts}, routes {routes}")
    if len(lanes) < 2 or backends != ["device-kernel"]:
        fail(f"placed expert FFN fanned out over lanes {lanes}, backends "
             f"{backends}")
    return {"arch": cfg.name, "tokens": FWD_BATCH * FWD_SEQ,
            "lanes": MOE_PLACED_LANES, "zipf_s": MOE_PLACED_ZIPF,
            "warm_steps": MOE_PLACED_STEPS, "bit_equal_unplaced": True,
            "launches": counts, "routes": routes, "fanout_lanes": lanes,
            "counters": pol.counters(),
            "decisions": [list(d.key) for d in pol.decisions],
            "home_lanes": {str(lane): pol.home.count(lane)
                           for lane in pol.lanes}}


def run_moe_f32(cfg, prompts, tokens):
    """Phase 10d: qwen3-moe at published widths, MOE_F32_LAYERS layers, f32
    weights: first decode step and last-position logits of a 1 x
    F32_FWD_SEQ forward, kernels against plain, under F32_LOGIT_TOL x max
    |logit|; and the routing decisions (token, top-k slot) each path took,
    counted where they differ, with the plain path's gap between the k-th
    and the next expert's probability at each.  Returns the phase's
    routes."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, num_layers=MOE_F32_LAYERS,
                                dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    first = torch.tensor([[p[0]] for p in prompts], device=dev)
    toks = tokens[:F32_FWD_BATCH, :F32_FWD_SEQ]
    picks = {}
    top_k = M._top_k_gates

    def spied(name, pol, k_parts, run):
        calls = []

        def spy(logits, k):
            gates, idx = top_k(logits, k)
            calls.append((idx, torch.softmax(logits.float(), dim=-1)))
            return gates, idx

        M._top_k_gates = spy
        try:
            with offload_policy(**pol), blas.host_k_split(k_parts), \
                    torch.no_grad():
                out = run()
        finally:
            M._top_k_gates = top_k
        picks[(name, pol is KERNEL_POLICY, k_parts)] = calls
        return out

    def first_logits(pol, k_parts=1):
        cache = model32.init_decode_cache(BATCH, CACHE_LEN, device=dev)
        return spied("decode", pol, k_parts, lambda: model32.decode_step(
            params32, cache, first, 0)[0].float())

    def last_logits(pol, k_parts=1):
        return spied("forward", pol, k_parts, lambda: model32.forward(
            params32, toks)[0][:, -1].float())

    zero_routes()
    out = {"layers": MOE_F32_LAYERS, "bar": F32_LOGIT_TOL,
           "forward_batch": F32_FWD_BATCH, "forward_seq": F32_FWD_SEQ,
           "decode_first_step": _logit_errs(first_logits,
                                            (BATCH, cfg.vocab_size)),
           "forward_last_position": _logit_errs(
               last_logits, (F32_FWD_BATCH, cfg.vocab_size)),
           "routes": read_routes()}
    k = cfg.experts_per_token
    for name in ("decode", "forward"):
        flips, gaps, decisions = 0, [], 0
        for (ik, _), (ip, probs) in zip(picks[(name, True, 1)],
                                        picks[(name, False, 1)], strict=True):
            decisions += ip.numel()
            diff = (ik != ip).any(dim=-1)
            flips += int((ik != ip).sum())
            if diff.any():
                srt = probs[diff].sort(dim=-1, descending=True).values
                gaps += (srt[:, k - 1] - srt[:, k]).tolist()
        out[f"{name}_routing"] = {"decisions": decisions, "differ": flips,
                                  "gaps_at_differing_tokens": gaps}
    if out["routes"]["gemm_batched"]["tiled"] == 0 or any(
            n for r, n in out["routes"]["gemm_batched"].items()
            if r != "tiled"):
        fail(f"f32 expert GEMMs off the tiled route: {out['routes']}")
    for name in ("decode_first_step", "forward_last_position"):
        if not out[name]["err"] <= F32_LOGIT_TOL:
            fail(f"qwen3-moe f32 {name} logits differ: {out[name]} > "
                 f"{F32_LOGIT_TOL} (routing: {out['decode_routing']}, "
                 f"{out['forward_routing']})")
    emit({"phase": "moe-float32", **out})
    del params32
    torch.cuda.empty_cache()
    return out["routes"]


def run_times(cfg, ssm_cfg, moe_cfg, randn, launches, routes, max_abs):
    """Phase 11: each kernel at its path's shapes; returns the kernels
    line."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched, gemm_route
    from repro_torch.kernels.ref import (attention_ref, gemm_batched_ref,
                                         gemm_ref)
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag

    dev = torch.device("cuda")
    bf16 = torch.bfloat16

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

    # SSD chunk kernel at the 4 x 1024 forward's shape: one launch per
    # layer.
    Ls = ssm_cfg.num_layers
    ssd = time_ssd(ssd_chunk_diag, ssm_cfg, randn)
    emit({"ssd_chunk_diag_shape": ssd})

    emit({"ssm_forward_gemm_shapes": fwd_shapes["mamba"],
          "per_forward": {**per_forward["mamba"], "ssd_ms": Ls * ssd["ms"]}})

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

    per = "decode_step"
    return [
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
         "route_launches": {path: r["gemm"] for path, r in routes.items()}},
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
         "route_launches": {path: r["gemm_batched"]
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
         "tile_source": "src/repro_torch/kernels/csrc/attn_wgmma.cuh",
         "route_launches": {path: r["flash_attention"]
                            for path, r in routes.items()
                            if any(r["flash_attention"].values())}},
        {"name": "ssd_chunk_diag", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "tile_source": "src/repro_torch/kernels/csrc/ssd_mma.cuh",
         "replaces": "src/repro/kernels/ssd_scan.py:37",
         "launches": launches["ssm-forward"]["ssd_chunk_diag"],
         "path": "ssm-forward", "max_abs_err": max_abs["ssd_chunk_diag"],
         "ms": Ls * ssd["ms"], "plain_ms": Ls * ssd["plain_ms"],
         "bound_ms": Ls * ssd["bound_ms"], "bound_by": ssd["bound_by"],
         "fp32_fma_bound_ms": Ls * ssd["fp32_fma_bound_ms"],
         "library_ms": Ls * ssd["library_ms"], "per": "forward",
         "ms_per_launch": ssd["ms"],
         "route_launches": {path: r["ssd_chunk_diag"]
                            for path, r in routes.items()
                            if any(r["ssd_chunk_diag"].values())}},
    ]


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
            "ms": t_c, "ms_per_pass": moe_cfg.num_layers * t_c,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "GBps": nbytes / t_c / 1e6}
        del bufs, views
    return rows, tot


def time_flash_decode(flash_decode, hq, hkv, d, randn):
    """Each DECODE_TIME_SHAPES shape in bf16: ``flash_decode`` (any tree's
    wrapper), its plain version and SDPA (GQA, the same slot mask) in ms
    per launch over caches rotated past L2, beside the bound (q read and
    the output written once, the valid K and V slots read once, 4·D FLOPs
    per q head and slot).  Returns ``{tag: {...}}``."""
    import torch

    from repro_torch.kernels.ref import decode_attention_ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for tag, b, s, valid in DECODE_TIME_SHAPES:
        q = randn(b, hq, d, dtype=bf16)
        kvs = _rotation(lambda: (randn(b, hkv, s, d, dtype=bf16),
                                 randn(b, hkv, s, d, dtype=bf16)),
                        2 * b * hkv * s * d * 2)
        lo = torch.zeros(b, dtype=torch.int32, device=dev)
        hi = torch.full((b,), valid, dtype=torch.int32, device=dev)
        slot_ok = (torch.arange(s, device=dev) < valid)[None, None, None]
        q4 = q[:, :, None, :]
        t_k = _time(lambda kv: flash_decode(q, kv[0], kv[1], lo, hi), kvs)
        t_p = _time(lambda kv: decode_attention_ref(q, kv[0], kv[1], lo, hi),
                    kvs, iters=10)
        t_l = _time(lambda kv: sdpa(q4, kv[0], kv[1], attn_mask=slot_ok,
                                    enable_gqa=True), kvs)
        nbytes = 2.0 * (2 * b * hq * d + 2 * b * hkv * valid * d)
        flops = 4.0 * b * hq * valid * d
        bound = _bound_ms(nbytes, flops, "bfloat16")
        out[tag] = {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "S": s,
                    "valid": valid, "ms": t_k, "plain_ms": t_p,
                    "library_ms": t_l, "library": "SDPA, GQA, slot mask",
                    "bound_ms": bound,
                    "bound_by": _bound_by(nbytes, flops, "bfloat16"),
                    "bound_share": bound / t_k, "GBps": nbytes / t_k / 1e6,
                    "vs_library": t_k / t_l}
        del kvs
    return out


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


def time_ssd(ssd_chunk_diag, ssm_cfg, randn):
    """``ssd_chunk_diag`` (any tree's wrapper) at mamba2-370m's 4 x 1024
    forward shape, fp32 operands with the model's decay (log-decays from
    dt ≈ 0.7), over inputs rotated past L2: kernel, plain version and the
    library yardstick (two fp32 cuBLAS bmm around a masked exp) in ms per
    launch, beside the bounds (``ssd_bounds``), with the routes the timed
    launches took where the tree counts them."""
    import torch

    from repro_torch.kernels.ref import ssd_chunk_diag_ref

    dev = torch.device("cuda")
    ps, ns = ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state_dim
    qs = min(ssm_cfg.ssm_chunk, SSM_FWD_SEQ)
    ncs, bhs = SSM_FWD_SEQ // qs, SSM_FWD_BATCH * ssm_cfg.ssm_num_heads
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
            "dtype": "float32", "launches_per_forward": ssm_cfg.num_layers,
            "routes": routes, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "library": "2 x torch.bmm fp32 + masked exp",
            **ssd_bounds(nbytes, tensor, ops), "bytes": nbytes,
            "tensor_GFLOP": tensor / 1e9,
            "TFLOPs": tensor / t_k / 1e9, "GBps": nbytes / t_k / 1e6}


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
