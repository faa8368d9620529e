"""The check's seeds, cells and bars, and the shapes they give.

One block of constants a phase (each says where its numbers come from),
the shapes of every GEMM, attention and SSD launch those cells make, and
the kernel launches a decode step or a forward must make
(:func:`expected`).  Imports only the standard library at import time.
"""

from __future__ import annotations

import dataclasses
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]

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
# The whole SSD core on the chunked route (B, S, H, G, P, N, Q):
# granite-4.0-h-small's mixer, jamba's eight groups (one prompt of 512),
# mamba2-370m's forward, and widths and a chunk off the models'.
SCAN_CHECK_CASES = [(4, 4096, 128, 1, 64, 128, 256, "granite"),
                    (1, 512, 256, 8, 64, 128, 256, "jamba"),
                    (4, 1024, 32, 1, 64, 128, 256, "mamba2-370m"),
                    (1, 200, 6, 3, 48, 32, 100, "test")]
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
# Streaming engine (phase 7c, modeled): yi-6b's config over 4 modeled
# devices (1 prefill lane, 8 decode slots a lane), a bursty trace at 2 x
# the cost model's capacity estimate for 1 s; then qwen3-moe with expert
# placement on a bursty 100 qps, 0.5 s trace.
STREAM_DEVICES, STREAM_PREFILL_LANES, STREAM_SLOTS = 4, 1, 8
STREAM_LOAD, STREAM_DURATION_S = 2.0, 1.0
STREAM_MOE_QPS, STREAM_MOE_DURATION_S = 100.0, 0.5
# granite-4.0-h-small's routed experts (phase 10g and the gemm_grouped
# row): d 4096, 72 experts of 768, top-10, on its benchmark cell's 4 x 4096
# tokens, so R = 163840 routed rows a layer.
GRANITE_D, GRANITE_EXPERTS, GRANITE_F, GRANITE_TOP_K = 4096, 72, 768, 10
GRANITE_TOKENS = (4, 4096)
GRANITE_ROWS = GRANITE_TOKENS[0] * GRANITE_TOKENS[1] * GRANITE_TOP_K

# The rest of the zoo (phases 12a-12h), weights built on the card from a
# seeded generator after the previous model's are freed.  jamba at its
# published widths cut to one super-block (8 of 72 layers: the hybrid needs
# whole super-blocks) and 8 of 16 experts (one super-block with 16 is
# about 90 GB of bf16, beyond the card; with 8 about 52 GB); its f32 check
# keeps JAMBA_F32_EXPERTS (about 46 GB of f32) and runs 1 x
# JAMBA_F32_FWD_SEQ (two 256-token chunks).  gemma3-27b, h2o-danube-1.8b
# and hubert-xlarge whole; qwen2-72b and qwen2-vl-72b at QWEN2_LAYERS of
# 80 layers (145 GB whole).  Forwards: ZOO_FWD for jamba, hubert (frame
# embeddings) and qwen2-vl (embeddings, three distinct position streams);
# GEMMA_FWD so that the 1024 window bites in 52 of 62 layers, DANUBE_FWD
# so that the 4096 window bites.  Long decode steps (batch, cache slots,
# index): gemma3 as yi-6b's (the local layers read [2977, 4001)), danube
# past the wrap of its 4096-slot rolling buffer.
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_CUT = {"num_layers": 8, "num_experts": 8}
JAMBA_F32_EXPERTS = 2
JAMBA_F32_FWD_SEQ = 512
GEMMA_ARCH, GEMMA_FWD, GEMMA_LONG = "gemma3-27b", (2, 2048), (8, 4096, 4000)
DANUBE_ARCH, DANUBE_FWD, DANUBE_LONG = ("h2o-danube-1.8b", (1, 8192),
                                        (8, 4096, 5000))
HUBERT_ARCH = "hubert-xlarge"
QWEN2_ARCH, QWEN2_VL_ARCH, QWEN2_LAYERS = "qwen2-72b", "qwen2-vl-72b", 8
ZOO_FWD = (2, 512)
# Training (phase 13): yi-6b at its published widths cut to TRAIN_LAYERS of
# its 32 layers (the whole model's train state, about 97 GB at 16 bytes a
# parameter, exceeds the card's 80), bf16, the config's 2 microbatches; a
# global batch of TRAIN_BATCH x TRAIN_SEQ tokens of SyntheticLM (seed 17),
# TRAIN_STEPS AdamW steps at peak lr TRAIN_LR (warmup max(steps // 10, 1),
# as launch/train.py sets it).  Its loss, kernels against the plain path,
# within TRAIN_LOSS_TOL relative: the bf16 logits move by 2e-2 to 8.4e-2 of
# max |logit| between sum orders (PERF.md), and the mean CE averages that
# down.  The restart check runs the reduced config: a checkpoint of the cut
# model would write about 19 GB.
TRAIN_PUBLISHED_LAYERS, TRAIN_LAYERS = 32, 8
TRAIN_BATCH, TRAIN_SEQ = 2, 512
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
TRAIN_LOSS_TOL = 1e-2
# The distributed layer (phase 14) on an emulated (data 2, model 4) mesh:
# 8 mesh devices whose shards all live on the one card.  (a) yi-6b whole in
# bf16 on FWD_BATCH x FWD_SEQ tokens, and in f32 cut to DIST_F32_LAYERS
# layers on DIST_F32_FWD tokens; (b) yi-6b cut to TRAIN_LAYERS, one
# TRAIN_BATCH x TRAIN_SEQ microbatch; (c) qwen3-moe's layer 0 on FWD_BATCH
# x FWD_SEQ tokens at capacity factor EP_CAPACITY (the reference's own EP
# test's); (d) mamba2-370m whole on SSM_FWD_BATCH x SSM_FWD_SEQ (f32:
# DIST_SSM_F32_FWD); (e) the ring at yi-6b's up projection and (f) GPipe
# of PIPE_STAGES yi-6b layers, PIPE_MICRO microbatches of a PIPE_BATCH x
# FWD_SEQ batch, both over a 1-D model-4 mesh.
DIST_MESH = (2, 4)
DIST_F32_LAYERS = 2
DIST_F32_FWD = (2, 128)
DIST_SSM_F32_FWD = (2, 512)
EP_CAPACITY = 8.0
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH = 4, 8, 8
# The roofline (phase 15).  (a) The dry run on meta tensors of
# tests/test_sharding.py's mini cell (yi-6b cut to ROOFLINE_MINI, one
# train step of ROOFLINE_MINI_TOKENS) on the emulated DIST_MESH, and of
# yi-6b's ROOFLINE_CELL on the 16 x 16 production mesh (of yi-6b's cells
# the cheapest in host time: ~0.2 s a shard_map call at 256 devices);
# (b) phase 4's and phase 8's forwards on the card beside the same
# forwards' work counted on meta.
ROOFLINE_MINI = dict(num_layers=4, num_microbatches=2, d_model=128,
                     d_ff=256, vocab_size=512, num_heads=4, num_kv_heads=2,
                     head_dim=32)
ROOFLINE_MINI_TOKENS = (8, 64)
ROOFLINE_CELL = "decode_32k"

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
# The f32 tensor-core route (tf32x3) at ragged shapes: m, n and k off every
# block tile (32, 64, 128), k off the 4-float copy unit and the 8-row mma
# step, n = 1 and a narrow n.
T3_RAGGED = [(17, 72, 104), (100, 200, 1000), (1000, 5128, 1048),
             (33, 7, 5), (300, 1, 1001)]
# Square f32 GEMMs timed in phase 11 (the tf32x3 route): Fig. 3's n 32-128
# and its crossover sweep's 256-4096.
F32_SQUARE_NS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
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
# window, empty rows, and a kv loop (5 tiles) that wraps its 3-stage ring.
# Each case runs in bf16 and f32, on the route ``attn_route`` names.
# Then SIMT_ATTN_CASES: a k one element off 16-byte alignment, bf16 at D 80
# and f32 at D 128, which must take ``simt``.
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
SIMT_ATTN_CASES = [
    dict(b=2, sq=77, skv=130, hq=8, hkv=2, d=80, causal=True, window=20,
         dtype="bfloat16"),
    dict(b=2, sq=128, skv=128, hq=8, hkv=2, d=128, causal=True,
         dtype="float32"),
]


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


def f32_forward_gemm_shapes(cfg, ssm_cfg):
    """(tag, m, k, n, launches per forward, B layout) of every GEMM of the
    f32 forward checks: yi-6b at F32_FWD_BATCH x F32_FWD_SEQ rows (m 128)
    and mamba2-370m at 1 x SSM_F32_FWD_SEQ (m 512), all on tf32x3."""
    m_yi, m_ssm = F32_FWD_BATCH * F32_FWD_SEQ, SSM_F32_FWD_SEQ
    return [(tag, m_yi if tag.startswith("yi:") else m_ssm, k, n, count, lay)
            for tag, _, k, n, count, lay in forward_gemm_shapes(cfg, ssm_cfg)]


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


def moe_layers(moe_cfg):
    """The stack's MoE layers: every layer of qwen3-moe, every second of
    jamba."""
    return sum(moe_cfg.layer_is_moe(i) for i in range(moe_cfg.num_layers))


def moe_expert_shapes(moe_cfg):
    """(tag, E, m, k, n, launches per decode step or forward) of the expert
    GEMMs, m = groups x capacity: gate and up (d -> f), down (f -> d)."""
    e, d, f = moe_cfg.num_experts, moe_cfg.d_model, moe_cfg.moe_d_ff
    L = moe_layers(moe_cfg)
    out = []
    for path, (g, cap) in moe_groups(moe_cfg).items():
        out += [(f"{path}:gate/up", e, g * cap, d, f, 2 * L),
                (f"{path}:down", e, g * cap, f, d, L)]
    return out


def f32_attention_cases(cfg, moe_cfg, zoo):
    """(tag, B, Hq, Hkv, S, D) of each f32 forward's causal attention
    launch: yi-6b's and qwen3-moe's at F32_FWD_BATCH x F32_FWD_SEQ,
    jamba's at 1 x JAMBA_F32_FWD_SEQ; a shape two models share once."""
    cases = {}
    for tag, c, b, s in (("yi-6b-f32", cfg, F32_FWD_BATCH, F32_FWD_SEQ),
                         ("qwen3-moe-f32", moe_cfg, F32_FWD_BATCH,
                          F32_FWD_SEQ),
                         ("jamba-f32", zoo["jamba-f32"], 1,
                          JAMBA_F32_FWD_SEQ)):
        shape = (b, c.num_heads, c.num_kv_heads, s, c.head_dim)
        cases[shape] = cases.get(shape, ()) + (tag,)
    return [("/".join(tags), *shape) for shape, tags in cases.items()]


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
    its counts are eager mode's.  A dense stack with a GELU MLP (hubert)
    runs 2 FFN GEMMs a layer (up, down), not 3.  jamba (hybrid): per
    super-block each sub-layer's mixer (attention: qkv, wo and one
    attention launch; Mamba: six GEMMs and, in a forward, one SSD launch,
    graph mode stacking z/x and B/C) and FFN (dense: three GEMMs; MoE: the
    router and three batched); decode keeps every FFN eager.  All: plus
    the head GEMM."""
    L = cfg.num_layers
    counts = dict.fromkeys(("gemm", "gemm_batched", "flash_decode",
                            "flash_attention", "ssd_chunk_diag", "ssd_scan"),
                           0)
    attn = "flash_decode" if path == "serve" else "flash_attention"
    if not cfg.uniform_stack:
        period = cfg.attn_layer_period
        g = b = a = ssd = 0
        for j in range(period):
            if cfg.layer_kind(j) == "attn":
                g, a = g + 2, a + 1
            elif path == "forward" and mode == "graph":
                g, b, ssd = g + 2, b + 2, ssd + 1
            else:
                g, ssd = g + 6, ssd + (path == "forward")
            if cfg.layer_is_moe(j):
                g, b = g + 1, b + 3
            else:
                g += 3
        n_sb = L // period
        ops = {"gemm", "qkv_project", "attention", "moe_expert_ffn",
               "mlp_block"}
        if path == "forward":
            ops |= {"ssd_scan"} | ({"gemm_batched"} if mode == "graph"
                                   else set())
        return ({**counts, "gemm": n_sb * g + 1, "gemm_batched": n_sb * b,
                 attn: n_sb * a, "ssd_scan": n_sb * ssd}, ops)
    if cfg.num_experts:
        return ({**counts, "gemm": 3 * L + 1, "gemm_batched": 3 * L,
                 attn: L},
                {"gemm", "qkv_project", "attention", "moe_expert_ffn"})
    if cfg.family == "ssm":
        if path == "serve":
            return {**counts, "gemm": 6 * L + 1}, {"gemm"}
        if mode == "graph":
            return ({**counts, "gemm": 2 * L + 1, "gemm_batched": 2 * L,
                     "ssd_scan": L}, {"gemm", "gemm_batched", "ssd_scan"})
        return ({**counts, "gemm": 6 * L + 1, "ssd_scan": L},
                {"gemm", "ssd_scan"})
    mlp = 3 if cfg.mlp_kind == "swiglu" else 2
    return ({**counts, "gemm": (2 + mlp) * L + 1, attn: L},
            {"gemm", "qkv_project", "mlp_block", "attention"})


def grouped_counts():
    """Phase 10g's rows an expert, GRANITE_ROWS in all: two experts empty,
    one of 5 rows, one heavy (8812), none of the others a multiple of the
    128-row tile."""
    counts = [2190 + (i * 37) % 173 for i in range(GRANITE_EXPERTS)]
    counts[3] = counts[40] = 0
    counts[71] = 5
    counts[0] += GRANITE_ROWS - sum(counts)
    return counts


def zoo_configs():
    """The configs of phases 12a-12h: jamba cut (``JAMBA_CUT``) and its f32
    twin with ``JAMBA_F32_EXPERTS``, gemma3-27b, h2o-danube-1.8b and
    hubert-xlarge whole, qwen2-72b / qwen2-vl-72b at ``QWEN2_LAYERS``."""
    from repro_torch.configs import get_arch

    jamba = dataclasses.replace(get_arch(JAMBA_ARCH), **JAMBA_CUT)
    return {
        "jamba": jamba,
        "jamba-f32": dataclasses.replace(jamba, num_experts=JAMBA_F32_EXPERTS,
                                         dtype="float32"),
        "gemma3": get_arch(GEMMA_ARCH),
        "danube": get_arch(DANUBE_ARCH),
        "hubert": get_arch(HUBERT_ARCH),
        "qwen2": dataclasses.replace(get_arch(QWEN2_ARCH),
                                     num_layers=QWEN2_LAYERS),
        "qwen2-vl": dataclasses.replace(get_arch(QWEN2_VL_ARCH),
                                        num_layers=QWEN2_LAYERS),
    }


def zoo_cuts(cfg):
    """What the phase cut from the published config, in words."""
    from repro_torch.configs import get_arch

    full = get_arch(cfg.name)
    cuts = []
    if cfg.num_layers != full.num_layers:
        cuts.append(f"layers {cfg.num_layers} of {full.num_layers}")
    if cfg.num_experts != full.num_experts:
        cuts.append(f"experts {cfg.num_experts} of {full.num_experts} "
                    f"(top-{cfg.experts_per_token} kept)")
    return cuts


def zoo_gemm_shapes(cfg):
    """(name, k, n, B layout, out dtype) of every distinct GEMM shape of a
    zoo model's layers and head: attention qkv / wo, Mamba z / x, B / C,
    dt (written f32) and out, the dense FFN's up (and gate) / down, the
    MoE router (written f32; under the kernel gate's 8 below 8 experts)
    and the head (``embed.T``, K-major, when tied)."""
    d, hd = cfg.d_model, cfg.head_dim
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    moe = any(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    dense = any(not cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    out = []
    if "attn" in kinds:
        out += [("qkv", d, (cfg.num_heads + 2 * cfg.num_kv_heads) * hd,
                 "mn", "bfloat16"),
                ("wo", cfg.num_heads * hd, d, "mn", "bfloat16")]
    if "mamba" in kinds:
        gn = cfg.ssm_num_groups * cfg.ssm_state_dim
        out += [("mamba:wz/wx", d, cfg.d_inner, "mn", "bfloat16"),
                ("mamba:wb/wc", d, gn, "mn", "bfloat16"),
                ("mamba:wdt", d, cfg.ssm_num_heads, "mn", "float32"),
                ("mamba:wo", cfg.d_inner, d, "mn", "bfloat16")]
    if dense:
        out += [("ffn:up", d, cfg.d_ff, "mn", "bfloat16"),
                ("ffn:down", cfg.d_ff, d, "mn", "bfloat16")]
    if moe and cfg.num_experts >= 8:
        out.append(("router", d, cfg.num_experts, "mn", "float32"))
    tied = cfg.tie_embeddings and cfg.embed_inputs
    out.append(("head", d, cfg.vocab_size, "k" if tied else "mn",
                "bfloat16"))
    return out


def zoo_forward_rows(key):
    """Rows (m) of a zoo model's forward: its batch x sequence."""
    b, s = {"gemma3": GEMMA_FWD, "danube": DANUBE_FWD}.get(key, ZOO_FWD)
    return b * s


def zoo_attention_cases(zoo):
    """(tag, B, Hq, Hkv, S, D, causal, window) of the zoo forwards'
    attention: danube's sliding window (D 80), hubert's bidirectional
    encoder (D 80), gemma3's local window (D 128), jamba / qwen2's GQA
    64 / 8 (D 128)."""
    g, dn, h, j = zoo["gemma3"], zoo["danube"], zoo["hubert"], zoo["jamba"]
    return [
        ("danube-swa", DANUBE_FWD[0], dn.num_heads, dn.num_kv_heads,
         DANUBE_FWD[1], dn.head_dim, True, dn.sliding_window),
        ("hubert-bidir", ZOO_FWD[0], h.num_heads, h.num_kv_heads, ZOO_FWD[1],
         h.head_dim, False, None),
        ("gemma3-local", GEMMA_FWD[0], g.num_heads, g.num_kv_heads,
         GEMMA_FWD[1], g.head_dim, True, g.local_window),
        ("jamba/qwen2", ZOO_FWD[0], j.num_heads, j.num_kv_heads, ZOO_FWD[1],
         j.head_dim, True, None),
    ]


def zoo_decode_cases(zoo):
    """(tag, B, Hq, Hkv, S, D, lo, hi) of the zoo decode steps: the serve
    step's 64-slot cache (32 of 16 + 16 tokens valid) at every new head
    geometry, gemma3's long step on a local layer, danube's step past the
    wrap of its rolling buffer (every slot valid)."""
    g, dn, j = zoo["gemma3"], zoo["danube"], zoo["jamba"]
    steps = PROMPT_LEN + MAX_NEW
    gb, gs, gi = GEMMA_LONG
    db, ds, _ = DANUBE_LONG
    return [
        ("jamba/qwen2-serve", BATCH, j.num_heads, j.num_kv_heads, CACHE_LEN,
         j.head_dim, 0, steps),
        ("gemma3-serve", BATCH, g.num_heads, g.num_kv_heads, CACHE_LEN,
         g.head_dim, 0, steps),
        ("danube-serve", BATCH, dn.num_heads, dn.num_kv_heads, CACHE_LEN,
         dn.head_dim, 0, steps),
        ("gemma3-long-local", gb, g.num_heads, g.num_kv_heads, gs, g.head_dim,
         gi - g.local_window + 1, gi + 1),
        ("danube-long-wrapped", db, dn.num_heads, dn.num_kv_heads, ds,
         dn.head_dim, 0, ds),
    ]


def zoo_ssd_shapes(zoo):
    """(tag, BH, C, Q, P, N) of jamba's SSD launches: the 2 x 512 forward
    (256 heads a row, chunk 256) and the f32 check's 1 x 512."""
    j = zoo["jamba"]
    q = j.ssm_chunk
    return [("jamba-forward", ZOO_FWD[0] * j.ssm_num_heads, ZOO_FWD[1] // q,
             q, j.ssm_head_dim, j.ssm_state_dim),
            ("jamba-f32", j.ssm_num_heads, JAMBA_F32_FWD_SEQ // q, q,
             j.ssm_head_dim, j.ssm_state_dim)]


# The Mamba-2 conv + SiLU's timed shapes: (tag, B, S, di, G·N, K, launches a
# forward): granite-4.0-h-small's prefill cell (18 mixers of its 20 kept
# layers) and mamba2-370m's 4 x 1024 forward (48 mixers).
CONV_TIME_SHAPES = (
    ("granite-4.0-h-small", GRANITE_TOKENS[0], GRANITE_TOKENS[1], 8192, 128, 4,
     18),
    ("mamba2-370m", SSM_FWD_BATCH, SSM_FWD_SEQ, 2048, 128, 4, 48))
# f32 ulp the kernel's SiLU output may lie from the plain version's (the
# pre-activation must be equal).
CONV_MAX_ULPS = 4
