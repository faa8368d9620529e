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
              launch bit for bit against its single launches; at the
              zoo's shapes (phases 12a-12h) every GEMM of each model on
              ``skinny`` and ``wgmma`` (jamba's on ``tf32x3`` in f32), jamba's
              expert GEMMs (d 8192, f 24576), flash attention at D 80 and
              128 on ``wgmma`` (danube's window, hubert bidirectional,
              gemma3's window), flash decode at D 80, past a
              rolling buffer's wrap and on gemma3's windowed long step, the
              SSD chunk kernel at jamba's 256 heads; flash
              attention on its three routes (bf16 at D 64 / 80 / 128 on
              the tensor cores by ``wgmma``, f32 on them by 3xTF32
              ``tf32x3``, D 32 in bf16 and a misaligned bf16 and f32
              operand on the CUDA cores, ``simt``), the prefill shape also
              as the model's transposed (B, S, H, D) views, the f32
              forwards' shapes (yi-6b / qwen3-moe 1 x 128, jamba 1 x 512)
              on ``tf32x3`` repeated bit for bit; flash decode
              on both routes (bf16 on the tensor cores, f32 on the CUDA
              cores), also on 4096- and
              4099-slot caches split across a cluster, each launch
              repeated bit for bit; the SSD chunk kernel on its
              tensor-core route (``mma``) at every case, the forward's
              shape repeated bit for bit; the batched GEMM at qwen3-moe's
              four expert shapes (128 experts, m 64 / 128, 2048 -> 768 and
              768 -> 2048) in bf16 (``wgmma``) and f32 (``tf32x3``)
              against ``moe_gemm_ref``, and
              one 128-expert launch bit for bit against its single
              launches; the GEMM at qwen3-moe's other shapes (qkv, wo,
              the router written f32, the head) on ``skinny`` at m = 8 and
              16 and on ``wgmma`` at the forward's m = 1024; the f32
              tensor-core route (``tf32x3``) at Fig. 3's n, ragged shapes
              with A row- / column-major and B MN- / K-major, a misaligned
              operand and every GEMM of the yi-6b and mamba2-370m f32
              forwards (k up to 11008), at the f32 bar, and stacks (128
              f32 experts, a broadcast A) bit for bit against single
              launches and a repeat; the CUDA-core ``tiled`` route on the
              bf16 GEMMs ``wgmma`` cannot take (a column-major A, k % 8);
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
5c. races   — every device's whole ticket stream of run (a) (kept by the
              flight recorder) through ``analysis.races``'s happens-before
              rules, and ``check_cluster`` on that run's engine (its
              in-flight window, empty after ``serve_cluster``'s closing
              sync): no violation (the second part runs in 10e);
6. float32  — first-step decode logits and last-position forward logits of
              the same model with f32 weights, kernels against plain (the
              forward's GEMMs and attention on ``tf32x3``, the decode
              step's GEMMs on ``skinny``), and the long-cache decode step
              of phase 5 with these weights;
7. hnp      — the paper's path: the reference quickstart's graph, then one
              wave of two same-shape GEMMs at yi-6b width stacked into one
              batched-GEMM launch;
7b. hnp-validated — phase 7 again under ``offload_region(validate=True)``
              (the graph verifier before every dispatch): values bit for
              bit, launches and routes equal to phase 7's; a seeded bad
              ``dispatch_placed("gemm", ..., validate=True)`` (inner
              dimensions that disagree, a dead handle) raises
              ``GraphVerificationError`` with no launch; host ms validated
              against plain, median of 3;
7c. stream  — the streaming engine (``launch/streaming.py``, modeled: no
              kernel runs) at yi-6b's config on the default ``h100-sxm``
              platform row, 4 devices, 1 prefill lane, 8 slots, a bursty
              trace at 2 x ``estimate_capacity`` for 1 s: two
              ``serve_stream`` runs with equal events and reports, one
              ``serve_lockstep``, slot refills and ticket streams
              race-free; qwen3-moe with expert placement fed by the decode
              traffic (decisions made, streams race-free);
7a. paper-fig3 — the paper's Fig. 3 on the card
              (``tools/paper_fig3_h100.py``): host numpy against
              ``blas.gemm`` offloaded, n 16 to 128, f64 / f32 / bf16, copy /
              launch / compute split, each result within its bar of numpy's
              f64 product and on its backend and route (f64 the plain
              ``device`` path, f32 ``skinny`` / ``tf32x3``, bf16 ``skinny`` /
              ``wgmma``), and the crossover n; written to
              ``DIR/paper_fig3.json``;
8. ssm-forward — the SSM path: ``Model.forward`` of mamba2-370m at full
              width (bf16, random weights) on 4 x 1024 tokens, eager and
              graph mode, on the kernels (48 SSD launches per forward, and
              one causal conv + SiLU launch a mixer: every forward here
              must launch the conv kernel as often as the SSD kernel) and
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
              kernels (run before 10d, on 10a's weights); the races
              phase's second part: the policy's migration edges and the
              lanes' in-flight windows through ``analysis.races``;
10d. moe-float32 — 2 layers at published widths in f32 (the depth cut):
              first decode step and last-position logits of a 1 x 128
              forward, kernels against plain, 1e-4 x max |logit|, and the
              count of routing decisions the two paths make differently;
10g. grouped — the dropless MoE's ragged grouped GEMM (``gemm_grouped``)
              at granite-4.0-h's expert shapes (72 experts, 4096 -> 768
              and back, its prefill's 163840 routed rows, empty experts,
              one heavy, counts off the 128-row tile) against one plain
              product an expert, two launches bit for bit; a dropless MoE
              layer at granite's widths on its 4 x 4096 tokens, on the
              kernels: three grouped launches, repeated bit for bit,
              nothing dropped, within the bf16 bar of plain under one
              shared routing (the two routers' top-k flips counted);
12a-12h. the rest of the zoo, each model built on the card after the
              last one's weights are freed (``zoo_configs``; cuts printed):
              jamba-1.5-large-398b at one super-block (8 of 72 layers) and
              8 of 16 experts, served eager and graph (12a, 12b) and run
              forward on 2 x 512 eager and graph (12c: 7 SSD launches; its
              bf16 logits held on the kernel path's routing, the unshared
              error and the routing flips printed), its f32 twin with 2
              experts at 1e-4 (12d); gemma3-27b whole: served, run forward
              on 2 x 2048 (the 1024 window bites in 52 of 62 layers) and a
              decode step at index 4000 of a 4096-slot cache at B 8 (12e);
              h2o-danube-1.8b whole: served, run forward on 1 x 8192 (D 80
              on ``wgmma``) and a decode step at index 5000, past the wrap
              of its 4096-slot rolling buffer (12f); hubert-xlarge whole:
              a bidirectional 2 x 512 forward on seeded frame embeddings
              (12g); qwen2-72b served and qwen2-vl-72b run forward on 2 x
              512 embeddings with three position streams, both at 8 of 80
              layers (12h); each with its launches and routes, logits
              against the plain path, weights and peak memory, and the
              profiled step or forward;
13. train   — training yi-6b at its published widths cut to 8 of 32
              layers (bf16, 2 microbatches of 1 x 512): (b) the GEMM
              Function's backward (dA = dC·Bᵀ, dB = Aᵀ·dC on the GEMM kernel)
              against autograd of ``gemm_ref`` at every forward GEMM shape,
              bf16 on ``wgmma`` and f32 on ``tf32x3``, none on ``tiled``,
              one repeated bit for bit; (c) the attention Function at the
              step's shape against autograd of ``attention_ref``; (a) one
              loss-and-gradients call, kernels against the plain path (loss
              within 1e-2 relative; layer 0's wq, the last w_down, the head
              and the embedding within 2e-2 of max |plain|), its launches
              split forward / backward, one step profiled (GEMM forward and
              backward, attention, torch kernels, optimizer; idle share);
              (d) 8 AdamW steps through ``repro_torch.launch.train.train``
              (finite losses, the last below the first; step times, peak
              memory); (e) ``run_with_recovery`` with one injected failure
              at the reduced config, losses bit for bit those of an
              uninterrupted run;
14. distributed — the distributed layer on an emulated (data 2, model 4)
              mesh: 8 mesh devices whose shards all live on the one card
              (``sharding/spmd.py``; a 1-D model-4 mesh for (e) and (f)),
              each sub-phase against the same work with no mesh: (a)
              yi-6b's TP forward, 32 layers, bf16, 2 x 512 (1281 GEMM
              launches, all ``wgmma``; 32 attention; 96 ``tp-plan``
              records), at phase 4's bar, and at 2 layers in f32, 2 x 128,
              at 2e-5; (b) its loss and gradients at 8 layers, one 2 x 512
              microbatch, each leaf within max(2e-2, twice the plain
              path's own floor); (g) ``compressed_psum`` over a data-2 mesh
              on (b)'s two gradient sets, bit for bit its formula; (c)
              qwen3-moe's layer 0 expert-parallel (``moe_dispatch="auto"``
              under the mesh, capacity factor 8) against the grouped path,
              bf16 and f32, on the tokens whose routing agrees (8 router
              GEMMs, 24 batched on 32 experts each); (d) mamba2-370m
              head-sharded, 48 layers, 4 x 1024 (384 SSD launches, all
              ``mma``) at phase 8's bar, f32 2 x 512 at 1e-4; (e) the ring
              collective matmul at yi-6b's up projection (16 GEMMs) against
              one GEMM, values and gradients; (f) GPipe, 4 yi-6b layers, 8
              microbatches of 1 x 512, bit for bit its stages applied
              microbatch by microbatch, gradients within 2e-2.  Each
              prints its wall, its kernels' device ms beside the no-mesh
              run's (profiled), the collectives' device ms (CUDA events
              behind a spin kernel), their calls and bytes, the host ms of
              a ``shard_map`` call and the peak GB;
15. roofline — (a) the dry run (``repro_torch.launch.dryrun``) on meta
              tensors of tests/test_sharding.py's mini cell (yi-6b cut to
              4 layers, d 128, 2 microbatches, 8 x 64 tokens) on an
              emulated (2, 4) mesh, within that test's bounds on its
              analytic forward, and of yi-6b's decode_32k cell on the 16 x
              16 production mesh (256 emulated devices), both
              ``status: "ok"`` with no kernel launched, each record's
              per-device FLOPs, traffic and collective bytes and its host
              seconds printed; (b) the device busy ms (profiled) and wall
              that phases 4 and 8 measured of yi-6b's 2 x 512 and
              mamba2-370m's 4 x 1024 forwards on the kernels, beside the
              roofline terms (H100 row) of the same forward's work
              counted on meta (``repro_torch.roofline.op_count``), once
              with the seam's kernel-ideal bytes alone and once with the
              counted traffic (those bytes plus the glue's); neither
              bound may exceed the busy time;
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
              shapes beside torch.bmm and its bound (and at jamba's); qwen3-moe's decode
              GEMMs outside the experts (qkv, wo, router, head); the f32
              GEMM (``tf32x3``) at square n 32-4096 and at the yi-6b (m
              128) and mamba2-370m (m 512) f32 forwards' shapes beside
              ``torch.matmul`` (TF32 off) and its bytes / 3xTF32 / CUDA-core
              fp32 bounds; f32 flash attention (``tf32x3``) at the yi-6b
              f32 forward's shape and flash decode (``simt``) at the f32
              long-cache step's beside SDPA in f32; at the zoo's shapes
              (``time_zoo``) bf16 flash attention on ``wgmma`` at D 80 and
              with gemma3's window beside SDPA with the same mask, flash decode
              at D 80 past the wrap and on gemma3's long step, the SSD
              kernel at jamba's shape; the ragged grouped GEMM on phase
              10g's operands beside its f32 plain version and
              ``torch._grouped_mm`` (the kernels line's ``gemm_grouped``);
              the Mamba-2 causal conv + SiLU (``time_conv``) at
              granite-4.0-h-small's prefill and mamba2-370m's forward,
              first checked against its plain version (the torch
              composition it replaced: the pre-activation bit for bit, the
              SiLU output within 4 f32 ulp), then timed beside it and its
              bytes bound (the kernels line's ``causal_conv_silu``).

Each path's launch counters are set to 0 just before it runs and read just
after; the GEMM's, flash attention's and flash decode's route counters
too: every bf16 forward and hnp-wave GEMM and every bf16 forward attention
launch (D 64 / 80 / 128) must have taken the tensor-core route
(``wgmma``), every serving GEMM the skinny one, every bf16 decode
attention launch the tensor-core one (``mma``), every f32 forward
attention launch (yi-6b, qwen3-moe, jamba) the f32 tensor-core one
(``tf32x3``), the f32 decode's attention the CUDA-core one (``simt``),
every f32 GEMM with m > 16 (phases 2, 6, 7a, 10, 10d)
the f32 tensor-core one (``tf32x3``), and every SSD launch of the phase-2
checks and of the forwards (eager, graph, f32) the tensor-core one
(``mma``).  The last
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
import itertools
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
    routed = _routed()
    for fn in routed.values():
        fn.route_launches.update(dict.fromkeys(fn.route_launches, 0))
    for k in ("gemm", "gemm_batched"):
        routed[k].grouped_launches = 0


def read_routes():
    """{"gemm": {route: launches}, "gemm_batched": {...},
    "flash_attention": {...}, "flash_decode": {...}, "ssd_chunk_diag":
    {...}, "grouped": {"gemm": n, "gemm_batched": n}} since the last
    ``zero_routes``; "grouped" counts the ``wgmma`` launches that ran in a
    tile order other than the plain one (``kernels/gemm.py::wgmma_plan``)."""
    routed = _routed()
    out = {k: dict(fn.route_launches) for k, fn in routed.items()}
    out["grouped"] = {k: routed[k].grouped_launches
                      for k in ("gemm", "gemm_batched")}
    return out


def require_route(label, routes, route, decode=None, batched=None,
                  attn=None):
    """Fail unless every GEMM launch in ``routes`` took ``route``, every
    flash-attention launch ``attn`` (default ``route``), every flash-decode
    launch ``decode``, every SSD chunk launch ``mma`` and every batched
    GEMM launch ``batched`` (default ``route``; a path that launches no
    attention or SSD passes on the GEMMs)."""
    want = {"flash_decode": decode, "ssd_chunk_diag": "mma",
            "gemm_batched": batched or route,
            "flash_attention": attn or route}
    stray = {k: {r: n for r, n in v.items() if r != want.get(k, route) and n}
             for k, v in routes.items() if k != "grouped"}
    if any(stray.values()):
        fail(f"{label}: kernel launches off the {route} / {attn or route} / "
             f"{decode} / mma routes: {routes}")


def require_f32_gemm_routes(label, routes):
    """Fail unless every GEMM launch (single and batched) in ``routes`` of
    an f32 path took ``skinny`` (m <= 16) or the f32 tensor-core route
    ``tf32x3`` (m > 16), and ``tf32x3`` ran: no f32 GEMM on the CUDA-core
    tile."""
    stray = {fn: {r: n for r, n in routes[fn].items()
                  if n and r not in ("skinny", "tf32x3")}
             for fn in ("gemm", "gemm_batched")}
    if any(stray.values()) or not (routes["gemm"]["tf32x3"]
                                   + routes["gemm_batched"]["tf32x3"]):
        fail(f"{label}: f32 GEMMs off the skinny / tf32x3 routes: {routes}")


def decode_route_of(dtype):
    """Flash decode's route for the models' (aligned, D 80 or 128)
    operands."""
    import torch

    return "mma" if dtype in ("bfloat16", torch.bfloat16) else "simt"


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


def attn_route(dtype, d):
    """Flash attention's route for aligned operands (every model's, and
    TEST_ATTN_CASES'): the bf16 tensor-core tile (``wgmma``) at D 64 / 80
    / 128, the f32 one (``tf32x3``) at D a multiple of 8 up to 128, else
    the CUDA cores (``simt``)."""
    import torch

    if dtype in ("bfloat16", torch.bfloat16):
        return "wgmma" if d in (64, 80, 128) else "simt"
    return "tf32x3" if d % 8 == 0 and d <= 128 else "simt"



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
    zoo = zoo_configs()
    max_abs = check_kernels(cfg, ssm_cfg, moe_cfg, randn, zoo)
    launches, routes = {}, {}

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
    hnp_phase, hnp_plain = run_hnp(cfg, randn, zero_counts, read_counts)
    launches["hnp"] = hnp_phase["launches"]
    routes["hnp-wave"] = hnp_phase["wave"]["routes"]
    max_abs["gemm_batched"] = max(max_abs["gemm_batched"],
                                  hnp_phase["wave"]["max_abs_err_vs_plain"])
    emit({"phase": "hnp", **hnp_phase})
    # ---- 7b. the same path under validate=True ---------------------------
    launches["hnp-validated"], routes["hnp-validated-wave"] = \
        run_hnp_validated(hnp_plain, zero_counts, read_counts)
    del hnp_plain
    # ---- 7c. the streaming engine (modeled) -------------------------------
    run_stream()
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
    launches["ssm-forward-conv"] = ssm_fwd["conv_launches"]
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
    routes["ssm-float32"] = run_ssm_f32(ssm_cfg, ssm_tokens, ssm_prompts)

    # ---- 10a.-10f. MoE: qwen3-moe-30b-a3b at full width --------------------
    run_moe(moe_cfg, rng, zero_counts, read_counts, launches, routes)
    # ---- 10g. the dropless MoE's ragged grouped GEMM (granite-4.0-h) -------
    grouped = run_grouped(moe_cfg, launches)
    max_abs["gemm_grouped"] = max(v["max_abs_err"]
                                  for v in grouped["gemm"].values())

    # ---- 12a.-12h. the rest of the zoo -------------------------------------
    run_zoo(zoo, rng, zero_counts, read_counts, launches, routes)

    # ---- 13. training: yi-6b at published widths, 8 of 32 layers ----------
    run_train(randn, zero_counts, read_counts, launches, routes, max_abs)

    # ---- 14. the distributed layer on an emulated 8-device mesh ------------
    run_distributed(zero_counts, read_counts, launches, routes, max_abs)

    # ---- 15. the roofline: dry runs on meta, forwards against their bound --
    run_roofline(zero_counts, read_counts, {ARCH: fwd, SSM_ARCH: ssm_fwd})

    # ---- 11. times --------------------------------------------------------
    kernels = run_times(cfg, ssm_cfg, moe_cfg, randn, launches, routes,
                        max_abs)
    zoo_lines = zoo_kernel_lines(launches, routes, max_abs,
                                 time_zoo(zoo, randn))
    for row in kernels:
        if row["name"] in zoo_lines:
            row["zoo"] = zoo_lines[row["name"]]
        if row["name"] in counters:
            row["distributed_launches"] = {
                path: n[row["name"]] for path, n in launches.items()
                if path.startswith("distributed")}
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


def check_kernels(cfg, ssm_cfg, moe_cfg, randn, zoo):
    """Phase 2: every kernel against its plain version; returns the max
    abs errors at the main paths' shapes (bf16), the zoo's
    (``zoo_configs``, ``check_zoo_kernels``) under ``<kernel>:zoo``."""
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
               "gemm_batched:moe": 0.0, "gemm:tf32x3": 0.0,
               **{f"{k}:zoo": 0.0 for k in ("gemm", "gemm_batched",
                                            "flash_attention", "flash_decode",
                                            "ssd_chunk_diag")}}
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
    its counts are eager mode's.  A dense stack with a GELU MLP (hubert)
    runs 2 FFN GEMMs a layer (up, down), not 3.  jamba (hybrid): per
    super-block each sub-layer's mixer (attention: qkv, wo and one
    attention launch; Mamba: six GEMMs and, in a forward, one SSD launch,
    graph mode stacking z/x and B/C) and FFN (dense: three GEMMs; MoE: the
    router and three batched); decode keeps every FFN eager.  All: plus
    the head GEMM."""
    L = cfg.num_layers
    counts = dict.fromkeys(("gemm", "gemm_batched", "flash_decode",
                            "flash_attention", "ssd_chunk_diag"), 0)
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
                 attn: n_sb * a, "ssd_chunk_diag": n_sb * ssd}, ops)
    if cfg.num_experts:
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
    mlp = 3 if cfg.mlp_kind == "swiglu" else 2
    return ({**counts, "gemm": (2 + mlp) * L + 1, attn: L},
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
        serve_batch(cfg, prompts, max_new_tokens=1, **kw)
    zero_counts()
    with offload_policy(**KERNEL_POLICY), offload_trace() as trace, \
            (metrics.collect(books) if books is not None
             else contextlib.nullcontext()):
        res_k = serve_batch(cfg, prompts, max_new_tokens=MAX_NEW, **kw)
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
        res_p = serve_batch(cfg, prompts, max_new_tokens=MAX_NEW, **kw)
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


KERNEL_FAMILIES = {"gemm": ("gemm_wgmma", "gemm_tiled", "gemm_skinny",
                            "gemm_tf32x3"),
                   "flash_attention": ("flash_attention_kernel",
                                       "attn_wgmma", "attn_tf32x3"),
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
        if ev.is_user_annotation:
            # The device's mirror of a host range (the program's own under
            # the profiler): no operation of the device.
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


def _first_positions(inputs, n):
    """The first ``n`` positions of a forward's inputs: a (B, S) token
    tensor, or the batch dict (``tokens`` / ``embeds``, ``positions``
    (B, S) or (3, B, S))."""
    if not isinstance(inputs, dict):
        return inputs[:, :n]
    return {k: v[..., :n] if k == "positions" else v[:, :n]
            for k, v in inputs.items()}


def _moe_routing(calls, replay):
    """A context in which the MoE router's top-k choices are recorded into
    ``calls`` (one (experts, probabilities) pair a router call), or, with
    ``replay``, taken from it call by call: the replaying path routes each
    token to the recorded experts, its gates read from its own router
    probabilities there and renormalized, as ``_top_k_gates`` does."""
    import contextlib

    import torch

    from repro_torch.models import moe as M

    @contextlib.contextmanager
    def scope():
        top_k = M._top_k_gates
        recorded = iter(list(calls))
        if not replay:
            calls.clear()

        def spy(logits, k):
            probs = torch.softmax(logits.float(), dim=-1)
            if replay:
                idx = next(recorded)[0]
                gates = probs.gather(-1, idx)
                return gates / torch.clamp(gates.sum(dim=-1, keepdim=True),
                                           min=1e-9), idx
            gates, idx = top_k(logits, k)
            calls.append((idx, probs))
            return gates, idx

        M._top_k_gates = spy
        try:
            yield
        finally:
            M._top_k_gates = top_k

    return scope()


def _routing_diff(kernel_calls, plain_calls, k):
    """Routing decisions (token, slot) of two paths, the count that differ,
    and the plain path's gap between its k-th and next expert's
    probability at each token that differs."""
    decisions = differ = 0
    gaps = []
    for (ik, _), (ip, probs) in zip(kernel_calls, plain_calls, strict=True):
        decisions += ip.numel()
        differ += int((ik != ip).sum())
        rows = (ik != ip).any(dim=-1)
        if rows.any():
            srt = probs[rows].sort(dim=-1, descending=True).values
            gaps += (srt[:, k - 1] - srt[:, k]).tolist()
    return {"decisions": decisions, "differ": differ,
            "gaps_at_differing_tokens": gaps}


def run_forward(cfg, model, params, tokens, zero_counts, read_counts,
                shared_routing=False):
    """Phases 4, 8, 10c and 12: Model.forward at full width, eager and
    graph mode on the kernels (counted), and on the plain path.  ``tokens``
    is a (B, S) token tensor or the batch dict (embedding inputs,
    positions).  ``shared_routing`` holds an MoE model's logits to the bar
    with the plain path taking the kernel path's routing (the top-k of two
    bf16 paths can flip at near-ties, and a flipped or dropped copy
    changes the answer); the unshared error, the routing decisions that
    differ and their probability gaps are printed beside it."""
    import contextlib

    import torch

    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels.ssd_scan import causal_conv_silu
    from repro_torch.models import build_model

    arch = cfg.name
    lead = tokens if not isinstance(tokens, dict) else (
        tokens.get("tokens", tokens.get("embeds")))
    bsz, seq = lead.shape[0], lead.shape[1]
    out = {"arch": arch, "dtype": cfg.dtype, "batch": bsz, "seq": seq,
           "seconds": {}, "launches": {}, "routes": {}, "trace_backends": {}}
    last = {}
    for mode in ("eager", "graph"):
        mdl = build_model(dataclasses.replace(cfg, forward_mode=mode))
        with offload_policy(**KERNEL_POLICY), torch.no_grad():
            mdl.forward(params, _first_positions(tokens, 64))  # warm up
        torch.cuda.synchronize()
        zero_counts()
        conv0 = causal_conv_silu.launches
        t0 = time.perf_counter()
        with offload_policy(**KERNEL_POLICY), offload_trace() as trace, \
                torch.no_grad():
            logits, aux = mdl.forward(params, tokens)
        torch.cuda.synchronize()
        runs = [time.perf_counter() - t0]
        counts = read_counts()
        out["launches"][mode] = counts
        # Every Mamba-2 mixer makes its SSD operands with one conv launch.
        conv = causal_conv_silu.launches - conv0
        out.setdefault("conv_launches", {})[mode] = conv
        if conv != counts["ssd_chunk_diag"]:
            fail(f"{arch} forward ({mode}) causal conv launches {conv}, want "
                 f"one a Mamba-2 mixer ({counts['ssd_chunk_diag']})")
        out["routes"][mode] = read_routes()
        require_route(f"{arch} forward ({mode})", out["routes"][mode],
                      "wgmma", attn=attn_route(cfg.dtype, cfg.head_dim))
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

    kernel_routing = []

    def last_logits(pol, k_parts=1, share=shared_routing):
        t0 = time.perf_counter()
        routing = (_moe_routing(kernel_routing, pol is not KERNEL_POLICY)
                   if share else contextlib.nullcontext())
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad(), routing:
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
    if shared_routing:
        plain_routing = []
        with offload_policy(**PLAIN_POLICY), torch.no_grad(), \
                _moe_routing(plain_routing, False):
            lp = model.forward(params, tokens)[0][:, -1].float()
        lk = last_logits(KERNEL_POLICY)
        out["last_logits"]["routing_shared"] = True
        out["last_logits"]["unshared"] = {
            "err": (lk - lp).abs().max().item() / lp.abs().max().item(),
            "argmax_agreement": (lk.argmax(-1) == lp.argmax(-1)).float()
            .mean().item(),
            "routing": _routing_diff(kernel_routing, plain_routing,
                                     cfg.experts_per_token)}
    return out


def run_long_decode(cfg, model, params, prompts, zero_counts, read_counts,
                    *, batch=BATCH, cache_len=LONG_CACHE, index=LONG_INDEX,
                    phase="long-decode", clone=True):
    """One decode step of the model at full width at cache index ``index``
    on a ``cache_len``-slot cache whose every layer's K and V are drawn
    from a generator seeded with SEED, the prompts' first tokens as input:
    kernels (counted: each layer's flash decode split across a cluster, on
    its dtype's route) against the plain path.  Logits bar: 1e-4 x max
    |logit| in f32, max(2e-2, 2 x floor) in bf16.  ``clone=False`` runs
    every path on the one cache (a step writes its slot before it reads
    the cache, so each path sees the same cache), where a second copy
    would not fit beside the weights."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels.flash_decode import cluster_capacity, decode_plan

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = model.init_decode_cache(batch, cache_len, device=dev)
    for buf in base.values():
        for layer in buf:
            layer.copy_(torch.randn(layer.shape, generator=gen, device=dev))
    first = torch.tensor([[p[0]] for p in prompts[:batch]], device=dev)

    def logits_of(pol, k_parts=1):
        cache = ({name: buf.clone() for name, buf in base.items()} if clone
                 else base)
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad():
            return model.decode_step(params, cache, first, index)[0].float()

    zero_counts()
    errs = _logit_errs(logits_of, (batch, cfg.vocab_size))
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
    slots = base["k"].shape[3]
    plan = decode_plan(batch, cfg.num_heads, cfg.num_kv_heads, slots,
                       cfg.head_dim, dt, route,
                       cluster_capacity(route, dt, cfg.head_dim, 0))
    out = {"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
           "batch": batch, "cache_len": cache_len, "cache_slots": slots,
           "cache_index": index, "plan": plan._asdict(),
           "launches": launches, "routes": routes,
           "logits": {**errs, "bar": bar},
           "cache_GB": sum(t.numel() * t.element_size()
                           for t in base.values()) / 1e9,
           "max_memory_allocated_GB": _peak_GB()}
    if phase != "long-decode":
        out["profile_step"] = _profile(lambda: logits_of(KERNEL_POLICY))
    emit(out)
    del base
    torch.cuda.empty_cache()
    return out


def run_f32(cfg, tokens, prompts, zero_counts, read_counts):
    """Phase 6: decode first-step and forward last-position logits with
    f32 weights at full width, kernels against plain, bar 1e-4, and the
    long-cache decode step at that bar.  Every attention launch of the f32
    forward must take the f32 tensor-core route (``tf32x3``: 3xTF32,
    fp32-accurate), of the decode the CUDA-core one (``simt``); returns
    the route counts of the phase's short and long-cache decode steps."""
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
    if attn != {"simt": 0, "wgmma": 0, "tf32x3": cfg.num_layers}:
        fail(f"f32 forward attention off the tf32x3 route: {attn}")
    require_f32_gemm_routes("f32 decode / forward", out["routes"])
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


HNP_POLICY = dict(mode="device", num_devices=2, scheduler="cost-aware",
                  use_kernels=True, platform="h100-sxm")


def hnp_quickstart(zero_counts, read_counts, validate=False):
    """examples/quickstart.py's graph under mode="device", 2 modeled
    devices, cost-aware, in an ``offload_region(validate=validate)``.
    Returns (facts, values, launches, routes); ``facts["run_s"]`` is the
    host time of the region, from the leaves to the last value on the
    host."""
    import numpy as np

    import repro_torch.hnp as hnp
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import engine, offload_policy

    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 256)).astype(np.float32)
    w1 = rng.normal(size=(256, 512)).astype(np.float32)
    b1 = rng.normal(size=(512,)).astype(np.float32)
    w2 = rng.normal(size=(512, 128)).astype(np.float32)
    engine().reset()
    zero_counts()
    t0 = time.perf_counter()
    with offload_policy(**HNP_POLICY), offload_trace() as t:
        with hnp.offload_region("quickstart", validate=validate) as region:
            h = hnp.tanh(hnp.linear(hnp.array(x), w1, b1))
            y = h @ w2
            sim = hnp.syrk(y)
            y_np = hnp.asnumpy(y)
            sim_np = hnp.asnumpy(sim)
    run_s = time.perf_counter() - t0
    counts, routes = read_counts(), read_routes()
    if y.node.value.device.type != "cuda":
        fail("hnp leaves did not land on the card")
    ref = (np.tanh(x.astype(np.float64) @ w1 + b1) @ w2)
    y_err = float(np.abs(y_np - ref).max() / np.abs(ref).max())
    sim_err = float(np.abs(sim_np - ref @ ref.T).max()
                    / np.abs(ref @ ref.T).max())
    if not (y_err <= TOL["float32"] and sim_err <= TOL["float32"]):
        fail(f"hnp quickstart values off: y {y_err}, syrk {sim_err}")
    if counts["gemm"] != 2:
        fail(f"hnp quickstart launches {counts}")
    facts = {
        "summary": region.report.summary(),
        "launches_by_node": [
            {"op": r.op, "backend": r.backend, "device_id": r.device_id,
             "resident_fraction": r.resident_fraction,
             "readback_bytes": r.readback_bytes, "fused": list(r.fused)}
            for r in region.report.launches],
        "records": [r.op for r in t.records], "kernel_launches": counts,
        "max_rel_err_vs_float64": {"y": y_err, "syrk": sim_err},
        "run_s": run_s,
    }
    return facts, (y_np, sim_np), counts, routes


def hnp_wave(operands, zero_counts, read_counts, validate=False):
    """One wave of two independent same-shape GEMMs (``operands``: x, wk,
    wv at yi-6b width), stacked into one batched-GEMM launch, in an
    ``offload_region(validate=validate)``.  Returns (facts, value,
    launches, routes); ``facts["run_s"]`` is the host time of the region
    up to the card's synchronize."""
    import numpy as np
    import torch

    import repro_torch.hnp as hnp
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import engine, offload_policy
    from repro_torch.kernels.ref import gemm_batched_ref

    xa, wk, wv = operands
    engine().reset()
    zero_counts()
    t0 = time.perf_counter()
    with offload_policy(**HNP_POLICY), offload_trace() as t:
        with hnp.offload_region("yi-kv-wave", validate=validate) as region:
            a = hnp.array(xa)
            yk, yv = a @ wk, a @ wv
            hnp.block_all(yk, yv)
            torch.cuda.synchronize()
            got = torch.stack([yk.node.value, yv.node.value])
    run_s = time.perf_counter() - t0
    counts, routes = read_counts(), read_routes()
    require_route("hnp wave", routes, "wgmma")
    ops = [r.op for r in t.records if r.op != "d2d_copy"]
    if ops != ["gemm_batched"] or counts["gemm_batched"] != 1 or \
            counts["gemm"] != 0:
        fail(f"hnp wave did not take one batched launch: {ops} {counts}")
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
    facts = {
        "summary": region.report.summary(), "records": ops,
        "shape": [2, *xa.shape, wk.shape[1]], "dtype": "bfloat16",
        "kernel_launches": counts, "routes": routes,
        "gemm_batched_launched": counts["gemm_batched"] == 1,
        "max_rel_err_vs_float64": err64, "max_rel_err_vs_plain": err_plain,
        "max_abs_err_vs_plain": abs_plain, "run_s": run_s,
    }
    return facts, got, counts, routes


def run_hnp(cfg, randn, zero_counts, read_counts):
    """Phase 7: the paper's path on the card — examples/quickstart.py's
    graph, then one wave of two same-shape GEMMs at yi-6b width, stacked
    into one launch.  Returns the phase's facts and, for phase 7b, the
    wave's operands and both values."""
    import torch

    quick, quick_values, quick_counts, quick_routes = hnp_quickstart(
        zero_counts, read_counts)
    d, n = cfg.d_model, cfg.num_kv_heads * cfg.head_dim
    bf16 = torch.bfloat16
    operands = (randn(HNP_ROWS, d, dtype=bf16), randn(d, n, dtype=bf16),
                randn(d, n, dtype=bf16))
    wave, wave_value, wave_counts, wave_routes = hnp_wave(
        operands, zero_counts, read_counts)
    plain = {"operands": operands, "quickstart": quick_values,
             "wave": wave_value,
             "launches": (quick_counts, wave_counts),
             "routes": (quick_routes, wave_routes)}
    return {"quickstart": quick, "wave": wave, "launches": {
        k: quick_counts[k] + wave_counts[k] for k in quick_counts}}, plain


def run_hnp_validated(plain, zero_counts, read_counts):
    """Phase 7b: phase 7 again under ``offload_region(validate=True)``
    (``repro_torch.analysis.graph`` checks every forced graph before it
    dispatches): values bit for bit, launch counts and routes equal to the
    unvalidated run's; a seeded bad call (``dispatch_placed("gemm", ...,
    validate=True)`` on operands whose inner dimensions disagree, and on a
    dead handle) must raise ``GraphVerificationError`` before any launch;
    host ms of the validated and the plain run, median of 3 in turns."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.analysis.graph import GraphVerificationError
    from repro_torch.core.dispatch import dispatch_placed
    from repro_torch.core.hero import offload_policy

    def both(validate):
        quick, qv, qc, qr = hnp_quickstart(zero_counts, read_counts,
                                           validate=validate)
        wave, wv, wc, wr = hnp_wave(plain["operands"], zero_counts,
                                    read_counts, validate=validate)
        return quick, wave, qv, wv, (qc, wc), (qr, wr)

    quick, wave, qv, wv, counts, routes = both(True)
    if not all(np.array_equal(g, w) for g, w in
               zip(qv, plain["quickstart"], strict=True)):
        fail("hnp-validated: quickstart values differ from the "
             "unvalidated run's")
    if not torch.equal(wv, plain["wave"]):
        fail("hnp-validated: wave values differ from the unvalidated run's")
    if counts != plain["launches"] or routes != plain["routes"]:
        fail(f"hnp-validated: launches {counts} / routes {routes}, "
             f"unvalidated {plain['launches']} / {plain['routes']}")
    launches = {k: counts[0][k] + counts[1][k] for k in counts[0]}

    xa, wk, _ = plain["operands"]
    seeded = {}
    with offload_policy(**HNP_POLICY) as cluster:
        dead = cluster.pin_handle("dead", float(xa.nbytes), device_id=0)
        cluster.unstage_handle(dead)
        for label, args, kw in (
                ("inner-dims-disagree", (xa, wk[:-1]), {}),
                ("dead-handle", (xa, wk), {"handle": dead})):
            zero_counts()
            raised = None
            try:
                dispatch_placed("gemm", *args, validate=True, **kw)
            except GraphVerificationError as e:
                raised = e
            torch.cuda.synchronize()
            if raised is None:
                fail(f"hnp-validated: seeded bad call ({label}) did not "
                     "raise GraphVerificationError")
            if any(read_counts().values()):
                fail(f"hnp-validated: seeded bad call ({label}) launched "
                     f"{read_counts()}")
            seeded[label] = [v.rule for v in raised.violations]
    if seeded != {"inner-dims-disagree": ["graph/shape-mismatch"],
                  "dead-handle": ["graph/use-after-unstage"]}:
        fail(f"hnp-validated: seeded bad calls named {seeded}")

    plain_s, validated_s = [], []
    for _ in range(3):
        q, w, *_ = both(False)
        plain_s.append(q["run_s"] + w["run_s"])
        q, w, *_ = both(True)
        validated_s.append(q["run_s"] + w["run_s"])
    out = {"values_bit_equal_unvalidated": True,
           "launches": launches, "quickstart_launches": counts[0],
           "wave_launches": counts[1], "wave_routes": routes[1],
           "quickstart_summary": quick["summary"],
           "wave_summary": wave["summary"],
           "seeded_bad_calls": seeded,
           "host_ms": {"validated_median_of_3":
                       statistics.median(validated_s) * 1e3,
                       "plain_median_of_3": statistics.median(plain_s) * 1e3,
                       "validated": [s * 1e3 for s in validated_s],
                       "plain": [s * 1e3 for s in plain_s]},
           "card": _card_name_and_power_limit()}
    emit({"phase": "hnp-validated", **out})
    return launches, routes[1]


def run_stream():
    """Phase 7c: the streaming engine at yi-6b's published config (full
    width in the cost model) on the port's default platform: STREAM_DEVICES
    modeled devices, STREAM_PREFILL_LANES prefill lane, STREAM_SLOTS slots,
    a bursty trace at STREAM_LOAD x ``estimate_capacity`` for
    STREAM_DURATION_S, seed SEED.  ``serve_stream`` twice (equal events and
    ``point_dict()``), ``serve_lockstep`` once; the slot refills and every
    device's ticket stream race-free.  Then qwen3-moe with expert placement
    fed by the decode traffic: its decisions non-empty, its streams
    race-free.  Every figure is modeled but the host seconds."""
    from repro_torch.analysis import format_violations
    from repro_torch.analysis.races import (check_slot_refills,
                                            check_ticket_streams)
    from repro_torch.core.placement import PlacementConfig
    from repro_torch.launch.streaming import (StreamConfig, bursty_trace,
                                              estimate_capacity,
                                              serve_lockstep, serve_stream)

    cfg = StreamConfig(num_devices=STREAM_DEVICES,
                       prefill_lanes=STREAM_PREFILL_LANES,
                       decode_slots=STREAM_SLOTS)
    capacity = estimate_capacity(ARCH, cfg)
    trace = bursty_trace(STREAM_LOAD * capacity, STREAM_DURATION_S,
                         seed=SEED)
    t0 = time.perf_counter()
    cont = serve_stream(ARCH, trace, config=cfg)
    host_s = time.perf_counter() - t0
    again = serve_stream(ARCH, trace, config=cfg)
    if cont.events != again.events or \
            cont.point_dict() != again.point_dict():
        fail("stream: two serve_stream runs of one trace differ")
    t0 = time.perf_counter()
    lock = serve_lockstep(ARCH, trace, config=cfg)
    lock_host_s = time.perf_counter() - t0
    violations = (check_slot_refills(cont.slot_refills)
                  + check_ticket_streams(cont.ticket_log)
                  + check_ticket_streams(lock.ticket_log))
    if violations:
        fail(f"stream: {format_violations(violations)}")

    moe_cfg = StreamConfig(expert_placement=PlacementConfig())
    moe = serve_stream(MOE_ARCH, bursty_trace(STREAM_MOE_QPS,
                                              STREAM_MOE_DURATION_S,
                                              seed=SEED), config=moe_cfg)
    if not moe.placement_decisions:
        fail("stream: qwen3-moe decode traffic made no placement decision")
    violations = (check_ticket_streams(moe.ticket_log)
                  + check_slot_refills(moe.slot_refills))
    if violations:
        fail(f"stream (qwen3-moe): {format_violations(violations)}")

    def tails(rep):
        o = rep.slo.overall
        return {"sustained_qps": rep.sustained_qps,
                "ttft_p99_ms": o.ttft.p99_s * 1e3,
                "per_token_p99_ms": o.per_token.p99_s * 1e3,
                "reject_rate": rep.reject_rate,
                "meets_slo": rep.slo.meets_slo}

    emit({"phase": "stream", "arch": ARCH, "platform": cfg.platform.name,
          "devices": STREAM_DEVICES, "prefill_lanes": STREAM_PREFILL_LANES,
          "decode_slots": STREAM_SLOTS, "seed": SEED,
          "requests": len(trace.requests), "events": len(cont.events),
          "events_equal_across_runs": True,
          "slot_refills": len(cont.slot_refills), "race_violations": 0,
          "host_s": {"serve_stream": host_s, "serve_lockstep": lock_host_s},
          "modeled": {
              "estimated_capacity_qps": capacity,
              "offered_qps": trace.offered_qps,
              "continuous": tails(cont), "lockstep": tails(lock),
              "continuous_over_lockstep":
                  cont.sustained_qps / lock.sustained_qps},
          "moe": {"arch": MOE_ARCH, "offered_qps": STREAM_MOE_QPS,
                  "duration_s": STREAM_MOE_DURATION_S,
                  "placement_decisions": len(moe.placement_decisions),
                  "slot_refills": len(moe.slot_refills),
                  "race_violations": 0,
                  "modeled": tails(moe)}})


def record_tickets(run):
    """Run ``run()`` with a flight recorder that keeps every ticket;
    returns (its result, every device's ticket stream in issue order).
    Fails if the recorder kept fewer tickets than the run issued."""
    import types

    from repro_torch.obs import flight, metrics

    def tickets_issued():
        return sum(v for k, v in metrics.snapshot().items()
                   if k.startswith("stream.tickets{"))

    flight.configure(1 << 22)
    issued = tickets_issued()
    try:
        result = run()
        recorded = flight.capture()["tickets"]
    finally:
        flight.configure(flight.DEFAULT_CAPACITY)
    issued = tickets_issued() - issued
    streams = {int(d): [types.SimpleNamespace(**t) for t in ts]
               for d, ts in recorded.items()}
    n_tickets = sum(len(v) for v in streams.values())
    if n_tickets != issued:
        fail(f"the flight recorder kept {n_tickets} of {issued} tickets")
    return result, streams


def run_serve_cluster(cfg, params, prompts, tokens0, zero_counts,
                      read_counts):
    """Phases 5a, 5b and 5c: ``serve_cluster`` on the serve phase's
    weights, CLUSTER_BATCHES batches (the first the serve phase's prompts)
    over CLUSTER_DEVICES modeled devices, run (a) cost-aware with pinned
    caches (counted; every ticket kept for the race check) and run (b)
    round-robin with caches drained to host (profiled); then run (a) again
    traced (``run_trace_export``); then the races phase over run (a)."""
    import numpy as np
    import torch

    from repro_torch.analysis import format_violations
    from repro_torch.analysis.races import check_cluster, check_ticket_streams
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

    window = {}

    def cluster_run(scheduler, pin, label):
        pol = dict(KERNEL_POLICY, num_devices=CLUSTER_DEVICES,
                   scheduler=scheduler)
        t0 = time.perf_counter()
        with offload_policy(**pol) as eng, offload_trace() as trace:
            res = serve_cluster(cfg.name, batches, pin_caches=pin, **kw)
            # the engine's own in-flight window, read before the scope
            # restores the outer devices
            window[label] = (check_cluster(eng),
                             sum(len(d.inflight) for d in eng.devices))
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
    (res_a, wall_a, trace_a), streams_a = record_tickets(
        lambda: cluster_run("cost-aware", True, "(a)"))
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

    # ---- 5c. races over run (a) -----------------------------------------
    full = check_ticket_streams(streams_a)
    in_window, window_tickets = window["(a)"]
    if full or in_window:
        fail(f"races (serve-cluster): {format_violations(full + in_window)}")
    emit({"phase": "races", "path": "serve-cluster (a)",
          "tickets": sum(len(v) for v in streams_a.values()),
          "tickets_by_device": {d: len(v) for d, v in streams_a.items()},
          "kinds": sorted({t.kind for v in streams_a.values() for t in v}),
          "violations": 0, "inflight_window_tickets": window_tickets,
          "inflight_window_violations": 0})
    return {"launches": launches, "routes": routes}


def run_trace_export(cfg, batches, want, kw):
    """Phase 5b: run (a) of ``run_serve_cluster`` under a ``SpanTracer``
    with a flight recorder that keeps every ticket; the Chrome trace must
    validate and every ticket must have its span (``ticket_spans`` of the
    recorded tickets against the tracer's ticket spans)."""
    import numpy as np

    from repro_torch.core.hero import offload_policy
    from repro_torch.launch.serve import serve_cluster
    from repro_torch.obs import spans, trace_export

    pol = dict(KERNEL_POLICY, num_devices=CLUSTER_DEVICES,
               scheduler="cost-aware")

    def run():
        with offload_policy(**pol), spans.span_trace("serve-cluster") as tr:
            res = serve_cluster(cfg.name, batches, pin_caches=True, **kw)
        return res, tr

    t0 = time.perf_counter()
    (res, tr), streams = record_tickets(run)
    wall = time.perf_counter() - t0
    for i, (r, w) in enumerate(zip(res.results, want, strict=True)):
        if not np.array_equal(r.tokens, w):
            fail(f"trace-export: batch {i} greedy tokens differ")
    n_tickets = sum(len(v) for v in streams.values())
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
    if used != {"skinny", "tf32x3", "wgmma"} or launches["gemm"] == 0 or \
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
    Model.forward(prompts)[:, -1] (one 16-row chunk).  Returns the
    forward's route counts."""
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
    fwd_routes = read_routes()
    ssd_routes = fwd_routes["ssd_chunk_diag"]
    if ssd_routes != {"simt": 0, "mma": cfg.num_layers}:
        fail(f"ssm f32 forward SSD off the mma route: {ssd_routes}")
    require_f32_gemm_routes("ssm f32 forward", fwd_routes)
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
          "gemm_routes": {k: fwd_routes[k] for k in ("gemm", "gemm_batched")},
          "forward_seq": SSM_F32_FWD_SEQ,
          "decode_vs_forward": {
              "err": dvf, "bar": DECODE_VS_FORWARD_TOL,
              "argmax_agreement":
                  (dec.argmax(-1) == full.argmax(-1)).float().mean().item(),
              "batch": BATCH, "prompt_len": PROMPT_LEN}})
    del params32
    torch.cuda.empty_cache()
    return fwd_routes


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


def grouped_counts():
    """Phase 10g's rows an expert, GRANITE_ROWS in all: two experts empty,
    one of 5 rows, one heavy (8812), none of the others a multiple of the
    128-row tile."""
    counts = [2190 + (i * 37) % 173 for i in range(GRANITE_EXPERTS)]
    counts[3] = counts[40] = 0
    counts[71] = 5
    counts[0] += GRANITE_ROWS - sum(counts)
    return counts


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


def run_grouped(moe_cfg, launches):
    """Phase 10g: the ragged grouped GEMM (``kernels/gemm.py::
    gemm_grouped``, the dropless MoE's expert products) at granite-4.0-h's
    expert shapes, 72 experts of 4096 -> 768 and 768 -> 4096, over its
    prefill's GRANITE_ROWS routed rows (:func:`grouped_counts`) against one
    f32 plain product an expert (``gemm_grouped_ref``), within
    TOL["bfloat16"] x max |plain|, two launches bit for bit equal; then a
    dropless MoE layer at granite's widths (``moe_dropless``) on its
    GRANITE_TOKENS on the kernels: three grouped launches, bit for bit on
    a second run, nothing dropped; and within the same bar of the plain
    path under one routing (the plain path's router) shared by both, as
    in phase 10f, since the two routers' products differ in rounding and
    flip near-tied top-k choices (counted as ``routing_flips``).  Records
    the layer's launches as ``launches["grouped"]``."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels.gemm import gemm_grouped
    from repro_torch.kernels.ref import gemm_grouped_ref
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bar = TOL["bfloat16"]
    counts = grouped_counts()
    out = {"bar": bar, "rows": GRANITE_ROWS, "experts": GRANITE_EXPERTS,
           "counts_min_max": [min(counts), max(counts)], "gemm": {}}
    for k, n in ((GRANITE_D, GRANITE_F), (GRANITE_F, GRANITE_D)):
        a, b, offsets = grouped_operands(gen, k, n)
        before = gemm_grouped.route_launches["wgmma"]
        got = gemm_grouped(a, b, offsets)
        again = gemm_grouped(a, b, offsets)
        torch.cuda.synchronize()
        if gemm_grouped.route_launches["wgmma"] != before + 2:
            fail(f"gemm_grouped {k}->{n}: launches "
                 f"{gemm_grouped.route_launches}")
        if not torch.equal(got, again):
            fail(f"gemm_grouped {k}->{n}: two launches differ")
        err, abs_err = _rel_err(got, gemm_grouped_ref(
            a, b, offsets, out_dtype=torch.float32))
        if not err <= bar:
            fail(f"gemm_grouped {k}->{n}: err {err} > {bar}")
        out["gemm"][f"{k}->{n}"] = {"err": err, "max_abs_err": abs_err}
        del a, b, got, again
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(
        moe_cfg.reduced(), d_model=GRANITE_D, num_experts=GRANITE_EXPERTS,
        moe_d_ff=GRANITE_F, experts_per_token=GRANITE_TOP_K,
        moe_dropless=True)
    layer = M.init_moe(gen, cfg, torch.bfloat16, device=dev)
    x = torch.randn(*GRANITE_TOKENS, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    before = gemm_grouped.launches
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        got, _ = M.moe_ffn(layer, x, cfg)
        again, _ = M.moe_ffn(layer, x, cfg)
    torch.cuda.synchronize()
    n_launch = gemm_grouped.launches - before
    step = M.last_moe_step()
    xf = x.reshape(-1, cfg.d_model)
    with offload_policy(**KERNEL_POLICY), torch.no_grad():
        kernel_idx = M._router(layer, xf, cfg)[1]
    with offload_policy(**PLAIN_POLICY), torch.no_grad():
        shared = M._router(layer, xf, cfg)
    flips = int((kernel_idx.sort(-1).values != shared[1].sort(-1).values)
                .any(-1).sum())
    with mock.patch.object(M, "_router", lambda *_: shared), \
            torch.no_grad():
        with offload_policy(**KERNEL_POLICY):
            got_shared, _ = M.moe_ffn(layer, x, cfg)
        with offload_policy(**PLAIN_POLICY):
            want, _ = M.moe_ffn(layer, x, cfg)
    err, _ = _rel_err(got_shared, want)
    if n_launch != 6 or not torch.equal(got, again) \
            or step.tokens_dropped or step.tokens_routed != GRANITE_ROWS \
            or not err <= bar:
        fail(f"dropless MoE layer: launches {n_launch}, repeat equal "
             f"{torch.equal(got, again)}, routed {step.tokens_routed}, "
             f"dropped {step.tokens_dropped}, err {err}")
    launches["grouped"] = {"gemm_grouped": n_launch}
    out["dropless_layer"] = {"d": cfg.d_model, "experts": cfg.num_experts,
                             "f": cfg.moe_d_ff, "top_k": GRANITE_TOP_K,
                             "tokens": list(GRANITE_TOKENS), "err": err,
                             "launches": n_launch, "routing_flips": flips,
                             "tokens_routed": step.tokens_routed,
                             "tokens_dropped": step.tokens_dropped,
                             "expert_rows_min_max": [min(step.counts),
                                                     max(step.counts)]}
    del layer, x, got, again, got_shared, want
    torch.cuda.empty_cache()
    emit({"phase": "grouped", **out})
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

    from repro_torch.analysis import format_violations
    from repro_torch.analysis.races import (check_cluster,
                                            check_expert_migrations)
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
        # the races phase's second part: the policy's migrations and the
        # lanes' in-flight windows, read inside the cluster's scope
        races = (check_expert_migrations(pol.migration_edges)
                 + check_cluster(cluster))
        window_tickets = sum(len(d.inflight) for d in cluster.devices)
    if races:
        fail(f"races (moe-placed): {format_violations(races)}")
    if not pol.migration_edges:
        fail("races (moe-placed): the placement made no migration to check")
    emit({"phase": "races", "path": "moe-placed",
          "migration_edges": len(pol.migration_edges),
          "inflight_window_tickets": window_tickets, "violations": 0})
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
    if out["routes"]["gemm_batched"]["tf32x3"] == 0 or any(
            n for r, n in out["routes"]["gemm_batched"].items()
            if r != "tf32x3"):
        fail(f"f32 expert GEMMs off the tf32x3 route: {out['routes']}")
    if out["routes"]["flash_attention"] != {"simt": 0, "wgmma": 0,
                                           "tf32x3": MOE_F32_LAYERS}:
        fail(f"qwen3-moe f32 attention off the tf32x3 route: "
             f"{out['routes']['flash_attention']}")
    require_f32_gemm_routes("qwen3-moe f32", out["routes"])
    for name in ("decode_first_step", "forward_last_position"):
        if not out[name]["err"] <= F32_LOGIT_TOL:
            fail(f"qwen3-moe f32 {name} logits differ: {out[name]} > "
                 f"{F32_LOGIT_TOL} (routing: {out['decode_routing']}, "
                 f"{out['forward_routing']})")
    emit({"phase": "moe-float32", **out})
    del params32
    torch.cuda.empty_cache()
    return out["routes"]


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


def _zoo_build(cfg):
    """(model, params, facts) for one zoo model: weights drawn on the card
    from a generator seeded with SEED (after the previous model's are
    freed), their count beside ``param_count()`` (which counts no norms,
    biases or Mamba conv / dt / A / D vectors), the data-sheet bytes
    and the measured peak."""
    import torch

    from repro_torch.models import build_model

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    facts = {"init_s": time.perf_counter() - t0,
             "params": sum(t.numel() for t in leaves),
             "param_count": cfg.param_count(),
             "weights_GB": sum(t.numel() * t.element_size()
                               for t in leaves) / 1e9,
             "data_sheet_GB": cfg.param_count()
             * getattr(torch, cfg.dtype).itemsize / 1e9,
             "reduced": zoo_cuts(cfg)}
    return model, params, facts


def _peak_GB():
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def _zoo_tokens(rng, cfg, shape):
    import torch

    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=shape)).to("cuda")


def _zoo_prompts(rng, cfg):
    return [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                          size=PROMPT_LEN)]
            for _ in range(BATCH)]


def _zoo_embeds(cfg, shape, mrope=False):
    """Seeded frame / patch embeddings (B, S, D) in the model's dtype, at
    the scale of the token embeddings (d_model**-0.5); with ``mrope``
    three distinct position streams: temporal, and height / width of a
    32-wide patch grid."""
    import torch

    dev = torch.device("cuda")
    b, s = shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = (torch.randn(b, s, cfg.d_model, generator=gen, device=dev)
         * cfg.d_model ** -0.5).to(getattr(torch, cfg.dtype))
    batch = {"embeds": x}
    if mrope:
        t = torch.arange(s, dtype=torch.int32, device=dev)
        batch["positions"] = torch.stack(
            [t, t // 32, t % 32])[:, None, :].expand(3, b, s).contiguous()
    return batch


def run_zoo(zoo, rng, zero_counts, read_counts, launches, routes):
    """Phases 12a-12h: the rest of the model zoo at published widths (cut
    where the card forces it, ``zoo_cuts``), each model's weights freed
    before the next is built.  Returns {phase: facts} for the kernels
    line."""
    import torch

    phases = {}

    def keep(tag, out, launch_key="launches", route_key="routes"):
        launches[tag] = (out[launch_key]["eager"]
                         if "eager" in out[launch_key] else out[launch_key])
        routes[tag] = (out[route_key]["eager"]
                       if "eager" in out[route_key] else out[route_key])
        if "graph" in out[route_key]:
            routes[tag + "-graph"] = out[route_key]["graph"]
        phases[tag] = out
        emit({"phase": tag, **out, "max_memory_allocated_GB": _peak_GB()})

    def serve(tag, cfg, model, params, facts, graph=False):
        prompts = _zoo_prompts(rng, cfg)
        out = run_serve(cfg, model, params, prompts, "eager", zero_counts,
                        read_counts)
        toks = out.pop("tokens")
        keep(tag, {**out, **facts})
        if graph:
            out_g = run_serve(cfg, model, params, prompts, "graph",
                              zero_counts, read_counts)
            if out_g.pop("tokens") != toks:
                fail(f"{cfg.name} graph-mode serving gave other greedy "
                     "tokens than eager mode")
            out_g["greedy_tokens_equal_eager"] = True
            keep(tag + "-graph", out_g)
        return prompts

    def forward(tag, cfg, model, params, inputs, facts=None):
        keep(tag, {**run_forward(cfg, model, params, inputs, zero_counts,
                                 read_counts,
                                 shared_routing=bool(cfg.num_experts)),
                   **(facts or {})})

    # ---- 12a-12d. jamba: one super-block, 8 experts ----------------------
    cfg = zoo["jamba"]
    model, params, facts = _zoo_build(cfg)
    prompts = serve("jamba-serve", cfg, model, params, facts, graph=True)
    forward("jamba-forward", cfg, model, params,
            _zoo_tokens(rng, cfg, ZOO_FWD))
    del params, model
    routes["jamba-float32"] = run_jamba_f32(zoo["jamba-f32"], prompts, rng)

    # ---- 12e. gemma3-27b whole -------------------------------------------
    cfg = zoo["gemma3"]
    model, params, facts = _zoo_build(cfg)
    prompts = serve("gemma3-serve", cfg, model, params, facts)
    forward("gemma3-forward", cfg, model, params,
            _zoo_tokens(rng, cfg, GEMMA_FWD))
    b, slots, index = GEMMA_LONG
    out = run_long_decode(cfg, model, params, prompts, zero_counts,
                          read_counts, batch=b, cache_len=slots, index=index,
                          phase="gemma3-long-decode", clone=False)
    launches["gemma3-long-decode"] = out["launches"]
    routes["gemma3-long-decode"] = out["routes"]
    phases["gemma3-long-decode"] = out
    del params, model

    # ---- 12f. h2o-danube-1.8b whole --------------------------------------
    cfg = zoo["danube"]
    model, params, facts = _zoo_build(cfg)
    prompts = serve("danube-serve", cfg, model, params, facts)
    forward("danube-forward", cfg, model, params,
            _zoo_tokens(rng, cfg, DANUBE_FWD))
    b, slots, index = DANUBE_LONG
    out = run_long_decode(cfg, model, params, prompts, zero_counts,
                          read_counts, batch=b, cache_len=slots, index=index,
                          phase="danube-long-decode")
    launches["danube-long-decode"] = out["launches"]
    routes["danube-long-decode"] = out["routes"]
    phases["danube-long-decode"] = out
    del params, model

    # ---- 12g. hubert-xlarge whole: a bidirectional encoder ----------------
    cfg = zoo["hubert"]
    model, params, facts = _zoo_build(cfg)
    forward("hubert-forward", cfg, model, params, _zoo_embeds(cfg, ZOO_FWD),
            facts)
    del params, model

    # ---- 12h. qwen2-72b and qwen2-vl-72b at 8 of 80 layers ----------------
    cfg = zoo["qwen2"]
    model, params, facts = _zoo_build(cfg)
    serve("qwen2-serve", cfg, model, params, facts)
    del params, model
    cfg = zoo["qwen2-vl"]
    model, params, facts = _zoo_build(cfg)
    forward("qwen2-vl-forward", cfg, model, params,
            _zoo_embeds(cfg, ZOO_FWD, mrope=True), facts)
    del params, model
    torch.cuda.empty_cache()
    return phases


def run_jamba_f32(cfg32, prompts, rng):
    """Phase 12d: the jamba super-block with f32 weights and
    JAMBA_F32_EXPERTS experts (top-2 of 2: no routing decision can
    differ): first decode step and last-position logits of a 1 x
    JAMBA_F32_FWD_SEQ forward, kernels against plain, under F32_LOGIT_TOL
    x max |logit|; every SSD launch on ``mma``, attention on ``tf32x3``,
    decode on ``simt``, GEMMs on ``skinny`` / ``tf32x3``.  Returns the
    routes."""
    import torch

    from repro_torch.core import blas
    from repro_torch.core.hero import offload_policy

    dev = torch.device("cuda")
    model32, params32, facts = _zoo_build(cfg32)
    first = torch.tensor([[p[0]] for p in prompts], device=dev)
    toks = _zoo_tokens(rng, cfg32, (1, JAMBA_F32_FWD_SEQ))

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
    out = {"bar": F32_LOGIT_TOL, "forward_batch": 1,
           "forward_seq": JAMBA_F32_FWD_SEQ,
           "decode_first_step": _logit_errs(first_logits,
                                            (BATCH, cfg32.vocab_size)),
           "forward_last_position": _logit_errs(
               last_logits, (1, cfg32.vocab_size)),
           "routes": read_routes(), **facts,
           "max_memory_allocated_GB": _peak_GB()}
    r = out["routes"]
    n_mamba = sum(cfg32.layer_kind(i) == "mamba"
                  for i in range(cfg32.num_layers))
    n_attn = cfg32.num_layers - n_mamba
    # The kernel path runs once per logits: decode then forward.
    if r["ssd_chunk_diag"] != {"simt": 0, "mma": n_mamba}:
        fail(f"jamba f32 SSD off the mma route: {r['ssd_chunk_diag']}")
    if r["flash_attention"] != {"simt": 0, "wgmma": 0, "tf32x3": n_attn} or \
            r["flash_decode"] != {"simt": n_attn, "mma": 0}:
        fail(f"jamba f32 attention off the tf32x3 / simt routes: {r}")
    if any(n for rt, n in r["gemm_batched"].items() if rt != "tf32x3"):
        fail(f"jamba f32 expert GEMMs off the tf32x3 route: {r}")
    require_f32_gemm_routes("jamba f32", r)
    for name in ("decode_first_step", "forward_last_position"):
        if not out[name]["err"] <= F32_LOGIT_TOL:
            fail(f"jamba f32 {name} logits differ: {out[name]} > "
                 f"{F32_LOGIT_TOL}")
    emit({"phase": "jamba-float32", **out})
    del params32
    torch.cuda.empty_cache()
    return r


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


# ---------------------------------------------------------------------------
# 13. training: yi-6b at published widths, 8 of 32 layers
# ---------------------------------------------------------------------------

def train_config():
    """yi-6b at its published widths cut to TRAIN_LAYERS layers, bf16, its
    own 2 microbatches."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(ARCH), num_layers=TRAIN_LAYERS)


def train_gemm_shapes(cfg):
    """(name, m, k, n, launches per microbatch forward) of every GEMM of
    the train step's forward: one microbatch is 1 x TRAIN_SEQ tokens."""
    m = TRAIN_BATCH * TRAIN_SEQ // cfg.num_microbatches
    return [(name, m, k, n, count)
            for name, _, k, n, count in serve_gemm_shapes(cfg)]


def check_gemm_backward(cfg, randn, zero_counts, read_counts, max_abs):
    """13b: the GEMM Function's backward (dA = dC·Bᵀ, dB = Aᵀ·dC, two
    launches of the GEMM kernel) against autograd of ``gemm_ref`` at every
    forward GEMM shape of the step, bf16 (2e-2, ``wgmma``) and f32 (2e-5,
    ``tf32x3``); no backward launch on ``tiled``; one backward repeated
    bit for bit."""
    import torch

    from repro_torch.kernels import autograd as kgrad
    from repro_torch.kernels.ref import gemm_ref

    want_route = {"bfloat16": "wgmma", "float32": "tf32x3"}
    rows = []
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, m, k, n, _ in train_gemm_shapes(cfg):
            a = randn(m, k, dtype=dtype)
            b = (randn(k, n) * k ** -0.5).to(dtype)
            dc = randn(m, n, dtype=dtype)

            def kernel_grads():
                ak = a.clone().requires_grad_(True)
                bk = b.clone().requires_grad_(True)
                y = kgrad.lowering("gemm")(ak, bk)
                torch.cuda.synchronize()
                zero_counts()
                y.backward(dc)
                torch.cuda.synchronize()
                return ak.grad, bk.grad, read_counts(), read_routes()

            da, db, counts, routes = kernel_grads()
            ap = a.clone().requires_grad_(True)
            bp = b.clone().requires_grad_(True)
            gemm_ref(ap, bp).backward(dc)
            err_a, _ = _rel_err(da, ap.grad)
            err_b, _ = _rel_err(db, bp.grad)
            bar = TOL[dtype_name]
            route = want_route[dtype_name]
            if counts["gemm"] != 2 or routes["gemm"][route] != 2:
                fail(f"train GEMM backward {name} {dtype_name}: launches "
                     f"{counts}, routes {routes['gemm']}; want 2 on {route}")
            if not (err_a <= bar and err_b <= bar):
                fail(f"train GEMM backward {name} {dtype_name}: dA {err_a}, "
                     f"dB {err_b} > {bar}")
            row = {"shape": name, "dtype": dtype_name, "m": m, "k": k,
                   "n": n, "routes": routes["gemm"], "err_dA": err_a,
                   "err_dB": err_b}
            if name == "qkv_project":
                da2, db2, _, _ = kernel_grads()
                if not (torch.equal(da, da2) and torch.equal(db, db2)):
                    fail(f"train GEMM backward {name} {dtype_name} not "
                         f"repeated bit for bit")
                row["repeat_bitwise"] = True
            rows.append(row)
            key = "gemm:train" if dtype_name == "bfloat16" else \
                "gemm:train-f32"
            max_abs[key] = max(max_abs.get(key, 0.0), err_a, err_b)
            del a, b, dc, da, db, ap, bp
    torch.cuda.empty_cache()
    return rows


def check_attention_backward(cfg, randn, zero_counts, read_counts, max_abs):
    """13c: the attention Function at the step's shape (1 x TRAIN_SEQ, the
    config's heads, causal, bf16): its forward (the kernel, ``wgmma``)
    against ``attention_ref`` row by row, its gradients (the plain
    recompute) against autograd of ``attention_ref``."""
    import torch

    from repro_torch.kernels import autograd as kgrad
    from repro_torch.kernels.ref import attention_ref

    b = TRAIN_BATCH // cfg.num_microbatches
    shape = (b, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
             cfg.head_dim)
    q, k, v = attn_operands(randn, *shape, torch.bfloat16, view=True)
    do = randn(b, cfg.num_heads, TRAIN_SEQ, cfg.head_dim,
               dtype=torch.bfloat16)
    ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    zero_counts()
    out = kgrad.lowering("attention")(*ins, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    counts, routes = read_counts(), read_routes()
    ref_ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = attention_ref(*ref_ins, causal=True)
    ref_out.backward(do)
    fwd_err, _ = _row_rel_err(out.detach(), ref_out.detach())
    grad_errs = [_rel_err(g.grad, r.grad)[0] for g, r in zip(ins, ref_ins)]
    if counts["flash_attention"] != 1 or routes["flash_attention"]["wgmma"] != 1:
        fail(f"train attention: launches {counts}, routes "
             f"{routes['flash_attention']}; want 1 on wgmma")
    if not (fwd_err <= TOL["bfloat16"]
            and max(grad_errs) <= TOL["bfloat16"]):
        fail(f"train attention: forward {fwd_err}, gradients {grad_errs} "
             f"> {TOL['bfloat16']}")
    max_abs["flash_attention:train"] = max(fwd_err, *grad_errs)
    return {"shape": shape, "forward_row_err": fwd_err,
            "grad_errs_dq_dk_dv": grad_errs, "routes": routes["flash_attention"]}


def _train_batch(cfg, step, dev):
    import torch

    from repro_torch.data import SyntheticLM

    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=17)
    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}


def _grad_leaf_errs(gk, gp, cfg):
    """The checked gradient leaves, kernel path against plain, x max
    |plain|: layer 0's wq, the last layer's w_down, the head and the
    embedding."""
    picks = {"stack/0/mixer/wq": lambda g: g["stack"][0]["mixer"]["wq"],
             f"stack/{cfg.num_layers - 1}/ffn/w_down":
                 lambda g: g["stack"][-1]["ffn"]["w_down"],
             "head": lambda g: g["head"], "embed": lambda g: g["embed"]}
    return {name: _rel_err(pick(gk), pick(gp))[0]
            for name, pick in picks.items()}


def run_train(randn, zero_counts, read_counts, launches, routes, max_abs):
    """Phase 13: training.  (b) GEMM backwards, (c) attention's Function,
    (a) one loss-and-gradients call, kernels against the plain path, and
    the step's launches split forward / backward, then one step profiled
    (with the forward and the optimizer profiled apart to split it), (d)
    TRAIN_STEPS steps through ``repro_torch.launch.train.train``, (e) the
    restart loop at the reduced config.  Records the train run's launches
    and routes in ``launches`` / ``routes`` under "train"."""
    import tempfile

    import torch

    from repro_torch import tree
    from repro_torch.core.hero import offload_policy
    from repro_torch.launch import steps
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, warmup_cosine

    dev = torch.device("cuda")
    cfg = train_config()
    nmb = cfg.num_microbatches
    t_phase = time.perf_counter()
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "of_layers": TRAIN_PUBLISHED_LAYERS, "dtype": cfg.dtype,
           "microbatches": nmb, "global_batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ}

    out["gemm_backward"] = check_gemm_backward(cfg, randn, zero_counts,
                                               read_counts, max_abs)
    out["attention"] = check_attention_backward(cfg, randn, zero_counts,
                                                read_counts, max_abs)

    # (a) one loss-and-gradients call, kernels against plain.
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    out["params"] = n_params
    out["train_state_GB_reckoned"] = {
        "bf16 params": 2 * n_params / 1e9, "bf16 grads": 2 * n_params / 1e9,
        "fp32 mu, nu": 8 * n_params / 1e9,
        "fp32 accumulator": 4 * n_params / 1e9,
        "total": 16 * n_params / 1e9}
    batch = _train_batch(cfg, 0, dev)
    mb = {k: v[0] for k, v in steps._split_microbatches(batch, nmb).items()}
    with offload_policy(**KERNEL_POLICY):
        steps._loss_and_grads(model, params, batch)      # warm up
        torch.cuda.synchronize()
        zero_counts()
        loss_k, grads_k = steps._loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        step_counts, step_routes = read_counts(), read_routes()
        zero_counts()
        with torch.enable_grad():
            req = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
            model.loss(req, mb)
            del req
        torch.cuda.synchronize()
        fwd_counts, fwd_routes = read_counts(), read_routes()
    with offload_policy(**PLAIN_POLICY):
        loss_p, grads_p = steps._loss_and_grads(model, params, batch)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_errs = _grad_leaf_errs(grads_k, grads_p, cfg)
    del grads_p
    bwd_counts = {k: step_counts[k] - nmb * fwd_counts[k]
                  for k in step_counts}
    bwd_routes = {fn: {r: step_routes[fn][r] - nmb * fwd_routes[fn][r]
                       for r in step_routes[fn]} for fn in step_routes}
    out["loss_and_grads"] = {
        "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
        "loss_rel_err": loss_err, "loss_bar": TRAIN_LOSS_TOL,
        "grad_errs": grad_errs, "grad_bar": TOL["bfloat16"],
        "launches_step": step_counts,
        "launches_forward_per_microbatch": fwd_counts,
        "launches_backward_step": bwd_counts,
        "routes_forward_per_microbatch": fwd_routes,
        "routes_backward_step": bwd_routes}
    if not loss_err <= TRAIN_LOSS_TOL:
        fail(f"train loss, kernels {float(loss_k)} against plain "
             f"{float(loss_p)}: {loss_err} > {TRAIN_LOSS_TOL}")
    if not max(grad_errs.values()) <= TOL["bfloat16"]:
        fail(f"train gradients, kernels against plain: {grad_errs} > "
             f"{TOL['bfloat16']}")
    require_route("train forward", fwd_routes, "wgmma", attn="wgmma")
    if bwd_routes["gemm"]["tiled"] or \
            bwd_counts["gemm"] != 2 * nmb * fwd_counts["gemm"] or \
            bwd_counts["flash_attention"]:
        fail(f"train backward launches {bwd_counts}, routes {bwd_routes}: "
             f"want two wgmma GEMMs per forward GEMM and no attention kernel")
    max_abs["gemm:train-step"] = max(grad_errs.values())

    # One step profiled, its forward (both microbatches, under grad) and
    # its optimizer profiled apart: the split of the step's busy time.
    opts = steps.TrainOptions(peak_lr=TRAIN_LR, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
    opt_state, _ = steps.init_train_state(model, params, opts)
    step_fn = steps.make_train_step(model, opts)
    _, opt_update = make_optimizer(cfg, warmup_cosine(TRAIN_LR, 1,
                                                      TRAIN_STEPS))
    mbs = steps._split_microbatches(batch, nmb)

    def one_step():
        with offload_policy(**KERNEL_POLICY):
            step_fn(params, opt_state, None, batch)

    def forward_only():
        with offload_policy(**KERNEL_POLICY), torch.enable_grad():
            req = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
            for j in range(nmb):
                model.loss(req, {k: v[j] for k, v in mbs.items()})

    def optimizer_only():
        with torch.no_grad():
            opt_update(grads_k, opt_state, params)

    one_step()                                      # warm up
    prof_step = _profile(one_step)
    prof_fwd = _profile(forward_only)
    prof_opt = _profile(optimizer_only)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    optimizer_only()
    torch.cuda.synchronize()
    opt_wall_s = time.perf_counter() - t0
    split = "not measured"
    if "device_busy_ms" in prof_step and "device_busy_ms" in prof_fwd \
            and "device_busy_ms" in prof_opt:
        by, fby = prof_step["device_ms_by_kernel"], \
            prof_fwd["device_ms_by_kernel"]
        split = {"gemm_forward_ms": fby["gemm"],
                 "gemm_backward_ms": by["gemm"] - fby["gemm"],
                 "flash_attention_ms": by["flash_attention"],
                 "optimizer_ms": prof_opt["device_busy_ms"],
                 "torch_kernels_ms": by["other"] - prof_opt["device_busy_ms"],
                 "busy_ms": prof_step["device_busy_ms"],
                 "wall_ms": prof_step["wall_ms"],
                 "idle_share": prof_step["device_idle_share"]}
    out["profile"] = {"step": prof_step, "forward": prof_fwd,
                      "optimizer": prof_opt, "split": split,
                      "optimizer_wall_s": opt_wall_s}
    del grads_k, opt_state, step_fn, params, batch, mb, mbs
    out["max_memory_allocated_GB_check"] = _peak_GB()
    torch.cuda.empty_cache()

    # (d) TRAIN_STEPS steps through the train entry point.
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    zero_counts()
    t0 = time.perf_counter()
    got = train(ARCH, smoke=False, num_layers=TRAIN_LAYERS,
                steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, peak_lr=TRAIN_LR, ckpt_dir=None,
                log_every=1, device="cuda",
                on_step=lambda s, loss, sec: (step_s.append(sec),
                                              losses.append(loss)))
    train_s = time.perf_counter() - t0
    counts, train_routes = read_counts(), read_routes()
    peak = _peak_GB()
    if got != losses or len(got) != TRAIN_STEPS or \
            not all(math.isfinite(x) for x in got) or not got[-1] < got[0]:
        fail(f"train: losses {got} not {TRAIN_STEPS} finite values ending "
             f"below the first")
    fwd_total = {k: TRAIN_STEPS * nmb * fwd_counts[k] for k in counts}
    want_gemm = TRAIN_STEPS * (nmb * fwd_counts["gemm"]
                               + bwd_counts["gemm"])
    if counts["gemm"] != want_gemm or train_routes["gemm"]["tiled"] or \
            counts["flash_attention"] != fwd_total["flash_attention"]:
        fail(f"train: launches {counts} (routes {train_routes}), want "
             f"{want_gemm} GEMMs, none tiled, "
             f"{fwd_total['flash_attention']} attention")
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    out["train"] = {
        "losses": got, "step_s": step_s, "median_step_s_2_to_8": median_s,
        "train_s": train_s, "launches": counts, "routes": train_routes,
        "launches_forward": fwd_total,
        "launches_backward": {k: counts[k] - fwd_total[k] for k in counts},
        "optimizer_share_of_step": opt_wall_s / median_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_s,
        "max_memory_allocated_GB": peak}
    launches["train"], routes["train"] = counts, train_routes
    torch.cuda.empty_cache()

    # (e) the restart loop at the reduced config, one injected failure.
    with tempfile.TemporaryDirectory() as root:
        clean, r0 = run_recovery(pathlib.Path(root) / "clean", None)
        faulty, r1 = run_recovery(pathlib.Path(root) / "fail", 6)
    if r0 != 0 or r1 != 1 or faulty[-6:] != clean[-6:] or \
            faulty[:6] != clean[:6] or len(faulty) != len(clean) + 2:
        fail(f"train restart: clean {clean} ({r0} restarts), with a failure "
             f"{faulty} ({r1})")
    out["restart"] = {"losses_clean": clean, "losses_with_failure": faulty,
                      "restarts": r1, "bitwise_equal": True}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "train", **out})


def run_recovery(root, inject_failure_at, num_steps=12):
    """``run_with_recovery`` around the train step and a ``Checkpointer``
    at yi-6b's reduced config on the card, with the kernels (the harness
    of ``tests/test_fault_tolerance.py``); returns (losses, restarts)."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_arch
    from repro_torch.core.hero import offload_policy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.runtime import WorkerFailure, run_with_recovery

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), num_microbatches=1)
    model = build_model(cfg)
    opts = steps.TrainOptions(peak_lr=1e-3, warmup_steps=1, total_steps=100)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    opt_state, _ = steps.init_train_state(model, params, opts)
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=5)
    step_fn_ = steps.make_train_step(model, opts)
    ck = Checkpointer(root, keep=3)
    state = {"params": params, "opt": opt_state, "failed": False}

    def step_fn(step):
        if step == inject_failure_at and not state["failed"]:
            state["failed"] = True
            raise WorkerFailure(f"injected failure at step {step}")
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        with offload_policy(**KERNEL_POLICY):
            p, o, _, m = step_fn_(state["params"], state["opt"], None, batch)
        state["params"], state["opt"] = p, o
        return float(m["loss"]), 0.0

    def save_fn(step):
        ck.save(step, (state["params"], state["opt"]))

    def restore_fn():
        (state["params"], state["opt"]), step = ck.restore(
            (state["params"], state["opt"]))
        return step

    save_fn(0)
    _, log, restarts = run_with_recovery(
        num_steps=num_steps, start_step=0, step_fn=step_fn, save_fn=save_fn,
        restore_fn=restore_fn, checkpoint_every=4)
    return [m for _, m in log], restarts


def _shard_map_host_ms(mesh, calls=50):
    """Host ms of one ``shard_map`` call on ``mesh`` whose body is one psum
    of 16 floats (the rendezvous of every mesh device's thread, the split
    and the assembly), median of ``calls`` after a warm-up."""
    import torch

    from repro_torch.sharding.spmd import P, psum, shard_map

    fn = shard_map(lambda a: psum(a, "model"), mesh=mesh, in_specs=(P(),),
                   out_specs=P())
    a = torch.zeros(16, device=mesh.device)
    for _ in range(5):
        fn(a)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn(a)
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return sorted(times)[calls // 2]


def _on_mesh(mesh, fn):
    """``fn()`` once with the mesh's books reset: (result, {host wall s,
    collective calls and operand bytes summed over devices, shard_map
    calls})."""
    import torch

    mesh.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, {"wall_s": time.perf_counter() - t0,
                 "collectives": mesh.collective_totals(),
                 "shard_map_calls": mesh.shard_map_calls}


def _median_s(fn, runs=3):
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[runs // 2]


def _kernel_ms(prof):
    """The profiled run's device ms by kernel family, or "not measured"."""
    return prof.get("device_ms_by_kernel", "not measured")


# Cycles of the spin kernel queued before each timed collective: longer
# than the host takes to queue one collective's torch ops.
COLLECTIVE_SPIN = 2_000_000
RING_TIMED_CALLS = 4


def _collective_device_ms(fn):
    """Device ms of the emulated collectives' copies and adds in one run
    of ``fn``: each collective's torch ops (one group's) queue behind a
    spin kernel and between two CUDA events, so the events time the
    device's work on them and not the host's gaps between them.  The
    collectives' math functions are wrapped for the run only."""
    import torch

    from repro_torch.sharding import spmd

    saved = dict(spmd._COLLECTIVES)
    pairs = []

    def timed(math):
        def run(vals, *extra):
            torch.cuda._sleep(COLLECTIVE_SPIN)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = math(vals, *extra)
            b.record()
            pairs.append((a, b))
            return out
        return run

    spmd._COLLECTIVES.update({k: timed(f) for k, f in saved.items()})
    try:
        fn()
    finally:
        spmd._COLLECTIVES.update(saved)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def run_distributed(zero_counts, read_counts, launches, routes, max_abs):
    """Phase 14: the distributed layer on an emulated (data 2, model 4)
    mesh of 8 devices on the one card (a 1-D model-4 mesh for the ring
    and GPipe).  (a) yi-6b's TP forward, (b) its TP gradients, (c)
    qwen3-moe's expert-parallel layer 0, (d) mamba2-370m's head-sharded
    forward, (e) the ring collective matmul, (f) GPipe, (g)
    ``compressed_psum`` on (b)'s gradients.  Each against the same work
    with no mesh; launches and routes recorded under "distributed-*"."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.core.hero import offload_policy
    from repro_torch.kernels.autograd import lowering
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import compressed_psum
    from repro_torch.launch.pipeline import pipeline_apply
    from repro_torch.sharding.collective_matmul import ring_ag_matmul
    from repro_torch.sharding.spmd import Mesh, P, shard_map

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    mesh = Mesh(DIST_MESH, ("data", "model"), device=dev)
    mesh4 = Mesh((DIST_MESH[1],), ("model",), device=dev)
    label = (f"emulated mesh: data {DIST_MESH[0]} x model {DIST_MESH[1]} = "
             f"{mesh.size} devices on one card")
    label4 = f"emulated mesh: model {DIST_MESH[1]} devices on one card"
    host_ms = _shard_map_host_ms(mesh)
    emit({"phase": "distributed", "mesh": label,
          "shard_map_host_ms": host_ms,
          "shard_map_host_ms_what": "one call whose body is a psum of 16 "
          "floats, median of 50"})

    def sub(name, run):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        res["seconds"] = time.perf_counter() - t0
        res["max_memory_allocated_GB"] = _peak_GB()
        res.setdefault("mesh", label)
        emit({"phase": f"distributed-{name}", **res})
        torch.cuda.empty_cache()
        return res

    def counted(fn):
        torch.cuda.synchronize()
        zero_counts()
        res = fn()
        torch.cuda.synchronize()
        return res, read_counts(), read_routes()

    def tokens_of(cfg, b, s):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             size=(b, s))).to(dev)

    def forward_pair(model, params, tokens, use_kernels=True):
        pol = KERNEL_POLICY if use_kernels else PLAIN_POLICY

        def fwd(m=None, k_parts=1):
            with offload_policy(**pol), torch.no_grad(), \
                    blas.host_k_split(k_parts), \
                    (m if m is not None else contextlib.nullcontext()):
                return model.forward(params, tokens)[0]
        return fwd

    # ---- (a) yi-6b TP forward, 32 layers bf16 -----------------------------
    def tp_forward():
        cfg = get_arch(ARCH)
        model = build_model(cfg)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
        tokens = tokens_of(cfg, FWD_BATCH, FWD_SEQ)
        fwd = forward_pair(model, params, tokens)
        fwd(), fwd(mesh)                                   # warm up
        torch.cuda.reset_peak_memory_stats()
        plain, c_plain, r_plain = counted(fwd)
        peak_plain = _peak_GB()
        torch.cuda.reset_peak_memory_stats()
        with offload_trace() as trace:
            (tp, books), counts, rts = counted(
                lambda: _on_mesh(mesh, lambda: fwd(mesh)))
        peak_mesh = _peak_GB()
        L = cfg.num_layers
        planned = sum(r.note == "tp-plan" for r in trace.records)
        want = {**dict.fromkeys(counts, 0), "gemm": 40 * L + 1,
                "flash_attention": L}
        if counts != want or planned != 3 * L:
            fail(f"distributed (a): launches {counts} (want {want}), "
                 f"{planned} tp-plan records (want {3 * L})")
        require_route("distributed (a) bf16", rts, "wgmma")
        # Phase 4's bar: the plain path's own floor (fp32 sums in halves).
        pf = forward_pair(model, params, tokens, use_kernels=False)
        lp = pf()[:, -1].float()
        floor, _ = _rel_err(pf(k_parts=2)[:, -1], lp)
        bar = max(LOGIT_TOL, 2 * floor)
        err, abs_err = _rel_err(tp[:, -1], plain[:, -1])
        err_all, _ = _rel_err(tp, plain)
        if not (torch.isfinite(tp).all() and err <= bar):
            fail(f"distributed (a): TP logits against no mesh {err} > {bar}")
        del lp, tp, plain
        prof_mesh = _profile(lambda: fwd(mesh))
        prof_plain = _profile(fwd)
        out = {"arch": cfg.name, "layers": L, "dtype": cfg.dtype,
               "batch": FWD_BATCH, "seq": FWD_SEQ,
               "launches": counts, "routes": rts,
               "launches_no_mesh": c_plain, "routes_no_mesh": r_plain,
               "tp_plan_records": planned,
               "last_logits_err": err, "last_logits_max_abs_err": abs_err,
               "all_logits_err": err_all, "bar": bar, "plain_floor": floor,
               "wall_s_mesh": _median_s(lambda: fwd(mesh)),
               "wall_s_no_mesh": _median_s(fwd),
               "device_ms_by_kernel_mesh": _kernel_ms(prof_mesh),
               "device_ms_by_kernel_no_mesh": _kernel_ms(prof_plain),
               "collective_device_ms": _collective_device_ms(
                   lambda: fwd(mesh)),
               "profile_mesh": prof_mesh, "profile_no_mesh": prof_plain,
               "peak_GB_mesh": peak_mesh, "peak_GB_no_mesh": peak_plain,
               "weights_GB": sum(t.numel() * t.element_size()
                                 for t in tree.leaves(params)) / 1e9,
               **books}
        launches["distributed-tp"], routes["distributed-tp"] = counts, rts
        max_abs["gemm:distributed"] = err
        del params
        torch.cuda.empty_cache()
        # f32 at DIST_F32_LAYERS layers, DIST_F32_FWD tokens.
        cfg32 = dataclasses.replace(cfg, num_layers=DIST_F32_LAYERS,
                                    dtype="float32")
        m32 = build_model(cfg32)
        p32 = m32.init_params(
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
        f32 = forward_pair(m32, p32, tokens_of(cfg32, *DIST_F32_FWD))
        ref32 = f32()
        got32, c32, r32 = counted(lambda: f32(mesh))
        L32 = cfg32.num_layers
        if c32 != {**dict.fromkeys(c32, 0), "gemm": 40 * L32 + 1,
                   "flash_attention": L32}:
            fail(f"distributed (a) f32: launches {c32}")
        require_route("distributed (a) f32", r32, "tf32x3")
        err32, _ = _rel_err(got32, ref32)
        if not err32 <= TOL["float32"]:
            fail(f"distributed (a) f32: logits {err32} > {TOL["float32"]}")
        out["float32"] = {"layers": L32, "batch": DIST_F32_FWD[0],
                          "seq": DIST_F32_FWD[1], "launches": c32,
                          "routes": r32, "logits_err": err32,
                          "bar": TOL["float32"]}
        routes["distributed-tp-f32"] = r32
        return out

    # ---- (b) yi-6b TP gradients, 8 layers, one 2 x 512 microbatch --------
    grads_b = {}

    def tp_grads():
        cfg = dataclasses.replace(get_arch(ARCH), num_layers=TRAIN_LAYERS,
                                  num_microbatches=1)
        model = build_model(cfg)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
        batch = _train_batch(cfg, 0, dev)

        def loss_and_grads(m=None, pol=KERNEL_POLICY, k_parts=1):
            req = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
            with offload_policy(**pol), torch.enable_grad(), \
                    blas.host_k_split(k_parts), \
                    (m if m is not None else contextlib.nullcontext()):
                loss = model.loss(req, batch)
                gs = torch.autograd.grad(loss, tree.leaves(req))
            return float(loss.detach()), tree.unflatten(params, gs)

        def leaf_errs(ga, gb):
            return {path: _rel_err(a, b)[0] for (path, a), b in
                    zip(tree.leaves_with_paths(ga), tree.leaves(gb))}

        # Each leaf's bar is phase 4's rule: the larger of 2e-2 and twice
        # the plain path's own floor (its fp32 sums in two halves).
        _, g_q = loss_and_grads(pol=PLAIN_POLICY, k_parts=2)
        _, g_r = loss_and_grads(pol=PLAIN_POLICY)
        floors = leaf_errs(g_q, g_r)
        del g_q, g_r
        loss_and_grads(mesh)                              # warm up
        (loss_p, g_p), c_p, r_p = counted(loss_and_grads)
        ((loss_m, g_m), books), c_m, r_m = counted(
            lambda: _on_mesh(mesh, lambda: loss_and_grads(mesh)))
        errs = leaf_errs(g_m, g_p)
        bars = {k: max(TOL["bfloat16"], 2 * floors[k]) for k in errs}
        worst = max(errs, key=lambda k: errs[k] / bars[k])
        loss_err = abs(loss_m - loss_p) / abs(loss_p)
        if not (errs[worst] <= bars[worst]
                and loss_err <= TRAIN_LOSS_TOL):
            fail(f"distributed (b): loss {loss_m} against {loss_p}, "
                 f"gradient leaf {worst} {errs[worst]} > {bars[worst]}")
        if r_m["gemm"]["tiled"] or c_m["gemm"] != 3 * (40 * TRAIN_LAYERS + 1):
            fail(f"distributed (b): launches {c_m}, routes {r_m}: want "
                 f"every forward GEMM and two backward ones each, none tiled")
        grads_b["mesh"], grads_b["no_mesh"] = g_m, g_p
        launches["distributed-grad"], routes["distributed-grad"] = c_m, r_m
        max_abs["gemm:distributed-grad"] = errs[worst]
        prof_mesh = _profile(lambda: loss_and_grads(mesh))
        prof_plain = _profile(loss_and_grads)
        return {"arch": cfg.name, "layers": TRAIN_LAYERS,
                "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "loss_mesh": loss_m, "loss_no_mesh": loss_p,
                "loss_rel_err": loss_err, "grad_worst_leaf": worst,
                "grad_worst_err": errs[worst], "grad_bar": bars[worst],
                "grad_leaves_above_2e-2": {k: {"err": v, "floor": floors[k]}
                                           for k, v in errs.items()
                                           if v > TOL["bfloat16"]},
                "grad_errs_checked_in_phase_13": {
                    k: errs[k] for k in ("stack/0/mixer/wq",
                                         f"stack/{TRAIN_LAYERS - 1}/ffn/w_down",
                                         "head", "embed")},
                "leaves": len(errs), "launches": c_m, "routes": r_m,
                "launches_no_mesh": c_p, "routes_no_mesh": r_p,
                "wall_s_mesh": _median_s(lambda: loss_and_grads(mesh)),
                "wall_s_no_mesh": _median_s(loss_and_grads),
                "device_ms_by_kernel_mesh": _kernel_ms(prof_mesh),
                "device_ms_by_kernel_no_mesh": _kernel_ms(prof_plain),
                "device_busy_ms_mesh": prof_mesh.get("device_busy_ms"),
                "device_busy_ms_no_mesh": prof_plain.get("device_busy_ms"),
                "collective_device_ms": _collective_device_ms(
                    lambda: loss_and_grads(mesh)),
                **books}

    # ---- (g) compressed_psum over the data axis on (b)'s gradients -------
    def int8_psum():
        mesh2 = Mesh((DIST_MESH[0],), ("data",), device=dev)
        fn = shard_map(lambda g, e: compressed_psum(g, e, "data"),
                       mesh=mesh2, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")))
        pairs = list(zip(tree.leaves(grads_b["mesh"]),
                         tree.leaves(grads_b["no_mesh"])))

        def replicas(gm, gp):
            g = torch.stack([gm, gp])                     # one a replica
            return g, torch.zeros(g.shape, dtype=torch.float32, device=dev)

        def all_leaves():
            for gm, gp in pairs:
                g, e = replicas(gm, gp)
                fn(g.flatten(0, 1), e.flatten(0, 1))

        all_leaves()                                       # warm up
        (_, books) = _on_mesh(mesh2, all_leaves)
        prof = _profile(all_leaves)
        coll_ms = _collective_device_ms(all_leaves)
        n, equal = 0, True
        for gm, gp in pairs:
            g, e = replicas(gm, gp)
            deq, err = fn(g.flatten(0, 1), e.flatten(0, 1))
            # The formula, evaluated with plain torch ops.
            gf = g.float() + e
            scale = torch.amax(torch.abs(gf).flatten(1), dim=1) / 127.0
            scale = torch.maximum(scale[0], scale[1])
            safe = torch.where(scale == 0, torch.ones_like(scale), scale)
            q = torch.clamp(torch.round(gf / safe), -127, 127).to(torch.int8)
            tot = q[0].to(torch.int32) + q[1].to(torch.int32)
            want = (tot.float() * safe).to(g.dtype)
            want_err = gf - q.float() * safe
            equal &= (torch.equal(deq.view(g.shape)[0], want)
                      and torch.equal(deq.view(g.shape)[1], want)
                      and torch.equal(err.view(g.shape), want_err))
            n += 1
            del g, e, deq, err, gf, q, tot, want, want_err
        grads_b.clear()
        del pairs
        mesh2.close()
        if not equal:
            fail("distributed (g): compressed_psum differs from its formula")
        return {"mesh": f"emulated mesh: data {DIST_MESH[0]} devices on one "
                        f"card", "leaves": n, "bitwise_equal": True,
                "replicas": "(b)'s mesh and no-mesh gradients",
                "device_ms_by_kernel": _kernel_ms(prof),
                "device_busy_ms": prof.get("device_busy_ms"),
                "collective_device_ms": coll_ms, **books}

    # ---- (c) qwen3-moe-30b-a3b layer 0, expert-parallel -------------------
    def ep_layer():
        cfg = dataclasses.replace(get_arch(MOE_ARCH),
                                  capacity_factor=EP_CAPACITY,
                                  moe_dispatch="auto")
        grouped = dataclasses.replace(cfg, moe_dispatch="grouped")
        out = {"arch": cfg.name, "layer": 0, "tokens": FWD_BATCH * FWD_SEQ,
               "capacity_factor": EP_CAPACITY}
        for dtype_name, bar in (("bfloat16", TOL["bfloat16"]),
                                ("float32", TOL["float32"])):
            dtype = getattr(torch, dtype_name)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            p = M.init_moe(gen, cfg, dtype, device=dev)
            x = torch.randn(FWD_BATCH, FWD_SEQ, cfg.d_model, generator=gen,
                            device=dev).to(dtype)

            def run(c, m=None, calls=None):
                with offload_policy(**KERNEL_POLICY), torch.no_grad(), \
                        (m if m is not None else contextlib.nullcontext()), \
                        (_moe_routing(calls, False) if calls is not None
                         else contextlib.nullcontext()):
                    return M.moe_ffn(p, x, c)[0]

            run(cfg, mesh), run(grouped)                  # warm up
            calls_ep, calls_g = [], []
            (y_ep, books), c_ep, r_ep = counted(
                lambda: _on_mesh(mesh, lambda: run(cfg, mesh, calls_ep)))
            y_g, c_g, r_g = counted(lambda: run(grouped, None, calls_g))
            want_route = "wgmma" if dtype_name == "bfloat16" else "tf32x3"
            if c_ep != {**dict.fromkeys(c_ep, 0), "gemm": mesh.size,
                        "gemm_batched": 3 * mesh.size} or \
                    r_ep["gemm_batched"][want_route] != 3 * mesh.size:
                fail(f"distributed (c) {dtype_name}: launches {c_ep}, "
                     f"routes {r_ep}")
            idx_ep = torch.cat([c[0] for c in calls_ep])
            idx_g = calls_g[0][0]
            agree = (idx_ep == idx_g).all(dim=-1)
            yf_ep = y_ep.reshape(-1, cfg.d_model)[agree]
            yf_g = y_g.reshape(-1, cfg.d_model)
            scale = yf_g.abs().max().item()
            err = float((yf_ep.float() - yf_g[agree].float()).abs().max()) \
                / scale
            if not (torch.isfinite(y_ep).all() and err <= bar):
                fail(f"distributed (c) {dtype_name}: EP against grouped on "
                     f"agreeing tokens {err} > {bar}")
            prof_ep = _profile(lambda: run(cfg, mesh))
            prof_g = _profile(lambda: run(grouped))
            out[dtype_name] = {
                "choices": idx_g.numel(),
                "choices_differ": int((idx_ep != idx_g).sum()),
                "tokens_agree": int(agree.sum()), "err_on_agreeing": err,
                "bar": bar, "launches": c_ep, "routes": r_ep,
                "launches_grouped": c_g, "routes_grouped": r_g,
                "wall_s_mesh": _median_s(lambda: run(cfg, mesh)),
                "wall_s_grouped": _median_s(lambda: run(grouped)),
                "device_ms_by_kernel_mesh": _kernel_ms(prof_ep),
                "device_ms_by_kernel_grouped": _kernel_ms(prof_g),
                "device_busy_ms_mesh": prof_ep.get("device_busy_ms"),
                "device_busy_ms_grouped": prof_g.get("device_busy_ms"),
                "collective_device_ms": _collective_device_ms(
                    lambda: run(cfg, mesh)),
                **books}
            launches[f"distributed-ep-{dtype_name}"] = c_ep
            routes[f"distributed-ep-{dtype_name}"] = r_ep
            max_abs[f"gemm_batched:distributed-{dtype_name}"] = err
            del p, x, y_ep, y_g
        return out

    # ---- (d) mamba2-370m head-sharded forward, 48 layers -----------------
    def ssm_forward():
        cfg = get_arch(SSM_ARCH)
        model = build_model(cfg)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
        tokens = tokens_of(cfg, SSM_FWD_BATCH, SSM_FWD_SEQ)
        fwd = forward_pair(model, params, tokens)
        fwd(), fwd(mesh)
        plain, c_p, r_p = counted(fwd)
        (got, books), counts, rts = counted(
            lambda: _on_mesh(mesh, lambda: fwd(mesh)))
        L = cfg.num_layers
        heads = cfg.ssm_num_heads // DIST_MESH[1]
        want = {**dict.fromkeys(counts, 0),
                "gemm": L * (5 + mesh.size) + 1,
                "ssd_chunk_diag": L * mesh.size}
        if counts != want:
            fail(f"distributed (d): launches {counts}, want {want}")
        require_route("distributed (d)", rts, "wgmma")
        pf = forward_pair(model, params, tokens, use_kernels=False)
        lp = pf()[:, -1].float()
        floor, _ = _rel_err(pf(k_parts=2)[:, -1], lp)
        bar = max(LOGIT_TOL, 2 * floor)
        err, _ = _rel_err(got[:, -1], plain[:, -1])
        if not (torch.isfinite(got).all() and err <= bar):
            fail(f"distributed (d): logits against no mesh {err} > {bar}")
        del got, plain, lp
        prof_mesh = _profile(lambda: fwd(mesh))
        prof_plain = _profile(fwd)
        out = {"arch": cfg.name, "layers": L, "dtype": cfg.dtype,
               "batch": SSM_FWD_BATCH, "seq": SSM_FWD_SEQ,
               "heads_a_shard": heads, "launches": counts, "routes": rts,
               "launches_no_mesh": c_p, "routes_no_mesh": r_p,
               "last_logits_err": err, "bar": bar, "plain_floor": floor,
               "wall_s_mesh": _median_s(lambda: fwd(mesh)),
               "wall_s_no_mesh": _median_s(fwd),
               "device_ms_by_kernel_mesh": _kernel_ms(prof_mesh),
               "device_ms_by_kernel_no_mesh": _kernel_ms(prof_plain),
               "device_busy_ms_mesh": prof_mesh.get("device_busy_ms"),
               "device_busy_ms_no_mesh": prof_plain.get("device_busy_ms"),
               "collective_device_ms": _collective_device_ms(
                   lambda: fwd(mesh)),
               **books}
        launches["distributed-ssm"], routes["distributed-ssm"] = counts, rts
        max_abs["ssd_chunk_diag:distributed"] = err
        del params
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        m32 = build_model(cfg32)
        p32 = m32.init_params(
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
        f32 = forward_pair(m32, p32, tokens_of(cfg32, *DIST_SSM_F32_FWD))
        ref32 = f32()
        got32, c32, r32 = counted(lambda: f32(mesh))
        require_route("distributed (d) f32", r32, "tf32x3")
        err32, _ = _rel_err(got32, ref32)
        if not err32 <= F32_LOGIT_TOL or \
                c32["ssd_chunk_diag"] != L * mesh.size:
            fail(f"distributed (d) f32: logits {err32} > {F32_LOGIT_TOL}, "
                 f"launches {c32}")
        out["float32"] = {"batch": DIST_SSM_F32_FWD[0],
                          "seq": DIST_SSM_F32_FWD[1], "launches": c32,
                          "routes": r32, "logits_err": err32,
                          "bar": F32_LOGIT_TOL}
        routes["distributed-ssm-f32"] = r32
        return out

    # ---- (e) the ring collective matmul at yi-6b's up projection ---------
    def ring():
        cfg = get_arch(ARCH)
        d, f = cfg.d_model, cfg.d_ff
        fn = shard_map(lambda xs, wl: ring_ag_matmul(xs, wl, "model"),
                       mesh=mesh4,
                       in_specs=(P(None, "model", None), P(None, "model")),
                       out_specs=P(None, None, "model"))
        gemm = lowering("gemm")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        out = {"mesh": label4, "x": [FWD_BATCH, FWD_SEQ, d], "w": [d, f]}
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            x = torch.randn(FWD_BATCH, FWD_SEQ, d, generator=gen,
                            device=dev).to(dtype)
            w = (torch.randn(d, f, generator=gen, device=dev)
                 * d ** -0.5).to(dtype)

            def single(xx, ww):
                return gemm(xx.reshape(-1, d), ww).reshape(
                    FWD_BATCH, FWD_SEQ, f)

            with offload_policy(**KERNEL_POLICY), torch.no_grad():
                fn(x, w)
                (y, books), counts, rts = counted(
                    lambda: _on_mesh(mesh4, lambda: fn(x, w)))
                want = single(x, w)
            err, _ = _rel_err(y, want)
            xa, wa = (t.clone().requires_grad_(True) for t in (x, w))
            xb, wb = (t.clone().requires_grad_(True) for t in (x, w))
            with offload_policy(**KERNEL_POLICY):
                (fn(xa, wa).float() ** 2).sum().backward()
                (single(xb, wb).float() ** 2).sum().backward()
            gerr = max(_rel_err(xa.grad, xb.grad)[0],
                       _rel_err(wa.grad, wb.grad)[0])
            bar = TOL[dtype_name]
            route = "wgmma" if dtype_name == "bfloat16" else "tf32x3"
            if counts["gemm"] != DIST_MESH[1] ** 2 or \
                    rts["gemm"][route] != counts["gemm"] or \
                    not (err <= bar and gerr <= bar):
                fail(f"distributed (e) {dtype_name}: launches {counts}, "
                     f"routes {rts['gemm']}, err {err}, gradient err {gerr} "
                     f"> {bar}")
            # Device ms a call by CUDA events behind a spin kernel (the
            # host queues a ring call's 16 GEMMs in ~15 ms, the spin
            # covers RING_TIMED_CALLS of them).
            with offload_policy(**KERNEL_POLICY), torch.no_grad():
                ring_ms = _time(lambda _: fn(x, w), [None],
                                iters=RING_TIMED_CALLS)
                coll_ms = _collective_device_ms(lambda: fn(x, w))
                one_ms = _time(lambda _: single(x, w), [None], iters=20)
            out[dtype_name] = {
                "launches": counts, "routes": rts, "err": err,
                "grad_err": gerr, "bar": bar, "ring_ms": ring_ms,
                "one_gemm_ms": one_ms, "collective_device_ms": coll_ms,
                **books}
            launches[f"distributed-ring-{dtype_name}"] = counts
            routes[f"distributed-ring-{dtype_name}"] = rts
            del x, w, xa, wa, xb, wb, y, want
        return out

    # ---- (f) GPipe: 4 yi-6b layers over model 4, 8 microbatches ----------
    def gpipe():
        cfg = dataclasses.replace(get_arch(ARCH), num_layers=PIPE_STAGES)
        model = build_model(cfg)
        layers = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED),
            device=dev)["stack"]
        stacked = tree.tree_map(lambda *ls: torch.stack(ls), *layers)
        del layers
        x = torch.randn(PIPE_BATCH, FWD_SEQ, cfg.d_model,
                        generator=torch.Generator(device=dev).manual_seed(SEED),
                        device=dev).to(torch.bfloat16)
        pos = torch.arange(FWD_SEQ, dtype=torch.int32, device=dev)[None]
        windows, thetas = T._layer_data(cfg, FWD_SEQ)

        def stage(p, xmb):
            return T._apply_block(p, xmb, cfg, "attn", False, positions=pos,
                                  window=windows[0],
                                  rope_theta=thetas[0])[0]

        def params_req():
            return tree.tree_map(lambda a: a.detach().requires_grad_(True),
                                 stacked)

        def piped():
            req = params_req()
            with offload_policy(**KERNEL_POLICY), torch.enable_grad():
                y = pipeline_apply(req, x, stage, mesh4,
                                   num_microbatches=PIPE_MICRO)
                g = torch.autograd.grad((y.float() ** 2).sum(),
                                        tree.leaves(req))
            return y.detach(), g

        def sequential():
            req = params_req()
            mb = PIPE_BATCH // PIPE_MICRO
            with offload_policy(**KERNEL_POLICY), torch.enable_grad():
                ys = []
                for j in range(PIPE_MICRO):
                    h = x[j * mb:(j + 1) * mb]
                    for i in range(PIPE_STAGES):
                        h = stage(tree.tree_map(lambda a: a[i], req), h)
                    ys.append(h)
                y = torch.cat(ys)
                g = torch.autograd.grad((y.float() ** 2).sum(),
                                        tree.leaves(req))
            return y.detach(), g

        piped()                                            # warm up
        ((y_pipe, g_pipe), books), c_pipe, r_pipe = counted(
            lambda: _on_mesh(mesh4, piped))
        (y_seq, g_seq), c_seq, r_seq = counted(sequential)
        bitwise = torch.equal(y_pipe, y_seq)
        errs = {path: _rel_err(a, b)[0] for (path, _), a, b in zip(
            tree.leaves_with_paths(stacked), g_pipe, g_seq)}
        worst = max(errs, key=errs.get)
        ticks = PIPE_MICRO + PIPE_STAGES - 1
        if not bitwise or errs[worst] > TOL["bfloat16"] or \
                c_pipe["flash_attention"] != ticks * PIPE_STAGES or \
                r_pipe["gemm"]["tiled"]:
            fail(f"distributed (f): forward bit for bit {bitwise}, worst "
                 f"gradient {worst} {errs[worst]}, launches {c_pipe}")
        launches["distributed-gpipe"], routes["distributed-gpipe"] = \
            c_pipe, r_pipe
        del g_pipe, g_seq
        prof_pipe = _profile(piped)
        prof_seq = _profile(sequential)
        return {"mesh": label4, "stages": PIPE_STAGES,
                "microbatches": PIPE_MICRO, "x": [PIPE_BATCH, FWD_SEQ,
                                                  cfg.d_model],
                "dtype": "bfloat16", "forward_bitwise_equal": bitwise,
                "grad_worst_leaf": worst, "grad_worst_err": errs[worst],
                "grad_bar": TOL["bfloat16"],
                "bubble": (PIPE_STAGES - 1) / ticks,
                "stage_calls": ticks * PIPE_STAGES,
                "stage_calls_sequential": PIPE_MICRO * PIPE_STAGES,
                "launches": c_pipe, "routes": r_pipe,
                "launches_sequential": c_seq, "routes_sequential": r_seq,
                "wall_s_pipeline": books["wall_s"],
                "wall_s_sequential": _median_s(sequential, runs=1),
                "device_ms_by_kernel_pipeline": _kernel_ms(prof_pipe),
                "device_ms_by_kernel_sequential": _kernel_ms(prof_seq),
                "device_busy_ms_pipeline": prof_pipe.get("device_busy_ms"),
                "device_busy_ms_sequential": prof_seq.get("device_busy_ms"),
                "collective_device_ms": _collective_device_ms(piped),
                **books}

    out = {"tp_forward": sub("tp", tp_forward)}
    out["tp_grads"] = sub("grad", tp_grads)
    out["int8_psum"] = sub("int8-psum", int8_psum)
    out["ep"] = sub("ep", ep_layer)
    out["ssm"] = sub("ssm", ssm_forward)
    out["ring"] = sub("ring", ring)
    out["gpipe"] = sub("gpipe", gpipe)
    mesh.close()
    mesh4.close()
    emit({"phase": "distributed-summary", "mesh": label,
          "seconds": time.perf_counter() - t_phase,
          "shard_map_host_ms": host_ms,
          "subphase_seconds": {k: v["seconds"] for k, v in out.items()},
          "subphase_peak_GB": {k: v["max_memory_allocated_GB"]
                               for k, v in out.items()}})


def _mini_forward_flops(cfg, bsz, seq):
    """tests/test_sharding.py's analytic forward of the mini cell."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv, dff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    t = bsz * seq
    return (2 * t * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d
                     + 3 * d * dff) * cfg.num_layers
            + 2 * t * d * cfg.vocab_size
            + 4 * bsz * hq * seq * seq * hd * cfg.num_layers)


_DRYRUN_KEYS = (
    "status", "chips", "compile_s", "dot_flops_per_device",
    "traffic_bytes_per_device", "collective_bytes_per_device",
    "collective_bytes_per_device_booked",
    "collective_bytes_per_device_derived", "collective_counts",
    "shard_map_calls", "ops_counted", "memory_analysis",
    "dot_flops_counted_global", "seam_flops_global", "tokens_per_step")


def run_roofline(zero_counts, read_counts, forwards):
    """Phase 15: (a) the dry run (``repro_torch.launch.dryrun``) of the
    mini cell on an emulated (2, 4) mesh and of one yi-6b production cell
    on the 16 x 16 mesh, on meta tensors: status ok, the mini cell within
    tests/test_sharding.py's bounds on its analytic forward, no kernel
    launched; each record's per-device figures and host seconds.  (b)
    ``forwards`` maps yi-6b and mamba2-370m to what phases 4 and 8
    measured of their full-width forwards on the kernels (launches, device
    busy ms profiled, wall); beside it, the roofline terms of the same
    forward's work counted on meta (``roofline.op_count``) on the H100
    row, once with the seam's kernel-ideal bytes alone and once with the
    counted traffic (the seam's bytes plus the glue's), each a bound that
    must not exceed the measured busy time."""
    import shutil

    from repro_torch.configs import ALL_SHAPES, get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.spmd import Mesh

    t_phase = time.perf_counter()
    out_dir = OUT_DIR / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)   # run_cell reads back a
    zero_counts()                                # record already written
    mini = dataclasses.replace(get_arch(ARCH).reduced(), **ROOFLINE_MINI)
    bsz, seq = ROOFLINE_MINI_TOKENS
    mesh = Mesh(DIST_MESH, ("data", "model"), device="meta")
    try:
        rec = dryrun.run_cell(mini, ShapeConfig("mini_train", seq, bsz,
                                                "train"),
                              mesh, "mini2x4", out_dir)
    finally:
        mesh.close()
    fwd = _mini_forward_flops(mini, bsz, seq)
    if rec["status"] != "ok":
        fail(f"dry run of the mini cell: {rec.get('error')}")
    ratio = rec["dot_flops_per_device"] * mesh.size / fwd
    if not (2.0 < ratio < 8.0 and rec["collective_bytes_per_device"] > 0):
        fail(f"mini cell: {mesh.size} x per-device dot FLOPs = {ratio} x "
             f"the analytic forward (want 2-8), collective bytes "
             f"{rec['collective_bytes_per_device']}")
    emit({"phase": "roofline-dryrun", "cell": "mini (tests/test_sharding.py)",
          "mesh": f"emulated {DIST_MESH}", "analytic_forward_flops": fwd,
          "mesh_x_per_device_over_forward": ratio,
          **{k: rec.get(k) for k in _DRYRUN_KEYS}})

    (cell,) = [c for c in ALL_SHAPES if c.name == ROOFLINE_CELL]
    prod = make_production_mesh(device="meta")
    try:
        rec = dryrun.run_cell(ARCH, cell, prod, "pod16x16", out_dir)
    finally:
        prod.close()
    if rec["status"] != "ok":
        fail(f"dry run of {ARCH} x {cell.name}: {rec.get('error')}")
    emit({"phase": "roofline-dryrun", "cell": f"{ARCH} x {cell.name}",
          "mesh": "pod16x16 (emulated, 256 devices)",
          **{k: rec.get(k) for k in _DRYRUN_KEYS}})
    if any(read_counts().values()):
        fail(f"the dry run on meta launched kernels: {read_counts()}")

    for arch, measured in forwards.items():
        out = _roofline_forward(get_arch(arch), measured)
        emit({"phase": f"roofline-{arch}", **out})
    emit({"phase": "roofline", "seconds": time.perf_counter() - t_phase})


def _roofline_forward(cfg, fwd):
    """One forward of phase 15 (b); see :func:`run_roofline`."""
    import torch

    from repro_torch.core.accounting import offload_trace
    from repro_torch.models import build_model
    from repro_torch.roofline import H100_SXM_HW, roofline_terms
    from repro_torch.roofline.op_count import count_ops

    want, _ = expected(cfg, "forward", "eager")
    if fwd["launches"]["eager"] != want:
        fail(f"{cfg.name} forward launches {fwd['launches']['eager']}, "
             f"want {want}")
    busy_ms = fwd["profile_eager"].get("device_busy_ms")
    wall_ms = 1e3 * fwd["seconds"]["eager"]
    model = build_model(cfg)
    params = model.param_specs()
    tokens = torch.empty((fwd["batch"], fwd["seq"]), dtype=torch.int64,
                         device="meta")
    t0 = time.perf_counter()
    with torch.no_grad(), offload_trace() as trace, count_ops() as counter:
        model.forward(params, tokens)
    count_s = time.perf_counter() - t0
    costs = counter.costs()
    terms = {}
    for name, nbytes in (("seam_bytes", trace.total_touched_bytes()),
                         ("counted_traffic", costs.traffic_bytes)):
        r = roofline_terms(costs.dot_flops, nbytes, 0.0, chips=1,
                           hw=H100_SXM_HW)
        bound_ms = 1e3 * r.bound_s
        if busy_ms and bound_ms > busy_ms:
            fail(f"{cfg.name} roofline bound ({name}) {bound_ms} ms exceeds "
                 f"the measured busy {busy_ms} ms")
        terms[name] = {
            "bytes": nbytes, "compute_ms": 1e3 * r.compute_s,
            "memory_ms": 1e3 * r.memory_s, "bound_ms": bound_ms,
            "dominant": r.dominant,
            "share_of_busy": (bound_ms / busy_ms if busy_ms
                              else "not measured"),
            "share_of_wall": bound_ms / wall_ms}
    return {"arch": cfg.name, "dtype": cfg.dtype, "batch": fwd["batch"],
            "seq": fwd["seq"], "hw": dataclasses.asdict(H100_SXM_HW),
            "measured_in": "phase 8 (ssm-forward)" if cfg.family == "ssm"
            else "phase 4 (forward)",
            "launches": fwd["launches"]["eager"], "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": fwd["profile_eager"].get(
                "device_idle_share"),
            "counted": {"dot_flops": costs.dot_flops,
                        "traffic_bytes": costs.traffic_bytes,
                        "ops": counter.total().ops, "host_s": count_s},
            "seam": {"flops": trace.total_flops(),
                     "touched_bytes": trace.total_touched_bytes()},
            "roofline": terms}


def run_times(cfg, ssm_cfg, moe_cfg, randn, launches, routes, max_abs):
    """Phase 11: each kernel at its path's shapes; returns the kernels
    line."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.gemm import gemm, gemm_batched, gemm_route
    from repro_torch.kernels.ref import (attention_ref, gemm_batched_ref,
                                         gemm_ref)
    from repro_torch.kernels.ssd_scan import causal_conv_silu, ssd_chunk_diag

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
