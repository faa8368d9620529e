"""Phases 8-10 on mamba2-370m at full width: ``ssm-forward`` (eager and
graph mode, one SSD and one causal conv launch a mixer), ``ssm-serve``
and ``ssm-float32``.
"""

from __future__ import annotations

import dataclasses
import time

from smoke.common import (KERNEL_POLICY, _leaves, _logit_errs, emit, fail,
                          read_routes, require_f32_gemm_routes, zero_routes)
from smoke.dense import run_forward, run_serve
from smoke.shapes import (BATCH, CACHE_LEN, DECODE_VS_FORWARD_TOL,
                          F32_LOGIT_TOL, PROMPT_LEN, SEED, SSM_F32_FWD_SEQ,
                          SSM_FWD_BATCH, SSM_FWD_SEQ)


def run_ssm(cfg, rng, tally):
    """Phases 8-10 in order.  Returns the forward's facts (phase 15 reads
    them)."""
    import torch

    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(SSM_FWD_BATCH, SSM_FWD_SEQ))).to(dev)
    fwd = run_forward(cfg, model, params, tokens, tally)
    fwd["init_s"] = init_s
    fwd["params"] = sum(t.numel() for t in _leaves(params))
    tally.keep("ssm-forward", fwd["launches"]["eager"],
               fwd["routes"]["eager"])
    tally.keep("ssm-forward-conv", fwd["conv_launches"])
    tally.keep("ssm-forward-graph", fwd["launches"]["graph"],
               fwd["routes"]["graph"])
    emit({"phase": "ssm-forward", **fwd})
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=PROMPT_LEN)]
               for _ in range(BATCH)]
    serve = run_serve(cfg, model, params, prompts, "eager", tally)
    serve.pop("tokens")
    tally.keep("ssm-serve", serve["launches"], serve["routes"])
    emit({"phase": "ssm-serve", **serve})
    del params
    torch.cuda.empty_cache()
    tally.keep("ssm-float32", routes=run_ssm_f32(cfg, tokens, prompts))
    return fwd


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
    ssd_routes = fwd_routes["ssd_scan"]
    if ssd_routes != {"composed": 0, "chunked": cfg.num_layers} \
            or any(fwd_routes["ssd_chunk_diag"].values()):
        fail(f"ssm f32 forward SSD off the chunked route: {ssd_routes}")
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
