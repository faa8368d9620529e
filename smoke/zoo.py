"""Phases 12a-12h: the rest of the model zoo at published widths (cuts in
``shapes.zoo_configs``), each model built on the card after the last
one's weights are freed: jamba, gemma3, danube, hubert, qwen2 and
qwen2-vl, each kernels against the plain path.
"""

from __future__ import annotations

import time

from smoke.common import (_leaves, _logit_errs, _peak_GB, emit, fail,
                          read_routes, require_f32_gemm_routes, zero_routes)
from smoke.dense import run_forward, run_long_decode, run_serve
from smoke.shapes import (BATCH, CACHE_LEN, DANUBE_FWD, DANUBE_LONG,
                          F32_LOGIT_TOL, GEMMA_FWD, GEMMA_LONG,
                          JAMBA_F32_FWD_SEQ, PROMPT_LEN, SEED, ZOO_FWD,
                          zoo_cuts)


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


def run_zoo(zoo, rng, tally):
    """Phases 12a-12h: the rest of the model zoo at published widths (cut
    where the card forces it, ``zoo_cuts``), each model's weights freed
    before the next is built."""
    import torch

    def keep(tag, out):
        launches, routes = out["launches"], out["routes"]
        tally.keep(tag, launches.get("eager", launches),
                   routes.get("eager", routes))
        if "graph" in routes:
            tally.keep(tag + "-graph", routes=routes["graph"])
        emit({"phase": tag, **out, "max_memory_allocated_GB": _peak_GB()})

    def serve(tag, cfg, model, params, facts, graph=False):
        prompts = _zoo_prompts(rng, cfg)
        out = run_serve(cfg, model, params, prompts, "eager", tally)
        toks = out.pop("tokens")
        keep(tag, {**out, **facts})
        if graph:
            out_g = run_serve(cfg, model, params, prompts, "graph",
                              tally)
            if out_g.pop("tokens") != toks:
                fail(f"{cfg.name} graph-mode serving gave other greedy "
                     "tokens than eager mode")
            out_g["greedy_tokens_equal_eager"] = True
            keep(tag + "-graph", out_g)
        return prompts

    def forward(tag, cfg, model, params, inputs, facts=None):
        keep(tag, {**run_forward(cfg, model, params, inputs, tally,
                                 shared_routing=bool(cfg.num_experts)),
                   **(facts or {})})

    # ---- 12a-12d. jamba: one super-block, 8 experts ----------------------
    cfg = zoo["jamba"]
    model, params, facts = _zoo_build(cfg)
    prompts = serve("jamba-serve", cfg, model, params, facts, graph=True)
    forward("jamba-forward", cfg, model, params,
            _zoo_tokens(rng, cfg, ZOO_FWD))
    del params, model
    tally.keep("jamba-float32",
               routes=run_jamba_f32(zoo["jamba-f32"], prompts, rng))

    # ---- 12e. gemma3-27b whole -------------------------------------------
    cfg = zoo["gemma3"]
    model, params, facts = _zoo_build(cfg)
    prompts = serve("gemma3-serve", cfg, model, params, facts)
    forward("gemma3-forward", cfg, model, params,
            _zoo_tokens(rng, cfg, GEMMA_FWD))
    b, slots, index = GEMMA_LONG
    out = run_long_decode(cfg, model, params, prompts, tally, batch=b,
                          cache_len=slots, index=index,
                          phase="gemma3-long-decode", clone=False)
    tally.keep("gemma3-long-decode", out["launches"], out["routes"])
    del params, model

    # ---- 12f. h2o-danube-1.8b whole --------------------------------------
    cfg = zoo["danube"]
    model, params, facts = _zoo_build(cfg)
    prompts = serve("danube-serve", cfg, model, params, facts)
    forward("danube-forward", cfg, model, params,
            _zoo_tokens(rng, cfg, DANUBE_FWD))
    b, slots, index = DANUBE_LONG
    out = run_long_decode(cfg, model, params, prompts, tally, batch=b,
                          cache_len=slots, index=index,
                          phase="danube-long-decode")
    tally.keep("danube-long-decode", out["launches"], out["routes"])
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
    if r["ssd_scan"] != {"composed": 0, "chunked": n_mamba} \
            or any(r["ssd_chunk_diag"].values()):
        fail(f"jamba f32 SSD off the chunked route: {r['ssd_scan']}")
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
