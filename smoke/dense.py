"""Phases 3-6 on yi-6b at full width, and the runners the other models'
phases share: ``serve`` (kernels against the plain path), ``forward``
(eager and graph mode), ``serve-graph``, ``long-decode`` (a 4096-slot
cache), phases 5a-5c on the same weights (``smoke.cluster``), and
``float32``.
"""

from __future__ import annotations

import dataclasses
import math
import time

from smoke.cluster import run_serve_cluster
from smoke.common import (KERNEL_POLICY, PLAIN_POLICY, _backends, _leaves,
                          _logit_errs, _peak_GB, attn_route, decode_route_of,
                          emit, fail, profile, read_routes,
                          require_f32_gemm_routes, require_route, zero_routes)
from smoke.shapes import (BATCH, CACHE_LEN, F32_FWD_BATCH, F32_FWD_SEQ,
                          F32_LOGIT_TOL, FWD_BATCH, FWD_SEQ, LOGIT_TOL,
                          LONG_CACHE, LONG_INDEX, MAX_NEW, PROMPT_LEN, SEED,
                          expected)


def run_yi(cfg, rng, tally):
    """Phases 3-6 in order, phases 3-5c on one set of bf16 weights.
    Returns the forward's facts (phase 15 reads them)."""
    import torch

    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=PROMPT_LEN)]
               for _ in range(BATCH)]
    serve = run_serve(cfg, model, params, prompts, "eager", tally)
    serve["init_s"] = init_s
    serve["params"] = sum(t.numel() for t in _leaves(params))
    tally.keep("serve", serve["launches"], serve["routes"])
    emit({"phase": "serve", **serve})

    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(FWD_BATCH, FWD_SEQ))).to(dev)
    fwd = run_forward(cfg, model, params, tokens, tally)
    tally.keep("forward", fwd["launches"]["eager"], fwd["routes"]["eager"])
    tally.keep("forward-graph", routes=fwd["routes"]["graph"])
    emit({"phase": "forward", **fwd})

    serve_g = run_serve(cfg, model, params, prompts, "graph", tally)
    serve_g["eager_tokens_per_s"] = serve["kernel"]["tokens_per_s"]
    # Both modes run the same kernels on the same operands.
    if serve_g.pop("tokens") != serve["tokens"]:
        fail("graph-mode serving gave other greedy tokens than eager mode")
    serve_g["greedy_tokens_equal_eager"] = True
    emit({"phase": "serve-graph", **serve_g})
    long_decode = run_long_decode(cfg, model, params, prompts, tally)
    tally.keep("long-decode", long_decode["launches"], long_decode["routes"])
    run_serve_cluster(cfg, params, prompts, serve["tokens"], tally)
    del params
    torch.cuda.empty_cache()
    run_f32(cfg, tokens, prompts, tally)
    return fwd


def run_serve(cfg, model, params, prompts, forward_mode, tally,
              registry=None):
    """Phases 3, 5, 9, 10a and 10b: serve the prompts on the kernels
    (counted; its metrics into ``registry`` when given) and on
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
    tally.zero()
    with offload_policy(**KERNEL_POLICY), offload_trace() as trace, \
            (metrics.collect(registry) if registry is not None
             else contextlib.nullcontext()):
        res_k = serve_batch(cfg, prompts, max_new_tokens=MAX_NEW, **kw)
    launches = tally.counts()
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
        out["profile_first_step"] = profile(
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


def run_forward(cfg, model, params, tokens, tally, shared_routing=False):
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
        tally.zero()
        conv0 = causal_conv_silu.launches
        t0 = time.perf_counter()
        with offload_policy(**KERNEL_POLICY), offload_trace() as trace, \
                torch.no_grad():
            logits, aux = mdl.forward(params, tokens)
        torch.cuda.synchronize()
        runs = [time.perf_counter() - t0]
        counts = tally.counts()
        out["launches"][mode] = counts
        # Every Mamba-2 mixer makes its SSD operands with one conv launch.
        conv = causal_conv_silu.launches - conv0
        out.setdefault("conv_launches", {})[mode] = conv
        if conv != counts["ssd_scan"]:
            fail(f"{arch} forward ({mode}) causal conv launches {conv}, want "
                 f"one a Mamba-2 mixer ({counts['ssd_scan']})")
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

    out["profile_eager"] = profile(eager_forward)
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


def run_long_decode(cfg, model, params, prompts, tally, *, batch=BATCH,
                    cache_len=LONG_CACHE, index=LONG_INDEX,
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

    tally.zero()
    errs = _logit_errs(logits_of, (batch, cfg.vocab_size))
    launches, routes = tally.counts(), read_routes()
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
        out["profile_step"] = profile(lambda: logits_of(KERNEL_POLICY))
    emit(out)
    del base
    torch.cuda.empty_cache()
    return out


def run_f32(cfg, tokens, prompts, tally):
    """Phase 6: decode first-step and forward last-position logits with
    f32 weights at full width, kernels against plain, bar 1e-4, and the
    long-cache decode step at that bar.  Every attention launch of the f32
    forward must take the f32 tensor-core route (``tf32x3``: 3xTF32,
    fp32-accurate), of the decode the CUDA-core one (``simt``); keeps
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
    long32 = run_long_decode(model32.cfg, model32, params32, prompts, tally)
    tally.keep("float32", routes=out["routes"])
    tally.keep("long-decode-f32", routes=long32["routes"])
    del params32
    torch.cuda.empty_cache()
