"""Phases 10a-10g: qwen3-moe-30b-a3b at full width (``moe-serve``,
``moe-serve-graph``, ``moe-forward``, ``moe-layer``, ``moe-placed``,
``moe-float32``), and the dropless MoE's ragged grouped GEMM at
granite-4.0-h-small's expert shapes (``grouped``).
"""

from __future__ import annotations

import dataclasses
import time

from smoke.common import (KERNEL_POLICY, PLAIN_POLICY, _leaves, _logit_errs,
                          _rel_err, emit, fail, profile, read_routes,
                          require_f32_gemm_routes, zero_routes)
from smoke.dense import _moe_routing, _routing_diff, run_forward, run_serve
from smoke.shapes import (BATCH, CACHE_LEN, F32_FWD_BATCH, F32_FWD_SEQ,
                          F32_LOGIT_TOL, FWD_BATCH, FWD_SEQ, GRANITE_D,
                          GRANITE_EXPERTS, GRANITE_F, GRANITE_ROWS,
                          GRANITE_TOKENS, GRANITE_TOP_K, MAX_NEW,
                          MOE_F32_LAYERS, MOE_PARAMS, MOE_PLACED_LANES,
                          MOE_PLACED_STEPS, MOE_PLACED_ZIPF, PROMPT_LEN, SEED,
                          TOL, grouped_counts, moe_expert_shapes, moe_groups)
from smoke.timing import _bound_ms, grouped_operands


def run_moe(cfg, rng, tally):
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
    serve = run_serve(cfg, model, params, prompts, "eager", tally,
                      registry=books)
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
    tally.keep("moe-serve", serve["launches"], serve["routes"])
    emit({"phase": "moe-serve", **serve})

    # ---- 10b. serve (graph) ---------------------------------------------
    serve_g = run_serve(cfg, model, params, prompts, "graph", tally)
    serve_g["eager_tokens_per_s"] = serve["kernel"]["tokens_per_s"]
    if serve_g.pop("tokens") != serve["tokens"]:
        fail(f"{cfg.name} graph-mode serving gave other greedy tokens than "
             "eager mode")
    serve_g["greedy_tokens_equal_eager"] = True
    tally.keep("moe-serve-graph", routes=serve_g["routes"])
    emit({"phase": "moe-serve-graph", **serve_g})

    # ---- 10c. forward (eager, graph) ------------------------------------
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(FWD_BATCH, FWD_SEQ))).to(dev)
    fwd = run_forward(cfg, model, params, tokens, tally)
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
    tally.keep("moe-forward", fwd["launches"]["eager"],
               fwd["routes"]["eager"])
    tally.keep("moe-forward-graph", routes=fwd["routes"]["graph"])
    emit({"phase": "moe-forward", **fwd})

    # ---- 10f. layer 0's expert FFN, kernels against plain -----------------
    run_moe_layer(cfg, params["stack"][0]["ffn"], tally)

    # ---- 10e. one MoE layer placed over modeled lanes ---------------------
    placed = run_moe_placed(cfg, params["stack"][0]["ffn"], tally)
    tally.keep("moe-placed", routes=placed["routes"])
    emit({"phase": "moe-placed", **placed})
    del params, model
    torch.cuda.empty_cache()

    # ---- 10d. float32 at two layers -------------------------------------
    tally.keep("moe-float32", routes=run_moe_f32(cfg, prompts, tokens))


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
        return profile(step)
    finally:
        M._note_moe_step = note


def run_moe_layer(cfg, layer, tally):
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
        tally.zero()
        with offload_policy(**KERNEL_POLICY), torch.no_grad():
            got = fn()
        torch.cuda.synchronize()
        counts, routes = tally.counts(), read_routes()
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


def run_grouped(moe_cfg, tally):
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
    flip near-tied top-k choices (counted as ``routing_flips``).  Keeps
    the layer's launches under "grouped"."""
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
    tally.keep("grouped", {"gemm_grouped": n_launch})
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
    tally.max_abs["gemm_grouped"] = max(v["max_abs_err"]
                                        for v in out["gemm"].values())


def run_moe_placed(cfg, layer, tally):
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
        tally.zero()
        with offload_trace() as trace:
            got, aux = M.moe_ffn_placed(layer, x, gcfg, policy=pol)
        torch.cuda.synchronize()
        counts, routes = tally.counts(), read_routes()
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

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, num_layers=MOE_F32_LAYERS,
                                dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    first = torch.tensor([[p[0]] for p in prompts], device=dev)
    toks = tokens[:F32_FWD_BATCH, :F32_FWD_SEQ]
    picks = {}

    def spied(name, pol, k_parts, run):
        calls = picks[(name, pol is KERNEL_POLICY, k_parts)] = []
        with offload_policy(**pol), blas.host_k_split(k_parts), \
                torch.no_grad(), _moe_routing(calls, False):
            return run()

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
    for name in ("decode", "forward"):
        out[f"{name}_routing"] = _routing_diff(
            picks[(name, True, 1)], picks[(name, False, 1)],
            cfg.experts_per_token)
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
