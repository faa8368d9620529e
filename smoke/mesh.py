"""Phase 14 (``distributed-*``): the distributed layer on an emulated
(data 2, model 4) mesh whose 8 devices all live on the one card, each
sub-phase (a)-(g) against the same work with no mesh.
"""

from __future__ import annotations

import dataclasses
import time

from smoke.common import (KERNEL_POLICY, PLAIN_POLICY, _peak_GB, _rel_err,
                          emit, fail, profile, read_routes, require_route)
from smoke.dense import _moe_routing
from smoke.shapes import (ARCH, DIST_F32_FWD, DIST_F32_LAYERS, DIST_MESH,
                          DIST_SSM_F32_FWD, EP_CAPACITY, F32_LOGIT_TOL,
                          FWD_BATCH, FWD_SEQ, LOGIT_TOL, MOE_ARCH, PIPE_BATCH,
                          PIPE_MICRO, PIPE_STAGES, SEED, SSM_ARCH,
                          SSM_FWD_BATCH, SSM_FWD_SEQ, TOL, TRAIN_BATCH,
                          TRAIN_LAYERS, TRAIN_LOSS_TOL, TRAIN_SEQ)
from smoke.timing import _time
from smoke.train import _train_batch


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


def run_distributed(tally):
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
        tally.zero()
        res = fn()
        torch.cuda.synchronize()
        return res, tally.counts(), read_routes()

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
        prof_mesh = profile(lambda: fwd(mesh))
        prof_plain = profile(fwd)
        out = {"arch": cfg.name, "layers": L, "dtype": cfg.dtype,
               "batch": FWD_BATCH, "seq": FWD_SEQ,
               "launches": counts, "routes": rts,
               "launches_no_mesh": c_plain, "routes_no_mesh": r_plain,
               "tp_plan_records": planned,
               "last_logits_err": err, "last_logits_max_abs_err": abs_err,
               "all_logits_err": err_all, "bar": bar, "plain_floor": floor,
               "wall_s_mesh": _median_s(lambda: fwd(mesh)),
               "wall_s_no_mesh": _median_s(fwd),
               "device_ms_by_kernel_mesh": prof_mesh["device_ms_by_kernel"],
               "device_ms_by_kernel_no_mesh":
                   prof_plain["device_ms_by_kernel"],
               "collective_device_ms": _collective_device_ms(
                   lambda: fwd(mesh)),
               "profile_mesh": prof_mesh, "profile_no_mesh": prof_plain,
               "peak_GB_mesh": peak_mesh, "peak_GB_no_mesh": peak_plain,
               "weights_GB": sum(t.numel() * t.element_size()
                                 for t in tree.leaves(params)) / 1e9,
               **books}
        tally.keep("distributed-tp", counts, rts)
        tally.max_abs["gemm:distributed"] = err
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
        tally.keep("distributed-tp-f32", routes=r32)
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
        tally.keep("distributed-grad", c_m, r_m)
        tally.max_abs["gemm:distributed-grad"] = errs[worst]
        prof_mesh = profile(lambda: loss_and_grads(mesh))
        prof_plain = profile(loss_and_grads)
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
                "device_ms_by_kernel_mesh": prof_mesh["device_ms_by_kernel"],
                "device_ms_by_kernel_no_mesh":
                    prof_plain["device_ms_by_kernel"],
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
        prof = profile(all_leaves)
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
                "device_ms_by_kernel": prof["device_ms_by_kernel"],
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
            prof_ep = profile(lambda: run(cfg, mesh))
            prof_g = profile(lambda: run(grouped))
            out[dtype_name] = {
                "choices": idx_g.numel(),
                "choices_differ": int((idx_ep != idx_g).sum()),
                "tokens_agree": int(agree.sum()), "err_on_agreeing": err,
                "bar": bar, "launches": c_ep, "routes": r_ep,
                "launches_grouped": c_g, "routes_grouped": r_g,
                "wall_s_mesh": _median_s(lambda: run(cfg, mesh)),
                "wall_s_grouped": _median_s(lambda: run(grouped)),
                "device_ms_by_kernel_mesh": prof_ep["device_ms_by_kernel"],
                "device_ms_by_kernel_grouped": prof_g["device_ms_by_kernel"],
                "device_busy_ms_mesh": prof_ep.get("device_busy_ms"),
                "device_busy_ms_grouped": prof_g.get("device_busy_ms"),
                "collective_device_ms": _collective_device_ms(
                    lambda: run(cfg, mesh)),
                **books}
            tally.keep(f"distributed-ep-{dtype_name}", c_ep, r_ep)
            tally.max_abs[f"gemm_batched:distributed-{dtype_name}"] = err
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
                "ssd_scan": L * mesh.size}
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
        prof_mesh = profile(lambda: fwd(mesh))
        prof_plain = profile(fwd)
        out = {"arch": cfg.name, "layers": L, "dtype": cfg.dtype,
               "batch": SSM_FWD_BATCH, "seq": SSM_FWD_SEQ,
               "heads_a_shard": heads, "launches": counts, "routes": rts,
               "launches_no_mesh": c_p, "routes_no_mesh": r_p,
               "last_logits_err": err, "bar": bar, "plain_floor": floor,
               "wall_s_mesh": _median_s(lambda: fwd(mesh)),
               "wall_s_no_mesh": _median_s(fwd),
               "device_ms_by_kernel_mesh": prof_mesh["device_ms_by_kernel"],
               "device_ms_by_kernel_no_mesh":
                   prof_plain["device_ms_by_kernel"],
               "device_busy_ms_mesh": prof_mesh.get("device_busy_ms"),
               "device_busy_ms_no_mesh": prof_plain.get("device_busy_ms"),
               "collective_device_ms": _collective_device_ms(
                   lambda: fwd(mesh)),
               **books}
        tally.keep("distributed-ssm", counts, rts)
        tally.max_abs["ssd_chunk_diag:distributed"] = err
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
                c32["ssd_scan"] != L * mesh.size:
            fail(f"distributed (d) f32: logits {err32} > {F32_LOGIT_TOL}, "
                 f"launches {c32}")
        out["float32"] = {"batch": DIST_SSM_F32_FWD[0],
                          "seq": DIST_SSM_F32_FWD[1], "launches": c32,
                          "routes": r32, "logits_err": err32,
                          "bar": F32_LOGIT_TOL}
        tally.keep("distributed-ssm-f32", routes=r32)
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
            tally.keep(f"distributed-ring-{dtype_name}", counts, rts)
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
        tally.keep("distributed-gpipe", c_pipe, r_pipe)
        del g_pipe, g_seq
        prof_pipe = profile(piped)
        prof_seq = profile(sequential)
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
                "device_ms_by_kernel_pipeline":
                    prof_pipe["device_ms_by_kernel"],
                "device_ms_by_kernel_sequential":
                    prof_seq["device_ms_by_kernel"],
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
