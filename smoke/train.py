"""Phase 13 (``train``): yi-6b at published widths cut to 8 of 32 layers:
the GEMM and attention Functions' backwards, one loss-and-gradients call
and one step profiled, 8 AdamW steps, and the restart loop.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import time

from smoke.common import (KERNEL_POLICY, PLAIN_POLICY, _peak_GB, _rel_err,
                          _row_rel_err, attn_operands, emit, fail, profile,
                          read_routes, require_route)
from smoke.shapes import (ARCH, TOL, TRAIN_BATCH, TRAIN_LAYERS, TRAIN_LOSS_TOL,
                          TRAIN_LR, TRAIN_PUBLISHED_LAYERS, TRAIN_SEQ,
                          TRAIN_STEPS, serve_gemm_shapes)


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


def check_gemm_backward(cfg, randn, tally):
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
                tally.zero()
                y.backward(dc)
                torch.cuda.synchronize()
                return ak.grad, bk.grad, tally.counts(), read_routes()

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
            tally.max_abs[key] = max(tally.max_abs.get(key, 0.0), err_a,
                                     err_b)
            del a, b, dc, da, db, ap, bp
    torch.cuda.empty_cache()
    return rows


def check_attention_backward(cfg, randn, tally):
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
    tally.zero()
    out = kgrad.lowering("attention")(*ins, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    counts, routes = tally.counts(), read_routes()
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
    tally.max_abs["flash_attention:train"] = max(fwd_err, *grad_errs)
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


def run_train(randn, tally):
    """Phase 13: training.  (b) GEMM backwards, (c) attention's Function,
    (a) one loss-and-gradients call, kernels against the plain path, and
    the step's launches split forward / backward, then one step profiled
    (with the forward and the optimizer profiled apart to split it), (d)
    TRAIN_STEPS steps through ``repro_torch.launch.train.train``, (e) the
    restart loop at the reduced config.  Records the train run's launches
    and routes under "train"."""
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

    out["gemm_backward"] = check_gemm_backward(cfg, randn, tally)
    out["attention"] = check_attention_backward(cfg, randn, tally)

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
        tally.zero()
        loss_k, grads_k = steps._loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        step_counts, step_routes = tally.counts(), read_routes()
        tally.zero()
        with torch.enable_grad():
            req = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
            model.loss(req, mb)
            del req
        torch.cuda.synchronize()
        fwd_counts, fwd_routes = tally.counts(), read_routes()
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
    tally.max_abs["gemm:train-step"] = max(grad_errs.values())

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
    prof_step = profile(one_step)
    prof_fwd = profile(forward_only)
    prof_opt = profile(optimizer_only)
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
    tally.zero()
    t0 = time.perf_counter()
    got = train(ARCH, smoke=False, num_layers=TRAIN_LAYERS,
                steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, peak_lr=TRAIN_LR, ckpt_dir=None,
                log_every=1, device="cuda",
                on_step=lambda s, loss, sec: (step_s.append(sec),
                                              losses.append(loss)))
    train_s = time.perf_counter() - t0
    counts, train_routes = tally.counts(), read_routes()
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
    tally.keep("train", counts, train_routes)
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
