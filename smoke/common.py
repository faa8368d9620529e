"""What every phase of the check shares: failing and printing, the
offload policies, the run's books (:class:`Tally`), the route checks, the
error measures, and the profile of one call read through
``portbench/trace.py``."""

from __future__ import annotations

import json
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    from repro_torch.kernels.ssd_scan import ssd_chunk_diag, ssd_scan

    return {"gemm": gemm, "gemm_batched": gemm_batched,
            "flash_attention": flash_attention, "flash_decode": flash_decode,
            "ssd_chunk_diag": ssd_chunk_diag, "ssd_scan": ssd_scan}


def zero_routes():
    routed = _routed()
    for fn in routed.values():
        fn.route_launches.update(dict.fromkeys(fn.route_launches, 0))
    for k in ("gemm", "gemm_batched"):
        routed[k].grouped_launches = 0


def read_routes():
    """{"gemm": {route: launches}, "gemm_batched": {...},
    "flash_attention": {...}, "flash_decode": {...}, "ssd_chunk_diag":
    {...}, "ssd_scan": {...} (the whole SSD core's calls by route),
    "grouped": {"gemm": n, "gemm_batched": n}} since the last
    ``zero_routes``; "grouped" counts the ``wgmma`` launches that ran in a
    tile order other than the plain one (``kernels/gemm.py::wgmma_plan``)."""
    routed = _routed()
    out = {k: dict(fn.route_launches) for k, fn in routed.items()}
    out["grouped"] = {k: routed[k].grouped_launches
                      for k in ("gemm", "gemm_batched")}
    return out


class Tally:
    """The run's books, one object that every phase takes: the launch
    counters of the port's five counted kernels and the SSD core's calls
    (``ssd_scan``), and their route counters
    (:meth:`zero` sets both to 0 just before a path runs; :meth:`counts`
    and :func:`read_routes` read them just after), what each path kept of
    them for the kernels line (``launches``, ``routes``: {path: counts}),
    each kernel's largest abs error against its plain version
    (``max_abs``) and where the long outputs go (``out_dir``)."""

    COUNTED = ("gemm", "gemm_batched", "flash_decode", "flash_attention",
               "ssd_chunk_diag", "ssd_scan")

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.launches, self.routes, self.max_abs = {}, {}, {}

    def zero(self):
        for fn in _routed().values():
            fn.launches = 0
        zero_routes()

    def counts(self):
        routed = _routed()
        return {k: routed[k].launches for k in self.COUNTED}

    def keep(self, path, launches=None, routes=None):
        """Keep one path's launch and route counts for the kernels line."""
        if launches is not None:
            self.launches[path] = launches
        if routes is not None:
            self.routes[path] = routes


def require_route(label, routes, route, decode=None, batched=None,
                  attn=None):
    """Fail unless every GEMM launch in ``routes`` took ``route``, every
    flash-attention launch ``attn`` (default ``route``), every flash-decode
    launch ``decode``, every SSD chunk launch ``mma``, every SSD core call
    ``chunked`` and every batched GEMM launch ``batched`` (default
    ``route``; a path that launches no attention or SSD passes on the
    GEMMs)."""
    want = {"flash_decode": decode, "ssd_chunk_diag": "mma",
            "ssd_scan": "chunked",
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


def _peak_GB():
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# The port's kernels by family: a device operation whose name holds one of
# a family's keys is that family's, any other (torch's elementwise kernels,
# cuBLAS, copies) "other".  tests/test_torch_smoke.py holds every kernel
# of src/repro_torch/kernels/csrc to one family.
FAMILIES = {"gemm": ("gemm_wgmma", "gemm_tiled", "gemm_skinny",
                     "gemm_tf32x3"),
            "flash_attention": ("flash_attention_kernel", "attn_wgmma",
                                "attn_tf32x3"),
            "flash_decode": ("flash_decode_",),
            "ssd_chunk_diag": ("ssd_chunk_kernel", "ssd_mma_kernel"),
            "ssd_scan": ("ssd_state_kernel", "ssd_pass_kernel"),
            "gemm_grouped": ("grouped_wgmma",),
            "causal_conv_silu": ("causal_conv_silu_kernel",)}


def family(name):
    """The family (``FAMILIES``) of a device operation's name."""
    return next((f for f, keys in FAMILIES.items()
                 if any(k in name for k in keys)), "other")


def profile(fn):
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity) after a
    synchronize, the call and a closing synchronize inside the range by
    which ``portbench/trace.py`` windows a trace, and read the trace
    through that module (:func:`readings`)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as traced

    from portbench import trace

    torch.cuda.synchronize()
    with traced(activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(trace.PHASES[1]):
            fn()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return readings(trace.from_profiler(prof), wall_ms)


def readings(tr, wall_ms):
    """What a profiled run's ``portbench.trace.Trace`` says beside its
    host-clock wall time: the device time of its operations by family
    (``FAMILIES``) and their launches, the device's busy time (the union of
    its operations) and idle share 1 - busy / wall, the GEMM's ms by tile,
    the top 15 operations by name (ms, launches), and the host's ms and
    calls in each of ``portbench/spans.py``'s synchronising runtime calls,
    with the read-backs' share of them (``host_sync_wait_ms``: all but the
    device synchronizes); "not measured" when it holds no device
    operation."""
    from portbench import spans

    if not tr.device_ops:
        return {"wall_ms": wall_ms, "device": "not measured",
                "device_ms_by_kernel": "not measured"}
    by = {f: 1e3 * tr.op_seconds(keys) for f, keys in FAMILIES.items()}
    by["other"] = 1e3 * tr.op_seconds(
        [k for keys in FAMILIES.values() for k in keys], exclude=True)
    launches, names = dict.fromkeys(by, 0), {}
    for name, _, _ in tr.device_ops:
        launches[family(name)] += 1
        names[name[:120]] = names.get(name[:120], 0) + 1
    waits = {name: {"ms": 0.0, "calls": 0} for name in spans.SYNCS}
    for name, s, e in spans.host_syncs(tr, [("", *tr.window)]):
        waits[name]["ms"] += 1e-3 * (e - s)
        waits[name]["calls"] += 1
    busy = 1e3 * tr.busy_s
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms, "host_waits": waits,
            "host_sync_wait_ms": (
                sum(w["ms"] for name, w in waits.items()
                    if name != "cudaDeviceSynchronize")
                if any(w["calls"] for w in waits.values())
                else "not measured"),
            "device_ms_by_kernel": by, "device_launches_by_kernel": launches,
            "gemm_device_ms_by_tile": {t: 1e3 * tr.op_seconds([t])
                                       for t in FAMILIES["gemm"]},
            "top_kernels": [{"name": name, "ms": 1e3 * s,
                             "launches": names[name]}
                            for name, s in tr.top_ops(15)]}
