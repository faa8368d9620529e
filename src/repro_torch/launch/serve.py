"""Batched serving loop: prefill + decode with a KV cache (or, for an
SSM stack such as mamba2-370m, a per-layer SSM and conv state cache).
MoE archs (qwen3-moe-30b-a3b, arctic-480b) serve through the same loop,
their expert FFNs on the batched GEMM kernel; jamba's hybrid stack with
its mixed cache (k/v a super-block, SSM and conv states a Mamba
sub-layer); gemma3's local / global windows and danube's rolling
sliding-window cache; qwen2's qkv bias.  Embedding-input archs (qwen2-vl,
hubert) and encoders (hubert) are refused, as the reference refuses them.

A deliberately small but real serving loop: requests arrive with prompts,
are padded into a batch, prefilled token by token through the decode step
(building the cache), then decoded token by token with greedy or
temperature sampling.  Every GEMM and the decode attention cross the
offload seam (``repro_torch.core.dispatch``), so an ``offload_policy`` with
``use_kernels=True`` runs them on the hand-written CUDA kernels.

``serve_cluster`` scales the loop to the modeled multi-device cluster with
placement as a first-class concept: each batch's prefill is placed by the
active scheduler, and the KV cache it builds is **pinned** there as a
:class:`~repro_torch.core.hero.DeviceHandle` (a device-residency token).
Decode placement then goes through ``cluster.assign(..., handle=...)`` —
the ``cost-aware`` scheduler sees the residency credit and routes the
decode batch to the device holding its cache (skipping the modeled copy
region); placement-oblivious schedulers (``round-robin``) do not, and pay a
modeled ``d2d_copy`` migration when decode lands elsewhere.  The un-pinned
baseline (``pin_caches=False``) models the cache draining to host DRAM
after prefill, so decode pays a full host re-stage.  Cluster throughput is
the modeled-parallel makespan — the max device lane, not the sum.  The
devices are modeled lanes: every batch computes on the one torch device.

Runs on the card unless the caller passes ``device="cpu"``; asking for the
card where there is none raises.  ``--stream`` runs the streaming engine
(``launch/streaming.py``) on a bursty trace instead, on modeled time alone.
``forward_mode="graph"``
(``--forward-mode graph``) runs each decode step's dense FFN as an ``hnp``
graph with the residual fused into its launch, as the reference serves in
graph mode.  The CLI serves the arch's reduced config, as the reference's
CLI does, with every eligible op on the kernels:

    python -m repro_torch.launch.serve --arch yi-6b --batch 8 [--forward-mode graph]
    python -m repro_torch.launch.serve --arch mamba2-370m
    python -m repro_torch.launch.serve --arch yi-6b --stream --qps 100 --duration 1
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b [--device cpu]
    python -m repro_torch.launch.serve --arch jamba-1.5-large-398b
    python -m repro_torch.launch.serve --arch gemma3-27b
    python -m repro_torch.launch.serve --arch h2o-danube-1.8b   # or qwen2-72b
    python -m repro_torch.launch.serve --arch yi-6b --devices 4 \
        --num-batches 4 --scheduler cost-aware [--no-pin-caches]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_arch
from repro_torch.core import cost_model as cm
from repro_torch.core.hero import DeviceHandle, engine, offload_policy
from repro_torch.launch import costing
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model

__all__ = ["ClusterServeResult", "ServeResult", "resolve_device",
           "serve_batch", "serve_cluster"]


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray          # (B, max_new)
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def resolve_device(device) -> torch.device:
    """The torch device to serve on; raises if the card was asked for and
    there is none (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_prefill(serve_step, params, cache, prompts: List[List[int]], device):
    """Prefill token by token through the decode path (correct for rolling
    caches; a fused prefill kernel is a perf option)."""
    bsz = len(prompts)
    max_prompt = max(len(p) for p in prompts)
    padded = np.zeros((bsz, max_prompt), np.int64)
    for b, p in enumerate(prompts):
        padded[b, :len(p)] = p
    tokens = torch.from_numpy(padded).to(device)
    t0 = time.perf_counter()
    logits = None
    for t in range(max_prompt):
        logits, cache = serve_step(params, cache, tokens[:, t:t + 1], t)
    _sync(device)
    return logits, cache, time.perf_counter() - t0


def _run_decode(
    serve_step, params, cache, logits, *, start_pos: int,
    max_new_tokens: int, temperature: float, seed: int, device,
):
    """Greedy/temperature sampling loop from a prefilled cache.  Greedy
    picks stay on the device; temperature sampling draws on the host with
    the reference's numpy generator."""
    bsz = logits.shape[0]
    rng = np.random.default_rng(seed)
    out = torch.zeros((bsz, max_new_tokens), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    for i in range(max_new_tokens):
        if temperature > 0:
            lf = logits.float().cpu().numpy()
            p = np.exp((lf - lf.max(-1, keepdims=True)) / temperature)
            p /= p.sum(-1, keepdims=True)
            nxt = torch.tensor(
                [rng.choice(lf.shape[-1], p=p[b]) for b in range(bsz)],
                dtype=torch.int64, device=device,
            )
        else:
            nxt = logits.float().argmax(-1)
        out[:, i] = nxt
        logits, cache = serve_step(params, cache, nxt[:, None], start_pos + i)
    _sync(device)
    return out.cpu().numpy().astype(np.int32), cache, time.perf_counter() - t0


def serve_batch(
    arch: Union[str, ArchConfig],
    prompts: List[List[int]],
    *,
    smoke: bool = True,
    max_new_tokens: int = 16,
    cache_len: int = 128,
    temperature: float = 0.0,
    seed: int = 0,
    params=None,
    device="cuda",
    forward_mode: Optional[str] = None,
) -> ServeResult:
    """Serve one batch of prompts; ``params`` (on ``device``) defaults to
    random weights from a generator seeded with ``seed``.  ``arch`` is a
    registered name or a config (e.g. a published one cut in depth to fit
    the card); ``smoke`` serves its reduced twin.  ``forward_mode``
    ("eager" / "graph") overrides the config's."""
    dev, model, params = _setup(arch, smoke, forward_mode, params, seed,
                                device)

    bsz = len(prompts)
    max_prompt = max(len(p) for p in prompts)
    cache = model.init_decode_cache(bsz, cache_len, device=dev)
    serve_step = make_serve_step(model)

    with torch.no_grad():
        logits, cache, prefill_s = _run_prefill(
            serve_step, params, cache, prompts, dev)
        out, cache, decode_s = _run_decode(
            serve_step, params, cache, logits, start_pos=max_prompt,
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, device=dev,
        )
    return ServeResult(
        tokens=out,
        prefill_s=prefill_s,
        decode_s=decode_s,
        tokens_per_s=bsz * max_new_tokens / max(decode_s, 1e-9),
    )


def _setup(arch, smoke, forward_mode, params, seed, device):
    """(torch device, model, params) for one serving call."""
    dev = resolve_device(device)
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    if forward_mode is not None:
        cfg = dataclasses.replace(cfg, forward_mode=forward_mode)
    if not cfg.embed_inputs:
        raise ValueError("serving driver targets token-input archs")
    if cfg.is_encoder:
        raise ValueError("encoder-only arch has no decode step")
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init_params(gen, device=dev)
    return dev, model, params


@dataclasses.dataclass
class ClusterServeResult:
    """One multi-device serving round."""

    results: List[ServeResult]            # one per request batch
    placements: List[int]                 # batch index -> decode device id
    prefill_placements: List[int]         # batch index -> prefill device id
    # Device holding each cache when its decode batch was *placed*
    # (-1 = unstaged to host); differs from `placements` exactly when the
    # scheduler strayed from the cache and a move was paid.
    cache_devices: List[int]
    per_device_s: Dict[int, float]        # modeled busy seconds per device
    makespan_s: float                     # modeled wall-clock (max lane)
    total_tokens: int
    tokens_per_s: float                   # modeled cluster throughput
    d2d_s: float = 0.0                    # modeled cache-migration seconds
    restage_s: float = 0.0                # modeled host re-stage seconds


def _cache_nbytes(cache: Dict[str, torch.Tensor]) -> float:
    """Total bytes of the KV/state cache (the pinned buffer size): the sum
    over the cache dict's tensors, equal to the reference's sum over its
    cache pytree's leaves."""
    return float(sum(t.numel() * t.element_size() for t in cache.values()))


def _prefill_cost(prompts: List[List[int]], cfg) -> cm.OpCost:
    """Batch-path adapter over the shared costed-step helper
    (:mod:`repro_torch.launch.costing`): every prompt token runs the
    stack's GEMMs, collapsed to one cost the scheduler can weigh."""
    return costing.prefill_cost(sum(len(p) for p in prompts), cfg)


def _decode_cost(
    bsz: int, max_new_tokens: int, cache_bytes: float, cfg
) -> cm.OpCost:
    """Batch-path adapter over :func:`repro_torch.launch.costing.decode_cost`
    — the whole decode phase's tokens with the KV cache riding staged
    bytes, the asymmetry the ``cost-aware`` scheduler keys on to route
    decode batches to the cache-holding device."""
    return costing.decode_cost(bsz * max_new_tokens, cache_bytes, cfg)


def serve_cluster(
    arch: str,
    request_batches: List[List[List[int]]],
    *,
    smoke: bool = True,
    max_new_tokens: int = 16,
    cache_len: int = 128,
    temperature: float = 0.0,
    seed: int = 0,
    pin_caches: bool = True,
    forward_mode: Optional[str] = None,
    params=None,
    device="cuda",
) -> ClusterServeResult:
    """Serve concurrent request batches across the HeroCluster's devices.

    Two placement rounds per batch, both through the active scheduler:

    1. **Prefill** is placed by workload (prompt tokens x stack GEMMs) and
       executed with the cluster pinned to its lane; the KV cache it builds
       is pinned there as a :class:`DeviceHandle` (``pin_caches=True``) or
       drained back to host DRAM (``pin_caches=False``).
    2. **Decode** is placed with ``assign(..., handle=...)``: a
       placement-affine scheduler routes it to the cache holder (no cache
       movement); landing elsewhere costs a modeled ``d2d_copy`` migration,
       and an unstaged cache costs a full host re-stage — both recorded on
       the decode lane's trace.

    All request batches are modeled as in flight concurrently — every KV
    cache stays live from its prefill to its decode, as on a real server
    holding resident caches per device.

    Devices run batches sequentially within a lane; lanes run in parallel
    — the modeled makespan is the longest lane.  Lane seconds are model
    units throughout (batch-level cost-model breakdowns plus explicit cache
    moves, never wall clock): the batch cost the scheduler placed is the
    lane measure, not the fine-grained per-op records.

    ``params`` (on ``device``) defaults to random weights from a generator
    seeded with ``seed``; one set of weights serves every batch.  The
    modeled devices are lanes of the cost model: every batch computes on
    ``device`` (the card unless ``device="cpu"``).
    """
    dev, model, params = _setup(arch, smoke, forward_mode, params, seed,
                                device)
    cfg = model.cfg
    cluster = engine()
    serve_step = make_serve_step(model)

    per_device_s: Dict[int, float] = {}
    prefill_placements: List[int] = []
    handles: List[DeviceHandle] = []
    sessions = []  # (logits, cache, prefill_s, max_prompt)

    results: List[ServeResult] = []
    placements: List[int] = []
    cache_devices: List[int] = []
    total_tokens = 0
    d2d_s = 0.0
    restage_s = 0.0
    try:
        # ---- round 1: prefill placement + execution, caches pinned ------
        for i, prompts in enumerate(request_batches):
            cache = model.init_decode_cache(len(prompts), cache_len,
                                            device=dev)
            p_dev, p_bd = cluster.assign(
                _prefill_cost(prompts, cfg), shape_key=f"serve-prefill-{i}"
            )
            prefill_placements.append(p_dev)
            with cluster.pin_device(p_dev), torch.no_grad():
                logits, cache, prefill_s = _run_prefill(
                    serve_step, params, cache, prompts, dev
                )
            per_device_s[p_dev] = per_device_s.get(p_dev, 0.0) + p_bd.offload_s
            handle = cluster.pin_handle(
                f"kv-cache-{i}", _cache_nbytes(cache), device_id=p_dev
            )
            if not pin_caches:
                # baseline: the cache drains to host DRAM between phases
                cluster.unstage_handle(handle)
            handles.append(handle)
            sessions.append(
                (logits, cache, prefill_s, max(len(p) for p in prompts))
            )

        cluster.sync()  # prefill barrier: decode starts after prefills retire

        # ---- round 2: handle-affine decode placement + execution --------
        for i, prompts in enumerate(request_batches):
            logits, cache, prefill_s, max_prompt = sessions[i]
            handle = handles[i]
            d_cost = _decode_cost(
                len(prompts), max_new_tokens, handle.nbytes, cfg
            )
            d_dev, _ = cluster.assign(
                d_cost,
                shape_key=f"serve-decode-{i}",
                handle=handle if pin_caches else None,
            )
            placements.append(d_dev)
            cache_devices.append(handle.device_id if handle.valid else -1)
            # Bring the cache to the decode lane first, paying the move
            # visibly (recorded on the active trace, charged to the lane):
            move_s = 0.0
            if not handle.valid:
                # unstaged cache: full host->device copy on this lane
                move_s = cluster.restage_handle(
                    handle, device_id=d_dev
                ).offload_s
                restage_s += move_s
            elif handle.device_id != d_dev:
                # pinned elsewhere: migrate over the d2d link
                move_s = cluster.migrate_handle(handle, d_dev).offload_s
                d2d_s += move_s
            with cluster.pin_device(d_dev), torch.no_grad():
                out, cache, decode_s = _run_decode(
                    serve_step, params, cache, logits, start_pos=max_prompt,
                    max_new_tokens=max_new_tokens, temperature=temperature,
                    seed=seed, device=dev,
                )
            # Not assign()'s breakdown: that one was scored before the move,
            # so a strayed/unstaged cache still counted in its copy region.
            # Now the cache is resident on the lane — the decode breakdown
            # takes the credit and the movement cost was added explicitly.
            lane_s = move_s + cluster.device(d_dev).breakdown_for(
                d_cost, cluster.policy, handle.name
            ).offload_s
            per_device_s[d_dev] = per_device_s.get(d_dev, 0.0) + lane_s
            results.append(ServeResult(
                tokens=out,
                prefill_s=prefill_s,
                decode_s=decode_s,
                tokens_per_s=(
                    len(prompts) * max_new_tokens / max(decode_s, 1e-9)
                ),
            ))
            total_tokens += len(prompts) * max_new_tokens

        cluster.sync()  # retire the batch tickets (modeled barrier)
    finally:
        # never leak handles into the singleton engine, even on failure
        for h in handles:
            cluster.release_handle(h)
    makespan_s = max(per_device_s.values(), default=0.0)
    return ClusterServeResult(
        results=results,
        placements=placements,
        prefill_placements=prefill_placements,
        cache_devices=cache_devices,
        per_device_s=per_device_s,
        makespan_s=makespan_s,
        total_tokens=total_tokens,
        tokens_per_s=total_tokens / max(makespan_s, 1e-9),
        d2d_s=d2d_s,
        restage_s=restage_s,
    )


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    # 8, not the reference's 4: decode GEMMs have m = batch, and the GEMM
    # kernel's eligibility gate is min(m, n, k) >= 8.
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--forward-mode", choices=("eager", "graph"),
                    default="eager",
                    help="graph: each decode step's dense FFN as an hnp graph")
    # Cluster mode: request batches over modeled devices (serve_cluster).
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--num-batches", type=int, default=1)
    ap.add_argument("--scheduler", default="least-loaded",
                    choices=["round-robin", "least-loaded", "cost-aware"])
    ap.add_argument("--policy-mode", default="device",
                    choices=["host", "device", "auto"],
                    help="offload routing policy for the cluster run")
    ap.add_argument("--no-pin-caches", action="store_true",
                    help="baseline: caches drain to host between phases")
    # Streaming mode: the continuous-batching engine over a live arrival
    # process (modeled: no model is built and nothing runs on a device).
    ap.add_argument("--stream", action="store_true",
                    help="run the streaming engine on a bursty trace")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="offered load for --stream (requests/s)")
    ap.add_argument("--duration", type=float, default=1.0,
                    help="trace duration for --stream (modeled seconds)")
    args = ap.parse_args(argv)
    if args.stream:
        from repro_torch.launch.streaming import (
            StreamConfig, bursty_trace, serve_stream,
        )

        # 1 prefill lane + >=1 decode lanes: at least 4 modeled devices.
        cfg = StreamConfig(
            num_devices=max(args.devices, 4), scheduler=args.scheduler
        )
        trace = bursty_trace(args.qps, args.duration, seed=args.seed)
        rep = serve_stream(args.arch, trace, config=cfg)
        o = rep.slo.overall
        print(f"streaming {args.arch}: offered {rep.offered_qps:.4g} qps "
              f"-> sustained {rep.sustained_qps:.4g} qps "
              f"(reject {rep.reject_rate:.1%}, "
              f"ttft p99 {o.ttft.p99_s * 1e3:.1f}ms, "
              f"per-token p99 {o.per_token.p99_s * 1e3:.2f}ms, "
              f"meets SLO: {rep.slo.meets_slo}) (modeled)")
        return
    rng = np.random.default_rng(args.seed)
    if args.devices > 1 or args.num_batches > 1:
        batches = [
            [list(rng.integers(1, 200, size=args.prompt_len))
             for _ in range(args.batch)]
            for _ in range(args.num_batches)
        ]
        with offload_policy(mode=args.policy_mode, use_kernels=True,
                            num_devices=args.devices,
                            scheduler=args.scheduler):
            res = serve_cluster(
                args.arch, batches, max_new_tokens=args.max_new,
                temperature=args.temperature, seed=args.seed,
                pin_caches=not args.no_pin_caches,
                forward_mode=args.forward_mode, device=args.device,
            )
        print(f"{len(batches)} batches over {args.devices} devices "
              f"({args.scheduler}): prefill={res.prefill_placements} "
              f"decode={res.placements} "
              f"makespan={res.makespan_s:.6g}s "
              f"d2d={res.d2d_s:.3g}s restage={res.restage_s:.3g}s "
              f"{res.tokens_per_s:.4g} tok/s (modeled)")
        return
    prompts = [list(rng.integers(1, 200, size=args.prompt_len))
               for _ in range(args.batch)]
    # Every eligible op goes to the hand-written kernels (on CPU tensors the
    # wrappers take their plain versions).
    with offload_policy(mode="device", use_kernels=True):
        res = serve_batch(
            args.arch, prompts, max_new_tokens=args.max_new,
            temperature=args.temperature, seed=args.seed, device=args.device,
            forward_mode=args.forward_mode,
        )
    print(f"prefill {res.prefill_s:.2f}s decode {res.decode_s:.2f}s "
          f"{res.tokens_per_s:.1f} tok/s")
    print(res.tokens)


if __name__ == "__main__":
    main()
