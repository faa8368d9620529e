"""Batched serving driver: prefill + decode with a KV cache.

A deliberately small but real serving loop: requests arrive with prompts,
are padded into a batch, prefilled token by token through the decode step
(building the cache), then decoded token by token with greedy or
temperature sampling.  Every GEMM and the decode attention cross the
offload seam (``repro_torch.core.dispatch``), so an ``offload_policy`` with
``use_kernels=True`` runs them on the hand-written CUDA kernels.

Runs on the card unless the caller passes ``device="cpu"``; asking for the
card where there is none raises.  ``serve_cluster`` and the streaming
engine (``--stream``) arrive with ``launch/costing.py`` and
``launch/streaming.py``.  ``forward_mode="graph"`` (``--forward-mode
graph``) runs each decode step's dense FFN as an ``hnp`` graph with the
residual fused into its launch, as the reference serves in graph mode.
The CLI serves the arch's reduced config, as the reference's CLI does, with
every eligible op on the kernels:

    python -m repro_torch.launch.serve --arch yi-6b --batch 8 [--forward-mode graph]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.hero import offload_policy
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model

__all__ = ["ServeResult", "resolve_device", "serve_batch"]


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
    arch: str,
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
    random weights from a generator seeded with ``seed``.  ``forward_mode``
    ("eager" / "graph") overrides the config's."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
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
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
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
