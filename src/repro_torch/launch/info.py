"""Arch/cell inspector: params, active params, shape applicability, memory
options.  The twin of ``src/repro/launch/info.py``: the same table, line
for line.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.info            # all archs
  PYTHONPATH=src python -m repro_torch.launch.info --arch yi-6b
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ALL_SHAPES, get_arch, list_archs, shape_applicable

__all__ = ["arch_row", "main"]


def arch_row(name: str) -> str:
    cfg = get_arch(name)
    n = cfg.param_count()
    na = cfg.active_param_count()
    shapes = []
    for s in ALL_SHAPES:
        ok, _ = shape_applicable(cfg, s)
        shapes.append(s.name if ok else f"~~{s.name}~~")
    memo = []
    if cfg.fsdp:
        memo.append("fsdp")
    if cfg.zero1:
        memo.append("zero1")
    if cfg.optimizer != "adamw":
        memo.append(cfg.optimizer)
    return (
        f"| {name} | {cfg.family} | {cfg.num_layers} | {cfg.d_model} "
        f"| {n/1e9:.1f}B | {na/1e9:.2f}B | {' '.join(shapes)} "
        f"| {','.join(memo) or '—'} |"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else [
        a for a in list_archs() if a != "paper-gemm"
    ]
    print("| arch | family | L | d_model | params | active | shapes (~~skip~~) | memory opts |")
    print("|---|---|---|---|---|---|---|---|")
    for a in archs:
        print(arch_row(a))


if __name__ == "__main__":
    main()
