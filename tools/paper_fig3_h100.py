#!/usr/bin/env python3
"""The paper's Fig. 3 measured on a card: host GEMM against offloaded GEMM.

    python3 tools/paper_fig3_h100.py [--out artifacts/paper_fig3.json]

For each n of ``configs/paper_gemm.py``'s ``PAPER_SIZES`` and for f64 (the
paper's dtype), f32 and bf16, one square GEMM C = A @ B from numpy in to
numpy out:

- **host**: numpy's ``A @ B`` on the host CPU (NumPy over the BLAS it
  links, the paper's host path); bf16 rows multiply the bf16-rounded
  values in f32, numpy having no bf16.
- **offload**: ``repro_torch.core.blas.gemm`` under
  ``offload_policy(mode="device", use_kernels=True)``, split the paper's
  way: *copy* (H2D of A and B, D2H of C, by CUDA events; bf16 rows cast on
  the card inside those events), *compute* (the GEMM's device time per
  call, back to back on a parked stream, by CUDA events), *launch /
  fork-join* (the end-to-end host-clock time less copy and compute: the
  seam's host work, the launch latency and the joins) and *total* (host
  clock, numpy in to numpy out).  ``dispatch_ms`` is the host time of the
  ``blas.gemm`` call alone; ``library_ms`` one ``torch.matmul`` of the
  same device operands (cuBLAS, TF32 off), timed as *compute* is.
- The backend each call reached (f64 the plain ``device`` path: the
  kernel gate takes f32 / bf16 only; f32 n = 16 the ``skinny`` kernel
  route, n >= 32 ``tf32x3``; bf16 n = 16 ``skinny``, n >= 32 ``wgmma``),
  each result against numpy's f64 product (bars f64 1e-12, f32 2e-5, bf16
  2e-2, scaled by max |ref|), the speed-up host / total, and the first n
  (doubling from 128 up to 4096) at which the offload beats the host in
  f64 and in f32, each step of that sweep with its compute and
  ``torch.matmul`` (``library_ms``) times.
- Beside each measured row, the cost model's breakdown of the same GEMM
  on ``h100-sxm`` (an uncalibrated data-sheet row) and on ``hesoc-vcu128``
  (the paper's board): labelled modeled, never a measurement.

Needs a card: exits non-zero without one.  ``run()`` is what
``chip_smoke.py``'s ``paper-fig3`` phase calls; it raises on a missed bar
or a stray route.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

DTYPES = ("float64", "float32", "bfloat16")
BARS = {"float64": 1e-12, "float32": 2e-5, "bfloat16": 2e-2}
CROSSOVER_SIZES = (128, 256, 512, 1024, 2048, 4096)
MODELED_PLATFORMS = ("h100-sxm", "hesoc-vcu128")


def want_route(dtype: str, n: int):
    """(trace backend, kernel route or None) the call must reach."""
    if dtype == "float64":
        return "device", None
    if n <= 16:
        return "device-kernel", "skinny"
    return "device-kernel", "tf32x3" if dtype == "float32" else "wgmma"


def blas_info() -> dict:
    """The BLAS numpy links (``numpy.show_config``) and its thread count."""
    import numpy as np

    info = {"numpy": np.__version__, "cpu_count": os.cpu_count()}
    try:
        deps = np.show_config(mode="dicts").get("Build Dependencies", {})
        info["blas"] = deps.get("blas", {})
    except TypeError:                      # numpy < 1.25: no dict mode
        info["blas"] = "not reported"
    info["threads"] = _openblas_threads()
    info["env"] = {k: os.environ[k] for k in ("OPENBLAS_NUM_THREADS",
                                              "OMP_NUM_THREADS")
                   if k in os.environ}
    return info


def _openblas_threads():
    """OpenBLAS's thread count through its C entry point, found in the
    libraries this process has loaded."""
    import ctypes

    try:
        maps = pathlib.Path("/proc/self/maps").read_text().splitlines()
    except OSError:
        return "not reported"
    libs = sorted({ln.split()[-1] for ln in maps
                   if "openblas" in ln.lower() and ".so" in ln})
    for lib in libs:
        handle = ctypes.CDLL(lib)
        for sym in ("scipy_openblas_get_num_threads64_",
                    "openblas_get_num_threads64_",
                    "openblas_get_num_threads"):
            fn = getattr(handle, sym, None)
            if fn is not None:
                return [{"library": lib, "symbol": sym,
                         "num_threads": int(fn())}]
    return "not reported"


def _median_s(fn, reps: int) -> float:
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs)


def host_ms(a, b) -> float:
    """Median host-clock ms of numpy's ``a @ b``, in loops long enough to
    resolve a microsecond call."""
    a @ b
    t0 = time.perf_counter()
    a @ b
    once = time.perf_counter() - t0
    inner = max(1, min(2000, int(2e-3 / max(once, 1e-7))))

    def loop():
        for _ in range(inner):
            a @ b

    return 1e3 * _median_s(loop, 7 if inner > 1 else 5) / inner


def _device_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``: the card parked on a spin kernel while
    the host queues ``iters`` calls, then CUDA events around them back to
    back (host dispatch does not count)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def modeled(n: int, itemsize: int) -> dict:
    """The cost model's serial three-region breakdown of one n x n x n
    GEMM on each of MODELED_PLATFORMS (ms; modeled, not measured)."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.platform import get_platform

    out = {}
    for name in MODELED_PLATFORMS:
        bd = cm.breakdown(cm.gemm_cost(n, n, n, itemsize), get_platform(name))
        out[name] = {"host_ms": 1e3 * bd.host_s, "copy_ms": 1e3 * bd.copy_s,
                     "fork_join_ms": 1e3 * bd.fork_join_s,
                     "compute_ms": 1e3 * bd.compute_s,
                     "offload_ms": 1e3 * bd.offload_s,
                     "speedup": bd.speedup}
    return out


def measure(n: int, dtype: str, rng, *, check: bool = True,
            reps: int = 25) -> dict:
    """One Fig. 3 row (see the module docstring); raises if ``check`` and
    the result misses its bar or the call its backend / route."""
    import numpy as np
    import torch

    from repro_torch.core import blas
    from repro_torch.core.accounting import offload_trace
    from repro_torch.kernels.gemm import gemm as gemm_kernel

    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    if dtype == "bfloat16":            # values the card's bf16 holds exactly
        a, b = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                for x in (a, b))
    np_dt = np.float64 if dtype == "float64" else np.float32
    a, b = a.astype(np_dt), b.astype(np_dt)
    ref = a.astype(np.float64) @ b.astype(np.float64)

    def stage_in():
        ta = torch.from_numpy(a).to(dev)
        tb = torch.from_numpy(b).to(dev)
        if dtype == "bfloat16":
            ta, tb = ta.to(tdt), tb.to(tdt)
        return ta, tb

    def stage_out(c):
        return (c.float() if dtype == "bfloat16" else c).cpu().numpy()

    def offload():
        ta, tb = stage_in()
        return stage_out(blas.gemm(ta, tb))

    # The route check: one call, traced, its kernel launches counted.
    before = dict(gemm_kernel.route_launches)
    launches = gemm_kernel.launches
    with offload_trace() as trace:
        got = offload()
    moved = {r: k - before[r] for r, k in gemm_kernel.route_launches.items()}
    backend, route = want_route(dtype, n)
    seen = sorted({r.backend for r in trace.records})
    took = [r for r, k in moved.items() if k]
    if check:
        if seen != [backend]:
            raise AssertionError(f"paper-fig3 {dtype} n={n}: backend {seen}, "
                                 f"want {backend}")
        want_moved = ([route] if route else [])
        if took != want_moved or any(k > 1 for k in moved.values()) or \
                gemm_kernel.launches - launches != len(want_moved):
            raise AssertionError(f"paper-fig3 {dtype} n={n}: kernel routes "
                                 f"{moved}, want {route}")
    err = float(np.abs(got.astype(np.float64) - ref).max()
                / np.abs(ref).max())
    if check and not err <= BARS[dtype]:
        raise AssertionError(f"paper-fig3 {dtype} n={n}: error {err} > "
                             f"{BARS[dtype]}")

    for _ in range(3):                 # warm the allocator and the seam
        offload()
    total_s = _median_s(offload, reps)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    copies = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ev[0].record()
        ta, tb = stage_in()
        ev[1].record()
        c = blas.gemm(ta, tb)
        torch.cuda.synchronize()
        ev[2].record()
        stage_out(c)
        ev[3].record()
        torch.cuda.synchronize()
        copies.append(ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3]))
    copy_ms = statistics.median(copies)

    ta, tb = stage_in()
    torch.cuda.synchronize()
    disp = []
    for _ in range(reps):
        t0 = time.perf_counter()
        blas.gemm(ta, tb)
        disp.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    compute_ms = _device_ms(lambda: blas.gemm(ta, tb))
    library_ms = _device_ms(lambda: torch.matmul(ta, tb))

    h_ms = host_ms(a, b)
    total_ms = 1e3 * total_s
    return {"n": n, "dtype": dtype, "backend": backend, "route": route,
            "routes": moved, "max_rel_err_vs_f64": err, "bar": BARS[dtype],
            "host_ms": h_ms, "copy_ms": copy_ms,
            "launch_ms": total_ms - copy_ms - compute_ms,
            "dispatch_ms": 1e3 * statistics.median(disp),
            "compute_ms": compute_ms, "library_ms": library_ms,
            "total_ms": total_ms,
            "speedup": h_ms / total_ms,
            "modeled": modeled(n, torch.empty((), dtype=tdt).element_size())}


def run(*, sizes=None, crossover=True, seed: int = 0) -> dict:
    """Every row of the figure, the crossover sweep and the host's BLAS."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_gemm import PAPER_DTYPE, PAPER_SIZES
    from repro_torch.core.hero import offload_policy

    if not torch.cuda.is_available():
        raise RuntimeError("paper_fig3_h100 needs the card: "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    rows, cross = [], {}
    with offload_policy(mode="device", use_kernels=True), torch.no_grad():
        for dtype in DTYPES:
            for n in sizes or PAPER_SIZES:
                rows.append(measure(n, dtype, rng))
        if crossover:
            for dtype in ("float64", "float32"):
                sweep = []
                for n in CROSSOVER_SIZES:
                    r = measure(n, dtype, rng, check=False, reps=5)
                    sweep.append({k: r[k] for k in (
                        "n", "host_ms", "copy_ms", "launch_ms", "compute_ms",
                        "library_ms", "total_ms", "speedup",
                        "max_rel_err_vs_f64")})
                    if r["speedup"] > 1.0:
                        break
                won = [s["n"] for s in sweep if s["speedup"] > 1.0]
                cross[dtype] = {"first_n_offload_wins": won[0] if won
                                else None, "sweep": sweep}
    return {"paper_dtype": PAPER_DTYPE, "rows": rows, "crossover": cross,
            "host_blas": blas_info(), "card": torch.cuda.get_device_name(0)}


def table(result: dict) -> str:
    """The measured rows as text, each beside its modeled rows."""
    lines = [f"{'dtype':9s} {'n':>4s} {'host':>9s} {'copy':>9s} "
             f"{'launch':>9s} {'compute':>9s} {'total':>9s} {'speedup':>8s} "
             f"route   (ms; measured on {result['card']}; cuBLAS beside)"]
    for r in result["rows"]:
        lines.append(
            f"{r['dtype']:9s} {r['n']:4d} {r['host_ms']:9.4f} "
            f"{r['copy_ms']:9.4f} {r['launch_ms']:9.4f} "
            f"{r['compute_ms']:9.4f} {r['total_ms']:9.4f} "
            f"{r['speedup']:8.3f} {r['backend']}/{r['route']} "
            f"{r['library_ms']:.4f}")
        for plat, m in r["modeled"].items():
            lines.append(
                f"{'':9s} {'':4s} {m['host_ms']:9.4f} {m['copy_ms']:9.4f} "
                f"{m['fork_join_ms']:9.4f} {m['compute_ms']:9.4f} "
                f"{m['offload_ms']:9.4f} {m['speedup']:8.3f} modeled "
                f"{plat}")
    for dtype, c in result["crossover"].items():
        lines.append(f"{dtype}: offload first beats the host at n = "
                     f"{c['first_n_offload_wins']}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the JSON result here")
    ap.add_argument("--no-crossover", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    result = run(crossover=not args.no_crossover)
    print(table(result))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"paper_fig3": result["rows"],
                      "crossover": {k: v["first_n_offload_wins"]
                                    for k, v in result["crossover"].items()},
                      "host_blas": result["host_blas"]}))


if __name__ == "__main__":
    main()
