"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``lib<name>.so`` with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

No PyTorch header is included, so a build takes seconds, not minutes.  The
output goes to ``build/kernels/<name>-<hash>/`` under the repository root
(listed in ``.gitignore``), where ``<hash>`` covers the source, every header
``csrc/*.cuh`` (a source may include any of them) and the flags: an edited
source or header builds into a fresh directory and a stale library is never
loaded.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time; a machine without ``nvcc`` can import
every module of the package and only fails when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["KERNEL_SOURCES", "build_all", "count_launch", "library"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_ROOT = _REPO_ROOT / "build" / "kernels"

KERNEL_SOURCES: Tuple[str, ...] = ("gemm", "flash_decode", "flash_attention",
                                   "ssd_scan")

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Guards every wrapper's launch counters: a launch may come from any thread
# (a mesh device's shard_map body, autograd's backward thread), and
# ``+= 1`` on a shared counter is a read-modify-write.
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, route: str, grouped: bool = False,
                 kernels: Iterable[str] = ()) -> None:
    """One launch of ``wrapper``'s kernel on ``route``: adds one to
    ``wrapper.launches`` and ``wrapper.route_launches[route]``, to
    ``wrapper.grouped_launches`` when ``grouped`` (a GEMM tile order other
    than the plain one), and to ``wrapper.kernel_launches[k]`` for each of
    ``kernels`` (a call that launches several kernels)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.route_launches[route] += 1
        if grouped:
            wrapper.grouped_launches += 1
        for k in kernels:
            wrapper.kernel_launches[k] += 1


# Loaded libraries by kernel name (a process-wide cache of dlopen handles:
# loading the same .so twice would only return the same handle).
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels can only be built on a machine with the CUDA toolkit"
    )


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def _start(name: str, nvcc: str, verbose: bool):
    """Start one nvcc; returns (process, temp output, final path)."""
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Optional[Iterable[str]] = None, *,
              verbose: bool = False) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library yet, one
    ``nvcc`` per source in parallel.  Returns ``{name: compiler output}``
    for the sources built now (the ptxas register/shared-memory report when
    ``verbose``).  Raises ``RuntimeError`` with the compiler's output if
    any build fails."""
    names = tuple(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    jobs = {n: _start(n, nvcc, verbose) for n in todo}
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)     # atomic: a reader never sees half a .so
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
