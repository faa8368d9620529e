"""Hardware platform models for the heterogeneous BLAS offload substrate.

The paper targets an FPGA-emulated RISC-V heSoC (CVA6 host + 8-core Snitch
PMCA).  We model that platform analytically — calibrated to the paper's three
published anchors — the TPU v5e the JAX reference targets, and the NVIDIA
H100 this package runs on (``H100_SXM``, the default).

Calibration of ``HESOC_VCU128`` (see DESIGN.md §2):

  Anchors from the paper, all at n=128, float64 GEMM:
    (a) offload speedup  T_host / T_offload            = 2.71x
    (b) copy fraction    T_copy / T_offload            = 0.47
    (c) zero-copy projection: replacing the copy with IO-PTE creation
        (measured 7.5x faster than copying) brings total speedup to ~4.7x.
        With (a) and (b) exactly satisfied the model projects
        2.71 / (1 - 0.47 + 0.47/7.5) = 4.57x — the paper's 4.7x is the
        same quantity under rounding; tests assert within tolerance.

  Remaining free constants are set to plausible values for a 50 MHz
  FPGA-emulated SoC:
    host_flops   = 25 MFLOP/s  (CVA6 fpnew, ~0.5 flop/cycle @ 50 MHz)
      -> T_host(128)    = 2*128^3 / 25e6            = 167.8 ms
      -> T_offload(128) = T_host / 2.71             =  61.9 ms
      -> T_copy(128)    = 0.47 * T_offload          =  29.1 ms
         bytes(128)     = 3 * 128^2 * 8             = 393 216 B
         copy_bw        = bytes / T_copy            ~ 13.5 MB/s
         (memcpy into the uncached, manually-managed device-DRAM
          partition through Linux on a 50 MHz in-order core)
    fork_join_s  = 10% of offload time at n=128     ~ 6.19 ms
         (OpenMP target enter/exit + Hero kernel-module ioctls)
      -> T_compute(128) = remaining 43%             =  26.6 ms
         dev_flops      = 2*128^3 / T_compute       ~ 157.5 MFLOP/s
         (20% of the 800 MFLOP/s Snitch-cluster peak at 50 MHz —
          DMA-refill bound at these small tiles, per the paper's
          "compute = DMA copies local data and processes in SPM")
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "Platform",
    "HESOC_VCU128",
    "TPU_V5E",
    "CPU_HOST",
    "H100_SXM",
    "get_platform",
]


@dataclasses.dataclass(frozen=True)
class Platform:
    """Analytic description of a host + accelerator pair.

    Times are modeled with the paper's three-region decomposition:

      T_offload = T_copy(bytes) + T_fork_join + T_compute(flops, bytes)
      T_host    = flops / host_flops

    ``dev_flops``/``dev_mem_bw`` bound compute by whichever is slower
    (roofline); ``copy_bw`` charges host<->device staging for non-resident
    buffers; ``fork_join_s`` is the constant launch/teardown overhead.
    """

    name: str
    # Host (scalar) execution rate, FLOP/s.
    host_flops: float
    # Device peak compute, FLOP/s (per chip for TPU).
    dev_flops: float
    # Device local/main memory bandwidth, B/s (HBM for TPU, SPM-DMA for heSoC).
    dev_mem_bw: float
    # Host <-> device staging bandwidth, B/s (device-DRAM memcpy / PCIe).
    copy_bw: float
    # Constant per-offload overhead, seconds (OpenMP fork/join, kernel launch).
    fork_join_s: float
    # Local scratch memory per compute unit, bytes (SPM / VMEM).
    local_mem_bytes: int
    # Inter-chip interconnect bandwidth per link, B/s (TPU ICI); 0 if N/A.
    ici_bw: float = 0.0
    # Zero-copy staging speedup (paper: IO-PTE creation 7.5x faster than copy).
    zero_copy_speedup: float = 7.5
    # Number of chips (for pod-level roofline math).
    chips: int = 1
    # Device-to-device copy bandwidth, B/s (ticket/cache migration between
    # PMCAs).  0 means "fall back": ICI if present, else staging through the
    # host at copy_bw (the heSoC has no direct PMCA-to-PMCA path).
    d2d_bw: float = 0.0
    # Natural DMA staging-chunk size for double-buffered (pipelined) h2d
    # transfers, bytes.  Half the local scratch is the classic bound (one
    # buffer computes while the other refills); 0 disables chunked staging
    # (single-chunk transfers — e.g. the CPU "device" shares the host
    # address space, there is nothing to overlap).
    dma_chunk_bytes: int = 0

    # ---- region models -------------------------------------------------
    def t_host(self, flops: float) -> float:
        return flops / self.host_flops

    def t_copy(self, bytes_moved: float, *, zero_copy: bool = False) -> float:
        t = bytes_moved / self.copy_bw
        if zero_copy:
            t = t / self.zero_copy_speedup
        return t

    def t_fork_join(self) -> float:
        return self.fork_join_s

    def t_d2d(self, bytes_moved: float) -> float:
        """Device-to-device transfer time for a migrating resident buffer."""
        bw = self.d2d_bw or self.ici_bw
        if bw <= 0:
            # no direct link: bounce through host staging, paying both hops
            return 2.0 * bytes_moved / self.copy_bw
        return bytes_moved / bw

    def t_compute(self, flops: float, bytes_touched: float) -> float:
        """Device compute region under a two-term roofline."""
        return max(flops / self.dev_flops, bytes_touched / self.dev_mem_bw)

    def t_offload(
        self,
        flops: float,
        staged_bytes: float,
        touched_bytes: float,
        *,
        zero_copy: bool = False,
    ) -> float:
        return (
            self.t_copy(staged_bytes, zero_copy=zero_copy)
            + self.t_fork_join()
            + self.t_compute(flops, touched_bytes)
        )


# --------------------------------------------------------------------------
# The paper's platform: CVA6 host + 8x Snitch PMCA on a Xilinx VCU128.
# Constants derived from the paper's anchors — see module docstring.
# --------------------------------------------------------------------------
_N = 128
_FLOPS_128 = 2.0 * _N**3               # 4_194_304
_BYTES_128 = 3.0 * _N**2 * 8           # A, B in + C out, float64
_T_HOST_128 = _FLOPS_128 / 25.0e6      # 167.77 ms
_T_OFF_128 = _T_HOST_128 / 2.71        # 61.91 ms
_T_COPY_128 = 0.47 * _T_OFF_128        # 29.10 ms
_T_FORK = 0.10 * _T_OFF_128            # 6.19 ms
_T_COMP_128 = _T_OFF_128 - _T_COPY_128 - _T_FORK

HESOC_VCU128 = Platform(
    name="hesoc-vcu128",
    host_flops=25.0e6,
    dev_flops=_FLOPS_128 / _T_COMP_128,          # ~157.5 MFLOP/s effective
    dev_mem_bw=64.0e6,                           # DMA SPM refill; not binding @128
    copy_bw=_BYTES_128 / _T_COPY_128,            # ~13.5 MB/s
    fork_join_s=_T_FORK,
    local_mem_bytes=128 * 1024,                  # 128 KiB SPM
    zero_copy_speedup=7.5,
    dma_chunk_bytes=64 * 1024,                   # SPM/2 double-buffer halves
)

# --------------------------------------------------------------------------
# TPU v5e — the framework's real target (per-chip numbers).
# --------------------------------------------------------------------------
TPU_V5E = Platform(
    name="tpu-v5e",
    host_flops=2.0e11,            # XLA:CPU host fallback ballpark (not used for scoring)
    dev_flops=197.0e12,           # bf16 MXU peak
    dev_mem_bw=819.0e9,           # HBM
    copy_bw=32.0e9,               # PCIe gen4 x16 host->HBM staging
    fork_join_s=3.0e-6,           # fused-graph launch overhead
    local_mem_bytes=128 * 1024 * 1024,   # VMEM
    ici_bw=50.0e9,                # per link
    zero_copy_speedup=1.0e9,      # resident buffers: staging cost ~ 0
    d2d_bw=50.0e9,                # cache migration rides the ICI
    dma_chunk_bytes=4 * 1024 * 1024,   # Pallas-pipeline tile granularity
)

# CPU host-only platform (this container) — used for interpret-mode runs.
CPU_HOST = Platform(
    name="cpu-host",
    host_flops=5.0e9,
    dev_flops=5.0e9,
    dev_mem_bw=20.0e9,
    copy_bw=1.0e12,               # same address space
    fork_join_s=0.0,
    local_mem_bytes=32 * 1024 * 1024,
)

# --------------------------------------------------------------------------
# NVIDIA H100 SXM — this package's target.  UNCALIBRATED: every constant is
# a data-sheet peak or a guess, not a measurement; the measured kernel and
# copy times live in PERF.md and have not been fitted back into this row.
# --------------------------------------------------------------------------
H100_SXM = Platform(
    name="h100-sxm",
    host_flops=1.0e12,            # host-CPU torch GEMM ballpark (guess)
    dev_flops=989.0e12,           # bf16 dense tensor-core peak (data sheet)
    dev_mem_bw=3.35e12,           # HBM3 (data sheet)
    copy_bw=64.0e9,               # PCIe gen5 x16, one direction (data sheet)
    fork_join_s=5.0e-6,           # kernel launch + sync overhead (guess)
    local_mem_bytes=232_448,      # shared memory one block may use
    zero_copy_speedup=1.0,        # mapped host memory still crosses PCIe
    d2d_bw=450.0e9,               # NVLink, one direction
    # One k-step of the tiled GEMM kernel's shared-memory operand tiles
    # (csrc/gemm.cu: a 64x16 and a 16x64 fp32 tile).
    dma_chunk_bytes=8 * 1024,
)

_REGISTRY = {p.name: p for p in (HESOC_VCU128, TPU_V5E, CPU_HOST, H100_SXM)}


def get_platform(name: str) -> Platform:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown platform {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
