// f32 GEMM on Hopper's tensor cores (gemm.cu's `tf32x3` route), sm_90a:
// C[z] = A[z] @ B[z] for float32 operands with m > 16, fp32-accurate, one
// rounding to the output type (f32 or bf16).
//
// Replaces the reference's Pallas TPU kernel `gemm_kernel` via `pallas_gemm`
// / `pallas_gemm_batched` (src/repro/kernels/gemm.py:32, pallas_call l.84
// and l.130) for f32 operands: there the MXU multiplied 128-tiles with an
// fp32 VMEM accumulator carried along the sequential k grid axis.
//
// Bound on an H100 SXM: 2·m·n·k FLOPs.  fp32 FMAs on the CUDA cores peak at
// 67 TFLOP/s; the tensor cores at 495 TFLOP/s in TF32, a third of that for
// the three products of 3xTF32 below (165).  At n 1024 that is 0.032 ms on
// the CUDA cores against 0.013 by 3xTF32 (bytes: 0.0038), so the design
// moves the work onto the tensor cores and keeps them fed:
//
//  * Precision: 3xTF32, as csrc/ssd_mma.cuh does it.  An fp32 value is
//    x = hi + lo, hi = x with its low 13 bits cleared and lo = x − hi
//    (exact); the mma reads only a register's top 19 bits, so it sees lo
//    truncated to TF32.  Each product is summed as lo·hi + hi·lo + hi·hi,
//    small terms first; only lo·lo (2^-22 of the product) is dropped.  A
//    single TF32 product (10-bit mantissa) would miss the 2e-5 bar
//    (tests/test_torch_gemm.py emulates both).
//  * Accumulation in two levels.  The tensor core adds to its accumulator
//    with truncation relative to the running sum (as ssd_mma.cuh found), a
//    bias toward zero that grows with the number of chained mma: at yi-6b's
//    down projection (k 11008, 1376 k8 steps, three mma each) it reaches
//    the bar.  So the mma accumulator restarts at every staged k tile (32
//    deep: 12 chained mma; the tile's first mma reads a zero accumulator)
//    and is added into a separate fp32 register accumulator by an
//    ordinary rounding FADD.  (Chained over all of k instead, the error
//    at 4096^3 was 3.7e-5 of max |plain|: PERF.md.)
//  * Tensor cores: `mma.sync.m16n8k8` TF32, fp32 accumulators in
//    registers.  (wgmma takes TF32 operands from shared memory K-major
//    only; every Fig. 3 and model B is MN-major.)
//  * Tiles: three block tiles of 4 warps, picked per shape by
//    kernels/gemm.py::tf32x3_plan: 128x64 (warp tiles of 64x32, up to 240
//    registers a thread: two blocks an SM), 64x64 (32x32: four) and 32x32
//    (16x16: seven), the smaller for grids the larger would leave idle.
//    (A 128x128 block of 8 such warps ran no faster than two 128x64 ones
//    at any measured shape and was dropped.)
//  * Staging: a ring of STAGES k tiles (32 deep) in shared memory, filled
//    by cp.async STAGES − 1 tiles ahead, one block barrier a tile.  Each
//    operand keeps its own layout in shared memory (k-contiguous rows for
//    a row-major A or a K-major B, m- or n-contiguous rows otherwise),
//    rows padded (+4 floats for k-contiguous, +8 for the others) so that
//    every fragment load of a warp touches 32 distinct banks.  16-byte
//    copies where the operand's unit-stride rows are 16-byte aligned (the
//    plan's a_vec / b_vec), 4-byte copies through any strides otherwise;
//    past an edge the copy zero-fills.  Fragments of k-contiguous tiles
//    (a row-major A, a K-major B) come by ldmatrix, four 8x4 fp32
//    matrices an instruction; each k8 step's load while the step before
//    it multiplies.  The hi / lo split is made at fragment load.
//  * Small grids: k split across the blocks of a thread-block cluster
//    (grid.y, at most 8, kc rows each, a multiple of 8).  Each block leaves
//    its partial tile in its own shared memory, the cluster barrier makes
//    them visible, and each block sums a slice of the tile over the
//    splits in split order through distributed shared memory and rounds it
//    once into C: no workspace, no atomics.  The plan never sees the batch
//    count, so a stacked launch equals its single launches bit for bit,
//    and a launch repeats bit for bit.
//
// Device functions are named gemm_tf32x3* so profiles book them with the
// GEMM.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace t3 {

namespace cg = cooperative_groups;

constexpr int BK = 32;            // k rows of a staged tile
constexpr int STAGES = 3;         // tiles in the ring
constexpr int MAX_SPLITS = 8;     // blocks of a (portable) cluster
constexpr int WM = 2, WN = 2;     // warps of a block along m and n
constexpr int THREADS = 32 * WM * WN;

struct Args {
  int M, N, K;
  long long sa_b, sa_m, sa_k;   // A strides (elements): batch, row, k
  long long sb_b, sb_k, sb_n;   // B strides: batch, k, column
  long long sc_b, sc_m;         // C strides: batch, row (column stride 1)
  int splits, kc;               // k splits (cluster size), k rows per split
  int a_vec, b_vec;             // 16-byte copies of A / B rows
  int out_bf16;                 // C is bf16 (else f32)
};

// Shared-memory geometry of one operand tile: R rows of the output
// dimension (m for A, n for B) by BK of k, stored k-contiguous ([R][BK +
// 4]) or R-contiguous ([BK][R + 8]).
template <int R, bool KCONTIG>
struct Op {
  static constexpr int PITCH = KCONTIG ? BK + 4 : R + 8;
  static constexpr int FLOATS = KCONTIG ? R * PITCH : BK * PITCH;
  // Element (r, k) of the tile.
  __device__ __forceinline__ static float at(const float* s, int r, int k) {
    return KCONTIG ? s[r * PITCH + k] : s[k * PITCH + r];
  }
};

template <int BM, int BN, bool AK, bool BKM>
struct Cfg {
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // mma tiles a warp
  using OpA = Op<BM, AK>;
  using OpB = Op<BN, BKM>;
  static constexpr int STAGE = OpA::FLOATS + OpB::FLOATS;
  static constexpr int RED_PITCH = BN + 8;             // split-k partials
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(STAGES) * STAGE > size_t(BM) * RED_PITCH
                           ? size_t(STAGES) * STAGE
                           : size_t(BM) * RED_PITCH);
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "tile");
};

// One float from src, or 0 when !valid.
__device__ __forceinline__ void gemm_tf32x3_cp4(float* dst, const float* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(tf32::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Copy a [ROWS][COLS] tile into shared memory (row pitch PITCH floats):
// element (r, c) is src[r * s_r + c * s_c], read while r < r_lim and
// c < c_lim, else 0.  `vec`: s_c == 1 and every row starts 16 bytes
// aligned, so 4 columns go in one 16-byte copy (the last of a row
// partially, past c_lim).  `safe` is an address that may be named in a
// copy that reads nothing.
template <int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void gemm_tf32x3_load(float* dst, const float* src,
                                                 long long s_r, long long s_c,
                                                 int r_lim, int c_lim, bool vec,
                                                 const float* safe) {
  constexpr int CPR = COLS / 4;                   // 16-byte chunks a row
  static_assert(ROWS * CPR % THREADS == 0, "whole copies a thread");
  if (vec) {
#pragma unroll
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int r = i / CPR, c = (i % CPR) * 4;
      const int n = r < r_lim ? max(0, min(4, c_lim - c)) : 0;
      tf32::cp16(dst + r * PITCH + c, n ? src + r * s_r + c : safe, 4 * n);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * COLS / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < r_lim && c < c_lim;
      gemm_tf32x3_cp4(dst + r * PITCH + c, ok ? src + r * s_r + c * s_c : safe,
                      ok);
    }
  }
}

// A warp's operand fragments of one k8 step, as fp32 bits.
template <int MT, int NT>
struct Frags {
  uint32_t a[MT][4];     // A rows g, g + 8 of m-tile i; k t, t + 4
  uint32_t b[NT][2];     // B column g of n-tile j; k t, t + 4
};

// d = a·b from a zero accumulator: a k tile's first product, so the mma
// sum needs no zeroing between tiles.
__device__ __forceinline__ void gemm_tf32x3_mma0(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void gemm_tf32x3_put(void* C, long long off, float v,
                                                bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(C)[off] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(C)[off] = v;
}

// One block: output tile (blockIdx.x: tile_m * tiles_n + tile_n) over k
// rows [split * kc, (split + 1) * kc) (blockIdx.y: split), matrix
// blockIdx.z.  AK: A is staged k-contiguous (row-major A), else
// m-contiguous; BKM: B staged k-contiguous (K-major B), else n-contiguous.
template <int BM, int BN, bool AK, bool BKM>
__global__ void __launch_bounds__(THREADS)
gemm_tf32x3(const float* __restrict__ A, const float* __restrict__ B,
            void* __restrict__ C, Args g) {
  using K = Cfg<BM, BN, AK, BKM>;
  using OpA = typename K::OpA;
  using OpB = typename K::OpB;
  constexpr int MT = K::MT, NT = K::NT;
  extern __shared__ __align__(16) float smem[];

  const int tiles_n = (g.N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const long long z = blockIdx.z;
  A += z * g.sa_b;
  B += z * g.sb_b;
  const int kbeg = blockIdx.y * g.kc;
  const int kend = min(g.K, kbeg + g.kc);
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const bool a_vec = g.a_vec != 0, b_vec = g.b_vec != 0;

  auto load = [&](int kt) {
    float* as = smem + (kt % STAGES) * K::STAGE;
    float* bs = as + OpA::FLOATS;
    const int k0 = kbeg + kt * BK, kl = kend - k0;
    const float* a0 = A + m0 * g.sa_m + k0 * g.sa_k;
    const float* b0 = B + k0 * g.sb_k + n0 * g.sb_n;
    if (AK)
      gemm_tf32x3_load<BM, BK, OpA::PITCH>(as, a0, g.sa_m, g.sa_k, g.M - m0,
                                           kl, a_vec, A);
    else
      gemm_tf32x3_load<BK, BM, OpA::PITCH>(as, a0, g.sa_k, g.sa_m, kl,
                                           g.M - m0, a_vec, A);
    if (BKM)
      gemm_tf32x3_load<BN, BK, OpB::PITCH>(bs, b0, g.sb_n, g.sb_k, g.N - n0,
                                           kl, b_vec, B);
    else
      gemm_tf32x3_load<BK, BN, OpB::PITCH>(bs, b0, g.sb_k, g.sb_n, kl,
                                           g.N - n0, b_vec, B);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = (warp / WN) * K::WTM, wc = (warp % WN) * K::WTN;
  // A k-contiguous tile's fragments come by ldmatrix: this lane names row
  // (lane & 7) + 8 * ((lane >> 3) & 1) of an m-tile at k + 4 * (lane >> 4)
  // (matrices a0..a3); a K-major B's, row (lane & 7) + 8 * (lane >> 4) of
  // two n-tiles at k + 4 * ((lane >> 3) & 1) (b0, b1 of n-tile j, then of
  // j + 1).  The other layouts load element by element.
  const uint32_t a_ld = 4u * ((wr + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                              OpA::PITCH + 4 * (lane >> 4));
  const uint32_t b_ld = 4u * ((wc + (lane & 7) + 8 * (lane >> 4)) *
                              OpB::PITCH + 4 * ((lane >> 3) & 1));
  auto fetch = [&](const float* as, const float* bs, int kk,
                   Frags<MT, NT>& f) {
    if constexpr (AK) {
      const uint32_t base = tf32::smem_u32(as) + a_ld + 4u * kk;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        tf32::ldsm_x4(base + 4u * i * 16 * OpA::PITCH, f.a[i]);
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wr + i * 16 + gq;
        f.a[i][0] = __float_as_uint(OpA::at(as, r, kk + tq));
        f.a[i][1] = __float_as_uint(OpA::at(as, r + 8, kk + tq));
        f.a[i][2] = __float_as_uint(OpA::at(as, r, kk + tq + 4));
        f.a[i][3] = __float_as_uint(OpA::at(as, r + 8, kk + tq + 4));
      }
    }
    if constexpr (BKM) {
      static_assert(NT % 2 == 0, "n-tiles in pairs");
      const uint32_t base = tf32::smem_u32(bs) + b_ld + 4u * kk;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        tf32::ldsm_x4(base + 4u * j * 8 * OpB::PITCH, r);
        f.b[j][0] = r[0];
        f.b[j][1] = r[1];
        f.b[j + 1][0] = r[2];
        f.b[j + 1][1] = r[3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wc + j * 8 + gq;
        f.b[j][0] = __float_as_uint(OpB::at(bs, c, kk + tq));
        f.b[j][1] = __float_as_uint(OpB::at(bs, c, kk + tq + 4));
      }
    }
  };

  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s);
    tf32::cp_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    tf32::cp_wait<STAGES - 2>();          // tile kt has landed (this thread)
    __syncthreads();                       // ... every thread's; slot kt-1 free
    if (kt + STAGES - 1 < ntiles) load(kt + STAGES - 1);
    tf32::cp_commit();
    const float* as = smem + (kt % STAGES) * K::STAGE;
    const float* bs = as + OpA::FLOATS;
    // k rows of this tile: a split's last may hold fewer than BK.
    const int kl = kend - kbeg - kt * BK;
    // The next k8 step's fragments load while this one's mma run.
    Frags<MT, NT> cur, nxt;
    fetch(as, bs, 0, cur);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      if (kk >= kl) break;
      if (kk + 8 < BK) fetch(as, bs, kk + 8, nxt);
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32::split<false>(__uint_as_float(cur.a[i][e]), ah[i][e], al[i][e]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tf32::split<false>(__uint_as_float(cur.b[j][e]), bh[j][e], bl[j][e]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (kk == 0)
            gemm_tf32x3_mma0(part[i][j], al[i], bh[j][0], bh[j][1]);
          else
            tf32::mma(part[i][j], al[i], bh[j][0], bh[j][1]);
          tf32::mma(part[i][j], ah[i], bl[j][0], bl[j][1]);
          tf32::mma(part[i][j], ah[i], bh[j][0], bh[j][1]);
        }
      if (kk + 8 < BK) cur = nxt;
    }
    // The tile's mma sum joins the fp32 sum by a rounding FADD.
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  const bool bf16 = g.out_bf16 != 0;
  const long long cz = z * g.sc_b;
  if (g.splits == 1) {                     // this block's tile is C's
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + wr + i * 16 + gq + (e >> 1) * 8;
          const int c = n0 + wc + j * 8 + 2 * tq + (e & 1);
          if (r < g.M && c < g.N)
            gemm_tf32x3_put(C, cz + r * g.sc_m + c, acc[i][j][e], bf16);
        }
    return;
  }

  // Split k: partial tile into this block's shared memory (the ring is
  // done with), then each block of the cluster sums its slice of the tile
  // over the splits, split 0 first, and rounds it once into C.
  tf32::cp_wait<0>();
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wr + i * 16 + gq, c = wc + j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(red + r * K::RED_PITCH + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(red + (r + 8) * K::RED_PITCH + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = g.splits, q = static_cast<int>(cluster.block_rank());
  const float* parts[MAX_SPLITS];
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    parts[s] = cluster.map_shared_rank(red, s < splits ? s : 0);
  constexpr int TOTAL = BM * BN;
  const int per = (TOTAL + splits - 1) / splits;
  const int end = min(TOTAL, (q + 1) * per);
  for (int e = q * per + threadIdx.x; e < end; e += THREADS) {
    const int r = e / BN, c = e % BN;
    if (m0 + r >= g.M || n0 + c >= g.N) continue;
    const int off = r * K::RED_PITCH + c;
    float v = parts[0][off];
#pragma unroll
    for (int s = 1; s < MAX_SPLITS; ++s)
      if (s < splits) v += parts[s][off];
    gemm_tf32x3_put(C, cz + (m0 + r) * g.sc_m + n0 + c, v, bf16);
  }
  cluster.sync();                          // keep every partial alive
}

template <int BM, int BN, bool AK, bool BKM>
cudaError_t launch_cfg(const float* A, const float* B, void* C, const Args& g,
                       int batch, cudaStream_t s) {
  using K = Cfg<BM, BN, AK, BKM>;
  auto kernel = gemm_tf32x3<BM, BN, AK, BKM>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K::SMEM));
  if (e != cudaSuccess) return e;
  const long long tiles =
      static_cast<long long>((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), g.splits, batch);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // splits == 1: none
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = g.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, A, B, C, g);
}

template <int BM, int BN>
cudaError_t launch_tile(const float* A, const float* B, void* C, const Args& g,
                        int batch, bool a_kmajor, bool b_kmajor,
                        cudaStream_t s) {
  if (a_kmajor && b_kmajor)
    return launch_cfg<BM, BN, true, true>(A, B, C, g, batch, s);
  if (a_kmajor)
    return launch_cfg<BM, BN, true, false>(A, B, C, g, batch, s);
  if (b_kmajor)
    return launch_cfg<BM, BN, false, true>(A, B, C, g, batch, s);
  return launch_cfg<BM, BN, false, false>(A, B, C, g, batch, s);
}

// Whether `vec` copies are safe: the copy dimension has unit stride, the
// other strides are multiples of 4 floats and the base is 16-byte aligned.
inline bool vec_ok(const void* p, long long unit, long long other,
                   long long batch_stride, int batch) {
  return unit == 1 && other % 4 == 0 && (batch == 1 || batch_stride % 4 == 0) &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Blocks of one tile's kernel (A row-major, B MN-major) that the current
// device holds at once in clusters of `splits` (1: no cluster).
template <int BM, int BN>
cudaError_t capacity_tile(int splits, int* blocks) {
  using K = Cfg<BM, BN, true, false>;
  auto kernel = gemm_tf32x3<BM, BN, true, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K::SMEM));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = K::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  *blocks = clusters * splits;
  return e;
}

inline cudaError_t capacity(int tile, int splits, int* blocks) {
  if (splits < 1 || splits > MAX_SPLITS) return cudaErrorInvalidValue;
  switch (tile) {
    case 0: return capacity_tile<128, 64>(splits, blocks);
    case 1: return capacity_tile<64, 64>(splits, blocks);
    case 2: return capacity_tile<32, 32>(splits, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// tile: 0 = 128x64 (4 warps of 64x32), 1 = 64x64 (4 warps of 32x32),
// 2 = 32x32 (4 warps of 16x16).
inline cudaError_t launch(const float* A, const float* B, void* C, Args g,
                          int batch, int tile, bool a_kmajor, bool b_kmajor,
                          cudaStream_t s) {
  if (g.splits < 1 || g.splits > MAX_SPLITS || g.kc <= 0 || g.kc % 8 ||
      static_cast<long long>(g.splits) * g.kc < g.K ||
      (g.splits > 1 && static_cast<long long>(g.splits - 1) * g.kc >= g.K) ||
      batch > 65535)
    return cudaErrorInvalidValue;
  if (g.a_vec && !(a_kmajor ? vec_ok(A, g.sa_k, g.sa_m, g.sa_b, batch)
                            : vec_ok(A, g.sa_m, g.sa_k, g.sa_b, batch)))
    return cudaErrorInvalidValue;
  if (g.b_vec && !(b_kmajor ? vec_ok(B, g.sb_k, g.sb_n, g.sb_b, batch)
                            : vec_ok(B, g.sb_n, g.sb_k, g.sb_b, batch)))
    return cudaErrorInvalidValue;
  switch (tile) {
    case 0: return launch_tile<128, 64>(A, B, C, g, batch, a_kmajor, b_kmajor, s);
    case 1: return launch_tile<64, 64>(A, B, C, g, batch, a_kmajor, b_kmajor, s);
    case 2: return launch_tile<32, 32>(A, B, C, g, batch, a_kmajor, b_kmajor, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace t3
