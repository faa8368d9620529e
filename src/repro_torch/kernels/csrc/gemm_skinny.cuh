// Decode-regime GEMM (gemm.cu's `skinny` route) for Hopper, sm_90a:
// C[z] = A[z] @ B[z] for m <= 16 (serving: m = batch), fp32 accumulation,
// one rounding to the output type.
//
// The Pallas kernel it stands for (src/repro/kernels/gemm.py:32,
// `gemm_kernel` via `pallas_gemm` / `pallas_gemm_batched`) padded m to a
// 128-row tile and ran it on the MXU.  At m <= 16 a GEMM does 2*m FLOPs per
// weight element it reads (8 FLOP/byte at m = 8 in bf16), far below the
// H100's ~295 FLOP/byte ridge: the bound is the bytes of B over 3.35 TB/s,
// and the design is about Hopper's memory system:
//
//   * B is read exactly once, in 16-byte `cp.async` copies that bypass L1
//     (a weight is streamed, never reused) into rings in shared memory
//     private to a thread or a warp, so several copies stay in flight
//     without holding registers.  (Register loads in flight would make
//     every shared-memory read of A behind them wait for device memory.)
//   * All m rows live in one block, so B is read once for any m <= 16.
//     A's rows are staged in shared memory in chunks of k, read through
//     A's strides (row- or column-major, or a column slice), 16 bytes at a
//     time when its rows allow.
//   * k is split across the warps of a block and across the blocks of a
//     thread-block cluster (blockIdx.y, up to 8), so a narrow n (mamba2-
//     370m's dt projection, n = 32) still spreads over the SMs.  The launch
//     plan (kernel pair, splits, k rows per split, vector width, tile) is
//     computed in kernels/gemm.py::skinny_plan from shape, dtype, strides
//     and alignment alone -- never from the batch count -- so a stacked
//     launch runs the same per-matrix schedule as its single launches and
//     equals them bit for bit.
//   * The split-k sum needs no workspace and no atomics: each block leaves
//     its partial tile in its own shared memory, the cluster barrier makes
//     all of them visible, and each block of the cluster sums a slice of
//     the tile over the splits' shared memory (distributed shared memory)
//     in split order and rounds it once into C.  The result does not depend
//     on which block finishes first.  One split writes C directly.
//   * Every launch is a programmatic dependent launch: a decode step runs
//     its projections back to back, and each may be scheduled while the
//     one before it finishes its epilogue.  A kernel touches global
//     memory only after griddepcontrol.wait (the grid before it complete
//     and its writes visible) and releases the next launch after its k
//     loop.
//   * Two kernel pairs, each with a kernel for either layout of B (MN-major:
//     a row-major [k, n] weight; K-major: a tied embedding's transpose, read
//     in place, no transpose copy):
//       gemm_skinny_tc_mn / gemm_skinny_tc_k -- bf16 with 16-byte B
//         vectors (every serving GEMM of the port's models): `mma.sync`
//         m16n8k16 on the tensor cores, B in 2 KB items per warp read back
//         with `ldmatrix`.  On the CUDA cores every bf16 weight costs m FMAs
//         plus its unpacking; one `mma` does 2048 multiply-adds.
//       gemm_skinny_mn / gemm_skinny_k -- f32 (true fp32 FMAs, no TF32:
//         the f32 logits check holds 1e-4), or B the 16-byte copies cannot
//         read (a base address or a non-unit stride that is not a multiple
//         of 16 bytes, or a vector dimension that is not a multiple of the
//         vector: then VEC = 1, plain loads).  MN-major: a thread owns VEC
//         consecutive columns and walks k rows; K-major: a warp owns 4
//         columns and its lanes read along k.
//
// Device functions are named gemm_skinny_* so profiles book them with the
// GEMM.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sk {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int A_SMEM_BYTES = 32 * 1024;   // one chunk of A's fp32 rows
constexpr int MAX_SPLITS = 8;             // blocks of a (portable) cluster
constexpr int MN_STAGES = 16;             // gemm_skinny_mn: B rows in the ring
constexpr int K_COLS_PER_WARP = 4;        // gemm_skinny_k
constexpr int K_COLS = WARPS * K_COLS_PER_WARP;
constexpr int K_STAGES = 4;               // gemm_skinny_k: k steps in the ring

// k rows of A staged at once: a multiple of 256, so every thread's rows
// (MN-major: a stride of at most 256) and every 32-lane step (K-major: at
// most 256 elements) fall inside one chunk.
template <int MR>
__host__ __device__ constexpr int a_chunk() {
  return A_SMEM_BYTES / (MR * 4) / 256 * 256;
}

struct Args {
  int M, N, K;
  long long sa_b, sa_m, sa_k;   // A strides (elements): batch, row, k
  long long sb_b, sb_k, sb_n;   // B strides: batch, k, column
  long long sc_b, sc_m;         // C strides: batch, row (column stride 1)
  int splits, kc;               // k splits (cluster size), k rows per split
  int tn_log2;                  // gemm_skinny_mn: log2(threads per k row)
  int a_vec;                    // 16 / sizeof(TI): A staged in 16-byte loads
};

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T out(float x);
template <> __device__ __forceinline__ float out<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 32-bit words one copy of VEC elements of TI fills (a scalar: one).
template <typename TI, int VEC>
__host__ __device__ constexpr int words() {
  return VEC * sizeof(TI) >= 4 ? VEC * sizeof(TI) / 4 : 1;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Programmatic dependent launch: a launch may begin while the kernel
// before it in the stream finishes.  Every global read and write waits for
// that kernel's grid (griddep_wait, first thing in each kernel); a block
// lets the next launch begin once its k loop is done.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void griddep_release() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// VEC elements at p into a ring slot: a 16-byte cp.async (L2 only) when
// VEC fills 16 bytes, else a plain load and store (operands the plan gave
// scalar loads).
template <typename TI, int VEC>
__device__ __forceinline__ void copy_to_slot(uint32_t* slot, const TI* p) {
  if constexpr (VEC * sizeof(TI) == 16) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(dst), "l"(p) : "memory");
  } else {
    static_assert(VEC == 1, "vector copies are 16 bytes");
    if constexpr (sizeof(TI) == 4)
      slot[0] = __float_as_uint(__ldg(reinterpret_cast<const float*>(p)));
    else
      slot[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

template <int W>
__device__ __forceinline__ void read_slot(const uint32_t* slot, uint32_t* w) {
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(slot);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = slot[i];
  }
}

// Element j of a slot's words, widened to fp32 (a bf16 is the high half
// of an fp32's bits).
template <typename TI, int VEC>
__device__ __forceinline__ float elem(const uint32_t* w, int j) {
  if constexpr (sizeof(TI) == 4) {
    return __uint_as_float(w[j]);
  } else if constexpr (VEC == 1) {
    return __uint_as_float(w[0] << 16);
  } else {
    const uint32_t x = w[j >> 1];
    return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// A's rows [0, MR) over k [k0, k0 + kc) into shared memory as fp32, row
// stride ld; rows at or past M are zero.  Each thread has one load per
// row in flight: 16 bytes along k when A's rows allow it (g.a_vec; kc is
// then a multiple of the vector), else one element through A's strides.
template <typename TI, int MR>
__device__ __forceinline__ void stage_a(float* As, const TI* A, const Args& g,
                                        int k0, int kc, int ld) {
  constexpr int AV = 16 / sizeof(TI);
  if (g.a_vec > 1) {
    for (int q = threadIdx.x; q < kc / AV; q += THREADS) {
      uint32_t w[MR][4];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r < g.M) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(
              A + r * g.sa_m + k0 + q * AV));
          w[r][0] = v.x; w[r][1] = v.y; w[r][2] = v.z; w[r][3] = v.w;
        } else {
          w[r][0] = w[r][1] = w[r][2] = w[r][3] = 0u;
        }
      }
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int j = 0; j < AV; j += 4)
          *reinterpret_cast<float4*>(&As[r * ld + q * AV + j]) = make_float4(
              elem<TI, AV>(w[r], j), elem<TI, AV>(w[r], j + 1),
              elem<TI, AV>(w[r], j + 2), elem<TI, AV>(w[r], j + 3));
    }
  } else {
    for (int kk = threadIdx.x; kk < kc; kk += THREADS) {
      float v[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r)
        v[r] = r < g.M ? f32(A[r * g.sa_m + (long long)(k0 + kk) * g.sa_k]) : 0.f;
#pragma unroll
      for (int r = 0; r < MR; ++r) As[r * ld + kk] = v[r];
    }
  }
}

// Split-k epilogue of one column tile [col0, col0 + ncols): `tile` (rows
// of stride ld in this block's shared memory) holds the block's partial
// sums.  After the cluster barrier, block q of the cluster sums its slice
// of the tile over the splits' tiles, split 0 first, and writes C; the
// second barrier keeps every tile alive until all slices are read.
template <typename TO>
__device__ __forceinline__ void gemm_skinny_cluster_sum(float* tile, int ld,
                                                        TO* C, const Args& g,
                                                        int col0, int ncols) {
  cg::cluster_group cluster = cg::this_cluster();
  if (g.splits == 1) {                          // this block's tile is C's
    __syncthreads();
    for (int e = threadIdx.x; e < g.M * ncols; e += THREADS) {
      const int r = e / ncols, c = e - r * ncols;
      if (col0 + c < g.N) C[r * g.sc_m + col0 + c] = out<TO>(tile[r * ld + c]);
    }
    return;
  }
  cluster.sync();
  const int splits = g.splits, q = static_cast<int>(cluster.block_rank());
  const int total = g.M * ncols, per = (total + splits - 1) / splits;
  const int end = min(total, (q + 1) * per);
  for (int e = q * per + threadIdx.x; e < end; e += THREADS) {
    const int r = e / ncols, c = e - r * ncols;
    float part[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      part[s] = s < splits ? cluster.map_shared_rank(tile, s)[r * ld + c] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < splits) v += part[s];
    if (col0 + c < g.N) C[r * g.sc_m + col0 + c] = out<TO>(v);
  }
  cluster.sync();
}

// ---- B MN-major: a thread owns VEC columns and walks k rows -------------
template <typename TI, typename TO, int MR, int VEC>
__global__ void __launch_bounds__(THREADS, MR <= 8 ? 2 : 1)
gemm_skinny_mn(const TI* __restrict__ A, const TI* __restrict__ B,
               TO* __restrict__ C, Args g) {
  constexpr int S = MN_STAGES, W = words<TI, VEC>(), KCH = a_chunk<MR>();
  constexpr int NCB = 32 * VEC;                 // widest column tile
  // Dynamic shared memory: the B ring [S][THREADS][W] words and A's chunk
  // [MR][KCH] as fp32; after the k loop, the warps' partial rows
  // [WARPS][MR][NCB] in the same bytes.
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;
  float* As = reinterpret_cast<float*>(smem + S * THREADS * W);
  float* part = reinterpret_cast<float*>(smem);
  const int z = blockIdx.z;
  A += z * g.sa_b;
  B += z * g.sb_b;
  C += z * g.sc_b;
  griddep_wait();
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int tn = 1 << g.tn_log2;                // threads per k row
  const int kgs = THREADS >> g.tn_log2;         // k rows walked at once
  const int ct = t & (tn - 1), kg = t >> g.tn_log2;
  const int ncb = tn * VEC;                     // the block's columns
  const int col0 = blockIdx.x * ncb, gc = col0 + ct * VEC;
  const int k0 = blockIdx.y * g.kc;
  const int kc = max(0, min(g.kc, g.K - k0));
  const int rows = kc > kg ? (kc - kg + kgs - 1) / kgs : 0;  // this thread's
  const bool col_ok = gc < g.N;                 // N % VEC == 0 when VEC > 1
  const TI* bp = B + (long long)(k0 + kg) * g.sb_k + (long long)gc * g.sb_n;
  const long long step = (long long)kgs * g.sb_k;
  uint32_t* mine = ring + t * W;

  // The thread's i-th k row (kg + i * kgs) goes to slot i % S; S - 1 rows
  // stay in flight.
  auto issue = [&](int i) {
    if (col_ok && i < rows)
      copy_to_slot<TI, VEC>(mine + (i % S) * THREADS * W, bp + i * step);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);

  float acc[MR][VEC];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  int i = 0;
  for (int c0 = 0; c0 < kc; c0 += KCH) {
    const int cn = min(KCH, kc - c0);
    if (c0 > 0) __syncthreads();                // the last chunk is read
    stage_a<TI, MR>(As, A, g, k0 + c0, cn, KCH);
    __syncthreads();
    const float* a_col = As + kg - c0;
    for (; i < rows && kg + i * kgs < c0 + cn; ++i) {
      issue(i + S - 1);
      cp_async_wait<S - 1>();                   // row i has landed
      uint32_t w[W];
      read_slot<W>(mine + (i % S) * THREADS * W, w);
      float b[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) b[v] = elem<TI, VEC>(w, v);
      const float* a = a_col + i * kgs;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float ar = a[r * KCH];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(ar, b[v], acc[r][v]);
      }
    }
  }
  cp_async_wait<0>();
  griddep_release();

  // Fold the k groups: inside a warp (lanes tn apart) by a butterfly, then
  // across warps through shared memory, warp 0 to 7 in order, into the
  // block's partial tile (warp 0's rows of `part`).
  for (int off = tn; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[r][v] += __shfl_xor_sync(0xffffffffu, acc[r][v], off);
  __syncthreads();                              // the ring and A are free
  if (lane < tn)
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= g.M) break;
      float* dst = part + (wid * MR + r) * NCB + ct * VEC;
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int v = 0; v < VEC; v += 4)
          *reinterpret_cast<float4*>(dst + v) =
              make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) dst[v] = acc[r][v];
      }
    }
  __syncthreads();
  for (int e = t; e < g.M * ncb; e += THREADS) {
    const int r = e / ncb, c = e - r * ncb;
    float s = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) s += part[(ww * MR + r) * NCB + c];
    part[r * NCB + c] = s;                      // warp 0's slot, read above
  }
  gemm_skinny_cluster_sum<TO>(part, NCB, C, g, col0, ncb);
}

// ---- B K-major: a warp owns 4 columns, lanes read along k -----------------
template <typename TI, typename TO, int MR, int VEC>
__global__ void __launch_bounds__(THREADS, MR <= 8 ? 2 : 1)
gemm_skinny_k(const TI* __restrict__ A, const TI* __restrict__ B,
              TO* __restrict__ C, Args g) {
  constexpr int CW = K_COLS_PER_WARP, S = K_STAGES, W = words<TI, VEC>();
  constexpr int KSTEP = 32 * VEC, KCH = a_chunk<MR>();
  // Dynamic shared memory: the B ring [S][CW][THREADS][W] words, then A's
  // chunk [MR][KCH] as fp32.
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;
  float* As = reinterpret_cast<float*>(smem + S * CW * THREADS * W);
  __shared__ float tile[MR * K_COLS];           // the block's partial sums
  const int z = blockIdx.z;
  A += z * g.sa_b;
  B += z * g.sb_b;
  C += z * g.sc_b;
  griddep_wait();
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int col0 = blockIdx.x * K_COLS, c0 = col0 + wid * CW;
  const int k0 = blockIdx.y * g.kc;
  const int kc = max(0, min(g.kc, g.K - k0));   // a multiple of VEC
  const int steps = (kc + KSTEP - 1) / KSTEP;
  const TI* bp = B + (long long)(k0 + lane * VEC) * g.sb_k + (long long)c0 * g.sb_n;
  uint32_t* mine = ring + t * W;

  // Step s (k offset s * KSTEP + lane * VEC) of the warp's CW columns goes
  // to slot s % S; S - 1 steps stay in flight.
  auto issue = [&](int s) {
    if (s < steps && s * KSTEP + lane * VEC < kc)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (c0 + c < g.N)
          copy_to_slot<TI, VEC>(mine + ((s % S) * CW + c) * THREADS * W,
                                bp + c * g.sb_n + (long long)s * KSTEP * g.sb_k);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);

  float acc[CW][MR];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[c][r] = 0.f;

  int s = 0;
  for (int c0k = 0; c0k < kc; c0k += KCH) {
    const int cn = min(KCH, kc - c0k);
    if (c0k > 0) __syncthreads();               // the last chunk is read
    stage_a<TI, MR>(As, A, g, k0 + c0k, cn, KCH);
    __syncthreads();
    for (; s < steps && s * KSTEP < c0k + cn; ++s) {
      issue(s + S - 1);
      cp_async_wait<S - 1>();                   // step s has landed
      const int kk = s * KSTEP + lane * VEC;
      if (kk >= kc) continue;
      float b[CW][VEC];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        uint32_t w[W];
        if (c0 + c < g.N)
          read_slot<W>(mine + ((s % S) * CW + c) * THREADS * W, w);
        else
#pragma unroll
          for (int i = 0; i < W; ++i) w[i] = 0u;
#pragma unroll
        for (int v = 0; v < VEC; ++v) b[c][v] = elem<TI, VEC>(w, v);
      }
      const float* a_row = As + kk - c0k;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        float a[VEC];
        if constexpr (VEC % 4 == 0) {
          // KCH and kk - c0k are multiples of VEC: 16-byte-aligned vectors.
#pragma unroll
          for (int v = 0; v < VEC; v += 4) {
            const float4 q = *reinterpret_cast<const float4*>(a_row + r * KCH + v);
            a[v] = q.x; a[v + 1] = q.y; a[v + 2] = q.z; a[v + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) a[v] = a_row[r * KCH + v];
        }
#pragma unroll
        for (int c = 0; c < CW; ++c)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[c][r] = fmaf(a[v], b[c][v], acc[c][r]);
      }
    }
  }
  cp_async_wait<0>();
  griddep_release();

  // Butterfly over the 32 lanes (every lane ends with the same sum); lane
  // (c * MR + r) % 32 writes element (r, c): to C with one split, else to
  // the block's partial tile.
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      float v = acc[c][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (r < g.M && lane == ((c * MR + r) & 31)) {
        if (g.splits > 1)
          tile[r * K_COLS + wid * CW + c] = v;
        else if (c0 + c < g.N)
          C[r * g.sc_m + c0 + c] = out<TO>(v);
      }
    }
  if (g.splits > 1) gemm_skinny_cluster_sum<TO>(tile, K_COLS, C, g, col0, K_COLS);
}

// Dynamic shared memory beside static shared memory above 48 KB in all
// needs the kernel's opt-in.  The attribute belongs to the current
// device's context, so it is set on every launch (it costs little).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A programmatic dependent launch, its splits (grid.y) one cluster.
template <typename Kernel, typename... Ts>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, size_t smem, int splits,
                           cudaStream_t s, Ts... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;  // splits == 1: none
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = splits;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ---- The tensor-core kernels: bf16 operands, 16-byte-aligned B ---------
// Sixteen accumulator rows (rows at or past M are zero in A), `mma.sync`
// m16n8k16 bf16 -> fp32.  On the CUDA cores every bf16 weight element
// costs m FMAs plus its unpacking, enough at m = 8 for the instruction
// issue, not the bytes, to set the pace; one `mma` does 2048
// multiply-adds, so the math drops out of the way of the bytes.  B arrives in items of 2 KB (16
// k rows x 64 columns, or 16 columns x 64 k): each lane of a warp copies 4
// of an item's 16-byte chunks with cp.async into the warp's own ring of
// items (XOR-swizzled by row, so `ldmatrix` reads are free of bank
// conflicts), and the warp reads the item back with `ldmatrix` once every
// lane's copies have landed (cp.async.wait_group, then __syncwarp).
constexpr int TC_ITEM = 2048;             // bytes of B per item
constexpr int TC_MN_STAGES = 5;           // items in a warp's ring: MN-major
constexpr int TC_K_STAGES = 4;            //   and K-major
constexpr int TC_MN_COLS = 64;            // MN-major block tile: 64 columns
constexpr int TC_K_COLS = WARPS * 16;     // K-major block tile: 16 a warp
constexpr int TC_K_DEPTH = 64;            // K-major item: 64 k of 16 columns
// A's staged rows: only its M rows (ldmatrix reads rows past M from a
// zero row), k in chunks of 1024 (M <= 8) or 512, rows padded by 16 bytes
// so that ldmatrix reads are free of bank conflicts.  With the rings this
// leaves room for two blocks on an SM.
constexpr int TC_A_ELEMS = 16 * 520;      // bf16 of A's buffer
__host__ __device__ constexpr int tc_a_chunk(int m) { return m <= 8 ? 1024 : 512; }
constexpr int TC_PART_LD = TC_MN_COLS + 8;
template <int STAGES>
constexpr size_t tc_smem() {
  return (size_t)WARPS * STAGES * TC_ITEM + (TC_A_ELEMS + 8) * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared memory, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk cc of row `row` in a 128-byte-row item.
__device__ __forceinline__ int swz(int row, int cc) {
  return row * 128 + ((cc ^ (row & 7)) << 4);
}

// A's rows [0, M) over k [k0, k0 + kc) into shared memory as bf16, row
// stride ld, zero from kc up to kpad (the last item's end).  With 16-byte
// rows (g.a_vec; kc is then a multiple of 8) every copy is a cp.async, all
// in flight at once; it drains every copy the thread has in flight, the
// ring's included.  Else one element at a time through A's strides.
__device__ __forceinline__ void stage_a_bf16(__nv_bfloat16* As,
                                             const __nv_bfloat16* A,
                                             const Args& g, int k0, int kc,
                                             int kpad, int ld) {
  const int per_row = kpad / 8;
  if (g.a_vec > 1) {
    for (int q = threadIdx.x; q < g.M * per_row; q += THREADS) {
      const int r = q / per_row, kk = (q - r * per_row) * 8;
      const bool ok = kk < kc;
      cp_async16(smem_addr(As + r * ld + kk),
                 ok ? A + r * g.sa_m + k0 + kk : A, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int q = threadIdx.x; q < g.M * kpad; q += THREADS) {
      const int r = q / kpad, kk = q - r * kpad;
      As[r * ld + kk] = kk < kc
          ? A[r * g.sa_m + (long long)(k0 + kk) * g.sa_k] : __float2bfloat16_rn(0.f);
    }
  }
}

// A's 16 x 16 fragment at column kk of the staged chunk; rows past M read
// the zero row at As[TC_A_ELEMS].
__device__ __forceinline__ void a_frag(const __nv_bfloat16* As, int ld, int m,
                                       int kk, uint32_t* a) {
  const int lane = threadIdx.x & 31, r = lane & 15;
  const __nv_bfloat16* p = r < m ? As + r * ld + kk + (lane >> 4) * 8
                                 : As + TC_A_ELEMS;
  ldsm_x4(smem_addr(p), a);
}

// MN-major B (row-major [k, n]): a block owns 64 columns; its warps take
// the split's 16-row items in turn, and fold their partial tiles through
// shared memory in warp order.
template <typename TO>
__global__ void __launch_bounds__(THREADS, 2)
gemm_skinny_tc_mn(const __nv_bfloat16* __restrict__ A,
                  const __nv_bfloat16* __restrict__ B, TO* __restrict__ C,
                  Args g) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int z = blockIdx.z;
  A += z * g.sa_b;
  B += z * g.sb_b;
  C += z * g.sc_b;
  griddep_wait();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  uint8_t* ring = tc_smem + wid * TC_MN_STAGES * TC_ITEM;
  auto* As = reinterpret_cast<__nv_bfloat16*>(tc_smem + WARPS * TC_MN_STAGES * TC_ITEM);
  float* part = reinterpret_cast<float*>(tc_smem);    // after the k loop
  const int col0 = blockIdx.x * TC_MN_COLS;
  const int k0 = blockIdx.y * g.kc;
  const int kc = max(0, min(g.kc, g.K - k0));
  const int items = (kc + 15) / 16;
  const int mine = items > wid ? (items - wid + WARPS - 1) / WARPS : 0;

  // The warp's i-th item (item wid + i * WARPS: k rows 16 apart) goes to
  // slot i % TC_MN_STAGES; each lane copies chunks q = lane + 32 j (row q / 8,
  // columns 8 (q % 8) ...), whose places are fixed for the whole loop.
  // Chunks past n are not copied: the accumulators they feed are never
  // stored.
  int c_row[4], c_off[4];
  const __nv_bfloat16* c_src[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = lane + 32 * j, row = q >> 3, cc = q & 7;
    c_row[j] = col0 + cc * 8 < g.N ? row : 1 << 30;  // never below kc
    c_off[j] = swz(row, cc);
    c_src[j] = B + (long long)(k0 + row) * g.sb_k + col0 + cc * 8;
  }
  const long long item_step = 16 * WARPS * g.sb_k;
  const long long first = 16 * wid * g.sb_k;
  auto issue = [&](int i) {
    if (i < mine) {
      const int it = wid + i * WARPS;
      const unsigned slot = smem_addr(ring + (i % TC_MN_STAGES) * TC_ITEM);
      const long long off = first + i * item_step;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = it * 16 + c_row[j] < kc;
        if (c_row[j] < 16) cp_async16(slot + c_off[j], ok ? c_src[j] + off : B, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < TC_MN_STAGES - 1; ++i) issue(i);

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int kch = tc_a_chunk(g.M), ld = kch + 8;
  if (threadIdx.x == 0)
    *reinterpret_cast<uint4*>(As + TC_A_ELEMS) = make_uint4(0u, 0u, 0u, 0u);
  int i = 0;
  for (int c0 = 0; c0 < kc; c0 += kch) {
    const int cn = min(kch, kc - c0);
    if (c0 > 0) __syncthreads();                // the last chunk is read
    stage_a_bf16(As, A, g, k0 + c0, cn, (cn + 15) / 16 * 16, ld);
    __syncthreads();
    for (; i < mine && (wid + i * WARPS) * 16 < c0 + cn; ++i) {
      __syncwarp();                             // slot (i - 1) % S is read
      issue(i + TC_MN_STAGES - 1);
      cp_async_wait<TC_MN_STAGES - 1>();           // this lane's item i landed
      __syncwarp();                             // every lane's has
      uint32_t a[4];
      a_frag(As, ld, g.M, (wid + i * WARPS) * 16 - c0, a);
      const unsigned slot = smem_addr(ring + (i % TC_MN_STAGES) * TC_ITEM);
      const int m = lane >> 3, krow = (m & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(slot + swz(krow, np * 2 + (m >> 1)), b);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  griddep_release();
  __syncthreads();                              // the ring is free

  // Accumulator (row g, columns 2t, 2t + 1) of each 8-column tile, and row
  // g + 8, into the warp's rows of `part`; then warp 0 to 7 in order.
  const int gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gr + 8 * h;
      if (r < g.M)
        *reinterpret_cast<float2*>(part + (wid * 16 + r) * TC_PART_LD + nt * 8 + tc) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < g.M * TC_MN_COLS; e += THREADS) {
    const int r = e / TC_MN_COLS, c = e - r * TC_MN_COLS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(w * 16 + r) * TC_PART_LD + c];
    part[r * TC_PART_LD + c] = s;               // warp 0's slot, read above
  }
  gemm_skinny_cluster_sum<TO>(part, TC_PART_LD, C, g, col0, TC_MN_COLS);
}

// K-major B ([n, k] in memory, a tied embedding's transpose): each warp
// owns 16 columns and walks the split's k in 64-deep items.
template <typename TO>
__global__ void __launch_bounds__(THREADS, 2)
gemm_skinny_tc_k(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, TO* __restrict__ C,
                 Args g) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  __shared__ float tile[16 * TC_K_COLS];        // the block's partial sums
  const int z = blockIdx.z;
  A += z * g.sa_b;
  B += z * g.sb_b;
  C += z * g.sc_b;
  griddep_wait();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  uint8_t* ring = tc_smem + wid * TC_K_STAGES * TC_ITEM;
  auto* As = reinterpret_cast<__nv_bfloat16*>(tc_smem + WARPS * TC_K_STAGES * TC_ITEM);
  const int col0 = blockIdx.x * TC_K_COLS, cw = col0 + wid * 16;
  const int k0 = blockIdx.y * g.kc;
  const int kc = max(0, min(g.kc, g.K - k0));   // a multiple of 8
  const int items = (kc + TC_K_DEPTH - 1) / TC_K_DEPTH;

  // Item i (k [64 i, 64 i + 64) of the warp's 16 columns) goes to slot
  // i % TC_K_STAGES; lane chunks q = lane + 32 j: column q / 8, k 8 (q % 8).
  auto issue = [&](int i) {
    if (i < items) {
      const unsigned slot = smem_addr(ring + (i % TC_K_STAGES) * TC_ITEM);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = lane + 32 * j, row = q >> 3, cc = q & 7;
        const int kk = i * TC_K_DEPTH + cc * 8, col = cw + row;
        const bool ok = kk < kc && col < g.N;
        cp_async16(slot + swz(row, cc),
                   ok ? B + (long long)col * g.sb_n + k0 + kk : B, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < TC_K_STAGES - 1; ++i) issue(i);

  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int kch = tc_a_chunk(g.M), ld = kch + 8;
  if (threadIdx.x == 0)
    *reinterpret_cast<uint4*>(As + TC_A_ELEMS) = make_uint4(0u, 0u, 0u, 0u);
  int i = 0;
  for (int c0 = 0; c0 < kc; c0 += kch) {
    const int cn = min(kch, kc - c0);
    if (c0 > 0) __syncthreads();
    stage_a_bf16(As, A, g, k0 + c0, cn,
                 (cn + TC_K_DEPTH - 1) / TC_K_DEPTH * TC_K_DEPTH, ld);
    __syncthreads();
    for (; i < items && i * TC_K_DEPTH < c0 + cn; ++i) {
      __syncwarp();
      issue(i + TC_K_STAGES - 1);
      cp_async_wait<TC_K_STAGES - 1>();
      __syncwarp();
      const unsigned slot = smem_addr(ring + (i % TC_K_STAGES) * TC_ITEM);
      const int m = lane >> 3, nrow = (m >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int ks = 0; ks < TC_K_DEPTH / 16; ++ks) {
        uint32_t a[4], b[4];
        a_frag(As, ld, g.M, i * TC_K_DEPTH - c0 + ks * 16, a);
        ldsm_x4(slot + swz(nrow, ks * 2 + (m & 1)), b);
        mma_bf16(acc[0], a, b[0], b[1]);
        mma_bf16(acc[1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  griddep_release();

  const int gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gr + 8 * h;
      if (r >= g.M) continue;
      const int c = wid * 16 + nt * 8 + tc;
      if (g.splits == 1) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + c + e < g.N)
            C[r * g.sc_m + col0 + c + e] = out<TO>(acc[nt][2 * h + e]);
      } else {
        tile[r * TC_K_COLS + c] = acc[nt][2 * h];
        tile[r * TC_K_COLS + c + 1] = acc[nt][2 * h + 1];
      }
    }
  if (g.splits > 1)
    gemm_skinny_cluster_sum<TO>(tile, TC_K_COLS, C, g, col0, TC_K_COLS);
}

template <typename TO>
cudaError_t launch_tc(const __nv_bfloat16* A, const __nv_bfloat16* B, TO* C,
                      const Args& g, bool k_major, int batch,
                      cudaStream_t s) {
  if (k_major) {
    auto kernel = gemm_skinny_tc_k<TO>;
    constexpr size_t smem = tc_smem<TC_K_STAGES>();
    const cudaError_t opt_in = allow_smem(kernel, smem);
    if (opt_in != cudaSuccess) return opt_in;
    dim3 grid((g.N + TC_K_COLS - 1) / TC_K_COLS, g.splits, batch);
    return launch_cluster(kernel, grid, smem, g.splits, s, A, B, C, g);
  }
  auto kernel = gemm_skinny_tc_mn<TO>;
  constexpr size_t smem = tc_smem<TC_MN_STAGES>();
  const cudaError_t opt_in = allow_smem(kernel, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid((g.N + TC_MN_COLS - 1) / TC_MN_COLS, g.splits, batch);
  return launch_cluster(kernel, grid, smem, g.splits, s, A, B, C, g);
}

template <typename TI, typename TO, int MR, int VEC>
cudaError_t launch_one(const TI* A, const TI* B, TO* C, const Args& g,
                       bool k_major, int batch, cudaStream_t s) {
  constexpr int W = words<TI, VEC>();
  constexpr size_t a_bytes = (size_t)MR * a_chunk<MR>() * sizeof(float);
  if (k_major) {
    constexpr size_t smem =
        (size_t)K_STAGES * K_COLS_PER_WARP * THREADS * W * 4 + a_bytes;
    auto kernel = gemm_skinny_k<TI, TO, MR, VEC>;
    const cudaError_t opt_in = allow_smem(kernel, smem);
    if (opt_in != cudaSuccess) return opt_in;
    dim3 grid((g.N + K_COLS - 1) / K_COLS, g.splits, batch);
    return launch_cluster(kernel, grid, smem, g.splits, s, A, B, C, g);
  }
  constexpr size_t ring_a = (size_t)MN_STAGES * THREADS * W * 4 + a_bytes;
  constexpr size_t parts = (size_t)WARPS * MR * 32 * VEC * sizeof(float);
  constexpr size_t smem = ring_a > parts ? ring_a : parts;
  auto kernel = gemm_skinny_mn<TI, TO, MR, VEC>;
  const cudaError_t opt_in = allow_smem(kernel, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const int ncb = (1 << g.tn_log2) * VEC;
  dim3 grid((g.N + ncb - 1) / ncb, g.splits, batch);
  return launch_cluster(kernel, grid, smem, g.splits, s, A, B, C, g);
}

// Checks the plan against the operands (a plan the kernels cannot run is
// refused, never patched) and launches.  The kernel pair follows from the
// input type and vec (16 / sizeof(TI) or 1): bf16 with 16-byte B vectors
// runs on the tensor cores (16 accumulator rows), anything else on the
// CUDA cores with 8 accumulator rows for M <= 8, else 16.
template <typename TI, typename TO>
cudaError_t launch(const void* a, const void* b, void* c, const Args& g,
                   int batch, bool k_major, int vec, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(TI);
  const long long kc = g.kc, splits = g.splits;
  const bool bad =
      g.M > 16 || g.K < 0 || kc < 8 ||
      kc % 8 || splits < 1 || splits > MAX_SPLITS || batch > 65535 ||
      splits * kc < g.K || (splits - 1) * kc >= (g.K > 0 ? g.K : 1) ||
      (!k_major && (g.tn_log2 < 0 || g.tn_log2 > 5)) ||
      (vec != 1 && vec != VEC) || (g.a_vec != 1 && g.a_vec != VEC);
  if (bad) return cudaErrorInvalidValue;
  if (vec != 1) {
    // 16-byte vectors: unit stride along the vector, whole vectors, and
    // 16-byte-aligned addresses.
    const long long unit = k_major ? g.sb_k : g.sb_n;
    const long long other = k_major ? g.sb_n : g.sb_k;
    const int along = k_major ? g.K : g.N;
    if (unit != 1 || along % VEC || other % VEC || g.sb_b % VEC ||
        reinterpret_cast<uintptr_t>(b) % 16)
      return cudaErrorInvalidValue;
  }
  if (g.a_vec != 1 && (g.sa_k != 1 || g.K % VEC || g.sa_m % VEC ||
                      g.sa_b % VEC || reinterpret_cast<uintptr_t>(a) % 16))
    return cudaErrorInvalidValue;
  const TI* A = static_cast<const TI*>(a);
  const TI* B = static_cast<const TI*>(b);
  TO* C = static_cast<TO*>(c);
  if constexpr (sizeof(TI) == 2) {
    if (vec == VEC) return launch_tc<TO>(A, B, C, g, k_major, batch, s);
    return g.M > 8 ? launch_one<TI, TO, 16, 1>(A, B, C, g, k_major, batch, s)
                   : launch_one<TI, TO, 8, 1>(A, B, C, g, k_major, batch, s);
  } else {
    if (g.M > 8)
      return vec == 1 ? launch_one<TI, TO, 16, 1>(A, B, C, g, k_major, batch, s)
                      : launch_one<TI, TO, 16, VEC>(A, B, C, g, k_major, batch, s);
    return vec == 1 ? launch_one<TI, TO, 8, 1>(A, B, C, g, k_major, batch, s)
                    : launch_one<TI, TO, 8, VEC>(A, B, C, g, k_major, batch, s);
  }
}

}  // namespace sk
