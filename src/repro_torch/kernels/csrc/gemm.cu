// GEMM for Hopper (sm_90a): C[z] = A[z] @ B[z], fp32 accumulation, one
// rounding to the output type.
//
// Replaces the reference's Pallas TPU kernel `gemm_kernel` / `pallas_gemm`
// (src/repro/kernels/gemm.py).  There the sequential k grid axis carried an
// fp32 VMEM accumulator from one grid step to the next and operands were
// zero-padded to 128-tiles.  Here blocks run in parallel in no order, so the
// k loop lives inside the block (or a cluster's blocks split k and sum in
// distributed shared memory) and each output element is written once.
// Ragged edges are masked (or zero-filled by TMA / cp.async); no operand is
// padded or copied.
//
// Four kernels; the caller names which one runs (`route`, chosen in
// kernels/gemm.py::gemm_route by shape, dtype, layout and alignment), and
// nothing here falls back from one to another:
//
//   wgmma (gemm_wgmma.cuh) — bf16 operands with m > 16: the forward's,
//     graph forward's and hnp's GEMMs.  Tensor cores (`wgmma`) on bf16
//     tiles staged by TMA through a ring of mbarrier-guarded stages, fp32
//     accumulators in registers, blocks over the tiles in grouped order
//     (kernels/gemm.py::wgmma_plan) so the L2 serves most panel reads;
//     bound by 989 TFLOP/s of bf16 work.
//   tf32x3 (gemm_tf32x3.cuh) — f32 operands with m > 16, any layout and
//     alignment: 3xTF32 `mma.sync` tiles fed by a cp.async ring, the mma
//     accumulator restarted every 32-deep k tile into an fp32 register sum,
//     k split across a cluster at small grids (plan from
//     kernels/gemm.py::tf32x3_plan); fp32-accurate (never a single TF32
//     product).
//   tiled  — the bf16 GEMMs with m > 16 that wgmma cannot take: a
//     column-major A, k % 8 != 0, or operands TMA cannot address.  A 64x64
//     register tile on the CUDA cores: operands widened to fp32 on load and
//     every product a true fp32 FMA.
//   skinny — m <= 16 (serving: m = batch), in gemm_skinny.cuh.  A GEMM
//     there does 2*m FLOPs per weight element it reads, far below the
//     card's ~295 FLOP/byte ridge, so the bound is the bytes of B over
//     3.35 TB/s: B read once in 16-byte cp.async copies through rings in
//     shared memory, every m <= 16 row in one block, k split across warps
//     and across the blocks of a cluster by a launch plan computed in
//     kernels/gemm.py::skinny_plan (never from the batch count), split
//     partials summed in split order through distributed shared memory (no
//     workspace, no atomics).  bf16 with 16-byte B vectors multiplies on
//     the tensor cores (mma.sync, fp32 accumulators); f32 and B the 16-byte
//     copies cannot read use fp32 FMAs on the CUDA cores.  Each pair has a
//     kernel for a row-major (MN-major) and one for a K-major B.  Each
//     launch is a programmatic dependent launch (it may start while the
//     kernel before it ends; all memory access waits for that kernel).
//     Its own entry point, repro_gemm_skinny, takes the plan.
//
// All four take a batch index (blockIdx.z) with batch strides, so a
// batched GEMM is the same kernel as the single one.
//
// Beside them, grouped (gemm_grouped.cuh) — the dropless MoE's ragged
// expert products, C[r] = A[r] @ B[e(r)] with A's rows sorted by expert and
// the per-expert offsets on the card: gemm_wgmma.cuh's producer, ring,
// consumers and epilogue over a tile table that each block reads from the
// offsets.  Its own entry point, repro_gemm_grouped.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes (see ../_build.py).  The launch never synchronises; it returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the named
// kernel does not take) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gemm_grouped.cuh"
#include "gemm_skinny.cuh"
#include "gemm_tf32x3.cuh"
#include "gemm_wgmma.cuh"

namespace {

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct GemmArgs {
  int M, N, K;
  long long sa_b, sa_m, sa_k;   // A strides (elements): batch, row, k
  long long sb_b, sb_k, sb_n;   // B strides: batch, k, column
  long long sc_b, sc_m;         // C strides: batch, row (column stride 1)
};

// ---- register-tiled kernel on the CUDA cores (bf16 m > 16 off wgmma) ------
constexpr int TB_M = 64, TB_N = 64, TB_K = 16, TT_M = 4, TT_N = 4;
constexpr int TB_THREADS = (TB_M / TT_M) * (TB_N / TT_N);   // 256

template <typename TI, typename TO>
__global__ void __launch_bounds__(TB_THREADS)
gemm_tiled(const TI* __restrict__ A, const TI* __restrict__ B,
           TO* __restrict__ C, GemmArgs g) {
  // As is stored k-major with one pad column so the transposing store of a
  // row-major A tile is free of bank conflicts.
  __shared__ float As[TB_K][TB_M + 1];
  __shared__ float Bs[TB_K][TB_N];
  const long long z = blockIdx.z;
  A += z * g.sa_b;
  B += z * g.sb_b;
  C += z * g.sc_b;
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;
  const int tid = threadIdx.x;
  constexpr int COLS = TB_N / TT_N;   // threads along n
  constexpr int ROWS = TB_M / TT_M;   // threads along m
  const int tr = tid / COLS, tc = tid % COLS;

  float acc[TT_M][TT_N];
#pragma unroll
  for (int i = 0; i < TT_M; ++i)
#pragma unroll
    for (int j = 0; j < TT_N; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += TB_K) {
    for (int i = tid; i < TB_M * TB_K; i += TB_THREADS) {
      const int r = i / TB_K, kk = i % TB_K;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < g.M && gk < g.K) ? to_f32(A[gm * g.sa_m + gk * g.sa_k]) : 0.f;
    }
    for (int i = tid; i < TB_K * TB_N; i += TB_THREADS) {
      const int kk = i / TB_N, c = i % TB_N;
      const int gk = k0 + kk, gn = n0 + c;
      Bs[kk][c] = (gk < g.K && gn < g.N) ? to_f32(B[gk * g.sb_k + gn * g.sb_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; ++kk) {
      float a[TT_M], b[TT_N];
#pragma unroll
      for (int i = 0; i < TT_M; ++i) a[i] = As[kk][tr + i * ROWS];
#pragma unroll
      for (int j = 0; j < TT_N; ++j) b[j] = Bs[kk][tc + j * COLS];
#pragma unroll
      for (int i = 0; i < TT_M; ++i)
#pragma unroll
        for (int j = 0; j < TT_N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TT_M; ++i) {
    const int gm = m0 + tr + i * ROWS;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TT_N; ++j) {
      const int gn = n0 + tc + j * COLS;
      if (gn < g.N) C[gm * g.sc_m + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

enum Route { kSkinny = 0, kTiled = 1, kWgmma = 2, kTf32x3 = 3 };

template <typename TI, typename TO>
cudaError_t launch(const void* a, const void* b, void* c, const GemmArgs& g,
                   int batch, int route, cudaStream_t stream) {
  const TI* A = static_cast<const TI*>(a);
  const TI* B = static_cast<const TI*>(b);
  TO* C = static_cast<TO*>(c);
  if (route == kTiled) {
    dim3 grid((g.N + TB_N - 1) / TB_N, (g.M + TB_M - 1) / TB_M, batch);
    gemm_tiled<TI, TO><<<grid, TB_THREADS, 0, stream>>>(A, B, C, g);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  route: 1 tiled, 2 wgmma (bf16
// inputs, row-major A, B with k- or n-stride 1), 3 tf32x3 (f32 inputs);
// the skinny route (0) has its own entry point below.  The last five ints
// are the tf32x3 launch plan of kernels/gemm.py::tf32x3_plan (the other
// routes ignore them): tile (0 = 128x64, 1 = 64x64, 2 = 32x32), layout
// (bit 0: A staged k-contiguous, i.e. row-major; bit 1: B staged
// k-contiguous, i.e. K-major), splits (blocks of a cluster along k, at
// most 8), kc (k rows per split, a multiple of 8) and vec (bit 0: A in
// 16-byte copies; bit 1: B).  The int after them is the wgmma plan of
// kernels/gemm.py::wgmma_plan (the other routes ignore it): group, the m
// tiles a group of the tile order (at least 1; the m tiles or more: the
// plain order).  Returns a cudaError_t as int (cudaErrorInvalidValue for a
// dtype pair, plan or operands the route does not take).
extern "C" int repro_gemm(const void* a, const void* b, void* c,
                          int M, int N, int K, int batch,
                          long long sa_b, long long sa_m, long long sa_k,
                          long long sb_b, long long sb_k, long long sb_n,
                          long long sc_b, long long sc_m,
                          int in_dtype, int out_dtype, int route,
                          int tile, int layout, int splits, int kc, int vec,
                          int group, void* stream) {
  GemmArgs g{M, N, K, sa_b, sa_m, sa_k, sb_b, sb_k, sb_n, sc_b, sc_m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  cudaError_t e;
  if (route == kTf32x3) {
    if (in_dtype != 0 || (out_dtype != 0 && out_dtype != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    t3::Args t{M, N, K, sa_b, sa_m, sa_k, sb_b, sb_k, sb_n, sc_b, sc_m,
               splits, kc, vec & 1, (vec >> 1) & 1, out_dtype == 1};
    e = t3::launch(static_cast<const float*>(a), static_cast<const float*>(b),
                   c, t, batch, tile, (layout & 1) != 0, (layout & 2) != 0, s);
  } else if (route == kWgmma) {
    if (in_dtype != 1 || sa_k != 1 || (sb_n != 1 && sb_k != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto* A = static_cast<const __nv_bfloat16*>(a);
    const auto* B = static_cast<const __nv_bfloat16*>(b);
    if (out_dtype == 0)
      e = wg::launch<float>(A, B, static_cast<float*>(c), M, N, K, batch,
                            sa_b, sa_m, sb_b, sb_k, sb_n, sc_b, sc_m, group,
                            s);
    else if (out_dtype == 1)
      e = wg::launch<__nv_bfloat16>(A, B, static_cast<__nv_bfloat16*>(c), M,
                                    N, K, batch, sa_b, sa_m, sb_b, sb_k, sb_n,
                                    sc_b, sc_m, group, s);
    else
      e = cudaErrorInvalidValue;
  } else if (in_dtype == 1 && out_dtype == 0) {
    e = launch<__nv_bfloat16, float>(a, b, c, g, batch, route, s);
  } else if (in_dtype == 1 && out_dtype == 1) {
    e = launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, g, batch, route, s);
  } else {
    e = cudaErrorInvalidValue;   // f32 inputs with m > 16 take tf32x3
  }
  return static_cast<int>(e);
}

// How many blocks of the tf32x3 kernel with block tile `tile` (codes as
// for repro_gemm) the current device runs at once in clusters of
// `splits`, into *blocks (cudaOccupancyMaxActiveClusters).  Returns a
// cudaError_t as int.
extern "C" int repro_gemm_tf32x3_capacity(int tile, int splits, int* blocks) {
  return static_cast<int>(t3::capacity(tile, splits, blocks));
}

// The skinny route (m <= 16) with the launch plan of kernels/gemm.py::
// skinny_plan: k_major (B's k stride is 1) picks the K-major kernel, else
// the MN-major one; vec 16 / itemsize or 1 (bf16 with 16-byte vectors runs
// on the tensor cores, the rest on the CUDA cores); splits blocks of a
// cluster along k (at most 8), kc rows each (a multiple of 8); tn_log2 the
// CUDA-core MN-major kernel's log2 of threads per k row; a_vec 16 /
// itemsize when A is staged in 16-byte loads (unit k-stride, aligned
// rows), else 1.  Needs no workspace.  Returns a cudaError_t as int
// (cudaErrorInvalidValue for a plan the operands do not allow).
extern "C" int repro_gemm_skinny(const void* a, const void* b, void* c,
                                 int M, int N, int K, int batch,
                                 long long sa_b, long long sa_m, long long sa_k,
                                 long long sb_b, long long sb_k, long long sb_n,
                                 long long sc_b, long long sc_m,
                                 int in_dtype, int out_dtype, int k_major,
                                 int vec, int splits, int kc, int tn_log2,
                                 int a_vec, void* stream) {
  sk::Args g{M, N, K, sa_b, sa_m, sa_k, sb_b, sb_k, sb_n, sc_b, sc_m,
             splits, kc, tn_log2, a_vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  const bool km = k_major != 0;
  cudaError_t e;
  if (in_dtype == 0 && out_dtype == 0)
    e = sk::launch<float, float>(a, b, c, g, batch, km, vec, s);
  else if (in_dtype == 0 && out_dtype == 1)
    e = sk::launch<float, __nv_bfloat16>(a, b, c, g, batch, km, vec, s);
  else if (in_dtype == 1 && out_dtype == 0)
    e = sk::launch<__nv_bfloat16, float>(a, b, c, g, batch, km, vec, s);
  else if (in_dtype == 1 && out_dtype == 1)
    e = sk::launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, g, batch, km, vec, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The ragged grouped GEMM (gemm_grouped.cuh): C (R, N) = A (R, K) @ B[e]
// for the rows offsets[e] .. offsets[e+1] - 1 of A, B an (E, K, N) stack of
// row-major bf16 matrices, offsets (E + 1) int32 on the card; A row stride
// sa_m, B expert stride sb_e and row stride sb_k, C row stride sc_m, in
// elements.  out_dtype as for repro_gemm.  Returns a cudaError_t as int
// (cudaErrorInvalidValue for operands the kernel does not take).
extern "C" int repro_gemm_grouped(const void* a, const void* b, void* c,
                                  const void* offsets, int R, int N, int K,
                                  int E, long long sa_m, long long sb_e,
                                  long long sb_k, long long sc_m,
                                  int out_dtype, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* B = static_cast<const __nv_bfloat16*>(b);
  const auto* off = static_cast<const int*>(offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (out_dtype == 0)
    e = wg::launch_grouped<float>(A, B, static_cast<float*>(c), off, R, N, K,
                                  E, sa_m, sb_e, sb_k, sc_m, s);
  else if (out_dtype == 1)
    e = wg::launch_grouped<__nv_bfloat16>(A, B,
                                          static_cast<__nv_bfloat16*>(c), off,
                                          R, N, K, E, sa_m, sb_e, sb_k, sc_m,
                                          s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
