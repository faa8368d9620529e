// Mamba-2 SSD within-chunk term for Hopper (sm_90a):
//
//     Y[z, c] = (L ∘ C Bᵀ) X,   L[i, j] = exp(dta_i − dta_j) · [j ≤ i]
//
// per (bh, chunk) cell, with x (BH, C, Q, P), dta (BH, C, Q), b and c
// (BH, C, Q, N) and the output (BH, C, Q, P), all contiguous.
//
// Replaces the reference's Pallas TPU kernel `_ssd_chunk_kernel` via
// `ssd_chunk_diag` (src/repro/kernels/ssd_scan.py:37).  There one grid cell
// held a whole (bh, chunk) cell in VMEM: C and B (Q x N each), the Q x Q
// scores, the mask and X.  At mamba2-370m's widths (Q 256, N 128, P 64)
// C and B alone take 128 KB each in fp32, more than a block's 227 KB of
// shared memory.
//
// Two routes, picked by kernels/ssd_scan.py::ssd_route before the launch:
//
//  * "mma" (ssd_mma.cuh): 3xTF32 mma.sync tiles on the tensor cores, the
//    causal triangle balanced across blocks.  f32 and bf16 whose rows are
//    whole 16-byte chunks, P <= 128, shared memory within a block's.  Its
//    note gives the design, the bound and the precision argument.  Every
//    SSD launch of the models' forwards takes it.
//  * "simt" (below): the rest (P up to 256, rows not whole 16-byte
//    chunks).  One block serves one (cell, tile of BQ query rows); a loop
//    inside the block walks the key tiles j <= the query tile, so key
//    tiles above the diagonal are never loaded; for each key tile the
//    scores S = C_tile · B_tileᵀ are summed over the state dimension in
//    chunks of NC columns staged through shared memory, kept in registers,
//    decayed, then S · X_tile is accumulated into a BQ x P fp32
//    accumulator in registers.  Every product is a true fp32 FMA on the
//    CUDA cores (no TF32).  The decay is exp(dta_i − dta_j) for each pair,
//    never factored (exp(180) overflows fp32), and masked pairs are
//    selected to 0, not multiplied by a 0/1 mask (inf · 0 is NaN).  Rows
//    past Q read as 0 and are never stored.
//
// simt thread layout: 256 threads as a 16 x 16 grid (ty, tx).  Thread
// (ty, tx) owns query rows ty + 16 i (i < 4) of the 64-row tile; for the
// scores it owns key columns tx + 16 j (j < 4), for the output head-dim
// columns tx + 16 j (j < NJ).  Shared rows are padded by one float so
// column walks are free of bank conflicts.
//
// ssd_mma.cuh also holds the whole chunked SSD core (chunk states, the pass
// over the chunks, the chunk output with B and C read once a group; entry
// repro_ssd_scan_chunked below).
//
// The same library holds the mixer's depthwise causal conv + SiLU, which
// makes the kernel's x / B / C operands (mamba_conv.cuh, entry
// repro_causal_conv_silu below).
//
// Plain C interface for ctypes (see ../_build.py); returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mamba_conv.cuh"
#include "ssd_mma.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // key rows per step of the block's loop
constexpr int NC = 32;             // state columns per step of the score sum
constexpr int THREADS = 256;
constexpr int RI = BQ / 16;        // rows per thread
constexpr int CJ = BK / 16;        // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory (floats): Cs[BQ][NC+1] | Bs[BK][NC+1] | Ps[BQ][BK+1] |
// Xs[BK][P+1] | dq[BQ] | dk[BK].
__host__ __device__ inline size_t smem_bytes(int P) {
  return sizeof(float) * ((size_t)(BQ + BK) * (NC + 1) + (size_t)BQ * (BK + 1) +
                          (size_t)BK * (P + 1) + BQ + BK);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ dta,
                 const T* __restrict__ b, const T* __restrict__ c,
                 T* __restrict__ out, int Q, int P, int N) {
  extern __shared__ float smem[];
  const int ldx = P + 1;
  float* Cs = smem;
  float* Bs = Cs + BQ * (NC + 1);
  float* Ps = Bs + BK * (NC + 1);
  float* Xs = Ps + BQ * (BK + 1);
  float* dq = Xs + BK * ldx;
  float* dk = dq + BQ;

  const long long cell = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* xc = x + cell * Q * P;
  const T* bc = b + cell * Q * N;
  const T* cc = c + cell * Q * N;
  const T* ac = dta + cell * Q;

  if (tid < BQ) dq[tid] = q0 + tid < Q ? to_f32(ac[q0 + tid]) : 0.f;
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // Key tiles 0 .. the one holding the tile's last query row.
  const int q_last = min(q0 + BQ, Q) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += BK) {
    if (tid < BK) dk[tid] = k0 + tid < Q ? to_f32(ac[k0 + tid]) : 0.f;

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int n0 = 0; n0 < N; n0 += NC) {
      for (int i = tid; i < BQ * NC; i += THREADS) {
        const int r = i / NC, col = i % NC, gn = n0 + col;
        const int gq = q0 + r, gk = k0 + r;
        Cs[r * (NC + 1) + col] =
            (gq < Q && gn < N) ? to_f32(cc[(long long)gq * N + gn]) : 0.f;
        Bs[r * (NC + 1) + col] =
            (gk < Q && gn < N) ? to_f32(bc[(long long)gk * N + gn]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int nn = 0; nn < NC; ++nn) {
        float cv[RI], bv[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) cv[i] = Cs[(ty + 16 * i) * (NC + 1) + nn];
#pragma unroll
        for (int j = 0; j < CJ; ++j) bv[j] = Bs[(tx + 16 * j) * (NC + 1) + nn];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
      __syncthreads();   // Cs / Bs are free for the next columns
    }

    // Decay by select: a live pair has gk <= gq < Q (so gk < Q too).
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + 16 * i, gq = q0 + row;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j, gk = k0 + col;
        Ps[row * (BK + 1) + col] =
            (gk <= gq && gq < Q) ? s[i][j] * expf(dq[row] - dk[col]) : 0.f;
      }
    }
    for (int i = tid; i < BK * P; i += THREADS) {
      const int r = i / P, d = i % P, gk = k0 + r;
      Xs[r * ldx + d] = gk < Q ? to_f32(xc[(long long)gk * P + d]) : 0.f;
    }
    __syncthreads();   // Ps and Xs are complete

    const int kn = min(BK, Q - k0);   // rows past Q are 0 in Ps
    for (int kk = 0; kk < kn; ++kk) {
      float xv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        xv[j] = d < P ? Xs[kk * ldx + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, xv[j], acc[i][j]);
      }
    }
    __syncthreads();   // Ps, Xs and dk are free for the next key tile
  }

  T* oc = out + cell * Q * P;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= Q) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < P) oc[(long long)gq * P + d] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int NJ>
int launch(const void* x, const void* dta, const void* b, const void* c,
           void* out, long long cells, int Q, int P, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_chunk_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>(cells), (Q + BQ - 1) / BQ);
  ssd_chunk_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dta),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(out), Q, P, N);
  return static_cast<int>(cudaGetLastError());
}

// Head-dim columns per thread, rounded up to an instantiated width.
template <typename T>
int dispatch_p(const void* x, const void* dta, const void* b, const void* c,
               void* out, long long cells, int Q, int P, int N, cudaStream_t s) {
  const int nj = (P + 15) / 16;
  if (nj <= 1) return launch<T, 1>(x, dta, b, c, out, cells, Q, P, N, s);
  if (nj <= 2) return launch<T, 2>(x, dta, b, c, out, cells, Q, P, N, s);
  if (nj <= 4) return launch<T, 4>(x, dta, b, c, out, cells, Q, P, N, s);
  if (nj <= 8) return launch<T, 8>(x, dta, b, c, out, cells, Q, P, N, s);
  if (nj <= 16) return launch<T, 16>(x, dta, b, c, out, cells, Q, P, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (cells, Q, P), dta: (cells, Q), b / c: (cells, Q, N), out: (cells, Q, P),
// all contiguous and of one dtype (0 = float32, 1 = bfloat16); cells = BH·C.
// route 0 = simt, 1 = mma; tiles and pairs are the mma route's plan
// (kernels/ssd_scan.py::ssd_plan: ceil(Q / 64) query tiles, paired t with
// tiles − 1 − t into ceil(tiles / 2) blocks a cell).  1 <= P <= 256,
// N >= 1 and cells < 2^31 are checked here and by the caller; the mma
// route checks its own limits.
extern "C" int repro_ssd_chunk_diag(const void* x, const void* dta,
                                    const void* b, const void* c, void* out,
                                    long long cells, int Q, int P, int N,
                                    int dtype, int route, int tiles, int pairs,
                                    void* stream) {
  if (cells <= 0 || Q <= 0) return 0;
  if (cells > INT_MAX || P <= 0 || P > 256 || N <= 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype == 0)
      return ssd_mma::dispatch<float>(x, dta, b, c, out, cells, Q, P, N, tiles, pairs, s);
    return ssd_mma::dispatch<__nv_bfloat16>(x, dta, b, c, out, cells, Q, P, N, tiles,
                                            pairs, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_p<float>(x, dta, b, c, out, cells, Q, P, N, s);
  return dispatch_p<__nv_bfloat16>(x, dta, b, c, out, cells, Q, P, N, s);
}

// The whole SSD core on route "chunked" (ssd_mma.cuh): x (B, S, H, P) and
// b / c (B, S, G, N) f32 read in place through their strides (9 numbers:
// batch, sequence and head / group strides of x, b, c in elements; unit
// along P / N; every address and stride 16-byte aligned), dt (B, H, S)
// and cum (B, H, C, Q) f32 contiguous, d (H,) f32; states a (B, C, H, N, P)
// f32 buffer it overwrites; out (B, S, H, P) f32 contiguous.  hg heads a
// block, a divisor of H / G (kernels/ssd_scan.py::heads_per_block).  Three
// launches: the chunk states, the pass over the chunks, the chunk output.
extern "C" int repro_ssd_scan_chunked(const void* x, const void* b, const void* c,
                                      const void* dt, const void* cum, const void* d,
                                      void* states, void* out, const long long* strides,
                                      int B, int S, int H, int G, int P, int N, int Q,
                                      int hg, void* stream) {
  const long long xs[3] = {strides[0], strides[1], strides[2]};
  const long long bs[3] = {strides[3], strides[4], strides[5]};
  const long long cs[3] = {strides[6], strides[7], strides[8]};
  return ssd_mma::chunked(static_cast<const float*>(x), static_cast<const float*>(b),
                          static_cast<const float*>(c), static_cast<const float*>(dt),
                          static_cast<const float*>(cum), static_cast<const float*>(d),
                          static_cast<float*>(states), static_cast<float*>(out), xs, bs, cs, B,
                          S, H, G, P, N, Q, hg, static_cast<cudaStream_t>(stream));
}

// Depthwise causal conv + SiLU of the x (B, S, di), B and C (B, S, gn)
// projections into out (B, S, di + 2·gn) f32, contiguous; w (K, F) and
// bias (F,) contiguous.  strides: the batch and sequence strides of x, B,
// C in elements (the channel stride is 1).  silu 0 writes the
// pre-activation (the conv rounded to the dtype) instead, for checks.
// dtype 0 = float32, 1 = bfloat16, one for all five operands.  K = 4, di
// and gn multiples of 4; the caller (kernels/ssd_scan.py::conv_route) also
// checks that x, B, C and their strides are aligned to 4 channels.
extern "C" int repro_causal_conv_silu(const void* x, const void* b, const void* c,
                                      const void* w, const void* bias, void* out,
                                      const long long* strides, int B, int S, int di,
                                      int gn, int K, int silu, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || di + 2 * gn <= 0) return 0;
  if (di < 0 || gn < 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mamba_conv::dispatch<float>(x, b, c, w, bias, out, strides, B, S, di, gn, K,
                                       silu, s);
  return mamba_conv::dispatch<__nv_bfloat16>(x, b, c, w, bias, out, strides, B, S, di, gn,
                                             K, silu, s);
}
