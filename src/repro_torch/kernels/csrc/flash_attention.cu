// Flash attention for Hopper (sm_90a): online-softmax attention over a full
// query sequence, causal / sliding-window / bidirectional, with GQA.
//
// Replaces the reference's Pallas TPU kernel `_attn_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py).  Three kernels; the caller names
// which one runs (`route`, chosen in kernels/flash_attention.py::
// flash_attention_route by dtype, head dim, strides and alignment), and
// nothing here falls back from one to another:
//
//   wgmma (attn_wgmma.cuh) — bf16 with D 64, 80 or 128 and TMA-addressable
//     operands (the models' prefill and forward): Hopper tensor cores fed
//     by TMA.
//   tf32x3 (attn_tf32x3.cuh) — f32 with D a multiple of 8 up to 128 and
//     16-byte-aligned operands (the f32 checks): 3xTF32 `mma.sync`, fed
//     by cp.async, fp32-accurate (the 2e-5 bar).
//   simt (below) — everything else: other head dims (D 32 in bf16, D not a
//     multiple of 8 in f32, D over 128), misaligned or broadcast operands.
//
// The CUDA-core kernel.  In the Pallas kernel the grid was (b, q head,
// q block, kv block) with the kv axis sequential: the fp32 running state
// (m, l, acc) lived in VMEM scratch and was carried from one grid step to
// the next, fully masked tiles skipped their compute under `pl.when` but
// still streamed their K/V DMA, and ragged Sq / Skv were zero-padded by
// copies in the wrapper.  Here:
//
//  * one block serves one (b, q head, tile of BQ queries); the kv loop runs
//    inside the block with (m, l, acc) in registers, so nothing carries
//    between blocks, which run in parallel and in no order;
//  * the loop visits only kv tiles that can hold a live position for some
//    query of the tile: under `causal` it stops at the tile holding the last
//    query's position, under `window` it starts at the tile holding the
//    first query's oldest visible position.  Dead tiles are never loaded;
//  * ragged tails are masked in the loads (rows past Sq / Skv read as 0 and
//    are never attended or stored), so no operand is padded or copied, and
//    q / k / v may be strided views (the head and sequence strides are
//    passed in; the head dimension must be contiguous);
//  * queries are right-aligned (position = Skv - Sq + row), masked scores
//    are -1e30 by select with probability 0, and a row with no live
//    position (l == 0) outputs 0, as in the reference.
//
// Arithmetic: operands widen to fp32 in shared memory and every product is a
// true fp32 FMA on the CUDA cores (no TF32, no tensor cores), so f32 inputs
// meet the reference's 2e-5 and bf16 inputs accumulate in fp32.
//
// What bounds it on an H100: prefill attention does 4·D FLOPs per (query,
// live key) pair against 2·D·itemsize bytes per key row, so at yi-6b's
// prefill shape (S 512, D 128) the work is FLOP-bound at the tensor cores'
// rate; this kernel uses the CUDA cores' fp32 FMAs (about 67 TFLOP/s on
// the data sheet) and sits far from that bound, so every operand the two
// tensor-core kernels can take goes to them; it stays for the rest.
//
// Thread layout: 256 threads as a 16 x 16 grid (ty, tx).  Thread (ty, tx)
// owns query rows ty + 16 i (i < 4) of the 64-row tile; for the scores it
// owns key columns tx + 16 j (j < 4), for the output head-dim columns
// tx + 16 j (j < NJ).  The 16 threads sharing a row are 16 lanes of one
// warp, so row max and row sum reduce with shuffles.  Shared rows are
// padded by one float so column walks are free of bank conflicts.
//
// Plain C interface for ctypes (see ../_build.py); returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_tf32x3.cuh"
#include "attn_wgmma.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BKV = 64;            // key rows per step of the block's loop
constexpr int THREADS = 256;
constexpr int RI = BQ / 16;        // rows per thread
constexpr int CJ = BKV / 16;       // score columns per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct AttnArgs {
  int Hq, Hkv, Sq, Skv, D;
  int causal, use_window, window;
  float scale;
  long long q_b, q_h, q_s;     // element strides (head dim contiguous)
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
};

// Shared memory (floats): Q[BQ][D+1] | KV[BKV][D+1] | P[BQ][BKV+1].
// K and V of a step share one buffer: the scores are done with K before V
// is loaded.
__host__ __device__ inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + BKV) * (D + 1) + (size_t)BQ * (BKV + 1));
}

__device__ __forceinline__ bool live(int q_pos, int kv_pos, const AttnArgs& a) {
  return kv_pos < a.Skv && (!a.causal || kv_pos <= q_pos) &&
         (!a.use_window || q_pos - kv_pos < a.window);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, AttnArgs a) {
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1;
  float* Qs = smem;
  float* KVs = Qs + BQ * ld;
  float* Ps = KVs + BKV * ld;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = q + b * a.q_b + h * a.q_h;
  const T* kb = k + b * a.k_b + hk * a.k_h;
  const T* vb = v + b * a.v_b + hk * a.v_h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, gq = q0 + r;
    Qs[r * ld + d] = gq < a.Sq ? to_f32(qb[gq * a.q_s + d]) : 0.f;
  }
  float m[RI], l[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // The kv range any query of this tile can see.
  const int q_offset = a.Skv - a.Sq;
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + BQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Skv, qpos_last + 1) : a.Skv;
  const long long first_live =
      a.use_window ? (long long)qpos_first - a.window + 1 : 0;
  const int kv_begin =
      (int)(max(0LL, min(first_live, (long long)a.Skv)) / BKV) * BKV;
  __syncthreads();

  for (int c0 = kv_begin; c0 < kv_end; c0 += BKV) {
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D, gk = c0 + r;
      KVs[r * ld + d] = gk < a.Skv ? to_f32(kb[gk * a.k_s + d]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = KVs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + 16 * i;
      const int q_pos = qpos_first + row;
      bool ok[CJ];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        ok[j] = live(q_pos, c0 + tx + 16 * j, a);
        s[i][j] = ok[j] ? s[i][j] * a.scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[row * (BKV + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();   // every thread is done with K; P is complete

    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D, gk = c0 + r;
      KVs[r * ld + d] = gk < a.Skv ? to_f32(vb[gk * a.v_s + d]) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < BKV; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? KVs[c * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = Ps[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();   // V and P are free for the next step
  }

  T* ob = out + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= a.Sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[gq * a.o_s + d] = from_f32<T>(l[i] == 0.f ? 0.f : acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  flash_attention_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

// Head-dim columns per thread, rounded up to an instantiated width.
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               const AttnArgs& a, cudaStream_t s) {
  const int nj = (a.D + 15) / 16;
  if (nj <= 1) return launch<T, 1>(q, k, v, out, B, a, s);
  if (nj <= 2) return launch<T, 2>(q, k, v, out, B, a, s);
  if (nj <= 4) return launch<T, 4>(q, k, v, out, B, a, s);
  if (nj <= 6) return launch<T, 6>(q, k, v, out, B, a, s);
  if (nj <= 8) return launch<T, 8>(q, k, v, out, B, a, s);
  if (nj <= 16) return launch<T, 16>(q, k, v, out, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D), out: (B, Hq, Sq, D), each with
// the given element strides for batch, head and sequence and a contiguous
// head dimension; one dtype (0 = float32, 1 = bfloat16).  With use_window a
// key is live only if q_pos - kv_pos < window (any int: 0 or less masks
// whole rows, as in the reference).  Hq % Hkv == 0, Skv >= Sq and
// 1 <= D <= 256 are checked here and by the caller.  route: 0 simt, 1
// wgmma (bf16, D 64, 80 or 128, 16-byte-aligned addresses and strides; an
// operand TMA cannot address returns cudaErrorInvalidValue), 2 tf32x3
// (f32, D % 8 == 0 and D <= 128, 16-byte-aligned addresses and strides;
// anything else returns cudaErrorInvalidValue).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
    int use_window, int window, float scale,
    long long q_b, long long q_h, long long q_s,
    long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s,
    long long o_b, long long o_h, long long o_s,
    int dtype, int route, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || D <= 0 || D > 256 || Skv < Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(fa::run(
        q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, use_window, window,
        scale, {q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},
        {o_b, o_h, o_s}, s));
  }
  if (route == 2) {
    if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(fa3::run(
        q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, use_window, window,
        scale, {q_b, q_h, q_s}, {k_b, k_h, k_s}, {v_b, v_h, v_s},
        {o_b, o_h, o_s}, s));
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{Hq, Hkv, Sq, Skv, D, causal, use_window, window, scale,
             q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s};
  if (dtype == 0) return dispatch_d<float>(q, k, v, out, B, a, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(q, k, v, out, B, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
