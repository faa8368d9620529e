// Flash decode for Hopper (sm_90a): one query token per (batch, q head)
// against a KV cache, with per-batch valid-slot bounds [lo[b], hi[b]).
//
// Replaces the reference's Pallas TPU kernel `_decode_kernel` / `flash_decode`
// (src/repro/kernels/flash_decode.py).  There one grid step per (b, q head,
// kv block) carried the fp32 online-softmax state (m, l, acc) in VMEM across
// the sequential kv grid axis.  Here one block serves one (b, kv head) and
// all `group = Hq / Hkv` q heads that share it, so K and V are read from
// device memory once per kv head, not once per q head; the loop over the
// cache runs inside the block in chunks of CHUNK slots, with (m, l, acc) in
// shared memory.
//
// Masking follows the reference exactly: a slot outside [lo, hi) gets the
// score -1e30 by select and probability 0, and a row with l == 0 (nothing
// valid) outputs 0.  Chunks wholly outside [lo, hi) are never read.  The
// ragged tail of the cache (S not a multiple of CHUNK) is masked in the
// loads, where the reference halved its block size until it divided S.
//
// What bounds it on an H100: one pass over the valid K and V slots at 4
// FLOPs per element (q.k and p.v), far below the card's FLOP/byte ridge,
// so the bound is bytes of K and V over 3.35 TB/s.  A block's lanes split
// the head dimension, so each warp reads a slot's K and V rows as
// contiguous, coalesced segments, and the V chunk is staged in shared
// memory once for all `group` q heads.
//
// Plain C interface for ctypes (see ../_build.py); returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CHUNK = 32;          // cache slots per step of the block's loop
constexpr int THREADS = 128;       // four warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory layout (floats): q[group*D] | acc[group*D] | v[CHUNK*D] |
// p[group*CHUNK] | m[group] | l[group] | corr[group]; then valid[CHUNK] ints.
__host__ __device__ inline size_t smem_bytes(int group, int D) {
  return sizeof(float) * (2 * (size_t)group * D + (size_t)CHUNK * D +
                          (size_t)group * CHUNK + 3 * (size_t)group) +
         sizeof(int) * CHUNK;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lo_b,
                    const int* __restrict__ hi_b, T* __restrict__ out,
                    int Hq, int Hkv, int S, int D, float scale) {
  extern __shared__ float smem[];
  const int group = Hq / Hkv;
  float* qs = smem;
  float* acc = qs + group * D;
  float* vs = acc + group * D;
  float* ps = vs + CHUNK * D;
  float* ms = ps + group * CHUNK;
  float* ls = ms + group;
  float* cs = ls + group;
  int* valid = reinterpret_cast<int*>(cs + group);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int h0 = hk * group;                       // first q head served
  const long long kv_base = ((long long)b * Hkv + hk) * S * D;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;

  for (int i = tid; i < group * D; i += THREADS) {
    qs[i] = to_f32(q[((long long)b * Hq + h0) * D + i]);
    acc[i] = 0.f;
  }
  if (tid < group) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }
  const int lo = max(lo_b[b], 0);
  const int hi = min(hi_b[b], S);
  __syncthreads();

  // Chunks that hold no slot of [lo, hi) contribute nothing: start at the
  // chunk holding lo and stop at hi.
  for (int c0 = (lo / CHUNK) * CHUNK; c0 < hi; c0 += CHUNK) {
    // 1. scores: warp w takes slots w, w+4, ...; lanes split D.
    for (int j = w; j < CHUNK; j += WARPS) {
      const int pos = c0 + j;
      const bool ok = pos >= lo && pos < hi;
      if (ok) {
        float kr[MAX_D / 32];
#pragma unroll
        for (int t = 0; t < MAX_D / 32; ++t) {
          const int d = lane + 32 * t;
          kr[t] = d < D ? to_f32(kb[(long long)pos * D + d]) : 0.f;
          if (d < D) vs[j * D + d] = to_f32(vb[(long long)pos * D + d]);
        }
        for (int g = 0; g < group; ++g) {
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < MAX_D / 32; ++t) {
            const int d = lane + 32 * t;
            if (d < D) part = fmaf(qs[g * D + d], kr[t], part);
          }
          part = warp_sum(part);
          if (lane == 0) ps[g * CHUNK + j] = part * scale;
        }
      } else {
        for (int d = lane; d < D; d += 32) vs[j * D + d] = 0.f;
        if (lane == 0)
          for (int g = 0; g < group; ++g) ps[g * CHUNK + j] = NEG;
      }
      if (lane == 0) valid[j] = ok;
    }
    __syncthreads();
    // 2. online-softmax update, one thread per q head of the group.
    for (int g = tid; g < group; g += THREADS) {
      float mx = NEG;
      for (int j = 0; j < CHUNK; ++j) mx = fmaxf(mx, ps[g * CHUNK + j]);
      const float m_new = fmaxf(ms[g], mx);
      float sum = 0.f;
      for (int j = 0; j < CHUNK; ++j) {
        const float p = valid[j] ? expf(ps[g * CHUNK + j] - m_new) : 0.f;
        ps[g * CHUNK + j] = p;
        sum += p;
      }
      const float corr = expf(ms[g] - m_new);
      ls[g] = corr * ls[g] + sum;
      ms[g] = m_new;
      cs[g] = corr;
    }
    __syncthreads();
    // 3. acc = corr * acc + p @ V_chunk, threads over (head, d).
    for (int i = tid; i < group * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float a = acc[i] * cs[g];
#pragma unroll 8
      for (int j = 0; j < CHUNK; ++j) a = fmaf(ps[g * CHUNK + j], vs[j * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < group * D; i += THREADS) {
    const float l = ls[i / D];
    out[((long long)b * Hq + h0) * D + i] = from_f32<T>(l == 0.f ? 0.f : acc[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lo, const int* hi,
           void* out, int B, int Hq, int Hkv, int S, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(Hkv, B);
  flash_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lo, hi, static_cast<T*>(out), Hq, Hkv, S, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, D); k, v: (B, Hkv, S, D); lo, hi: (B,) int32; out: (B, Hq, D).
// All contiguous, one dtype (0 = float32, 1 = bfloat16).  Hq % Hkv == 0 and
// 8 <= D <= 256 are checked by the caller.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* lo, const void* hi, void* out,
                                  int B, int Hq, int Hkv, int S, int D,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (D > MAX_D || Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lo_i = static_cast<const int*>(lo);
  const int* hi_i = static_cast<const int*>(hi);
  if (dtype == 0) return launch<float>(q, k, v, lo_i, hi_i, out, B, Hq, Hkv, S, D, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, lo_i, hi_i, out, B, Hq, Hkv, S, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
