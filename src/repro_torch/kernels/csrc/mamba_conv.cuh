// Mamba-2's depthwise causal conv and its SiLU, in one pass (sm_90a):
//
//     out[b, s, f] = silu(round_T(Σ_i u[b, s − (K−1) + i, f] · w[i, f] + bias[f]))
//
// where u is the x, B and C projections side by side along f (widths di,
// gn, gn; F = di + 2·gn), each read in place by its own strides, rows
// before a sequence's start read as 0, round_T rounds the fp32 sum once to
// the operands' dtype T (bf16 or f32), and the SiLU is fp32.  The output
// is (B, S, F) f32, contiguous.  K is 4, the width every Mamba-2
// configuration of the port sets; the caller refuses any other.  `silu` 0
// writes the rounded sum itself, the pre-activation: it exists only so that
// the card tests can hold it to the plain version's bit for bit, which the
// SiLU's output (a few ulp apart) cannot show.  Included by ssd_scan.cu,
// which holds the C entry point.
//
// Replaces no TPU kernel: the reference leaves the conv to XLA, whose
// fusion reads each projection once.  The port's torch composition
// (kernels/ref.py::causal_conv_silu_ref, the plain version) concatenates
// the three projections and runs K shifted pads, casts, multiplies and adds,
// a cast back and a SiLU: about 20 launches that move ≈ 26 × the pass's
// bytes (21.6 GB a layer at granite-4.0-h-small's 4 x 4096 tokens, F 8448).
//
// Bound on an H100 SXM (3.35 TB/s): the pass reads u once (bf16: 2·F bytes
// a row) and writes the f32 output once (4·F): 0.83 GB a layer at
// granite's shape, 0.248 ms.  2·K + 1 flops and a SiLU an output are little
// beside that, so the pass is bound by the bytes, and its design is about
// moving them in wide, coalesced accesses and nothing twice from HBM:
//  * A thread owns a vector of V = 4 channels (one 8-byte load a row in
//    bf16, 16 bytes in f32; one 16-byte store of the f32 result; never
//    straddling two projections: di and gn are multiples of 4) and a run
//    of `rows` positions of one sequence; consecutive threads take
//    consecutive vectors, so a warp reads 256 (bf16) contiguous bytes a row
//    and writes 512.  A run starts from its K − 1 halo rows (zeros before
//    position 0: no row reads across the boundary between sequences) and
//    slides a window of K rows along the run in registers, so the halo is
//    the only row read twice ((K − 1) / rows of the input, mostly from L2,
//    where the neighbouring run read it).
//  * The K taps and the bias of the thread's channels sit in registers for
//    the whole run (read once, element by element: no alignment asked of
//    the weights).  Four channels, not eight, a thread: with eight, taps,
//    window and loads in flight took 143 registers and one block an SM
//    (0.49 ms a launch at granite's shape); four leave room for three.
//  * Rows are loaded GROUP at a time before any is used, so each thread
//    keeps GROUP loads in flight.
//  * Runs are 32 rows, halved (to 4 at least) while the grid would give
//    fewer than 8 blocks an SM, so a small call still fills the card.
//
// Arithmetic, bit for bit with the plain version before the SiLU: each
// product is rounded on its own (__fmul_rn; a bf16 × bf16 product is exact
// in fp32) and added with __fadd_rn, tap 0 first onto 0.0f, then the bias,
// so no FMA contraction can change a sum; one rounding to T; the SiLU is
// x / (1 + expf(−x)) in fp32, as PyTorch's CUDA SiLU writes it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mamba_conv {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;     // blocks an SM the registers must allow
constexpr int V = 4;              // channels a thread
constexpr int MAX_ROWS = 32;      // positions a thread walks, at most
constexpr int GROUP = 4;          // rows loaded before any is used
constexpr int K = 4;              // conv width (taps)

// V channels of T loaded at once, and their exact unpacking to fp32.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[V]) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};
template <> struct Vec<float> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[V]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One thread: channels [vec·V, vec·V + V) of sequence `bi`, positions
// [run·rows, run·rows + rows) ∩ [0, S).  Threads are numbered vector
// fastest, then run, then sequence.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
causal_conv_silu_kernel(const T* __restrict__ x, const T* __restrict__ b,
                        const T* __restrict__ c, const T* __restrict__ w,
                        const T* __restrict__ bias, float* __restrict__ out,
                        long long sbx, long long ssx, long long sbb,
                        long long ssb, long long sbc, long long ssc, int S,
                        int di, int gn, int vecs, int rows, int runs,
                        long long threads, int silu) {
  using Raw = typename Vec<T>::Raw;
  const long long t = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (t >= threads) return;
  const int vec = static_cast<int>(t % vecs);
  const long long rest = t / vecs;
  const int run = static_cast<int>(rest % runs);
  const long long bi = rest / runs;
  const int F = di + 2 * gn;
  const int f0 = vec * V;

  // The projection these channels lie in (a select, not a branch).
  const bool in_x = f0 < di, in_b = !in_x && f0 < di + gn;
  const T* src = in_x ? x : in_b ? b : c;
  const long long sb = in_x ? sbx : in_b ? sbb : sbc;
  const long long ss = in_x ? ssx : in_b ? ssb : ssc;
  src += bi * sb + (in_x ? f0 : in_b ? f0 - di : f0 - di - gn);

  float wt[K][V], bs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int i = 0; i < K; ++i) wt[i][j] = to_f32(w[static_cast<long long>(i) * F + f0 + j]);
    bs[j] = to_f32(bias[f0 + j]);
  }

  const int s0 = run * rows;
  const int s1 = min(s0 + rows, S);
  // win[i] holds position s − (K − 1) + i for the row s about to be made.
  float win[K - 1][V];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int pos = s0 - (K - 1) + i;
    Vec<T>::unpack(pos >= 0 ? __ldg(reinterpret_cast<const Raw*>(src + pos * ss))
                            : Vec<T>::zero(),
                   win[i]);
  }

  float* dst = out + (bi * S) * F + f0;
  for (int s = s0; s < s1; s += GROUP) {
    Raw raw[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      raw[g] = s + g < s1 ? __ldg(reinterpret_cast<const Raw*>(src + (s + g) * ss))
                          : Vec<T>::zero();
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (s + g >= s1) break;
      float cur[V];
      Vec<T>::unpack(raw[g], cur);
      float y[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < K - 1; ++i) acc = __fadd_rn(acc, __fmul_rn(win[i][j], wt[i][j]));
        acc = __fadd_rn(acc, __fmul_rn(cur[j], wt[K - 1][j]));
        acc = round_to<T>(__fadd_rn(acc, bs[j]));
        y[j] = silu ? acc / (1.0f + expf(-acc)) : acc;
      }
      *reinterpret_cast<float4*>(dst + static_cast<long long>(s + g) * F) =
          make_float4(y[0], y[1], y[2], y[3]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int i = 0; i + 1 < K - 1; ++i) win[i][j] = win[i + 1][j];
        win[K - 2][j] = cur[j];
      }
    }
  }
}

// SMs of the current device, asked once.
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const void* w, const void* bias,
           void* out, const long long* strides, int B, int S, int di, int gn, int silu,
           cudaStream_t stream) {
  const int vecs = (di + 2 * gn) / V;
  int rows = MAX_ROWS;
  auto blocks_of = [&](int r) {
    const long long threads = static_cast<long long>(B) * ((S + r - 1) / r) * vecs;
    return (threads + THREADS - 1) / THREADS;
  };
  while (rows > GROUP && blocks_of(rows) < 8LL * sm_count()) rows /= 2;
  const int runs = (S + rows - 1) / rows;
  const long long threads = static_cast<long long>(B) * runs * vecs;
  const long long blocks = blocks_of(rows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  causal_conv_silu_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<float*>(out),
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5], S, di, gn,
      vecs, rows, runs, threads, silu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* b, const void* c, const void* w, const void* bias,
             void* out, const long long* strides, int B, int S, int di, int gn, int k,
             int silu, cudaStream_t stream) {
  if (di % V || gn % V || k != K) return static_cast<int>(cudaErrorInvalidValue);
  return launch<T>(x, b, c, w, bias, out, strides, B, S, di, gn, silu, stream);
}

}  // namespace mamba_conv
