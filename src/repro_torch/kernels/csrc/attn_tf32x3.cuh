// f32 flash attention on Hopper's tensor cores (flash_attention.cu's
// `tf32x3` route), sm_90a: fp32 q / k / v / out, head dim a multiple of 8
// up to 128, fp32-accurate.  kernels/flash_attention.py's
// flash_attention_route sends a call here when the operands allow 16-byte
// copies (f32, contiguous head dim, 16-byte-aligned base addresses and
// positive batch / head / sequence strides of whole 16-byte chunks).
//
// Replaces, for f32 operands, the reference's Pallas TPU kernel
// `_attn_kernel` via `flash_attention` (src/repro/kernels/
// flash_attention.py:37, pallas_call l.172): online-softmax attention over
// the full key sequence, causal / sliding-window (any int, 0 or less masks
// whole rows) / bidirectional, GQA, queries right-aligned to the end of
// the keys, masked scores at probability 0 and a row with no live key
// written as exactly 0.  The Pallas kernel did both products on the MXU
// with an fp32 VMEM accumulator carried along its sequential kv grid
// axis; here the kv loop runs inside the block.
//
// Bound on an H100 SXM (3.35 TB/s, 495 TFLOP/s TF32 dense, 67 fp32): at
// the yi-6b f32 check's shape (1 x 128, 32 / 4 heads, D 128, causal) a
// launch reads q, k, v once and writes the output once, 4.72 MB: 1.41 µs;
// its 0.135 GFLOP over the live pairs are 0.41 GFLOP as 3xTF32, 0.82 µs
// at the TF32 peak (2.0 µs as fp32 FMAs on the CUDA cores).  So the bound
// is the bytes, and at this size what a launch costs is the longest chain
// of dependent steps, not the card's rate: the block that owns the last
// query rows walks every key before them.
//
// Precision.  The bar is 2e-5 of each output row's max |plain|
// (tests/test_kernels.py).  One TF32 product (10-bit mantissa) misses it;
// 3xTF32 as in ssd_mma.cuh and gemm_tf32x3.cuh keeps it: x = hi + lo,
// each product summed as lo·hi + hi·lo + hi·hi (mma_tf32.cuh).  The
// tensor core truncates as it adds to its accumulator, so no mma chain
// runs longer than 32 deep (12 mma): S = Q·Kᵀ sums each 32 head-dim
// columns into a fresh accumulator and adds it into an fp32 total, and
// O += P·V multiplies one 32-key step into a fresh accumulator, added into
// O (rescaled by the step's max correction) by one FMA.  The softmax is
// fp32 on the CUDA cores: exp2f (2 ulp) of scores times scale·log2(e).
//
// Design:
//  * Block: 4 warps, 64 query rows of one (batch entry, q head), 16 rows a
//    warp; blockIdx.x = head + Hq * batch, blockIdx.y the query tile
//    counted from the last, so the causal-heavy tiles start first.
//  * Filling the card.  At the check's 1 x 128 x 32 heads there are 64
//    query tiles for 132 SMs.  A smaller query tile, or the 8 q heads of a
//    GQA group packed into the tile's rows, gives more blocks but the same
//    critical path: a warp owns 16 rows and walks every live key before
//    them, so the last rows' warp takes 128 / 32 = 4 steps either way (and
//    packing would save K / V reads that L2 already serves).  Splitting a
//    tile's kv steps across a cluster cuts that path (on an H100 at that
//    shape, tools/flash_attention_times.py: 23.1 µs unsplit, 17.0 split
//    in 2) but needs a second epilogue that merges the blocks' states,
//    and a rule for when the split pays that follows the card's
//    occupancy; the unsplit launch already meets the route's bar (34 µs),
//    so there is none.  23 µs for a path of four 32-key steps: with one
//    warp a scheduler the mma latency is not hidden.
//  * Loads: Q's tile once, then each 32-key step's K and V tiles by
//    16-byte cp.async into a two-stage ring (the next step's copies fly
//    while this one multiplies), one block barrier a step.  Shared rows
//    are W + 4 floats (W: D rounded up to 16, 32, 64 or 128), so every
//    fragment load of a warp hits 32 distinct banks.  Rows past Sq / Skv
//    and columns past D copy 0 (cp.async's source size 0): no operand is
//    padded or copied in device memory, strided views are read in place.
//    Q stays in shared memory, not in registers: its hi / lo fragments
//    would take 128 registers a thread at D 128 beside O's 64; a k8
//    step's A fragment is one ldmatrix (8x4 fp32 matrices; rows W + 4
//    floats apart hit eight distinct 16-byte bank groups), shared by the
//    step's four key n-tiles, whose B fragments are two more.
//  * Scores: m16n8k8 TF32 `mma.sync`, 4 n-tiles of 8 keys a warp a step,
//    two 32-column sums at a time: eight independent chains.
//  * Masks: the kv loop visits only 32-key steps that can hold a live key
//    for some query of the block (dead steps are never loaded); a warp
//    skips a step none of its rows can see; the causal / window / Skv-tail
//    mask is evaluated only on steps that cross the diagonal, a window
//    edge or the tail, a masked score becomes -inf, whose exp2 is 0.
//  * P·V: the m16n8 accumulator holds key columns 2t and 2t + 1 in a
//    lane, the m16n8k8 A fragment wants columns t and t + 4; since k is
//    summed, the k order is permuted instead (as ssd_mma.cuh does): A
//    slot t takes key 2t and slot t + 4 key 2t + 1, and the lane's B
//    fragment reads V rows 2t and 2t + 1.  P never leaves registers.
//    Four 8-column n-tiles of O run at a time, so that four independent
//    chains of 12 mma hide each mma's latency: with one warp on each of
//    an SM's four schedulers nothing else would.
//  * Epilogue: O / l (the quad's partial row sums added once) as float2
//    stores, rows below Sq and columns below D; l == 0 writes 0.
// A launch repeats bit for bit: no atomics, a fixed order of every sum.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32.cuh"

namespace fa3 {

constexpr int BQ = 64;               // query rows per block
constexpr int BKV = 32;              // keys per step of the block's loop
constexpr int WARPS = BQ / 16;       // 16 query rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr float NEG = -1e30f;        // a row's max before any live key

struct Args {
  int Hq, Hkv, Sq, Skv, D;
  int causal, use_window, window;
  float scale_log2;                  // sm_scale * log2(e)
  long long q_b, q_h, q_s;           // element strides (head dim contiguous)
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
};

// W: the tile's head-dim columns.  Shared memory: Q [BQ][PITCH], then two
// stages of K [BKV][PITCH] and V [BKV][PITCH].
template <int W>
struct Tile {
  static constexpr int PITCH = W + 4;
  static constexpr int Q_FLOATS = BQ * PITCH;
  static constexpr int KV_FLOATS = BKV * PITCH;
  static constexpr size_t SMEM = sizeof(float) * (Q_FLOATS + 4 * KV_FLOATS);
};

__device__ __forceinline__ bool live(int q_pos, int kv_pos, const Args& a) {
  return kv_pos < a.Skv && (!a.causal || kv_pos <= q_pos) &&
         (!a.use_window || q_pos - kv_pos < a.window);
}

// Rows r0 .. r0 + R - 1 of a (rows, D) operand with row stride ld into a
// [R][PITCH] tile; rows at or past `rows` and columns at or past D are 0.
template <int W, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int r0, int rows,
                                          int D, int tid) {
  constexpr int CH = W / 4;                    // 16-byte chunks of a row
  static_assert(R * CH % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int j = 0; j < R * CH / THREADS; ++j) {
    const int i = tid + j * THREADS, r = i / CH, c = (i % CH) * 4;
    const bool ok = r0 + r < rows && c < D;
    tf32::cp16(dst + r * Tile<W>::PITCH + c,
               ok ? src + static_cast<long long>(r0 + r) * ld + c : src,
               ok ? 16 : 0);
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS)
attn_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, Args a) {
  using T = Tile<W>;
  constexpr int P = T::PITCH;
  constexpr int NT = W / 8;                    // 8-column n-tiles of O
  constexpr int NG = NT < 4 ? NT : 4;          // n-tiles of P·V at a time
  extern __shared__ __align__(16) float smem[];
  float* const sq = smem;
  float* const ring = smem + T::Q_FLOATS;      // stage s: K, then V

  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // The kv range any query of this block can see, in whole BKV steps.
  const int q_offset = a.Skv - a.Sq;
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + BQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Skv, qpos_last + 1) : a.Skv;
  const long long first_live =
      a.use_window ? (long long)qpos_first - a.window + 1 : 0;
  const int kv_begin =
      (int)(max(0LL, min(first_live, (long long)a.Skv)) / BKV) * BKV;
  const int nsteps = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  const float* kb = k + b * a.k_b + hk * a.k_h;
  const float* vb = v + b * a.v_b + hk * a.v_h;
  auto load_step = [&](int j) {
    float* st = ring + (j & 1) * 2 * T::KV_FLOATS;
    const int c0 = kv_begin + j * BKV;
    load_tile<W, BKV>(st, kb, a.k_s, c0, a.Skv, a.D, tid);
    load_tile<W, BKV>(st + T::KV_FLOATS, vb, a.v_s, c0, a.Skv, a.D, tid);
    tf32::cp_commit();
  };
  load_tile<W, BQ>(sq, q + b * a.q_b + h * a.q_h, a.q_s, q0, a.Sq, a.D, tid);
  tf32::cp_commit();
  if (nsteps > 0) load_step(0);

  // This warp's rows 16 w .. 16 w + 15 of the tile.  Lane (g, t) holds
  // accumulator rows g (hh = 0) and g + 8 (hh = 1), columns 2t and 2t + 1
  // of each 8-wide n-tile.
  const int wrow0 = q0 + 16 * warp;
  const int wq_first = q_offset + wrow0, wq_last = wq_first + 15;
  const float* qw = sq + 16 * warp * P;
  const uint32_t q_lane = tf32::smem_u32(qw) +
      4 * (((lane & 7) + 8 * ((lane >> 3) & 1)) * P + 4 * (lane >> 4));
  float o[NT][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < nsteps; ++j) {
    if (j + 1 < nsteps) {
      load_step(j + 1);
      tf32::cp_wait<1>();                      // Q and step j have landed
    } else {
      tf32::cp_wait<0>();
    }
    __syncthreads();
    const int c0 = kv_begin + j * BKV;
    const float* kt = ring + (j & 1) * 2 * T::KV_FLOATS;
    const float* vt = kt + T::KV_FLOATS;
    // This lane's ldmatrix rows: of Q, matrix lane / 8 = (rows 8 (m & 1),
    // columns 4 (m >> 1)); of K, (keys 8 (m >> 1), columns 4 (m & 1)).
    const uint32_t k_lane = tf32::smem_u32(kt) +
        4 * ((8 * (lane >> 4) + (lane & 7)) * P + 4 * ((lane >> 3) & 1));
    const bool dead =
        wrow0 >= a.Sq || (a.causal && c0 > wq_last) ||
        (a.use_window && (long long)wq_first - (c0 + BKV - 1) >= a.window);
    if (!dead) {
      // S = Q·Kᵀ, 16 rows x 32 keys, each 32 head-dim columns summed in a
      // fresh accumulator and added into s, two such sums at a time (eight
      // independent chains: four n-tiles of keys by two column blocks).
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < W; d0 += 64) {
        if (d0 >= a.D) continue;
        float part[2][4][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[h2][i][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int c = d0 + 32 * h2 + 8 * kk;
            if (c >= W || c >= a.D) continue;
            // A: rows g, g + 8 x columns t, t + 4 (one ldmatrix); B: keys
            // 8i + g x columns t, t + 4 for four n-tiles (two).
            uint32_t qa[4], kb[2][4];
            tf32::ldsm_x4(q_lane + 4 * c, qa);
            tf32::ldsm_x4(k_lane + 4 * c, kb[0]);
            tf32::ldsm_x4(k_lane + 4 * (16 * P + c), kb[1]);
            uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tf32::split<false>(__uint_as_float(qa[e]), ah[e], al[e]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                tf32::split<false>(__uint_as_float(kb[i >> 1][2 * (i & 1) + e]),
                                   bh[i][e], bl[i][e]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              tf32::mma(part[h2][i], al, bh[i][0], bh[i][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              tf32::mma(part[h2][i], ah, bl[i][0], bl[i][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              tf32::mma(part[h2][i], ah, bh[i][0], bh[i][1]);
          }
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][e] += part[h2][i][e];
      }

      // Online softmax in the log2 domain; a step every row of this warp
      // sees whole needs no mask.
      const bool whole = c0 + BKV <= a.Skv &&
                         (!a.causal || c0 + BKV - 1 <= wq_first) &&
                         (!a.use_window || (long long)wq_last - c0 < a.window);
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q_pos = wq_first + g + 8 * hh;
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[i][2 * hh + e];
            x = whole || live(q_pos, c0 + 8 * i + 2 * t + e, a)
                    ? x * a.scale_log2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);   // finite: NEG at worst
        corr[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[i][2 * hh + e];
            x = exp2f(x - m_new);               // masked: exp2(-inf) = 0
            sum += x;
          }
        l[hh] = l[hh] * corr[hh] + sum;
      }

      // O = O·corr + P·V, k permuted: A slot t <- key 2t, slot t + 4 <-
      // key 2t + 1 of n-tile i; B rows 2t and 2t + 1 of the same 8 keys.
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tf32::split<false>(s[i][0], ph[i][0], pl[i][0]);
        tf32::split<false>(s[i][2], ph[i][1], pl[i][1]);
        tf32::split<false>(s[i][1], ph[i][2], pl[i][2]);
        tf32::split<false>(s[i][3], ph[i][3], pl[i][3]);
      }
      // NG n-tiles at a time, so that NG independent accumulator chains
      // hide the mma's latency (a single chain of 12 dependent mma waits
      // out each one's).
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NG) {
        if (8 * n0 >= a.D) continue;
        float pv[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t vh[NG][2], vl[NG][2];
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const float* vr = vt + (8 * i + 2 * t) * P + 8 * (n0 + n) + g;
            tf32::split<false>(vr[0], vh[n][0], vl[n][0]);
            tf32::split<false>(vr[P], vh[n][1], vl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < NG; ++n) tf32::mma(pv[n], pl[i], vh[n][0], vh[n][1]);
#pragma unroll
          for (int n = 0; n < NG; ++n) tf32::mma(pv[n], ph[i], vl[n][0], vl[n][1]);
#pragma unroll
          for (int n = 0; n < NG; ++n) tf32::mma(pv[n], ph[i], vh[n][0], vh[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          o[n0 + n][0] = fmaf(o[n0 + n][0], corr[0], pv[n][0]);
          o[n0 + n][1] = fmaf(o[n0 + n][1], corr[0], pv[n][1]);
          o[n0 + n][2] = fmaf(o[n0 + n][2], corr[1], pv[n][2]);
          o[n0 + n][3] = fmaf(o[n0 + n][3], corr[1], pv[n][3]);
        }
      }
    }
    __syncthreads();                           // the stage is free to refill
  }
  tf32::cp_wait<0>();                          // (no step: Q's copy)

  // Epilogue: the quad's partial row sums, then O / l.
  float* ob = out + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = wrow0 + g + 8 * hh;
    if (row >= a.Sq) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      if (col >= a.D) continue;                // D % 8 == 0: a pair is whole
      *reinterpret_cast<float2*>(ob + row * a.o_s + col) =
          make_float2(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
  }
}

// One block per (q head, batch entry) along x, query tiles along y.
template <int W>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   const Args& a, int B, cudaStream_t stream) {
  auto kernel = attn_tf32x3<W>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile<W>::SMEM));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.Hq * B, (a.Sq + BQ - 1) / BQ, 1);
  kernel<<<grid, THREADS, Tile<W>::SMEM, stream>>>(q, k, v, out, a);
  return cudaGetLastError();
}

// q: (B, Hq, Sq, D), k / v: (B, Hkv, Skv, D), out: (B, Hq, Sq, D), f32,
// with element strides (batch, head, sequence) and a contiguous head dim.
// Returns cudaErrorInvalidValue unless D is a multiple of 8 up to 128,
// every base address is 16-byte aligned and every stride a positive
// multiple of 4 elements (the checks of flash_attention_route).
inline cudaError_t run(const void* q, const void* k, const void* v, void* out,
                       int B, int Hq, int Hkv, int Sq, int Skv, int D,
                       int causal, int use_window, int window, float scale,
                       const long long (&qs)[3],
                       const long long (&ks)[3], const long long (&vs)[3],
                       const long long (&os)[3], cudaStream_t stream) {
  if (D % 8 || D > 128 || (long long)Hq * B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const void* const ptrs[4] = {q, k, v, out};
  const long long* const strides[4] = {qs, ks, vs, os};
  for (int j = 0; j < 4; ++j) {
    if (reinterpret_cast<uintptr_t>(ptrs[j]) % 16) return cudaErrorInvalidValue;
    for (int i = 0; i < 3; ++i)
      if (strides[j][i] <= 0 || strides[j][i] % 4) return cudaErrorInvalidValue;
  }
  Args a{Hq, Hkv, Sq, Skv, D, causal, use_window, window,
         scale * 1.4426950408889634f,
         qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
         vs[0], vs[1], vs[2], os[0], os[1], os[2]};
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(out);
  if (D <= 16) return launch<16>(fq, fk, fv, fo, a, B, stream);
  if (D <= 32) return launch<32>(fq, fk, fv, fo, a, B, stream);
  if (D <= 64) return launch<64>(fq, fk, fv, fo, a, B, stream);
  return launch<128>(fq, fk, fv, fo, a, B, stream);
}

}  // namespace fa3
