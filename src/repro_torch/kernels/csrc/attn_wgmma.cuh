// Tensor-core flash attention for Hopper (sm_90a): bf16 q / k / v with head
// dim 64, 80 or 128, fp32 softmax and accumulators, bf16 output.  The
// `wgmma` route of flash_attention.cu; kernels/flash_attention.py's
// flash_attention_route sends a call here only when TMA can address its
// operands (bf16, D 64 / 80 / 128, contiguous head dim, 16-byte-aligned
// base addresses and batch / head / sequence strides).
//
// It computes what the reference's Pallas kernel `_attn_kernel`
// (src/repro/kernels/flash_attention.py) computes: online-softmax attention
// over the full key sequence, causal / sliding-window (any int, 0 or less
// masks whole rows) / bidirectional, GQA, queries right-aligned to the end
// of the keys, masked scores at probability 0 and a row with no live key
// written as 0.  The Pallas kernel did its two products on the MXU; here:
//
//   * Grid: one block per (tile of BQ = 128 query rows, q head, batch
//     entry), blockIdx.x = head + Hq * batch and blockIdx.y the query tile
//     counted from the last, so the causal-heavy tiles of every head are
//     scheduled first.  GQA's K/V reuse comes from L2 (the q heads of one
//     kv head are neighbouring blocks).
//   * Warp roles: warpgroup 0 is the producer; one thread asks TMA for the
//     Q tile once, then for the K and V tiles of BKV keys into a ring of
//     STAGES stages, each guarded by its own "full" mbarriers (K and V
//     apart, so the scores start before V lands) and one "empty" mbarrier.
//     Warpgroups 1 and 2 are consumers and own 64 query rows each.
//     `setmaxnreg` moves registers from the producer to the consumers.
//   * Tensor maps: 4-D (D, S, H, B) maps built from the tensors' own
//     strides, so the model's (B, S, H, D) storage, handed over as
//     transposed views, is read in place; TMA zero-fills rows past Sq and
//     Skv and never crosses a head or batch entry, so nothing is padded.
//     Tiles are 64 head-dim columns (128 bytes, the swizzle width) wide,
//     128-byte swizzled, TD / 64 of them side by side (TD, the tile's
//     head dim and the template's D, is the true D rounded up to 64 or
//     128; Args::D is the true one).
//   * D 80 (h2o-danube, hubert) runs the TD-128 tile.  The maps carry the
//     true extent D, so TMA zero-fills columns 80-127 of every box: the
//     model's views hold the next head's data there, and a map as wide
//     as the row stride would read it.  The scores run only the D / 16
//     k16 steps that hold data (DQK = 80: 5 of 8); P·V runs the whole
//     128-wide tile (zero columns of V give zero columns of O; a wgmma
//     n80 cannot read an MN-major 128-byte-swizzled tile, whose atom is
//     64 wide), and the epilogue stores only columns below D, since the
//     output row is D wide and columns 80-127 would be the next row's.
//     So D 80 costs (80 + 128) / 160 = 1.3 times its tensor-core work.
//   * Scores: S = Q·Kᵀ with `wgmma.m64nBKVk16`, Q and K both K-major (D
//     contiguous), DQK / 16 steps per tile, fp32 in registers.
//   * Softmax in fp32 on the accumulator fragment: a row lives in one quad
//     of lanes, so its max takes two `shfl_xor`s (the row sum l is kept per
//     thread and reduced once, at the end).  exp2 with scale·log2(e)
//     folded into the scores.  The causal / window / Skv-tail mask is
//     evaluated only on tiles that cross the diagonal, a window edge or
//     the tail; masked scores become -inf, whose exp2 is exactly 0.  The
//     kv loop visits only tiles that can hold a live key for some query of
//     the block (dead tiles are never loaded), as the CUDA-core kernel.
//   * P·V: P rounded to bf16 in registers is the A operand of a register-A
//     `wgmma.m64nTDk16` against V, which is MN-major (D contiguous) and read
//     with the transpose bit, as the GEMM's row-major B.  O is fp32 in
//     registers, rescaled by each tile's max correction.
//   * Epilogue: O / l rounded to bf16, plain masked stores of bf16 pairs to
//     the strided output (rows below Sq, columns below D); l == 0 writes
//     exactly 0.
//
// Bound on an H100: at yi-6b's prefill shape (B 2, Hq 32, Hkv 4, S 512, D
// 128, causal) the call does 4.3 GFLOP against 18.9 MB read and written,
// about 230 FLOP/byte, near the card's ~295 FLOP/byte ridge: 4.35 µs of
// bf16 tensor-core work against 5.6 µs of bytes, so its bound is the
// bytes.  At h2o-danube's 1 x 8192 (32 / 8 heads, D 80, causal, window
// 4096) the live pairs make 258 GFLOP, 0.261 ms of bf16 tensor-core work
// against a few MB: bound by the operations, and the padded P·V makes
// the tile's work 335 GFLOP.  Not in this kernel yet: an exact D-80 tile
// (16-column boxes with the 32-byte swizzle, n80 for P·V), overlap of one
// tile's softmax with the next tile's scores inside a warpgroup (the two
// consumer warpgroups overlap each other only as the scheduler
// interleaves them), TMA-store epilogue, persistent blocks.
//
// Every mbarrier wait traps after a bounded spin instead of hanging
// (wg::mbar_wait).

#pragma once

#include <math.h>

#include "gemm_wgmma.cuh"

namespace fa {

constexpr int BQ = 128;                     // query rows per block
constexpr int CONSUMERS = 2;                // warpgroups of 64 query rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int BOX = 64;                     // head-dim columns per TMA box
constexpr float NEG = -1e30f;               // a row's max before any live key

// D: the tile's head dim (a multiple of the box); DQK: the head-dim
// columns the scores read (the true D rounded up to 16).
template <int D, int DQK, int BKV, int STAGES>
struct Cfg {
  static_assert(D % BOX == 0 && BKV % 16 == 0 && DQK % 16 == 0 && DQK <= D,
                "tile shape");
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;      // one K or one V tile
  // Q, the K ring, the V ring, the barriers (Q, K full, V full, empty) and
  // slack to align to 1024 bytes.
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 3 * STAGES) * 8 + 1024;
};

struct Args {
  int Hq, Hkv, Sq, Skv, D;          // D: the true head dim (stores stop there)
  int causal, use_window, window;
  float scale_log2;                 // sm_scale * log2(e)
  long long o_b, o_h, o_s;          // output strides (elements)
};

__device__ __forceinline__ bool live(int q_pos, int kv_pos, const Args& a) {
  return kv_pos < a.Skv && (!a.causal || kv_pos <= q_pos) &&
         (!a.use_window || q_pos - kv_pos < a.window);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int DQK, int BKV, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
attn_wgmma(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v,
           __nv_bfloat16* __restrict__ out, Args a) {
  using C = Cfg<D, DQK, BKV, STAGES>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;                              // D / 64 boxes of BQ rows
  uint8_t* sk = sq + C::Q_BYTES;                   // STAGES K tiles
  uint8_t* sv = sk + STAGES * C::KV_BYTES;         // STAGES V tiles
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sv + STAGES * C::KV_BYTES);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  const int h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  // The kv range any query of this block can see, in whole BKV tiles.
  const int q_offset = a.Skv - a.Sq;
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + BQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Skv, qpos_last + 1) : a.Skv;
  const long long first_live =
      a.use_window ? (long long)qpos_first - a.window + 1 : 0;
  const int kv_begin =
      (int)(max(0LL, min(first_live, (long long)a.Skv)) / BKV) * BKV;
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    wg::mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&kfull[s], 1);                 // the producer's expect_tx
      wg::mbar_init(&vfull[s], 1);
      wg::mbar_init(&empty[s], CONSUMERS * 4);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(qfull, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < D / BOX; ++j)
        wg::tma_load_4d(sq + j * BQ * 128, &map_q, qfull, j * BOX, q0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        const uint32_t round = it / STAGES;
        const int c0 = kv_begin + it * BKV;
        wg::mbar_wait(&empty[s], (round & 1) ^ 1);  // round 0 passes at once
        wg::mbar_expect_tx(&kfull[s], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < D / BOX; ++j)
          wg::tma_load_4d(sk + s * C::KV_BYTES + j * BKV * 128, &map_k,
                          &kfull[s], j * BOX, c0, hk, b);
        wg::mbar_expect_tx(&vfull[s], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < D / BOX; ++j)
          wg::tma_load_4d(sv + s * C::KV_BYTES + j * BKV * 128, &map_v,
                          &vfull[s], j * BOX, c0, hk, b);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns rows c*64 .. c*64+63 of the block.  Thread
  // (warp, lane) holds accumulator rows warp*16 + lane/4 (hh = 0) and +8
  // (hh = 1), columns 8j + 2(lane%4) and +1, as acc[4j + 2hh + {0, 1}].
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = c * 64 + warp * 16 + lane / 4;   // block row of hh = 0
  const int wq_first = qpos_first + c * 64;         // this warpgroup's rows
  const int wq_last = wq_first + 63;

  float o[D / 2];
  float sc[BKV / 2];
  uint32_t p[BKV / 4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  const uint8_t* q_tile = sq + c * 64 * 128;
  wg::mbar_wait(qfull, 0);

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int c0 = kv_begin + it * BKV;

    // S = Q Kᵀ (fp32, 64 x BKV per warpgroup).
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    wg::mbar_wait(&kfull[s], phase);
    const uint8_t* k_tile = sk + s * C::KV_BYTES;
    wg::fence_regs(sc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      // Box kk / 4 of the head dim, 16 columns = 32 bytes along its
      // swizzled 128-byte rows.
      const int box = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = wg::smem_desc(q_tile + box * BQ * 128 + off, 16, 1024);
      const uint64_t db = wg::smem_desc(k_tile + box * BKV * 128 + off, 16, 1024);
      wg::wgmma_tile<BKV, 0>(sc, da, db);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(sc);

    // Online softmax in the log2 domain.  A tile that every row of this
    // warpgroup sees whole needs no mask.
    const bool whole = c0 + BKV <= a.Skv &&
                       (!a.causal || c0 + BKV - 1 <= wq_first) &&
                       (!a.use_window || (long long)wq_last - c0 < a.window);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
      if (whole) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            x *= a.scale_log2;
            mx = fmaxf(mx, x);
          }
      } else {
        const int q_pos = wq_first + warp * 16 + lane / 4 + 8 * hh;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * hh + e];
            const int kv_pos = c0 + 8 * j + 2 * (lane % 4) + e;
            x = live(q_pos, kv_pos, a) ? x * a.scale_log2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);          // finite: NEG at worst
      const float corr = fast_exp2(m[hh] - m_new);
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * hh + e];
          x = fast_exp2(x - m_new);                   // masked: exp2(-inf) = 0
          sum += x;
        }
      l[hh] = l[hh] * corr + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * hh] *= corr;
        o[4 * j + 2 * hh + 1] *= corr;
      }
    }
    // P in bf16: the fragment of columns 16kk .. 16kk+15 is registers
    // 4kk .. 4kk+3, i.e. consecutive accumulator pairs.
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    // O += P V.
    wg::mbar_wait(&vfull[s], phase);
    const uint8_t* v_tile = sv + s * C::KV_BYTES;
    wg::fence_regs(o);
    wg::fence_regs(p);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      // V MN-major: 16 key rows of 128 bytes per step; LBO steps between
      // the 64-column boxes of D, SBO between groups of 8 key rows.
      const uint64_t db = wg::smem_desc(v_tile + kk * 16 * 128, BKV * 128, 1024);
      wg::wgmma_rs<D, 1>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                         p[4 * kk + 3], db);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
    wg::fence_regs(p);
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  }

  // Epilogue: the quad's partial row sums, then O / l in bf16.
  __nv_bfloat16* ob = out + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + row0 + 8 * hh;
    if (row >= a.Sq) continue;
    const float inv = lr == 0.f ? 0.f : 1.f / lr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col >= a.D) continue;        // D is even: a pair is whole or out
      wg::store2(ob + row * a.o_s + col, o[4 * j + 2 * hh] * inv,
                 o[4 * j + 2 * hh + 1] * inv);
    }
  }
}

template <int D, int DQK, int BKV, int STAGES>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, __nv_bfloat16* out, const Args& a,
                   int B, cudaStream_t stream) {
  constexpr int smem = Cfg<D, DQK, BKV, STAGES>::SMEM;
  auto kernel = attn_wgmma<D, DQK, BKV, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.Hq * B, (a.Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mk, mv, out, a);
  return cudaGetLastError();
}

// q: (B, Hq, Sq, D), k / v: (B, Hkv, Skv, D), out: (B, Hq, Sq, D), bf16,
// with element strides (batch, head, sequence) and a contiguous head dim.
// Returns cudaErrorInvalidValue for a head dim it has no tile for, or when
// a tensor map cannot be encoded (a misaligned base or stride).
inline cudaError_t run(const void* q, const void* k, const void* v, void* out,
                       int B, int Hq, int Hkv, int Sq, int Skv, int D,
                       int causal, int use_window, int window, float scale,
                       const long long (&qs)[3], const long long (&ks)[3],
                       const long long (&vs)[3], const long long (&os)[3],
                       cudaStream_t stream) {
  if (D != 64 && D != 80 && D != 128) return cudaErrorInvalidValue;
  constexpr int BKV = 128;
  // Maps (D, S, H, B); strides of S, H, B from (batch, head, seq) order.
  CUtensorMap mq, mk, mv;
  const long long qd[4] = {D, Sq, Hq, B}, kd[4] = {D, Skv, Hkv, B};
  const long long qst[3] = {qs[2], qs[1], qs[0]};
  const long long kst[3] = {ks[2], ks[1], ks[0]};
  const long long vst[3] = {vs[2], vs[1], vs[0]};
  if (!wg::encode_4d(&mq, q, qd, qst, BOX, BQ) ||
      !wg::encode_4d(&mk, k, kd, kst, BOX, BKV) ||
      !wg::encode_4d(&mv, v, kd, vst, BOX, BKV))
    return cudaErrorInvalidValue;
  Args a{Hq, Hkv, Sq, Skv, D, causal, use_window, window,
         scale * 1.4426950408889634f, os[0], os[1], os[2]};
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (D == 64) return launch<64, 64, BKV, 3>(mq, mk, mv, o, a, B, stream);
  if (D == 80) return launch<128, 80, BKV, 2>(mq, mk, mv, o, a, B, stream);
  return launch<128, 128, BKV, 2>(mq, mk, mv, o, a, B, stream);
}

}  // namespace fa
