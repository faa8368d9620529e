// Mamba-2 SSD within-chunk term on Hopper's tensor cores (route "mma").
//
//     Y[z, c] = (L ∘ C Bᵀ) X,   L[i, j] = exp(dta_i − dta_j) · [j ≤ i]
//
// per (bh, chunk) cell, x (BH, C, Q, P), dta (BH, C, Q), b and c (BH, C,
// Q, N), out (BH, C, Q, P), contiguous, all f32 or all bf16.  Included by
// ssd_scan.cu, which holds the C entry point and the CUDA-core route.
//
// Replaces the reference's Pallas TPU kernel `_ssd_chunk_kernel` via
// `ssd_chunk_diag` (src/repro/kernels/ssd_scan.py:37, pallas_call l.71).
//
// Bound on an H100 SXM (3.35 TB/s, 495 TFLOP/s TF32 dense): at mamba2-370m's
// forward shape (BH 128, C 4, Q 256, P 64, N 128, f32) a launch reads x,
// dta, b, c once and writes y once, 202 MB: 0.0603 ms.  The products over
// the live (j ≤ i) pairs are 6.47 GFLOP; 3xTF32 runs each three times on
// the tensor cores, 19.4 GFLOP at 495 TFLOP/s: 0.0392 ms.  So the bound is
// the bytes.  Two facts of the card keep the kernel above it (PERF.md
// §6 row 5): mma.sync, unlike wgmma, does not reach the 495 TFLOP/s, and
// every tensor-core instruction needs its fp32 operands cut into TF32
// pieces by the CUDA cores.  (The same fp32 work on the CUDA cores:
// 0.0967 ms at 67 TFLOP/s.)
//
// Precision.  The reference's bar is 1e-4 of each output row in f32
// (tests/test_kernels.py:169).  One TF32 product (10-bit mantissa) misses
// it tenfold and more (tests/test_torch_ssd.py emulates both).  3xTF32
// keeps it: an fp32 operand is x = hi + lo with both TF32, and each
// product is summed as lo·hi + hi·lo + hi·hi (small terms first) in fp32
// accumulators; only lo·lo is dropped.  How the pieces are cut, and one
// term, follow from the hardware (found on an H100):
//  * cvt.rna.tf32.f32 is not one instruction on sm_90 (ptxas emits five,
//    with NaN / inf checks), while the mma reads only a register's top 19
//    bits.  So hi = x with its low 13 bits cleared and lo = x − hi, exact;
//    the mma truncates lo to TF32.  A product then errs by less than
//    2^-20 of itself, for two instructions a split (ptxas even drops the
//    mask where hi feeds the mma directly).
//  * The tensor core adds to its accumulator with truncation relative to
//    the running sum.  A chunk's first row is the single term c_0·b_0, a
//    128-term dot product that can cancel to a small part of its terms in
//    the worst of mamba2-370m's 512 cells a launch; there fp32's own
//    rounding is already of the bar's order in any summation order, and
//    48 chained mma missed the bar against the plain version.  So every
//    pair (i, i) takes the plain fp32 dot product c_i · b_i (FMAs over the
//    state dimension in order, as the plain version's GEMM sums), computed
//    on the CUDA cores on the row's diagonal step.  The card tests and
//    chip_smoke.py's phase 2 hold every row to the bar.
//  bf16 operands are exact in TF32 (their lo is 0): the bf16 instances
//  skip the passes with a lo of x, b or c; the decayed scores P are fp32
//  in both and always split.
//
// Design:
//  * Tiles.  Query tiles of 64 rows, key steps of 32 keys.  One block of
//    four warps serves one (cell, pair of query tiles t and T−1−t): tile t
//    holds t + 1 tiles' worth of live keys and tile T−1−t holds T − t, so
//    every block carries T + 1 and the causal triangle is balanced across
//    blocks (the plan is kernels/ssd_scan.py::ssd_plan).  Warp w owns
//    m-tile (16 rows) w of tile t and m-tile 3 − w of tile T−1−t, so the
//    diagonal's short and long rows land on every warp alike.  The block
//    walks its key steps once; an m-tile skips the steps past its last row
//    and, on its diagonal step, the 8-key n-tiles past it: nothing above
//    the diagonal is multiplied.  When both of a warp's m-tiles are on a
//    full step, B's and X's fragments are loaded and split once for the
//    two.  No atomics on device memory and no workspace: a repeated launch
//    gives the same bits.
//  * Loads.  C of both query tiles stays in shared memory for the whole
//    block; B and X of each key step come into a two-stage ring.  All
//    tiles are TMA boxes of 128-byte rows with the 128-byte swizzle (16-
//    byte chunks XORed by row & 7), so ldmatrix (f32 fragments of S) and
//    the scalar loads (bf16, and X) are free of bank conflicts; TMA
//    zero-fills rows past Q and columns past N or P, nothing is padded by
//    copies in device memory, and nothing past Q is stored.  The block
//    fits twice on an SM (112 KB at mamba2-370m's widths).  There is no
//    block barrier per step: a warp waits only for its step's data (an
//    mbarrier per stage), and the last of the four warps done with a stage
//    (a counter in shared memory) asks TMA to refill it two steps on.
//    dta is read by element: each lane loads its four query rows' values
//    once and its eight keys' values per step, used after the scores are
//    summed.
//  * Scores.  S = C·Bᵀ over the state dimension, m16n8k8 TF32 mma.sync.
//  * Decay and mask in registers: each accumulator element is scaled by
//    exp(dq_i − dk_j) for its own pair (never factored as
//    exp(dq_i)·exp(−dk_j): the log-decay of a 256-token chunk reaches
//    about −180 and exp(180) overflows fp32); on the diagonal step a
//    masked pair (j > i) is selected to 0, never multiplied by a 0/1
//    mask: its exponent may be inf, and inf·0 is NaN.  Rows past Q take
//    dq = −inf, so their decay is 0.
//  * P·X.  The decayed S accumulator becomes the A operand of Y += P·X
//    without leaving registers.  The m16n8 accumulator holds key columns
//    2t and 2t+1 in a lane, the m16n8k8 A fragment wants columns t and
//    t+4; since k is summed, the k order is permuted instead: A slot t
//    takes key 2t and slot t+4 key 2t+1, and the lane's B fragment reads
//    X rows 2t and 2t+1 to match.  This costs nothing, where staging P
//    through shared memory would cost a round trip and a block barrier
//    per step.  Y stays in registers (fp32) until the one rounding to the
//    output dtype at the end.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_wgmma.cuh"   // tensor-map encoder, mbarriers, TMA loads
#include "mma_tf32.cuh"

namespace ssd_mma {

constexpr int BQ = 64;             // query rows per query tile
constexpr int BK = 32;             // keys per step of the block's loop
constexpr int WARPS = 4;           // warp w: m-tile w of t, 3 − w of T−1−t
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;          // ring of B / X tiles
constexpr int GROUP = 128;         // bytes of a row in one TMA box (128B swizzle)
constexpr float LOG2E = 1.4426950408889634f;

// 128-byte column groups of a row of `cols` elements: a tile is stored as
// that many TMA boxes, each [rows][128 bytes], 16-byte chunks swizzled by
// (row & 7).
__host__ __device__ inline int groups(int cols, int itemsize) {
  return (cols * itemsize + GROUP - 1) / GROUP;
}

// Head-dim n-tiles (8 columns each) of a warp's accumulators: P rounded up
// to an instantiated width.
__host__ __device__ inline int np_of(int P) {
  return P <= 16 ? 2 : P <= 32 ? 4 : P <= 64 ? 8 : 16;
}

// C of two query tiles, then STAGES x (B tile | X tile), then 64 bytes
// for the mbarriers (a full barrier per stage, one for C) and the stage
// counters.
__host__ __device__ inline size_t smem_bytes(int N, int P, int itemsize) {
  const size_t gn = groups(N, itemsize), gp = groups(8 * np_of(P), itemsize);
  return (2 * BQ * gn + size_t(STAGES) * BK * (gn + gp)) * GROUP + 64;
}

// The 3xTF32 split, the m16n8k8 product and ldmatrix (mma_tf32.cuh).
using tf32::ldsm_x4;
using tf32::mma;
using tf32::split;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One element from shared memory, widened to fp32.
template <typename T> __device__ __forceinline__ float lds(const unsigned char* p);
template <> __device__ __forceinline__ float lds<float>(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}
template <> __device__ __forceinline__ float lds<__nv_bfloat16>(const unsigned char* p) {
  return __uint_as_float(uint32_t(*reinterpret_cast<const unsigned short*>(p)) << 16);
}

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A lane's fragments of S = C·Bᵀ for one 8-wide k step of a 128-byte
// group: A (rows g, g + 8 of the m-tile; columns t, t + 4) and B for four
// 8-key n-tiles (key g; columns t, t + 4), as fp32 bits.  f32 tiles are
// read by ldmatrix (an 8x8 b16 matrix is 8 rows of four fp32, lane l
// getting row l/4, word l%4: the TF32 fragment); bf16 tiles element by
// element.  Rows are GROUP bytes apart inside a box.
template <typename T> struct Frags;

template <> struct Frags<float> {
  static constexpr int KPG = 4;            // k steps per 128-byte group
  uint32_t a_row, b_row;                   // this lane's ldmatrix rows
  uint32_t a_off[4], b_off[4];             // swizzled chunk, by k step
  __device__ Frags(const unsigned char* c_mt, const unsigned char* b_keys, int lane) {
    const int mi = lane >> 3, r = lane & 7;
    // A: matrix mi = rows 8(mi & 1).., chunk 2kk + (mi >> 1) -> a[mi].
    a_row = static_cast<uint32_t>(__cvta_generic_to_shared(c_mt)) + (r + 8 * (mi & 1)) * GROUP;
    // B: matrix mi = keys 8(2p + (mi >> 1)).., chunk 2kk + (mi & 1) ->
    // n-tile 2p + (mi >> 1), b0 / b1 (p = 0, 1: two ldmatrix).
    b_row = static_cast<uint32_t>(__cvta_generic_to_shared(b_keys)) +
            (8 * (mi >> 1) + r) * GROUP;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_off[j] = ((2 * j + (mi >> 1)) ^ r) << 4;
      b_off[j] = ((2 * j + (mi & 1)) ^ r) << 4;
    }
  }
  __device__ __forceinline__ void load_a(int gi, int kk, float (&a)[4]) const {
    uint32_t r[4];
    ldsm_x4(a_row + gi * (BQ * GROUP) + a_off[kk], r);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = __uint_as_float(r[e]);
  }
  __device__ __forceinline__ void load(int gi, int kk, float (&a)[4], float (&b)[4][2]) const {
    uint32_t r[4];
    ldsm_x4(a_row + gi * (BQ * GROUP) + a_off[kk], r);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = __uint_as_float(r[e]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      ldsm_x4(b_row + gi * (BK * GROUP) + p * 16 * GROUP + b_off[kk], r);
      b[2 * p][0] = __uint_as_float(r[0]);
      b[2 * p][1] = __uint_as_float(r[1]);
      b[2 * p + 1][0] = __uint_as_float(r[2]);
      b[2 * p + 1][1] = __uint_as_float(r[3]);
    }
  }
};

template <> struct Frags<__nv_bfloat16> {
  static constexpr int KPG = 8;            // k steps per 128-byte group
  const unsigned char* a_row;              // row g of the m-tile
  const unsigned char* b_row;              // key g of the step
  int off[8];                              // chunk kk ^ g, element t
  __device__ Frags(const unsigned char* c_mt, const unsigned char* b_keys, int lane) {
    const int g = lane >> 2, t = lane & 3;
    a_row = c_mt + g * GROUP;
    b_row = b_keys + g * GROUP;
#pragma unroll
    for (int j = 0; j < 8; ++j) off[j] = ((j ^ g) << 4) + 2 * t;
  }
  __device__ __forceinline__ void load_a(int gi, int kk, float (&a)[4]) const {
    using T = __nv_bfloat16;
    const unsigned char* ar = a_row + gi * (BQ * GROUP) + off[kk];
    a[0] = lds<T>(ar);
    a[1] = lds<T>(ar + 8 * GROUP);
    a[2] = lds<T>(ar + 8);
    a[3] = lds<T>(ar + 8 * GROUP + 8);
  }
  __device__ __forceinline__ void load(int gi, int kk, float (&a)[4], float (&b)[4][2]) const {
    using T = __nv_bfloat16;
    const unsigned char* ar = a_row + gi * (BQ * GROUP) + off[kk];
    const unsigned char* br = b_row + gi * (BK * GROUP) + off[kk];
    a[0] = lds<T>(ar);
    a[1] = lds<T>(ar + 8 * GROUP);
    a[2] = lds<T>(ar + 8);
    a[3] = lds<T>(ar + 8 * GROUP + 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i][0] = lds<T>(br + 8 * i * GROUP);
      b[i][1] = lds<T>(br + 8 * i * GROUP + 8);
    }
  }
};

// X's B fragment for P·X: element (key row, column 8n + g) of a key step's
// X tile, rows 2t and 2t + 1 of each 8-key n-tile (the permuted k order).
// f32 has 4 n-tiles a 128-byte group (chunk 2n + g/4, byte 4(g%4)), bf16
// 8 (chunk n, byte 2g); row 2t (2t + 1) swizzles by 2t (2t + 1).
template <typename T> struct XGeo;
template <> struct XGeo<float> {
  static constexpr int NPG = 4;
  __device__ static constexpr int chunk(int j, int g) { return 2 * j + (g >> 2); }
  __device__ static constexpr int byte(int g) { return 4 * (g & 3); }
};
template <> struct XGeo<__nv_bfloat16> {
  static constexpr int NPG = 8;
  __device__ static constexpr int chunk(int j, int g) { return j; }
  __device__ static constexpr int byte(int g) { return 2 * g; }
};

// The score of the pair (i, i) for row `rl` of the m-tile: fp32 FMAs over
// the state dimension in order, from the swizzled rows of C (in a 64-row
// tile) and B (in a 32-key tile); `nch` 16-byte chunks hold data.
template <typename T>
__device__ __forceinline__ float diag_dot(const unsigned char* c_row, const unsigned char* b_row,
                                          int nch, int sw) {
  float acc = 0.f;
#pragma unroll 4
  for (int ch = 0; ch < nch; ++ch) {
    const int o = ((ch & 7) ^ sw) << 4;
    const uint4 cv = *reinterpret_cast<const uint4*>(c_row + (ch >> 3) * (BQ * GROUP) + o);
    const uint4 bv = *reinterpret_cast<const uint4*>(b_row + (ch >> 3) * (BK * GROUP) + o);
    const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (sizeof(T) == 4) {
        acc = fmaf(__uint_as_float(cw[e]), __uint_as_float(bw[e]), acc);
      } else {
        acc = fmaf(__uint_as_float(cw[e] << 16), __uint_as_float(bw[e] << 16), acc);
        acc = fmaf(__uint_as_float(cw[e] & 0xffff0000u), __uint_as_float(bw[e] & 0xffff0000u),
                   acc);
      }
    }
  }
  return acc;
}

// One m-tile's key step (keys k0 .. k0 + 31, four 8-key n-tiles): S over
// the state dimension, decay and mask, then Y += P·X.  DIAG: the m-tile's
// diagonal step (its last), with `nlive` n-tiles holding a pair j <= i;
// else every pair of the step is live.
template <typename T, int NP, bool DIAG>
__device__ __forceinline__ void key_step(const Frags<T>& fr, int gn, int nch,
                                         const unsigned char* c_mt, const unsigned char* b_keys,
                                         const unsigned char* x_keys,
                                         const int (&xoff0)[XGeo<T>::NPG],
                                         const int (&xoff1)[XGeo<T>::NPG], int nlive,
                                         const float (&dq)[2], const float (&dk)[4][2],
                                         int rg0, int k0, int lane, float (&y)[NP][4]) {
  constexpr bool EX = sizeof(T) == 2;
  const int g = lane >> 2, t = lane & 3;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;

#pragma unroll 1
  for (int gi = 0; gi < gn; ++gi) {
#pragma unroll
    for (int kk = 0; kk < Frags<T>::KPG; ++kk) {
      float af[4], bf[4][2];
      fr.load(gi, kk, af, bf);
      uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) split<EX>(af[e], ah[e], al[e]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split<EX>(bf[i][0], bh[i][0], bl[i][0]);
        split<EX>(bf[i][1], bh[i][1], bl[i][1]);
      }
      if (!EX) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!DIAG || i < nlive) mma(s[i], al, bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!DIAG || i < nlive) mma(s[i], ah, bl[i][0], bl[i][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!DIAG || i < nlive) mma(s[i], ah, bh[i][0], bh[i][1]);
    }
  }

  if (DIAG) {
    // The pair (i, i) takes the plain fp32 dot product c_i · b_i (lanes
    // 0-15 compute rows 0-15; lanes 16-31 repeat them).
    const int rl = lane & 15;
    const float sd = diag_dot<T>(c_mt + rl * GROUP, b_keys + (rg0 - k0 + rl) * GROUP, nch,
                                 rl & 7);
    const float sdv[2] = {__shfl_sync(0xffffffffu, sd, g), __shfl_sync(0xffffffffu, sd, g + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * i + 2 * t + (e & 1) == rg0 + g + 8 * (e >> 1)) s[i][e] = sdv[e >> 1];
    }
  }

  // Decay (and, on the diagonal step, the mask by select): element e of
  // n-tile i is row rg0 + g + 8(e/2), key k0 + 8i + 2t + e%2.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = e & 1;
      const float p = s[i][e] * ex2((dq[h] - dk[i][j]) * LOG2E);
      s[i][e] = (!DIAG || k0 + 8 * i + 2 * t + j <= rg0 + g + 8 * h) ? p : 0.f;
    }
  }

  // Y += P · X, k permuted: A slot t <- key 2t, slot t + 4 <- key 2t + 1
  // of n-tile i; B rows 2t and 2t + 1 of the same 8 keys.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!DIAG || i < nlive) {
      uint32_t ph[4], pl[4];
      split<false>(s[i][0], ph[0], pl[0]);
      split<false>(s[i][2], ph[1], pl[1]);
      split<false>(s[i][1], ph[2], pl[2]);
      split<false>(s[i][3], ph[3], pl[3]);
      const unsigned char* x0 = x_keys + (8 * i + 2 * t) * GROUP;
      const unsigned char* x1 = x0 + GROUP;
      uint32_t xh[NP][2], xl[NP][2];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const int grp = (n / XGeo<T>::NPG) * (BK * GROUP), j = n % XGeo<T>::NPG;
        split<EX>(lds<T>(x0 + grp + xoff0[j]), xh[n][0], xl[n][0]);
        split<EX>(lds<T>(x1 + grp + xoff1[j]), xh[n][1], xl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) mma(y[n], pl, xh[n][0], xh[n][1]);
      if (!EX) {
#pragma unroll
        for (int n = 0; n < NP; ++n) mma(y[n], ph, xl[n][0], xl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) mma(y[n], ph, xh[n][0], xh[n][1]);
    }
  }
}

// Both of a warp's m-tiles on a full key step (every pair live): the same
// as two key_step<.., false> calls, with B's and X's fragments loaded and
// split once for the two.
template <typename T, int NP>
__device__ __forceinline__ void key_step2(const Frags<T>& fr0, const Frags<T>& fr1, int gn,
                                          const unsigned char* x_tile,
                                          const int (&xoff0)[XGeo<T>::NPG],
                                          const int (&xoff1)[XGeo<T>::NPG],
                                          const float (&dq)[2][2], const float (&dk)[4][2],
                                          int lane, float (&y)[2][NP][4]) {
  constexpr bool EX = sizeof(T) == 2;
  const int t = lane & 3;
  float s[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][i][e] = 0.f;

#pragma unroll 1
  for (int gi = 0; gi < gn; ++gi) {
#pragma unroll
    for (int kk = 0; kk < Frags<T>::KPG; ++kk) {
      float af[2][4], bf[4][2];
      fr0.load(gi, kk, af[0], bf);
      fr1.load_a(gi, kk, af[1]);
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) split<EX>(af[m][e], ah[m][e], al[m][e]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split<EX>(bf[i][0], bh[i][0], bl[i][0]);
        split<EX>(bf[i][1], bh[i][1], bl[i][1]);
      }
      if (!EX) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) mma(s[m][i], al[m], bh[i][0], bh[i][1]);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) mma(s[m][i], ah[m], bl[i][0], bl[i][1]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) mma(s[m][i], ah[m], bh[i][0], bh[i][1]);
    }
  }

  // Decay (every pair of a full step is live).
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[m][i][e] *= ex2((dq[m][e >> 1] - dk[i][e & 1]) * LOG2E);

  // Y += P · X (k permuted as in key_step), X's fragments shared.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      split<false>(s[m][i][0], ph[m][0], pl[m][0]);
      split<false>(s[m][i][2], ph[m][1], pl[m][1]);
      split<false>(s[m][i][1], ph[m][2], pl[m][2]);
      split<false>(s[m][i][3], ph[m][3], pl[m][3]);
    }
    const unsigned char* x0 = x_tile + (8 * i + 2 * t) * GROUP;
    const unsigned char* x1 = x0 + GROUP;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int grp = (n / XGeo<T>::NPG) * (BK * GROUP), j = n % XGeo<T>::NPG;
      uint32_t xh[2], xl[2];
      split<EX>(lds<T>(x0 + grp + xoff0[j]), xh[0], xl[0]);
      split<EX>(lds<T>(x1 + grp + xoff1[j]), xh[1], xl[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma(y[m][n], pl[m], xh[0], xh[1]);
        if (!EX) mma(y[m][n], ph[m], xl[0], xl[1]);
        mma(y[m][n], ph[m], xh[0], xh[1]);
      }
    }
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 2)
ssd_mma_kernel(const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_x, const T* __restrict__ dta,
               T* __restrict__ out, int Q, int P, int N, int tiles, int pairs) {
  using XG = XGeo<T>;
  extern __shared__ __align__(1024) unsigned char smem[];
  // The 128-byte swizzle of TMA boxes is laid on 1024-byte-aligned
  // addresses; a CTA's dynamic shared memory starts so aligned on sm_90 (a
  // wrong layout would be silent, so check).
  if (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) & 1023u) __trap();
  const int E = sizeof(T), cols = GROUP / E;           // elements of a box row
  const int gn = groups(N, E), gp = groups(8 * NP, E);
  const int nch = N * E >> 4;                          // 16-byte chunks of a C / B row
  const int ct_bytes = BQ * gn * GROUP;
  const int b_bytes = BK * gn * GROUP, stage_bytes = BK * (gn + gp) * GROUP;
  unsigned char* const ring = smem + 2 * ct_bytes;
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + STAGES * stage_bytes);
  uint64_t* const cbar = full + STAGES;
  int* const done = reinterpret_cast<int*>(cbar + 1);   // warps done with a stage

  const int cell = blockIdx.x / pairs;
  const int pair = blockIdx.x - cell * pairs;
  const int t_lo = pair, t_hi = tiles - 1 - pair;
  const T* ac = dta + (long long)cell * Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // The block walks the key steps up to tile t_hi's last row once; tile
  // t_lo's m-tiles take the steps up to their own rows.
  const int total = min(t_hi * BQ + BQ - 1, Q - 1) / BK + 1;

  // One thread asks TMA for the tiles: C of both query tiles, then each
  // key step's B and X into the ring stage the step uses.
  auto load_step = [&](int f) {
    const int st = f & 1;
    unsigned char* dst = ring + st * stage_bytes;
    wg::mbar_expect_tx(&full[st], stage_bytes);
    for (int q = 0; q < gn; ++q)
      wg::tma_load_3d(dst + q * BK * GROUP, &map_b, &full[st], q * cols, f * BK, cell);
    for (int q = 0; q < gp; ++q)
      wg::tma_load_3d(dst + b_bytes + q * BK * GROUP, &map_x, &full[st], q * cols, f * BK, cell);
  };
  if (tid == 0) {
    wg::mbar_init(&full[0], 1);
    wg::mbar_init(&full[1], 1);
    wg::mbar_init(cbar, 1);
    done[0] = done[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_step(0);
    const int nt = t_hi != t_lo ? 2 : 1;
    wg::mbar_expect_tx(cbar, nt * ct_bytes);
    for (int h = 0; h < nt; ++h)
      for (int q = 0; q < gn; ++q)
        wg::tma_load_3d(smem + h * ct_bytes + q * BQ * GROUP, &map_c, cbar, q * cols,
                        (h ? t_hi : t_lo) * BQ, cell);
    if (total > 1) load_step(1);
  }

  // X fragment offsets inside a 128-byte group (see XGeo).
  int xoff0[XG::NPG], xoff1[XG::NPG];
#pragma unroll
  for (int j = 0; j < XG::NPG; ++j) {
    const int ch = XG::chunk(j, g);
    xoff0[j] = ((ch ^ (2 * t)) << 4) + XG::byte(g);
    xoff1[j] = ((ch ^ (2 * t + 1)) << 4) + XG::byte(g);
  }

  // This warp's m-tiles: m-tile `warp` of t_lo (m = 0) and 3 − warp of
  // t_hi (m = 1, none when the two tiles are one): first row, last live
  // row (-1: past Q), C rows, the rows' dta (rows past Q: -inf, decay 0).
  int rg0[2], rlast[2];
  const unsigned char* c_mt[2];
  float dq[2][2], y[2][NP][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mi = m == 0 ? warp : 3 - warp;
    rg0[m] = (m == 0 ? t_lo : t_hi) * BQ + 16 * mi;
    c_mt[m] = smem + m * ct_bytes + 16 * mi * GROUP;
    rlast[m] = rg0[m] < Q && (m == 0 || t_hi != t_lo) ? min(rg0[m] + 15, Q - 1) : -1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg0[m] + g + 8 * h;
      dq[m][h] = r < Q ? ldg(ac + r) : -__int_as_float(0x7f800000);
    }
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[m][n][e] = 0.f;
  }
  wg::mbar_wait(cbar, 0);

  // No block barrier per step: a warp waits only for its step's data, and
  // the last warp done with a stage asks TMA to refill it two steps on.
  for (int f = 0; f < total; ++f) {
    const int k0 = f * BK;
    const unsigned char* b_tile = ring + (f & 1) * stage_bytes;
    // dk of the lane's keys k0 + 8i + 2t + j (read now, used after S).
    float dk[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + 8 * i + 2 * t + j;
        dk[i][j] = k < Q ? ldg(ac + k) : 0.f;
      }
    wg::mbar_wait(&full[f & 1], (f >> 1) & 1);   // step f has landed
    if (rlast[0] - k0 >= BK && rlast[1] - k0 >= BK) {
      key_step2<T, NP>(Frags<T>(c_mt[0], b_tile, lane), Frags<T>(c_mt[1], b_tile, lane), gn,
                       b_tile + b_bytes, xoff0, xoff1, dq, dk, lane, y);
    } else {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int rem = rlast[m] - k0;
        if (rem < 0) continue;   // no key of the step is at or below the m-tile's rows
        const Frags<T> fr(c_mt[m], b_tile, lane);
        if (rem < BK)
          key_step<T, NP, true>(fr, gn, nch, c_mt[m], b_tile, b_tile + b_bytes, xoff0, xoff1,
                                min(4, (rem >> 3) + 1), dq[m], dk, rg0[m], k0, lane, y[m]);
        else
          key_step<T, NP, false>(fr, gn, nch, c_mt[m], b_tile, b_tile + b_bytes, xoff0, xoff1,
                                 4, dq[m], dk, rg0[m], k0, lane, y[m]);
      }
    }
    __syncwarp();
    if (lane == 0 && f + 2 < total) {
      __threadfence_block();   // this warp's reads of the stage come first
      if ((atomicAdd(&done[f & 1], 1) & (WARPS - 1)) == WARPS - 1) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_step(f + 2);
      }
    }
  }

  // One rounding to the output dtype; rows past Q and columns past P stay
  // unwritten (P is even, so a column pair is whole or absent).
  T* oc = out + (long long)cell * Q * P;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (rlast[m] < 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg0[m] + g + 8 * h;
      if (r >= Q) continue;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const int col = 8 * n + 2 * t;
        if (col < P) store2(oc + (long long)r * P + col, y[m][n][2 * h], y[m][n][2 * h + 1]);
      }
    }
  }
}

// A 3-D map (inner, Q, cells) of a contiguous (cells, Q, inner) tensor, a
// box of (128 bytes, rows, 1), 128-byte swizzle; reads past the tensor's
// rows or columns are 0.
inline bool encode(CUtensorMap* map, const void* base, int itemsize, long long inner,
                   long long q, long long cells, int rows) {
  wg::EncodeTiledFn fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(q),
                        static_cast<cuuint64_t>(cells)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner * itemsize),
                           static_cast<cuuint64_t>(q * inner * itemsize)};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(GROUP / itemsize),
                       static_cast<cuuint32_t>(rows), 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, itemsize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NP>
int launch(const void* x, const void* dta, const void* b, const void* c, void* out,
           long long cells, int Q, int P, int N, int tiles, int pairs,
           cudaStream_t stream) {
  const int E = sizeof(T);
  CUtensorMap mc, mb, mx;
  if (!encode(&mc, c, E, N, Q, cells, BQ) || !encode(&mb, b, E, N, Q, cells, BK) ||
      !encode(&mx, x, E, P, Q, cells, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N, P, E);
  auto kern = ssd_mma_kernel<T, NP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(cells * pairs), THREADS, smem, stream>>>(
      mc, mb, mx, static_cast<const T*>(dta), static_cast<T*>(out), Q, P, N, tiles, pairs);
  return static_cast<int>(cudaGetLastError());
}

// The mma route's checks (mirrored by kernels/ssd_scan.py::ssd_route), then
// the head-dim width.
template <typename T>
int dispatch(const void* x, const void* dta, const void* b, const void* c, void* out,
             long long cells, int Q, int P, int N, int tiles, int pairs,
             cudaStream_t s) {
  const int E = sizeof(T);
  if (P > 128 || (P * E) % 16 || (N * E) % 16 || tiles != (Q + BQ - 1) / BQ ||
      pairs != (tiles + 1) / 2 || cells * pairs > 0x7fffffffLL ||
      smem_bytes(N, P, E) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (np_of(P)) {
    case 2: return launch<T, 2>(x, dta, b, c, out, cells, Q, P, N, tiles, pairs, s);
    case 4: return launch<T, 4>(x, dta, b, c, out, cells, Q, P, N, tiles, pairs, s);
    case 8: return launch<T, 8>(x, dta, b, c, out, cells, Q, P, N, tiles, pairs, s);
    default: return launch<T, 16>(x, dta, b, c, out, cells, Q, P, N, tiles, pairs, s);
  }
}

}  // namespace ssd_mma
