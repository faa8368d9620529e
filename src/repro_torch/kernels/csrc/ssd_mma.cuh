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
// tile) and B (in a tile of `b_grp` bytes a 128-byte column group: 32 keys
// by default); `nch` 16-byte chunks hold data.
template <typename T>
__device__ __forceinline__ float diag_dot(const unsigned char* c_row, const unsigned char* b_row,
                                          int nch, int sw, int b_grp = BK * GROUP) {
  float acc = 0.f;
#pragma unroll 4
  for (int ch = 0; ch < nch; ++ch) {
    const int o = ((ch & 7) ^ sw) << 4;
    const uint4 cv = *reinterpret_cast<const uint4*>(c_row + (ch >> 3) * (BQ * GROUP) + o);
    const uint4 bv = *reinterpret_cast<const uint4*>(b_row + (ch >> 3) * b_grp + o);
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
  void (*kern)(CUtensorMap, CUtensorMap, CUtensorMap, const T*, T*, int, int, int, int, int) =
      ssd_mma_kernel<T, NP>;
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


// ---- The whole chunked core, B and C read once a group ---------------------
//
// Route "chunked" of kernels/ssd_scan.py::ssd_scan: the Mamba-2 SSD core
//
//     y = (L ∘ C Bᵀ)(dt·x) + exp(cum) · (C · h_entering) + D·x   per chunk,
//     h_c = exp(cum_last,c−1) · h_c−1 + Bᵀ (exp(cum_last − cum) · dt · x)_c−1
//
// as three launches, f32 only, every operand read where it lies: x (B, S,
// H, P) and B, C (B, S, G, N) through 4-D tensor maps with their own
// strides (the conv's (B, S, F) output, sliced, is read in place); dt as
// (B, H, S) and the within-chunk cumulative log-decays cum as (B, H, C, Q),
// contiguous; the states (B, C, H, N, P) f32 in a buffer of the caller's.
// Head h reads group h / (H / G), so no per-head copy of B or C is made.
//
//  1. ssd_state_kernel: for each (cell = batch·chunk, block of a group's
//     heads) the chunk's states Bᵀ · (w ∘ x), w = exp(cum_last − cum)·dt.
//     The chunk's B (Q x N) is loaded once into shared memory and serves
//     every head of the block; X streams through a ring of 32-row slabs,
//     as deep as shared memory allows (up to 8).
//     Eight warps, warp w the state rows 16w.. (N <= 128); 3xTF32 mma.sync,
//     both operands in the permuted k order (slot t <-> row 2t, t + 4 <->
//     2t + 1) that makes the swizzled column loads free of bank conflicts.
//  2. ssd_pass_kernel: h_c in place of states_c, walked over the chunks in
//     order, one thread a float4 of a (batch, head)'s N x P state.
//  3. ssd_mma_kernel (ChunkArgs instances): per (query tile, cell, block of
//     a group's heads).  S = C·Bᵀ for the tile's rows and the keys up to
//     them is computed once, with the diagonal pairs' plain fp32 dot
//     products as the diagonal route does, and kept in shared memory in
//     the accumulators' own lane order (64 KB at Q 256).  Each head of the
//     block then takes y = exp(cum_q)·(C · h) (the C tile stays resident;
//     h in 32-row slabs through the ring), and y += P·X over the key steps
//     with P = S·exp(dq − dk)·dt_k decayed per pair in registers, masked
//     pairs selected to 0 (never multiplied by a 0/1 mask), then the D skip,
//     and writes y once as (B, S, H, P).  Blocks of the last query tile,
//     which carry the most keys, come first.
//
// Precision as the diagonal route's (the note at the top): 3xTF32 products
// with fp32 sums, the decay applied per pair, never factored; besides, each
// 32-deep k product (a slab of rows, of state rows or of keys) is summed in
// a fresh mma accumulator and added to the running fp32 sum, since the
// tensor core truncates as it accumulates (gemm_tf32x3.cuh restarts alike).
// The rows past a chunk's end that a slab reads (the next chunk's, or TMA's
// zeros past the sequence) weigh 0 in the states and are masked keys in S.
//
// No atomics on device memory and no split sums: a repeated launch gives
// the same bits.

constexpr int BKS = 16;            // keys a slab of the score pass
constexpr int MAX_SSTAGES = 8;     // ring stages of the state kernel, at most
constexpr int MAX_SMEM = 232448;   // what one block may use on an H100
constexpr int STATE_WARPS = 8;     // warp w: state rows 16w .. 16w + 15

__host__ __device__ inline int round_q(int q) { return (q + BQ - 1) / BQ * BQ; }

struct ChunkArgs {
  CUtensorMap c64;                 // C (N, G, S, B), boxes of 64 rows
  CUtensorMap b16;                 // B (N, G, S, B), boxes of 16 rows
  CUtensorMap x32;                 // x (P, H, S, B), boxes of 32 rows
  CUtensorMap h32;                 // entering states (P, N, H, B·C), 32 rows
  const float* x;                  // for the D skip
  const float* dt;                 // (B, H, S)
  const float* cum;                // (B, H, C, Q)
  const float* d;                  // (H,)
  float* out;                      // (B, S, H, P)
  long long xs_b, xs_s, xs_h;      // x's strides in elements (unit along P)
  int S, H, G, P, N, Q, C, tiles, hg, hblocks, cells;
};

struct StateArgs {
  CUtensorMap b64;                 // B (N, G, S, B), boxes of 64 rows
  CUtensorMap x32;                 // x (P, H, S, B), boxes of 32 rows
  const float* dt;
  const float* cum;
  float* states;                   // (B, C, H, N, P)
  int S, H, G, P, N, Q, C, hg, hblocks, stages;
};

// The C tile (64 rows), S of four warps for every 8-key n-tile up to Q
// (one float4 a lane), two ring stages holding a 16-key B slab or a 32-row
// X / h slab, and the mbarriers.
__host__ __device__ inline int chunk_stage_bytes(int N, int P) {
  const int gn = groups(N, 4), gp = groups(8 * np_of(P), 4);
  return (BKS * gn > BK * gp ? BKS * gn : BK * gp) * GROUP;
}
__host__ __device__ inline size_t chunk_smem_bytes(int Q, int N, int P) {
  return size_t(BQ) * groups(N, 4) * GROUP + size_t(round_q(Q)) * 256 +
         2 * size_t(chunk_stage_bytes(N, P)) + 64;
}
// The state kernel's block: the chunk's B (rows up to Q rounded to 64),
// the block's per-row weights a head and the mbarriers, then as many X-slab
// ring stages as fit, up to MAX_SSTAGES (0 when fewer than 2 fit): X comes
// from memory once, so the deeper the ring, the more of its latency hides.
__host__ __device__ inline int state_stages(int Q, int N, int P, int hg) {
  const long long fixed = (long long)round_q(Q) * groups(N, 4) * GROUP +
                          (long long)hg * round_q(Q) * 4 + 16 * (MAX_SSTAGES + 1);
  const long long stage = (long long)BK * groups(8 * np_of(P), 4) * GROUP;
  const long long n = (MAX_SMEM - fixed) / stage;
  return n < 2 ? 0 : n > MAX_SSTAGES ? MAX_SSTAGES : static_cast<int>(n);
}
__host__ __device__ inline size_t state_smem_bytes(int Q, int N, int P, int hg) {
  return size_t(round_q(Q)) * groups(N, 4) * GROUP + size_t(hg) * round_q(Q) * 4 +
         16 * (MAX_SSTAGES + 1) +
         size_t(state_stages(Q, N, P, hg)) * BK * groups(8 * np_of(P), 4) * GROUP;
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// X-fragment offsets inside a 128-byte group for rows 2t / 2t + 1 (XGeo).
__device__ __forceinline__ void x_offsets(int g, int t, int (&o0)[4], int (&o1)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = XGeo<float>::chunk(j, g);
    o0[j] = ((ch ^ (2 * t)) << 4) + XGeo<float>::byte(g);
    o1[j] = ((ch ^ (2 * t + 1)) << 4) + XGeo<float>::byte(g);
  }
}

// acc[n] += A · (w ∘ X) for one 8-row k step of a 32-row slab: A's slots t
// and t + 4 hold rows 2t and 2t + 1 (a0 / a2 row g, a1 / a3 row g + 8), X's
// rows 2t and 2t + 1 of the step scaled by w0 / w1; 3xTF32.
// acc += part in fp32 adds: the tensor core's accumulator truncates as it
// sums, so every k product of 32 rows starts a fresh one (as gemm_tf32x3.cuh
// restarts every 32-deep k tile) and is added here, rounded to nearest.
template <int NP>
__device__ __forceinline__ void add_to(float (&acc)[NP][4], const float (&part)[NP][4]) {
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

template <int NP>
__device__ __forceinline__ void mma_x(const float (&af)[4], const unsigned char* x_step,
                                      const int (&o0)[4], const int (&o1)[4], float w0, float w1,
                                      int t, float (&acc)[NP][4]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split<false>(af[e], ah[e], al[e]);
  const unsigned char* x0 = x_step + 2 * t * GROUP;
  const unsigned char* x1 = x0 + GROUP;
  uint32_t xh[NP][2], xl[NP][2];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const int grp = (n / 4) * (BK * GROUP), j = n % 4;
    split<false>(w0 * lds<float>(x0 + grp + o0[j]), xh[n][0], xl[n][0]);
    split<false>(w1 * lds<float>(x1 + grp + o1[j]), xh[n][1], xl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NP; ++n) mma(acc[n], al, xh[n][0], xh[n][1]);
#pragma unroll
  for (int n = 0; n < NP; ++n) mma(acc[n], ah, xl[n][0], xl[n][1]);
#pragma unroll
  for (int n = 0; n < NP; ++n) mma(acc[n], ah, xh[n][0], xh[n][1]);
}

template <int NP>
__global__ void __launch_bounds__(32 * STATE_WARPS, 1)
ssd_state_kernel(const __grid_constant__ StateArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) & 1023u) __trap();
  const int gn = groups(a.N, 4), gp = groups(8 * NP, 4), qp = round_q(a.Q);
  const int stages = a.stages;
  unsigned char* const btile = smem;                       // gn boxes of [qp][128 B]
  unsigned char* const ring = smem + qp * gn * GROUP;
  const int stage_bytes = BK * gp * GROUP;
  float* const w = reinterpret_cast<float*>(ring + stages * stage_bytes);   // [hg][qp]
  uint64_t* const full = reinterpret_cast<uint64_t*>(w + a.hg * qp);
  uint64_t* const bbar = full + MAX_SSTAGES;

  const int cell = blockIdx.x / a.hblocks, hblk = blockIdx.x - cell * a.hblocks;
  const int bi = cell / a.C, ci = cell - bi * a.C;
  const int grp = hblk * a.hg / (a.H / a.G), row0 = ci * a.Q;
  const int nq = (a.Q + BK - 1) / BK, total = a.hg * nq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  auto issue = [&](int f) {
    const int st = f % stages, head = hblk * a.hg + f / nq, q0 = (f % nq) * BK;
    unsigned char* dst = ring + st * stage_bytes;
    wg::mbar_expect_tx(&full[st], stage_bytes);
    for (int q = 0; q < gp; ++q)
      wg::tma_load_4d(dst + q * BK * GROUP, &a.x32, &full[st], q * 32, head, row0 + q0, bi);
  };
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) wg::mbar_init(&full[st], 1);
    wg::mbar_init(bbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(bbar, qp * gn * GROUP);
    for (int r = 0; r < qp; r += BQ)
      for (int q = 0; q < gn; ++q)
        wg::tma_load_4d(btile + q * qp * GROUP + r * GROUP, &a.b64, bbar, q * 32, grp, row0 + r, bi);
    for (int f = 0; f < stages && f < total; ++f) issue(f);
  }
  // The rows' weights exp(cum_last − cum_q)·dt_q, 0 past Q.
  for (int i = tid; i < a.hg * qp; i += 32 * STATE_WARPS) {
    const int hh = i / qp, q = i - hh * qp;
    const long long bh = (long long)bi * a.H + hblk * a.hg + hh;
    const float* cr = a.cum + (bh * a.C + ci) * a.Q;
    w[i] = q < a.Q ? ex2((cr[a.Q - 1] - cr[q]) * LOG2E) * a.dt[bh * a.S + row0 + q] : 0.f;
  }
  __syncthreads();
  wg::mbar_wait(bbar, 0);

  // A = Bᵀ: this warp's state rows m0 + g and m0 + g + 8 are columns of the
  // B tile (chunk cA / cA + 2 of their 128-byte group, word g & 3).
  const int m0 = 16 * warp;
  const bool live = m0 < a.N;
  const unsigned char* bcol = btile + (m0 / 32) * qp * GROUP + 4 * (g & 3);
  const int cA = 4 * ((m0 / 16) & 1) + (g >> 2);
  int o0[4], o1[4];
  x_offsets(g, t, o0, o1);
  float acc[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int f = 0; f < total; ++f) {
    const int st = f % stages, hh = f / nq, qs = f - hh * nq;
    wg::mbar_wait(&full[st], (f / stages) & 1);
    if (live) {
      const unsigned char* xs = ring + st * stage_bytes;
      const float* wr = w + hh * qp + qs * BK;
      float part[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned char* p0 = bcol + (qs * BK + 8 * kk + 2 * t) * GROUP;
        const unsigned char* p1 = p0 + GROUP;
        const float af[4] = {lds<float>(p0 + ((cA ^ (2 * t)) << 4)),
                             lds<float>(p0 + (((cA + 2) ^ (2 * t)) << 4)),
                             lds<float>(p1 + ((cA ^ (2 * t + 1)) << 4)),
                             lds<float>(p1 + (((cA + 2) ^ (2 * t + 1)) << 4))};
        mma_x<NP>(af, xs + 8 * kk * GROUP, o0, o1, wr[8 * kk + 2 * t], wr[8 * kk + 2 * t + 1], t,
                  part);
      }
      add_to(acc, part);
    }
    if (qs == nq - 1) {
      if (live) {
        const long long head = hblk * a.hg + hh;
        float* sp = a.states + ((long long)cell * a.H + head) * a.N * a.P;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = m0 + g + 8 * h;
          if (n >= a.N) continue;
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            const int col = 8 * j + 2 * t;
            if (col < a.P) store2(sp + (long long)n * a.P + col, acc[j][2 * h], acc[j][2 * h + 1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    __syncthreads();                       // every warp is done with stage st
    if (tid == 0 && f + stages < total) {
      fence_async();
      issue(f + stages);
    }
  }
}

// states (B, C, H, N·P) -> the state entering each chunk, in place:
// h_0 = 0, h_c = exp(cum[b, h, c − 1, Q − 1]) · h_c−1 + states_c−1 (the
// product rounded, then the sum, as the plain loop's two ops).
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float4* __restrict__ states, const float* __restrict__ cum, int H, int C, int Q,
                long long per, long long items) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= items) return;
  const long long bh = i / per, e = i - bh * per;
  const long long b = bh / H, h = bh - b * H;
  float4 hs = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* const base = states + (b * C * H + h) * per + e;
  const long long step = (long long)H * per;        // one chunk
  // Eight chunks' states are loaded before any is overwritten, so that a
  // thread keeps eight loads in flight.
  for (int c0 = 0; c0 < C; c0 += 8) {
    float4 s[8];
    float dec[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < C) {
        s[j] = base[(c0 + j) * step];
        dec[j] = expf(cum[(bh * C + c0 + j) * Q + Q - 1]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < C) {
        base[(c0 + j) * step] = hs;
        hs.x = __fadd_rn(__fmul_rn(dec[j], hs.x), s[j].x);
        hs.y = __fadd_rn(__fmul_rn(dec[j], hs.y), s[j].y);
        hs.z = __fadd_rn(__fmul_rn(dec[j], hs.z), s[j].z);
        hs.w = __fadd_rn(__fmul_rn(dec[j], hs.w), s[j].w);
      }
  }
}

// S for one 16-key slab of this warp's m-tile (its first `nlive` 8-key
// n-tiles), 3xTF32 over the state dimension, the diagonal pairs' plain dot
// products on the diagonal slab; stored as the lanes' accumulators.
__device__ __forceinline__ void score_slab(const Frags<float>& fa, const unsigned char* c_mt,
                                           const unsigned char* slab, int gn, int nch, int nlive,
                                           int rg0, int k0, int lane, float4* out) {
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r = lane & 7;
  const uint32_t b_row = static_cast<uint32_t>(__cvta_generic_to_shared(slab)) +
                         (8 * (mi >> 1) + r) * GROUP;
  float s[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 1
  for (int gi = 0; gi < gn; ++gi) {
    float sg[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sg[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float af[4];
      fa.load_a(gi, kk, af);
      uint32_t rb[4];
      ldsm_x4(b_row + gi * (BKS * GROUP) + (((2 * kk + (mi & 1)) ^ r) << 4), rb);
      uint32_t ah[4], al[4], bh[2][2], bl[2][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) split<false>(af[e], ah[e], al[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e) split<false>(__uint_as_float(rb[e]), bh[e >> 1][e & 1], bl[e >> 1][e & 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < nlive) mma(sg[i], al, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < nlive) mma(sg[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < nlive) mma(sg[i], ah, bh[i][0], bh[i][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] += sg[i][e];
  }
  if (k0 == rg0) {
    const int rl = lane & 15;
    const float sd = diag_dot<float>(c_mt + rl * GROUP, slab + rl * GROUP, nch, rl & 7,
                                     BKS * GROUP);
    const float sdv[2] = {__shfl_sync(0xffffffffu, sd, g), __shfl_sync(0xffffffffu, sd, g + 8)};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * i + 2 * t + (e & 1) == g + 8 * (e >> 1)) s[i][e] = sdv[e >> 1];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (i < nlive) out[i * 32 + lane] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

// y += P · X for one 32-key step of a head: P = S · exp(dq − dk) · dt_k from
// the stored S, masked pairs (DIAG) selected to 0; k permuted as key_step's.
template <int NP, bool DIAG>
__device__ __forceinline__ void px_step(const float4* sw, const unsigned char* x_keys,
                                        const int (&o0)[4], const int (&o1)[4], int nlive,
                                        const float (&dq)[2], const float (&dk)[4][2],
                                        const float (&dtk)[4][2], int rg0, int k0, int lane,
                                        float (&y)[NP][4]) {
  const int g = lane >> 2, t = lane & 3;
  float part[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (DIAG && i >= nlive) continue;
    const float4 sv = sw[i * 32 + lane];
    float s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = e & 1;
      const float p = s[e] * ex2((dq[h] - dk[i][j]) * LOG2E) * dtk[i][j];
      s[e] = (!DIAG || k0 + 8 * i + 2 * t + j <= rg0 + g + 8 * h) ? p : 0.f;
    }
    uint32_t ph[4], pl[4];
    split<false>(s[0], ph[0], pl[0]);
    split<false>(s[2], ph[1], pl[1]);
    split<false>(s[1], ph[2], pl[2]);
    split<false>(s[3], ph[3], pl[3]);
    const unsigned char* x0 = x_keys + (8 * i + 2 * t) * GROUP;
    const unsigned char* x1 = x0 + GROUP;
    uint32_t xh[NP][2], xl[NP][2];
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int grp = (n / 4) * (BK * GROUP), j = n % 4;
      split<false>(lds<float>(x0 + grp + o0[j]), xh[n][0], xl[n][0]);
      split<false>(lds<float>(x1 + grp + o1[j]), xh[n][1], xl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NP; ++n) mma(part[n], pl, xh[n][0], xh[n][1]);
#pragma unroll
    for (int n = 0; n < NP; ++n) mma(part[n], ph, xl[n][0], xl[n][1]);
#pragma unroll
    for (int n = 0; n < NP; ++n) mma(part[n], ph, xh[n][0], xh[n][1]);
  }
  add_to(y, part);
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 2)
ssd_mma_kernel(const __grid_constant__ ChunkArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) & 1023u) __trap();
  const int gn = groups(a.N, 4), qp = round_q(a.Q);
  const int nch = a.N >> 2;                               // 16-byte chunks of a C / B row
  unsigned char* const ctile = smem;                      // gn boxes of [64][128 B]
  float4* const sbuf = reinterpret_cast<float4*>(smem + BQ * gn * GROUP);
  unsigned char* const ring = smem + BQ * gn * GROUP + qp * 256;
  const int stage_bytes = chunk_stage_bytes(a.N, a.P);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + 2 * stage_bytes);
  uint64_t* const cbar = full + 2;
  const int gp = groups(8 * NP, 4);

  // Block -> (query tile, cell, head block), the last query tile first.
  const int per_tile = a.cells * a.hblocks;
  const int tile = a.tiles - 1 - blockIdx.x / per_tile;
  const int rest = blockIdx.x % per_tile;
  const int cell = rest / a.hblocks, hblk = rest - (rest / a.hblocks) * a.hblocks;
  const int bi = cell / a.C, ci = cell - bi * a.C;
  const int grp = hblk * a.hg / (a.H / a.G), row0 = ci * a.Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const int keys = min((tile + 1) * BQ, a.Q);
  const int nks = (keys + BKS - 1) / BKS;                 // score slabs
  const int nkx = (keys + BK - 1) / BK;                   // X steps a head
  const int hsteps = ci > 0 ? gn : 0;                     // h slabs a head (none in chunk 0)
  const int per_head = hsteps + nkx, total = nks + a.hg * per_head;

  auto issue = [&](int f) {
    const int st = f & 1;
    unsigned char* dst = ring + st * stage_bytes;
    if (f < nks) {
      wg::mbar_expect_tx(&full[st], BKS * gn * GROUP);
      for (int q = 0; q < gn; ++q)
        wg::tma_load_4d(dst + q * BKS * GROUP, &a.b16, &full[st], q * 32, grp, row0 + f * BKS, bi);
      return;
    }
    const int hh = (f - nks) / per_head, r = (f - nks) - hh * per_head;
    const int head = hblk * a.hg + hh;
    wg::mbar_expect_tx(&full[st], BK * gp * GROUP);
    for (int q = 0; q < gp; ++q) {
      if (r < hsteps)
        wg::tma_load_4d(dst + q * BK * GROUP, &a.h32, &full[st], q * 32, r * BK, head, cell);
      else
        wg::tma_load_4d(dst + q * BK * GROUP, &a.x32, &full[st], q * 32, head,
                        row0 + (r - hsteps) * BK, bi);
    }
  };
  if (tid == 0) {
    wg::mbar_init(&full[0], 1);
    wg::mbar_init(&full[1], 1);
    wg::mbar_init(cbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(cbar, BQ * gn * GROUP);
    for (int q = 0; q < gn; ++q)
      wg::tma_load_4d(ctile + q * BQ * GROUP, &a.c64, cbar, q * 32, grp, row0 + tile * BQ, bi);
    issue(0);
    if (total > 1) issue(1);
  }

  const int rg0 = tile * BQ + 16 * warp;                  // this warp's m-tile
  const int rlast = rg0 < a.Q ? min(rg0 + 15, a.Q - 1) : -1;
  const unsigned char* c_mt = ctile + 16 * warp * GROUP;
  float4* const sw = sbuf + warp * (qp / 8) * 32;         // its S, by 8-key n-tile
  const Frags<float> fa(c_mt, ring, lane);
  wg::mbar_wait(cbar, 0);

  // 1. S, once for all the block's heads.
  for (int f = 0; f < nks; ++f) {
    const int k0 = f * BKS;
    wg::mbar_wait(&full[f & 1], (f >> 1) & 1);
    if (k0 <= rlast)
      score_slab(fa, c_mt, ring + (f & 1) * stage_bytes, gn, nch, min(2, ((rlast - k0) >> 3) + 1),
                 rg0, k0, lane, sw + (k0 / 8) * 32);
    __syncthreads();
    if (tid == 0 && f + 2 < total) {
      fence_async();
      issue(f + 2);
    }
  }

  // 2. Each head: the entering state's term, the decayed P·X, the D skip.
  int o0[4], o1[4];
  x_offsets(g, t, o0, o1);
  float y[NP][4], dq[2];
  long long bh = 0;
  for (int f = nks; f < total; ++f) {
    const int hh = (f - nks) / per_head, r = (f - nks) - hh * per_head;
    const int head = hblk * a.hg + hh;
    const unsigned char* stg = ring + (f & 1) * stage_bytes;
    if (r == 0) {
      bh = (long long)bi * a.H + head;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rg0 + g + 8 * h;
        dq[h] = row < a.Q ? __ldg(a.cum + (bh * a.C + ci) * a.Q + row) : -__int_as_float(0x7f800000);
      }
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[n][e] = 0.f;
    }
    wg::mbar_wait(&full[f & 1], (f >> 1) & 1);
    if (rlast >= 0) {
      if (r < hsteps) {
        // y += C · h over state rows 32r ..: A's slots t / t + 4 <- C columns
        // 2t / 2t + 1 of each 8-wide k step (one float2), matching X's rows.
        const unsigned char* cr = c_mt + g * GROUP + r * (BQ * GROUP);
        float part[NP][4];
#pragma unroll
        for (int n = 0; n < NP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int o = (((2 * kk + (t >> 1)) ^ g) << 4) + 8 * (t & 1);
          const float2 lo = *reinterpret_cast<const float2*>(cr + o);
          const float2 hi = *reinterpret_cast<const float2*>(cr + 8 * GROUP + o);
          const float af[4] = {lo.x, hi.x, lo.y, hi.y};
          mma_x<NP>(af, stg + 8 * kk * GROUP, o0, o1, 1.f, 1.f, t, part);
        }
        add_to(y, part);
        if (r == hsteps - 1) {
#pragma unroll
          for (int n = 0; n < NP; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[n][e] *= ex2(dq[e >> 1] * LOG2E);
        }
      } else {
        const int k0 = (r - hsteps) * BK, rem = rlast - k0;
        if (rem >= 0) {
          const float* cr = a.cum + (bh * a.C + ci) * a.Q;
          const float* dr = a.dt + bh * a.S + row0;
          float dk[4][2], dtk[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int k = k0 + 8 * i + 2 * t + j;
              dk[i][j] = k < a.Q ? __ldg(cr + k) : 0.f;
              dtk[i][j] = k < a.Q ? __ldg(dr + k) : 0.f;
            }
          if (rem < BK)
            px_step<NP, true>(sw + (k0 / 8) * 32, stg, o0, o1, min(4, (rem >> 3) + 1), dq, dk, dtk,
                              rg0, k0, lane, y);
          else
            px_step<NP, false>(sw + (k0 / 8) * 32, stg, o0, o1, 4, dq, dk, dtk, rg0, k0, lane, y);
        }
      }
      if (r == per_head - 1) {
        const float dh = __ldg(a.d + head);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rg0 + g + 8 * h;
          if (row >= a.Q) continue;
          const float* xr = a.x + bi * a.xs_b + (long long)(row0 + row) * a.xs_s + head * a.xs_h;
          float* orow = a.out + (((long long)bi * a.S + row0 + row) * a.H + head) * a.P;
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            const int col = 8 * n + 2 * t;
            if (col >= a.P) continue;
            const float2 xv = __ldg(reinterpret_cast<const float2*>(xr + col));
            store2(orow + col, y[n][2 * h] + dh * xv.x, y[n][2 * h + 1] + dh * xv.y);
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0 && f + 2 < total) {
      fence_async();
      issue(f + 2);
    }
  }
}

// A 4-D f32 map with unit stride along dims[0], the element strides of the
// other three, a box of (32 floats, box rows along dim `rows_dim`, else 1)
// and the 128-byte swizzle; reads out of bounds are 0.
inline bool encode_f32(CUtensorMap* map, const void* base, const long long (&dims)[4],
                       const long long (&strides)[3], int rows_dim, int rows) {
  wg::EncodeTiledFn fn = wg::encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gd[4], gs[3];
  cuuint32_t box[4] = {32, 1, 1, 1}, estr[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) gd[i] = static_cast<cuuint64_t>(dims[i]);
  for (int i = 0; i < 3; ++i) gs[i] = static_cast<cuuint64_t>(strides[i]) * 4;
  box[rows_dim] = static_cast<cuuint32_t>(rows);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), gd, gs, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP>
int launch_chunked(const StateArgs& sa, const ChunkArgs& ca, float* states, const float* cum,
                   int B, cudaStream_t stream) {
  const size_t s_smem = state_smem_bytes(ca.Q, ca.N, ca.P, ca.hg);
  const size_t c_smem = chunk_smem_bytes(ca.Q, ca.N, ca.P);
  void (*sk)(StateArgs) = ssd_state_kernel<NP>;
  void (*ck)(ChunkArgs) = ssd_mma_kernel<NP>;
  cudaError_t e = cudaFuncSetAttribute(sk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(s_smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ck, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(c_smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ck, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  sk<<<static_cast<unsigned>(ca.cells * ca.hblocks), 32 * STATE_WARPS, s_smem, stream>>>(sa);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long per = (long long)ca.N * ca.P / 4, items = (long long)B * ca.H * per;
  ssd_pass_kernel<<<static_cast<unsigned>((items + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<float4*>(states), cum, ca.H, ca.C, ca.Q, per, items);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ck<<<static_cast<unsigned>(ca.tiles * ca.cells * ca.hblocks), THREADS, c_smem, stream>>>(ca);
  return static_cast<int>(cudaGetLastError());
}

// The chunked route's checks (mirrored by kernels/ssd_scan.py::scan_route),
// its tensor maps, then the three launches.  x_st / b_st / c_st: the batch,
// sequence and head (group) strides in elements, unit along P / N.
inline int chunked(const float* x, const float* b, const float* c, const float* dt,
                   const float* cum, const float* d, float* states, float* out,
                   const long long (&x_st)[3], const long long (&b_st)[3],
                   const long long (&c_st)[3], int B, int S, int H, int G, int P, int N, int Q,
                   int hg, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const int C = S / Q;
  const long long cells = (long long)B * C, tiles = (Q + BQ - 1) / BQ;
  if (G <= 0 || H % G || Q <= 0 || S % Q || P <= 0 || P > 128 || P % 4 || N <= 0 || N > 128 ||
      N % 4 || hg <= 0 || (H / G) % hg || chunk_smem_bytes(Q, N, P) > MAX_SMEM ||
      state_stages(Q, N, P, hg) == 0 || tiles * cells * (H / hg) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  StateArgs sa;
  ChunkArgs ca;
  const long long xd[4] = {P, H, S, B}, xs[3] = {x_st[2], x_st[1], x_st[0]};
  const long long bd[4] = {N, G, S, B}, bs[3] = {b_st[2], b_st[1], b_st[0]};
  const long long cs[3] = {c_st[2], c_st[1], c_st[0]};
  const long long hd[4] = {P, N, H, cells}, hs[3] = {P, (long long)N * P, (long long)H * N * P};
  if (!encode_f32(&sa.b64, b, bd, bs, 2, BQ) || !encode_f32(&sa.x32, x, xd, xs, 2, BK) ||
      !encode_f32(&ca.c64, c, bd, cs, 2, BQ) || !encode_f32(&ca.b16, b, bd, bs, 2, BKS) ||
      !encode_f32(&ca.h32, states, hd, hs, 1, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  ca.x32 = sa.x32;
  sa.dt = ca.dt = dt;
  sa.cum = ca.cum = cum;
  sa.states = states;
  ca.x = x;
  ca.d = d;
  ca.out = out;
  ca.xs_b = x_st[0];
  ca.xs_s = x_st[1];
  ca.xs_h = x_st[2];
  sa.S = ca.S = S;
  sa.H = ca.H = H;
  sa.G = ca.G = G;
  sa.P = ca.P = P;
  sa.N = ca.N = N;
  sa.Q = ca.Q = Q;
  sa.C = ca.C = C;
  sa.hg = ca.hg = hg;
  sa.hblocks = ca.hblocks = H / hg;
  sa.stages = state_stages(Q, N, P, hg);
  ca.tiles = static_cast<int>(tiles);
  ca.cells = static_cast<int>(cells);
  switch (np_of(P)) {
    case 2: return launch_chunked<2>(sa, ca, states, cum, B, stream);
    case 4: return launch_chunked<4>(sa, ca, states, cum, B, stream);
    case 8: return launch_chunked<8>(sa, ca, states, cum, B, stream);
    default: return launch_chunked<16>(sa, ca, states, cum, B, stream);
  }
}

}  // namespace ssd_mma
