// Ragged grouped GEMM for Hopper (sm_90a), the dropless MoE's expert
// products: C[r] = A[r] @ B[e(r)] for every row r of A, where the rows are
// sorted by expert and expert e owns rows offsets[e] .. offsets[e+1] - 1.
// bf16 operands, fp32 accumulators, one rounding to the output type.
//
// It replaces no TPU kernel: the reference's MoE caps every expert at a
// static capacity and runs the batched GEMM (src/repro/kernels/gemm.py,
// `pallas_gemm_batched`) over an (E, C, d) buffer, dropping the copies past
// C.  A dropless MoE (granite-4.0-h) gives each expert exactly its routed
// rows, so the row count differs from expert to expert and is known only on
// the card, after the router.  The batched GEMM needs one row count for all
// experts, and padding every expert to the largest would read and compute
// rows that hold nothing; this kernel reads the offsets on the card instead.
//
//   * Operands: A (R, K) row-major, rows sorted by expert; B a stack
//     (E, K, N), each expert's matrix row-major (MN-major for `wgmma`);
//     C (R, N), row stride sc_m; offsets (E + 1) int32 on the card.
//   * Tile table, built on the card: expert e has ceil(count_e / BM) m
//     tiles, the first at row offsets[e], and the table lists the experts'
//     tiles in expert order.  blockIdx.y is a tile of the table: warp 0 of
//     each block finds its expert by a prefix sum of the tile counts over
//     the offsets, 32 experts at a time with warp shuffles.  The host
//     launches ceil(R / BM) + E rows of blocks, a bound on the table's
//     length whatever the counts, so it never reads them; the blocks past
//     the table's end exit at once.  An empty expert has no tile.
//   * Each tile runs gemm_wgmma.cuh's pieces unchanged: the TMA producer,
//     the ring of STAGES mbarrier-guarded stages, two consumer warpgroups
//     of `wgmma`, and the epilogue.  A tile that starts at row offsets[e]
//     + j * BM may reach into the next expert's rows (or past R, which TMA
//     fills with zeros); the epilogue writes only the rows below
//     offsets[e + 1], so no row of another expert is written, and each row
//     of C is written by exactly one block.
//   * Order: blockIdx.x is the n tile, so the blocks the card starts
//     together share the m tile's A panel, and a wave (132 blocks on an
//     H100) covers a few m tiles of one or two experts across all n: A is
//     read from device memory once, and each expert's B while its tiles
//     run, from the L2 after the first wave.
//
// Bound on an H100: at granite-4.0-h's prefill (R = 163840 routed rows, K
// 4096, N 768 and back) the products do 2*R*K*N FLOPs over the rows, each
// expert's weights once and the outputs, hundreds of FLOPs per byte, so
// the bound is 989 TFLOP/s of bf16 work.  The ragged edges cost at most one
// partial tile an expert (72 of ~1350 tiles there).

#pragma once

#include "gemm_wgmma.cuh"

namespace wg {

struct GroupedArgs {
  int R, N, K, E;
  long long sc_m;            // C row stride (elements)
};

// Tile `y` of the table over `offsets`: its expert (-1 past the table's
// end), first row and end row.  Warp 0 only (all 32 lanes).
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets,
                                          int E, int y, int* out) {
  const int lane = threadIdx.x % 32;
  int base = 0;                                    // tiles of earlier experts
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    int lo = 0, hi = 0;
    if (e < E) {
      lo = offsets[e];
      hi = offsets[e + 1];
    }
    const int tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
    int incl = tiles;                              // inclusive scan over lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int first = base + incl - tiles;
    const unsigned mine =
        __ballot_sync(0xffffffffu, tiles > 0 && y >= first && y < first + tiles);
    if (mine) {                                    // the same on every lane
      if (lane == __ffs(mine) - 1) {
        out[0] = e;
        out[1] = lo + (y - first) * BM;
        out[2] = hi;
      }
      return;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) out[0] = -1;
}

// BN: block tile width (64 or 128); B MN-major (each expert row-major).
template <int BN, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
grouped_wgmma(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, TO* __restrict__ C,
              const int* __restrict__ offsets, GroupedArgs g) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ int tile[3];                          // expert, first row, end row
  const Ring<BN> ring = ring_of<BN>(smem_raw);
  if (threadIdx.x < 32) find_tile(offsets, g.E, blockIdx.y, tile);
  ring_init(ring);
  __syncthreads();
  const int e = tile[0];
  if (e < 0) return;                               // past the table: the block
  const int m0 = tile[1], row_end = tile[2], n0 = blockIdx.x * BN;
  const int ktiles = (g.K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    if (threadIdx.x == 0)
      produce<BN, 1>(ring, &map_a, &map_b, ktiles, m0, n0, 0, e);
    return;
  }
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float acc[BN / 2];
  consume<BN, 1>(ring, acc, ktiles, c, lane);
  store_tile<BN, TO>(C, acc, m0, n0, row_end, g.N, g.sc_m, g.sc_m % 2 == 0,
                     c, warp, lane);
}

template <int BN, typename TO>
cudaError_t launch_grouped_tile(const CUtensorMap& ma, const CUtensorMap& mb,
                                TO* C, const int* offsets, const GroupedArgs& g,
                                int tiles, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  auto kernel = grouped_wgmma<BN, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.N + BN - 1) / BN, tiles, 1);
  kernel<<<grid, THREADS, smem, stream>>>(ma, mb, C, offsets, g);
  return cudaGetLastError();
}

// C = A @ B[e(r)] row by row (see the top of this file).  A row-major with
// row stride sa_m; B (E, K, N) with expert stride sb_e and row stride sb_k,
// unit column stride; C row stride sc_m; strides in elements.  Returns
// cudaErrorInvalidValue when a tensor map cannot be encoded (misaligned
// base or stride) or the table would need more than 65535 rows of blocks.
template <typename TO>
cudaError_t launch_grouped(const __nv_bfloat16* A, const __nv_bfloat16* B,
                           TO* C, const int* offsets, int R, int N, int K,
                           int E, long long sa_m, long long sb_e,
                           long long sb_k, long long sc_m,
                           cudaStream_t stream) {
  const long long tiles = (R + BM - 1) / BM + static_cast<long long>(E);
  if (R <= 0 || E <= 0 || tiles > 65535) return cudaErrorInvalidValue;
  const bool narrow = N <= 64;
  CUtensorMap ma, mb;
  if (!encode_3d(&ma, A, K, R, 1, sa_m, 0, BK, BM) ||
      !encode_3d(&mb, B, N, K, E, sb_k, E > 1 ? sb_e : 0, 64, BK))
    return cudaErrorInvalidValue;
  GroupedArgs g{R, N, K, E, sc_m};
  return narrow
      ? launch_grouped_tile<64, TO>(ma, mb, C, offsets, g, int(tiles), stream)
      : launch_grouped_tile<128, TO>(ma, mb, C, offsets, g, int(tiles), stream);
}

}  // namespace wg
