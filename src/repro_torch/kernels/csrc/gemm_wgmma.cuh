// Tensor-core tile of the GEMM (gemm.cu) for Hopper, sm_90a: bf16 operands,
// fp32 accumulators, C[z] = A[z] @ B[z] for m > 16.
//
// The Pallas kernel it stands for (src/repro/kernels/gemm.py:32,
// `gemm_kernel`) did each block's products on the MXU with bf16 operands and
// an fp32 accumulator.  On Hopper that is `wgmma` on bf16 tiles in shared
// memory, fed by the Tensor Memory Accelerator (TMA):
//
//   * Block tile BM 128 x BN (128, or 64 for n <= 64) x BK 64, three
//     warpgroups.  Warpgroup 0 is the producer: one thread walks k, waits for
//     a free stage of the ring ("empty" mbarrier), and asks TMA for the A
//     and B tiles of that stage, which arrive on the stage's "full"
//     mbarrier.  Warpgroups 1 and 2 are consumers: each owns 64 rows of the
//     block tile, waits for a full stage, issues four m64nBNk16 `wgmma`s
//     (one per 16 of k) out of shared memory into fp32 registers, and frees
//     the stage once that group is done, keeping one group in flight while
//     it waits for the next stage.  The ring has STAGES stages of 32 KB, so
//     TMA keeps up to STAGES - 2 tiles in flight ahead of the tensor cores.
//   * Shared memory is swizzled 128 B wide, as TMA writes it and `wgmma`
//     reads it; each tile starts on a 1024-byte boundary.  A tile: 128 rows
//     of 64 k (K-major).  B tile, by the layout of B in device memory:
//     K-major (B[k][n] at k-stride 1, e.g. a tied embedding's transpose):
//     BN rows of 64 k, read like A; MN-major (a row-major [k, n] weight):
//     BN / 64 boxes of 64 k-rows of 64 n, read with `wgmma`'s transpose bit.
//   * Batch: blockIdx.z, the third coordinate of 3-D tensor maps (inner,
//     rows, batch), so a tile never reads across two batch entries and TMA
//     fills with zeros every read past m, n or k.  A broadcast operand
//     (batch stride 0) is mapped with one batch entry.  The single GEMM is
//     the batch of one: both run this function, so a stacked launch equals
//     its single launches bit for bit.
//   * Epilogue: each consumer thread holds its 64 x BN fragment in
//     registers and writes it once, rounded to bf16 (round to nearest even)
//     or as fp32, with masked stores.
//   * Tile order: the blocks of one batch entry visit the output tiles in
//     groups of `group` consecutive m tiles (kernels/gemm.py::wgmma_plan
//     picks it, and writes the map out): within a group m fastest, then n,
//     then the next group; the last group may be short.  A group that
//     spans every m tile is the plain order, m fastest over the whole grid.
//     Only which block computes which tile changes, never a tile's
//     arithmetic, so C is the same bits in every order.
//
// Bound on an H100: a whole GEMM at the forward's shapes does hundreds of
// FLOPs per byte, above the card's ~295 FLOP/byte ridge, so the bound is
// 989 TFLOP/s of bf16 tensor-core work.  One tile alone does 2*128*BN*k
// FLOPs over the (128 + BN) * k * 2 bytes of its A and B panels, 64
// FLOP/byte at BN 128, so a kernel reaches that bound only where the 50 MB
// L2 serves most panel reads, i.e. where the blocks on the card at once
// share panels.  In the plain order one wave of 132 blocks (one a SM) at m
// 16384 is a strip of 128 m tiles by about one n tile: it reads all of A
// (134 MB at k 4096) from HBM once a column of n tiles, which caps the
// kernel near 128 FLOP/byte.  A wave in grouped order is a patch of group
// x 132 / group tiles, whose blocks read about group + 132 / group panels
// from HBM instead of about 133: at yi-6b's prefill GEMMs (m 16384) that
// takes the kernel from about 340 to about 600 TFLOP/s on an H100
// (tools/gemm_bf16_times.py).  Not in this tile yet: persistent blocks,
// clusters with TMA multicast, a TMA-store epilogue overlapped with the
// next tile, wider (BN 256) tiles.
//
// TMA needs 16-byte-aligned base addresses and strides: kernels/gemm.py's
// gemm_route sends only such operands here.  A wait on an mbarrier that
// never completes traps after a bounded spin instead of hanging the card.
// The barrier, TMA, descriptor and `wgmma` helpers below also serve flash
// attention's tensor-core kernel (attn_wgmma.cuh); the ring, producer,
// consumer and epilogue pieces serve the ragged grouped kernel
// (gemm_grouped.cuh).

#pragma once

#include <cuda.h>           // CUtensorMap and the encoder's types (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                      // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_STAGE = BM * BK * 2;              // bytes of one A tile
template <int BN> __host__ __device__ constexpr int b_stage() { return BN * BK * 2; }
template <int BN> constexpr int smem_bytes() {
  // tiles, the full and empty barriers, and slack to align to 1024 bytes
  return STAGES * (A_STAGE + b_stage<BN>()) + 2 * STAGES * 8 + 1024;
}

struct Args {
  int M, N, K;
  int a_z, b_z;              // 1: the operand's batch coordinate is z; 0: broadcast
  long long sc_b, sc_m;      // C strides (elements): batch, row
  int group;                 // m tiles a group of the tile order, 1..m tiles
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  Any
// legitimate wait here lasts microseconds; a wait that outlives 2^24
// polls is a fault (a wrong parity or a lost TMA transaction), and trapping
// turns it into a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D map: flash attention's (head dim, sequence, head,
// batch) tiles (attn_wgmma.cuh).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
// K-major: SBO is the 1024 bytes between groups of 8 rows (LBO unused).
// MN-major: LBO is the step between 64-wide MN blocks, SBO the step
// between groups of 8 k-rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D(64 x N, fp32, in registers) += A(64 x 16) @ B(16 x N), both from shared
// memory.  TB is the transpose bit of B: 0 K-major, 1 MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128) wgmma_n128<TB>(d, da, db);
  else wgmma_n64<TB>(d, da, db);
}

// D(64 x N, fp32, in registers) += A(64 x 16) @ B(16 x N) with A in
// registers: four 32-bit registers of bf16 pairs per thread.  Thread
// (warp, lane) holds, of the 64 x 16 tile, a0 = row warp*16 + lane/4 at
// columns 2(lane%4) and +1, a1 = the same columns of row +8, a2 and a3 =
// a0 and a1 eight columns on.  That is the accumulator fragment's layout
// (see the epilogue below), so a product's fp32 accumulator, rounded
// pairwise to bf16, is the next product's A operand without a trip
// through shared memory.  B from shared memory, TB its transpose bit.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a0, a1, a2, a3, db);
  else wgmma_rs_n64<TB>(d, a0, a1, a2, a3, db);
}

// Pin registers that an asynchronous `wgmma` reads or writes: the empty
// asm "redefines" each one, so the compiler neither reads an accumulator
// before the wait that completes it nor reuses an operand's register while
// the product is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---- the block's pieces: ring, producer, consumers, epilogue ---------------
// A block tile's work once its tile is known: the ragged grouped kernel
// (gemm_grouped.cuh) runs the same pieces on the tiles of its table.

// The ring in dynamic shared memory: STAGES A and B tiles, each 1024-byte
// aligned, then each stage's full and empty mbarrier.
template <int BN>
struct Ring {
  uint8_t* sa;
  uint8_t* sb;
  uint64_t* full;
  uint64_t* empty;
};

template <int BN>
__device__ __forceinline__ Ring<BN> ring_of(uint8_t* smem_raw) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring<BN> r;
  r.sa = smem;                                     // STAGES x A tile
  r.sb = smem + STAGES * A_STAGE;                  // STAGES x B tile
  r.full = reinterpret_cast<uint64_t*>(r.sb + STAGES * b_stage<BN>());
  r.empty = r.full + STAGES;
  return r;
}

// Thread 0 sets up the ring's barriers; the caller synchronises the block.
template <int BN>
__device__ __forceinline__ void ring_init(const Ring<BN>& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);                    // the producer's expect_tx
      mbar_init(&r.empty[s], CONSUMERS * 4);       // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Producer (one thread): keeps the ring full with the A tile at rows m0 of
// batch entry za and the B tile at columns n0 of batch entry zb, k-tile by
// k-tile.
template <int BN, int TB>
__device__ __forceinline__ void produce(const Ring<BN>& r, const CUtensorMap* map_a,
                                        const CUtensorMap* map_b, int ktiles,
                                        int m0, int n0, int za, int zb) {
  constexpr int B_STAGE = b_stage<BN>();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t round = kt / STAGES;
    mbar_wait(&r.empty[s], (round & 1) ^ 1);       // round 0 passes at once
    mbar_expect_tx(&r.full[s], A_STAGE + B_STAGE);
    const int k0 = kt * BK;
    tma_load_3d(r.sa + s * A_STAGE, map_a, &r.full[s], k0, m0, za);
    if constexpr (TB == 0) {
      tma_load_3d(r.sb + s * B_STAGE, map_b, &r.full[s], k0, n0, zb);
    } else {
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        tma_load_3d(r.sb + s * B_STAGE + h * 64 * BK * 2, map_b, &r.full[s],
                    n0 + 64 * h, k0, zb);
    }
  }
}

// Consumer warpgroup c (rows c*64 .. c*64+63 of the block tile): the k loop
// of `wgmma`s out of the ring into acc.
template <int BN, int TB>
__device__ __forceinline__ void consume(const Ring<BN>& r, float (&acc)[BN / 2],
                                        int ktiles, int c, int lane) {
  constexpr int B_STAGE = b_stage<BN>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t round = kt / STAGES;
    mbar_wait(&r.full[s], round & 1);
    const uint8_t* a_tile = r.sa + s * A_STAGE + c * 64 * BK * 2;
    const uint8_t* b_tile = r.sb + s * B_STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major operands step 16 k = 32 bytes along the swizzled row; an
      // MN-major B steps 16 k-rows of 128 bytes.
      const uint64_t da = smem_desc(a_tile + kk * 32, 16, 1024);
      const uint64_t db = TB == 0
          ? smem_desc(b_tile + kk * 32, 16, 1024)
          : smem_desc(b_tile + kk * 16 * 128, 64 * BK * 2, 1024);
      wgmma_tile<BN, TB>(acc, da, db);
    }
    wgmma_commit();
    // Keep this stage's group in flight; once the previous one is done its
    // stage goes back to the producer.
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&r.empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
}

// Epilogue of consumer warpgroup c: its 64 x BN fragment of the tile at
// (m0, n0) into C (row stride sc_m), rows below row_end and columns below
// N only.  Fragment of m64nBN: thread (warp, lane) holds rows warp*16 +
// lane/4 and +8, columns 8j + 2(lane%4) and +1, as acc[4j + {0,1,2,3}].
// A pair is stored as one aligned 4- or 8-byte word when `even` (the row
// and batch strides are even; then col, even, keeps it aligned).
template <int BN, typename TO>
__device__ __forceinline__ void store_tile(TO* C, const float (&acc)[BN / 2],
                                           int m0, int n0, int row_end, int N,
                                           long long sc_m, bool even, int c,
                                           int warp, int lane) {
  const int r0 = m0 + c * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
    const bool two = col + 1 < N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= row_end) continue;
      TO* p = C + row * sc_m + col;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (two && even) {
        store2(p, x, y);
      } else {
        store1(p, x);
        if (two) store1(p + 1, y);
      }
    }
  }
}

// BN: block tile width (64 or 128).  TB: B's layout (0 K-major, 1 MN-major).
template <int BN, int TB, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_b, TO* __restrict__ C,
           Args g) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring<BN> ring = ring_of<BN>(smem_raw);

  // The block's tile in grouped order: the card starts a launch's blocks in
  // the order of id (x fastest, in practice), and a group of g.group m
  // tiles takes g.group * gridDim.y consecutive ids.
  const int id = blockIdx.y * gridDim.x + blockIdx.x;
  const int span = g.group * gridDim.y;
  const int first = id / span * g.group;
  const int rows = min(static_cast<int>(gridDim.x) - first, g.group);
  const int r = id - id / span * span;
  const int m0 = (first + r % rows) * BM, n0 = r / rows * BN, z = blockIdx.z;
  const int ktiles = (g.K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  ring_init(ring);
  __syncthreads();

  if (wg == 0) {
    // Producer: a single thread keeps the ring full.
    if (threadIdx.x == 0)
      produce<BN, TB>(ring, &map_a, &map_b, ktiles, m0, n0, z * g.a_z,
                      z * g.b_z);
    return;
  }

  // Consumers: warpgroup c owns rows c*64 .. c*64+63 of the block tile.
  const int c = wg - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float acc[BN / 2];
  consume<BN, TB>(ring, acc, ktiles, c, lane);

  C += static_cast<long long>(z) * g.sc_b;
  const bool even = (g.sc_m % 2 == 0) && (g.sc_b % 2 == 0);
  store_tile<BN, TO>(C, acc, m0, n0, g.M, g.N, g.sc_m, even, c, warp, lane);
}

// ---- host side: tensor maps and the launch ---------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled out of libcuda, looked up through the runtime so
// that the library needs no -lcuda.  The encoder fails on a thread with no
// current context, and a thread whose first CUDA call is this one has none
// (autograd's device thread runs a backward's GEMMs; its torch calls do not
// bind the context of this library's own runtime): each thread binds the
// device's primary context once first, as the runtime's first call on a
// thread does (cudaFree(nullptr) frees nothing).
inline EncodeTiledFn encode_tiled() {
  thread_local bool bound = false;
  if (!bound) {
    bound = cudaFree(nullptr) == cudaSuccess;
  }
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D bf16 map (inner, rows, batch) with unit stride along inner, a box of
// (box_inner, box_rows, 1) and 128-byte swizzle; out-of-bounds reads are 0.
inline bool encode_3d(CUtensorMap* map, const void* base, long long inner,
                      long long rows, long long batch, long long row_stride,
                      long long batch_stride, int box_inner, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  if (batch_stride == 0) {                        // broadcast or a single GEMM
    batch = 1;
    batch_stride = rows * row_stride;
  }
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                           static_cast<cuuint64_t>(batch_stride) * 2};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                       static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D bf16 map with unit stride along dims[0] and the element strides
// of the other three (any order: a transposed view keeps its own), a box of
// (box0, box1, 1, 1) and 128-byte swizzle; out-of-bounds reads are 0.
inline bool encode_4d(CUtensorMap* map, const void* base,
                      const long long (&dims)[4], const long long (&strides)[3],
                      int box0, int box1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdims[4], gstrides[3];
  for (int i = 0; i < 4; ++i) gdims[i] = static_cast<cuuint64_t>(dims[i]);
  for (int i = 0; i < 3; ++i) gstrides[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box0),
                       static_cast<cuuint32_t>(box1), 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            gdims, gstrides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int TB, typename TO>
cudaError_t launch_tile(const CUtensorMap& ma, const CUtensorMap& mb, TO* C,
                        const Args& g, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  auto kernel = gemm_wgmma<BN, TB, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN, batch);
  kernel<<<grid, THREADS, smem, stream>>>(ma, mb, C, g);
  return cudaGetLastError();
}

// C[z] = A[z] @ B[z] on the tensor cores.  A row-major (sa_k == 1); B
// MN-major (sb_n == 1) or K-major (sb_k == 1).  Strides in elements; a batch
// stride of 0 broadcasts the operand.  group: m tiles a group of the tile
// order (kernels/gemm.py::wgmma_plan; at least the m tiles: the plain
// order).  Returns cudaErrorInvalidValue when a tensor map cannot be encoded
// (misaligned base or stride) or group is below 1.
template <typename TO>
cudaError_t launch(const __nv_bfloat16* A, const __nv_bfloat16* B, TO* C,
                   int M, int N, int K, int batch, long long sa_b,
                   long long sa_m, long long sb_b, long long sb_k,
                   long long sb_n, long long sc_b, long long sc_m, int group,
                   cudaStream_t stream) {
  if (group < 1) return cudaErrorInvalidValue;
  const bool narrow = N <= 64;
  const int bn = narrow ? 64 : 128;
  const bool mn_major = sb_n == 1;
  CUtensorMap ma, mb;
  if (!encode_3d(&ma, A, K, M, batch, sa_m, batch > 1 ? sa_b : 0, BK, BM))
    return cudaErrorInvalidValue;
  const long long b_batch_stride = batch > 1 ? sb_b : 0;
  const bool ok = mn_major
      ? encode_3d(&mb, B, N, K, batch, sb_k, b_batch_stride, 64, BK)
      : encode_3d(&mb, B, K, N, batch, sb_n, b_batch_stride, BK, bn);
  if (!ok) return cudaErrorInvalidValue;
  const int m_tiles = (M + BM - 1) / BM;
  Args g{M, N, K, batch > 1 && sa_b != 0, batch > 1 && b_batch_stride != 0,
         sc_b, sc_m, group < m_tiles ? group : m_tiles};
  if (mn_major)
    return narrow ? launch_tile<64, 1, TO>(ma, mb, C, g, batch, stream)
                  : launch_tile<128, 1, TO>(ma, mb, C, g, batch, stream);
  return narrow ? launch_tile<64, 0, TO>(ma, mb, C, g, batch, stream)
                : launch_tile<128, 0, TO>(ma, mb, C, g, batch, stream);
}

}  // namespace wg
