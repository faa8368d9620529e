// Flash decode for Hopper (sm_90a): one query token per (batch, q head)
// against a KV cache, with per-batch valid-slot bounds [lo[b], hi[b]).
//
// Replaces the reference's Pallas TPU kernel `_decode_kernel` / `flash_decode`
// (src/repro/kernels/flash_decode.py:32, pallas_call at l.102).  There one
// grid step per (b, q head, kv block) carried the fp32 online-softmax state
// (m, l, acc) in VMEM across the sequential kv grid axis.
//
// What bounds it on an H100: one pass over the valid K and V slots at 4
// FLOPs per cache element per q head (q.k and p.v; 32 per element for a
// GQA group of 8), far below the card's ~295 FLOP/byte ridge, so the bound
// is the bytes of the valid K and V slots over 3.35 TB/s.  Reaching it
// takes many bytes in flight on every SM; the design:
//
//   * Split the cache across a thread-block cluster.  The grid is (split,
//     kv head x head group, batch); the splits of one (b, kv head, head
//     group) form a cluster of at most 8 blocks along x.  A block serves
//     the (at most 8) q heads of its head group, so K and V are read once
//     per kv head, not once per q head.  The launch plan (splits, slots
//     per split, slots per warp step) is computed in
//     kernels/flash_decode.py::decode_plan from (B, Hq, Hkv, S, D, dtype),
//     the route and the card's cluster capacity -- never from lo / hi,
//     which live on the device and differ per row.
//   * Inside a split every warp runs its own online softmax over its own
//     steps of `step` slots (steps j0 + w, j0 + w + 4, ... of the split's
//     slots that meet [lo, hi)), with (m, l, acc) in registers.  A split
//     whose range holds no valid slot of its row reads nothing and
//     contributes l = 0; it still arrives at every cluster barrier.
//   * A step's K and V rows reach shared memory through the tensor memory
//     accelerator, into a per-warp ring of STAGES steps, each stage with
//     its mbarrier, so STAGES - 1 steps are in flight while one is scored
//     and no thread spends an instruction a 16 bytes on a copy.  The mma
//     kernel with D a multiple of 64 (yi-6b) asks for a step as D / 64
//     boxes of K and of V (16 slots x 64 elements, 2 KB each, 128-byte
//     swizzled so ldmatrix reads are free of bank conflicts) through
//     tensor maps built at each launch: four requests a step at D 128;
//     slots of such a step outside [lo, hi) are read, as the reference's
//     blocks read them, and masked.  Elsewhere every valid row is one bulk
//     copy (cp.async.bulk) issued by its own lane into rows padded to an
//     odd number of 16-byte chunks (again free of bank conflicts), and a
//     slot outside [lo, hi) is not read but zeroed.  Rows that are not
//     whole 16-byte chunks (a head dim such as bf16 D 12), or a misaligned
//     cache, are copied element by element (`vec16` = 0).  Why TMA: with
//     one 16-byte cp.async a lane, issuing a step's copies cost a warp as
//     long as scoring the step (the SM runs out of outstanding requests).
//   * Clusters are sized to the card: at yi-6b's shape two blocks share an
//     SM, but the card holds only 30 clusters of 8 at once, so 32 would
//     run a second wave of two; the plan takes the most splits whose
//     clusters all fit at once (7 at B 8, 8 at B 1), from the card's
//     cudaOccupancyMaxActiveClusters (repro_flash_decode_clusters).
//   * The combination is deterministic: the warps' states are merged in
//     warp order into the block's state in shared memory; after a cluster
//     barrier each block of the cluster merges a slice of the (head, d)
//     outputs over the splits' states, read through distributed shared
//     memory in split order, and writes it.  No global workspace, no
//     atomics; two launches on the same inputs agree bit for bit.  With
//     one split the block writes the output directly.
//
// Two kernels; the caller names which one runs (`route`, chosen in
// kernels/flash_decode.py::flash_decode_route by dtype, head dim and
// alignment), and nothing here falls back from one to the other:
//
//   flash_decode_mma  -- bf16 with D a multiple of 16 (yi-6b: D 128, a GQA
//     group of 8).  The group is scored on the tensor cores: per 16 slots,
//     S^T = K (16 slots x D) . Q^T (D x 8 heads) with mma.sync m16n8k16
//     (8 heads fit N = 8 exactly; a smaller group is padded with zero
//     heads), K through ldmatrix.  The softmax runs on the score fragments
//     (3-step shuffle max per head), P is rounded to bf16 and turned into
//     the B operand by movmatrix.trans, and out^T += V^T (D x 16 slots) .
//     P^T (16 slots x 8 heads) reads V with ldmatrix.trans.  Accumulators
//     are fp32.
//   flash_decode_simt -- f32 (true fp32 FMAs, no TF32: the f32 bar is
//     2e-5), and bf16 head dims that are not a multiple of 16 or operands
//     that are not 16-byte aligned.  The same split design on the CUDA
//     cores: 32 / step lanes share a slot's score (each a share of D, then
//     a shuffle sum), the softmax is across the warp per head, and for
//     P.V each lane owns head-dim elements lane, lane + 32, ...
//
// Masking follows the reference exactly: a slot outside [lo, hi) gets the
// score -1e30 by select and probability 0, and a row with l == 0 (nothing
// valid) outputs exactly 0.  Scores are kept in base 2 (scale * log2 e), so
// exp becomes exp2; the softmax and every sum stay fp32.
//
// Plain C interface for ctypes (see ../_build.py); returns the first CUDA
// error of the launch (cudaGetLastError() after it).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"   // tensor maps, mbarriers, TMA loads

namespace {

namespace cg = cooperative_groups;
using wg::mbar_expect_tx;
using wg::mbar_wait;

constexpr int THREADS = 128;       // four warps
constexpr int WARPS = THREADS / 32;
constexpr int HEADS = 8;           // q heads a block serves (one head group)
constexpr int STAGES = 3;          // steps in a warp's ring
constexpr int MAX_SPLITS = 8;      // blocks of a (portable) cluster
constexpr int MAX_D = 256;
constexpr int MMA_STEP = 16;       // slots per warp step on the mma route
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

enum Route { kSimt = 0, kMma = 1 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lo;
  const int* hi;
  void* out;
  int Hq, Hkv, S, D;
  int group, hgroups;   // q heads per kv head; head groups of HEADS
  float scale2;         // softmax scale * log2(e)
  int splits, per;      // cluster size; slots per split
  int step;             // slots per warp step
  int vec16;            // cache rows copied in 16-byte chunks
};

// Geometry shared by the host (shared-memory size) and the device.
__host__ __device__ inline int chunks(int D, int isz) { return (D * isz + 15) / 16; }
// Row stride in bytes: the row's 16-byte chunks plus one or two, so the
// stride is an odd number of chunks.
__host__ __device__ inline int row_bytes(int D, int isz) {
  const int nc = chunks(D, isz);
  return (nc + 1 + (nc & 1)) * 16;
}
__host__ __device__ inline size_t ring_bytes(int D, int isz, int step) {
  return (size_t)WARPS * STAGES * 2 * step * row_bytes(D, isz);
}
// Warp states [WARPS][HEADS][D + 2] and the block state [HEADS][D + 2]
// (acc, then m and l) and the merge's factors [HEADS][WARPS], as fp32;
// they reuse the ring once it is drained.
__host__ __device__ inline size_t combine_bytes(int D) {
  return (size_t)(WARPS + 1) * HEADS * (D + 2) * 4 + HEADS * WARPS * 4;
}
// The CUDA-core kernel also keeps q as fp32 rows of whole chunks and a
// per-warp [step][HEADS] tile of probabilities.
__host__ __device__ inline size_t simt_extra_bytes(int D, int isz, int step) {
  return (size_t)HEADS * chunks(D, isz) * (16 / isz) * 4 + (size_t)WARPS * step * HEADS * 4;
}
// Layout: the rings (or the merge's states) | the CUDA-core kernel's q and
// probabilities | an mbarrier per ring stage.
__host__ __device__ inline size_t bars_offset(int route, int D, int isz, int step) {
  const size_t ring = ring_bytes(D, isz, step), comb = combine_bytes(D);
  return (ring > comb ? ring : comb) + (route == kSimt ? simt_extra_bytes(D, isz, step) : 0);
}
size_t smem_bytes(int route, int D, int isz, int step) {
  return bars_offset(route, D, isz, step) + (size_t)WARPS * STAGES * 8;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` contiguous bytes from global memory into shared memory by the
// tensor memory accelerator, completing on `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// One warp step: the K and V rows of slots [slot0, slot0 + step) into a
// ring stage (K rows, then V rows, each `rs` bytes apart), completing on
// the stage's mbarrier.  With 16-byte rows every valid row is one bulk
// copy, issued by its own lane (K rows by lanes [0, step), V rows by
// [step, 2 step)), so a step is in flight after one instruction a lane.
// A slot outside [lo, hi) is not read: its rows are zeroed by plain
// stores.  Without 16-byte rows the lanes copy element by element (zeros
// past D and for invalid slots) and the mbarrier expects no bytes.
template <typename T>
__device__ __forceinline__ void load_step(unsigned char* stage, uint64_t* bar, const T* kb,
                                          const T* vb, int slot0, int lo, int hi,
                                          const Args& g, int lane) {
  const int D = g.D, step = g.step, rs = row_bytes(D, sizeof(T));
  unsigned char* vs = stage + step * rs;
  if (g.vec16) {
    const uint32_t row = D * sizeof(T);
    if (lane == 0) {
      const int nvalid = max(0, min(hi, slot0 + step) - max(lo, slot0));
      mbar_expect_tx(bar, 2u * row * nvalid);
    }
    __syncwarp();
    if (lane < 2 * step) {
      const bool is_v = lane >= step;
      const int t = is_v ? lane - step : lane, slot = slot0 + t;
      unsigned char* dst = (is_v ? vs : stage) + t * rs;
      if (slot >= lo && slot < hi) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bulk_copy(smem_addr(dst), (is_v ? vb : kb) + (long long)slot * D, row, bar);
      } else {
        for (uint32_t c = 0; c < row; c += 16)
          *reinterpret_cast<uint4*>(dst + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const int rw = chunks(D, sizeof(T)) * 16 / (int)sizeof(T);   // padded row
    for (int c = lane; c < step * rw; c += 32) {
      const int t = c / rw, col = c - t * rw, slot = slot0 + t;
      const bool ok = slot >= lo && slot < hi && col < D;
      const long long off = (long long)slot * D + col;
      T kx = from_f32<T>(0.f), vx = from_f32<T>(0.f);
      if (ok) {
        kx = kb[off];
        vx = vb[off];
      }
      reinterpret_cast<T*>(stage + t * rs)[col] = kx;
      reinterpret_cast<T*>(vs + t * rs)[col] = vx;
    }
    if (lane == 0) mbar_expect_tx(bar, 0u);
  }
}

// The tensor-map load of the mma kernel (D a multiple of 64): a step's K
// and V rows as D / 64 boxes each of 16 slots x 64 head-dim elements (2 KB,
// 128-byte swizzled: chunk c of row r lands at chunk c ^ (r % 8)), all
// issued by lane 0 with one expect_tx on the stage's mbarrier.  Rows past S
// are zero-filled by TMA; slots outside [lo, hi) inside a step that meets
// the range are read, as the reference's blocks read them, and masked.
constexpr int TILE_BOX = 64;                    // head-dim elements a box
constexpr int TILE_BYTES = MMA_STEP * TILE_BOX * 2;

__device__ __forceinline__ void load_step_tiled(unsigned char* stage, uint64_t* bar,
                                                const CUtensorMap* map_k,
                                                const CUtensorMap* map_v, int slot0,
                                                int kv_row, int D, int lane) {
  if (lane == 0) {
    const int boxes = D / TILE_BOX;
    mbar_expect_tx(bar, 2u * boxes * TILE_BYTES);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int x = 0; x < boxes; ++x) {
      wg::tma_load_3d(stage + x * TILE_BYTES, map_k, bar, x * TILE_BOX, slot0, kv_row);
      wg::tma_load_3d(stage + (boxes + x) * TILE_BYTES, map_v, bar, x * TILE_BOX, slot0,
                      kv_row);
    }
  }
}

// Which block of the grid this is, and the warp's share of its split.
struct Work {
  int b, h0, nh, lo, hi;
  int split;
  int first;     // first slot of this warp's first step
  int n;         // steps of this warp
};

__device__ __forceinline__ Work work_of(const Args& g) {
  Work wk;
  const int hk = blockIdx.y / g.hgroups, hg = blockIdx.y - hk * g.hgroups;
  wk.b = blockIdx.z;
  wk.split = blockIdx.x;
  wk.h0 = hk * g.group + hg * HEADS;
  wk.nh = min(HEADS, g.group - hg * HEADS);
  wk.lo = max(g.lo[wk.b], 0);
  wk.hi = min(g.hi[wk.b], g.S);
  const int s0 = wk.split * g.per, s1 = min(g.S, s0 + g.per);
  const int a = max(s0, wk.lo), e = min(s1, wk.hi);
  const int w = threadIdx.x >> 5;
  wk.n = 0;
  wk.first = s0;
  if (a < e) {
    const int j0 = (a - s0) / g.step, nsteps = (e - s0 + g.step - 1) / g.step - j0;
    wk.n = nsteps > w ? (nsteps - w + WARPS - 1) / WARPS : 0;
    wk.first = s0 + (j0 + w) * g.step;
  }
  return wk;
}

// Merge the warps' states (ws: [WARPS][HEADS][D + 2], acc then m, l) in
// warp order, then, with several splits, the splits' block states in split
// order through distributed shared memory; write out[b, h0 + h, :].
template <typename T>
__device__ __forceinline__ void combine_and_store(float* ws, const Work& wk, const Args& g) {
  const int D = g.D, D2 = D + 2, total = wk.nh * D;
  float* bs = ws + WARPS * HEADS * D2;          // the block state
  float* fs = bs + HEADS * D2;                  // [HEADS][WARPS] factors
  T* out = static_cast<T*>(g.out) + ((long long)wk.b * g.Hq + wk.h0) * D;
  if (threadIdx.x < wk.nh) {                    // per head: M, L, factors
    const int h = threadIdx.x;
    float M = NEG, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ws[(w * HEADS + h) * D2 + D]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(ws[(w * HEADS + h) * D2 + D] - M);
      fs[h * WARPS + w] = f;
      L += ws[(w * HEADS + h) * D2 + D + 1] * f;
    }
    bs[h * D2 + D] = M;
    bs[h * D2 + D + 1] = L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int h = e / D, d = e - h * D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) A += ws[(w * HEADS + h) * D2 + d] * fs[h * WARPS + w];
    if (g.splits == 1) {
      const float L = bs[h * D2 + D + 1];
      out[e] = from_f32<T>(L == 0.f ? 0.f : A / L);
    } else {
      bs[h * D2 + d] = A;
    }
  }
  if (g.splits == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = g.splits, r = static_cast<int>(cluster.block_rank());
  const int per = (total + splits - 1) / splits, end = min(total, (r + 1) * per);
  for (int e = r * per + threadIdx.x; e < end; e += THREADS) {
    const int h = e / D, d = e - h * D;
    const float* rb[MAX_SPLITS];
    float ms[MAX_SPLITS];
    float M = NEG;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < splits) {
        rb[s] = cluster.map_shared_rank(bs, s) + h * D2;
        ms[s] = rb[s][D];
        M = fmaxf(M, ms[s]);
      }
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < splits) {
        const float f = exp2f(ms[s] - M);
        L += rb[s][D + 1] * f;
        A += rb[s][d] * f;
      }
    }
    out[e] = from_f32<T>(L == 0.f ? 0.f : A / L);
  }
  cluster.sync();                               // keep every state alive
}

// The warp's ring barriers: one mbarrier per stage, initialised by lane 0
// and made visible to the tensor memory accelerator.
__device__ __forceinline__ uint64_t* init_bars(unsigned char* smem, size_t offset, int w,
                                               int lane) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + offset) + w * STAGES;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) wg::mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  return bars;
}

// ---- the tensor-core kernel (bf16, D % 16 == 0) --------------------------

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The 8x8 bf16 matrix held as one fragment register a warp, transposed.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments (g = lane / 4, c = lane % 4): a thread's scores are S^T rows
// (slots) g and g + 8, columns (heads) 2c and 2c + 1; its accumulators are
// out^T rows (head-dim elements) 16 mt + g and + 8, the same two heads.
// So m, l and the rescale factors of heads 2c, 2c + 1 live in the thread
// that needs them, and only the max needs shuffles (over lanes of one c).
// TILE: the cache comes by tensor map (D a multiple of 64), else by a
// bulk copy a row into padded rows.
template <int DMAX, bool TILE>
__global__ void __launch_bounds__(THREADS)
flash_decode_mma(const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, Args g) {
  constexpr int KD = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int D = g.D, kd = D / 16, rs = row_bytes(D, 2);
  const Work wk = work_of(g);
  const long long kv_base = ((long long)wk.b * g.Hkv + wk.h0 / g.group) * g.S * D;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(g.k) + kv_base;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(g.v) + kv_base;
  // Tiled stages are whole 2 KB boxes from a 1024-byte boundary (the
  // swizzle's period); they fit in the padded rows' room.
  const int stage_bytes = TILE ? 2 * D * MMA_STEP * 2 : 2 * MMA_STEP * rs;
  unsigned char* base = TILE ? smem + ((1024 - (smem_addr(smem) & 1023)) & 1023) : smem;
  unsigned char* ring = base + (size_t)w * STAGES * stage_bytes;
  uint64_t* bars = init_bars(smem, bars_offset(kMma, D, 2, MMA_STEP), w, lane);
  const int kv_row = wk.b * g.Hkv + wk.h0 / g.group;   // the tensor maps' 3rd axis

  // Q^T as B fragments, one pair of registers per 16 of D; padded heads 0.
  uint32_t qf[KD][2];
  {
    const int h = lane >> 2;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        static_cast<const __nv_bfloat16*>(g.q) + ((long long)wk.b * g.Hq + wk.h0 + h) * D);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const bool ok = kk < kd && h < wk.nh && wk.n > 0;
      const int d2 = (kk * 16 + 2 * (lane & 3)) / 2;
      qf[kk][0] = ok ? qrow[d2] : 0u;
      qf[kk][1] = ok ? qrow[d2 + 4] : 0u;
    }
  }
  float acc[KD][4];
#pragma unroll
  for (int mt = 0; mt < KD; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  auto issue = [&](int i) {
    unsigned char* st = ring + (i % STAGES) * stage_bytes;
    const int slot0 = wk.first + i * WARPS * MMA_STEP;
    if constexpr (TILE)
      load_step_tiled(st, &bars[i % STAGES], &map_k, &map_v, slot0, kv_row, D, lane);
    else
      load_step(st, &bars[i % STAGES], kb, vb, slot0, wk.lo, wk.hi, g, lane);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < wk.n) issue(i);
  // ldmatrix row addresses: K as A (slots x d; matrix j = lane / 8 holds
  // slot half j & 1, d half j >> 1), V as A^T (d half j & 1, slot half j >> 1).
  // Padded rows: row r at r * rs; tiled: box x at 2 KB x, row r at 128 r,
  // 16-byte chunk c at (c ^ (r % 8)) * 16.
  const int jm = lane >> 3;
  const int k_row = (lane & 7) + (jm & 1) * 8, k_ch = jm >> 1;
  const int v_row = (lane & 7) + (jm >> 1) * 8, v_ch = jm & 1;
  auto addr = [&](int row, int ch) {           // ch: 16-byte chunk along D
    if constexpr (TILE)
      return (ch >> 3) * TILE_BYTES + row * 128 + (((ch & 7) ^ (row & 7)) << 4);
    else
      return row * rs + ch * 16;
  };
  for (int i = 0; i < wk.n; ++i) {
    mbar_wait(&bars[i % STAGES], (i / STAGES) & 1);
    __syncwarp();                               // the stage refilled next is free
    if (i + STAGES - 1 < wk.n) issue(i + STAGES - 1);
    const unsigned kst = smem_addr(ring + (i % STAGES) * stage_bytes);
    const unsigned vst = kst + (TILE ? D * MMA_STEP * 2 : MMA_STEP * rs);
    const int slot0 = wk.first + i * WARPS * MMA_STEP;

    // Scores S^T = K . Q^T, two accumulator chains.
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk < kd) {
        uint32_t a[4];
        ldsm_x4(kst + addr(k_row, 2 * kk + k_ch), a);
        mma_bf16((kk & 1) ? sb : sa, a, qf[kk][0], qf[kk][1]);
      }
    }
    const int sl = slot0 + (lane >> 2);
    const bool va = sl >= wk.lo && sl < wk.hi, vb8 = sl + 8 >= wk.lo && sl + 8 < wk.hi;
    const float x00 = va ? (sa[0] + sb[0]) * g.scale2 : NEG;
    const float x01 = va ? (sa[1] + sb[1]) * g.scale2 : NEG;
    const float x10 = vb8 ? (sa[2] + sb[2]) * g.scale2 : NEG;
    const float x11 = vb8 ? (sa[3] + sb[3]) * g.scale2 : NEG;
    float mx0 = fmaxf(x00, x10), mx1 = fmaxf(x01, x11);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    const float p00 = va ? exp2f(x00 - mn0) : 0.f, p01 = va ? exp2f(x01 - mn1) : 0.f;
    const float p10 = vb8 ? exp2f(x10 - mn0) : 0.f, p11 = vb8 ? exp2f(x11 - mn1) : 0.f;
    l0 = l0 * c0 + p00 + p10;
    l1 = l1 * c1 + p01 + p11;
    m0 = mn0;
    m1 = mn1;
    // P^T (slots x heads) as the B operand: the score fragment transposed.
    const uint32_t b0 = movmatrix_t(pack_bf16(p00, p01));
    const uint32_t b1 = movmatrix_t(pack_bf16(p10, p11));
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      if (mt < kd) {
        acc[mt][0] *= c0;
        acc[mt][1] *= c1;
        acc[mt][2] *= c0;
        acc[mt][3] *= c1;
        uint32_t a[4];
        ldsm_x4_t(vst + addr(v_row, 2 * mt + v_ch), a);
        mma_bf16(acc[mt], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();                              // every warp is off the ring
  float* ws = reinterpret_cast<float*>(smem);
  const int D2 = D + 2, hc = 2 * (lane & 3);
  float* r0 = ws + (w * HEADS + hc) * D2;
  float* r1 = r0 + D2;
  if (lane < 4) {
    r0[D] = m0;
    r0[D + 1] = l0;
    r1[D] = m1;
    r1[D + 1] = l1;
  }
#pragma unroll
  for (int mt = 0; mt < KD; ++mt) {
    if (mt < kd) {
      const int d = mt * 16 + (lane >> 2);
      r0[d] = acc[mt][0];
      r1[d] = acc[mt][1];
      r0[d + 8] = acc[mt][2];
      r1[d + 8] = acc[mt][3];
    }
  }
  __syncthreads();
  combine_and_store<__nv_bfloat16>(ws, wk, g);
}

// ---- the CUDA-core kernel (f32; bf16 that the mma route does not take) ----

template <typename T>
__device__ __forceinline__ void chunk_f32(const unsigned char* p, float* x) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_decode_simt(Args g) {
  constexpr int NJ = DMAX / 32;                 // head-dim elements a lane owns
  constexpr int EPC = 16 / sizeof(T);           // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int D = g.D, step = g.step, nc = chunks(D, sizeof(T)), rs = row_bytes(D, sizeof(T));
  const int rw = nc * EPC;
  const Work wk = work_of(g);
  const long long kv_base = ((long long)wk.b * g.Hkv + wk.h0 / g.group) * g.S * D;
  const T* kb = static_cast<const T*>(g.k) + kv_base;
  const T* vb = static_cast<const T*>(g.v) + kv_base;
  const size_t ring_total = ring_bytes(D, sizeof(T), step);
  const size_t comb = combine_bytes(D);
  float* qs = reinterpret_cast<float*>(smem + (ring_total > comb ? ring_total : comb));
  float* pw = qs + HEADS * rw + w * step * HEADS;   // this warp's [step][HEADS]
  unsigned char* ring = smem + (size_t)w * STAGES * 2 * step * rs;
  const int stage_bytes = 2 * step * rs;
  uint64_t* bars = init_bars(smem, bars_offset(kSimt, D, sizeof(T), step), w, lane);

  const T* qg = static_cast<const T*>(g.q) + ((long long)wk.b * g.Hq + wk.h0) * D;
  for (int i = threadIdx.x; i < HEADS * rw; i += THREADS) {
    const int h = i / rw, col = i - h * rw;
    qs[i] = (h < wk.nh && col < D) ? to_f32(qg[h * D + col]) : 0.f;
  }
  __syncthreads();

  float acc[HEADS][NJ], m[HEADS], l[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    m[h] = NEG;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[h][j] = 0.f;
  }
  const int t = lane % step, part = lane / step, lps = 32 / step;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < wk.n)
      load_step(ring + i * stage_bytes, &bars[i], kb, vb, wk.first + i * WARPS * step, wk.lo,
                wk.hi, g, lane);
  for (int i = 0; i < wk.n; ++i) {
    mbar_wait(&bars[i % STAGES], (i / STAGES) & 1);
    __syncwarp();                               // the stage refilled next is free
    const int nxt = i + STAGES - 1;
    if (nxt < wk.n)
      load_step(ring + (nxt % STAGES) * stage_bytes, &bars[nxt % STAGES], kb, vb,
                wk.first + nxt * WARPS * step, wk.lo, wk.hi, g, lane);
    const unsigned char* ks = ring + (i % STAGES) * stage_bytes;
    const unsigned char* vs = ks + step * rs;
    const int slot = wk.first + i * WARPS * step + t;
    const bool ok = slot >= wk.lo && slot < wk.hi;

    // Scores of slot t: this lane's share of the chunks, then the sum
    // over the lps lanes of the slot.
    float s[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) s[h] = 0.f;
    for (int c = part; c < nc; c += lps) {
      float kx[EPC];
      chunk_f32<T>(ks + t * rs + c * 16, kx);
#pragma unroll
      for (int h = 0; h < HEADS; ++h) {
        const float* qh = qs + h * rw + c * EPC;
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qh + e);
          s[h] = fmaf(qv.x, kx[e], s[h]);
          s[h] = fmaf(qv.y, kx[e + 1], s[h]);
          s[h] = fmaf(qv.z, kx[e + 2], s[h]);
          s[h] = fmaf(qv.w, kx[e + 3], s[h]);
        }
      }
    }
    float corr[HEADS], p[HEADS];
#pragma unroll
    for (int h = 0; h < HEADS; ++h) {
      for (int off = step; off < 32; off <<= 1)
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
      const float x = ok ? s[h] * g.scale2 : NEG;
      float mx = x;
      for (int off = 1; off < step; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[h], mx);
      corr[h] = exp2f(m[h] - mn);
      p[h] = ok ? exp2f(x - mn) : 0.f;
      l[h] = l[h] * corr[h] + (part == 0 ? p[h] : 0.f);
      m[h] = mn;
    }
    if (part == 0) {
      float4* dst = reinterpret_cast<float4*>(pw + t * HEADS);
      dst[0] = make_float4(p[0], p[1], p[2], p[3]);
      dst[1] = make_float4(p[4], p[5], p[6], p[7]);
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < HEADS; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[h][j] *= corr[h];
    for (int u = 0; u < step; ++u) {
      const float4 pa = reinterpret_cast<const float4*>(pw + u * HEADS)[0];
      const float4 pb = reinterpret_cast<const float4*>(pw + u * HEADS)[1];
      const float pu[HEADS] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const T* vrow = reinterpret_cast<const T*>(vs + u * rs);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int e = lane + 32 * j;
        if (e < D) {
          const float vx = to_f32(vrow[e]);
#pragma unroll
          for (int h = 0; h < HEADS; ++h) acc[h][j] = fmaf(pu[h], vx, acc[h][j]);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < HEADS; ++h)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
  __syncthreads();                              // every warp is off the ring
  float* ws = reinterpret_cast<float*>(smem);
  const int D2 = D + 2;
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    float* r = ws + (w * HEADS + h) * D2;
    if (lane == 0) {
      r[D] = m[h];
      r[D + 1] = l[h];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j < D) r[lane + 32 * j] = acc[h][j];
  }
  __syncthreads();
  combine_and_store<T>(ws, wk, g);
}

using SimtKernel = void (*)(Args);
using MmaKernel = void (*)(CUtensorMap, CUtensorMap, Args);

template <int DMAX>
const void* kernel_of(int route, int dtype, bool tile) {
  if (route == kMma)
    return tile ? reinterpret_cast<const void*>(flash_decode_mma<DMAX, true>)
                : reinterpret_cast<const void*>(flash_decode_mma<DMAX, false>);
  if (dtype == 0) return reinterpret_cast<const void*>(flash_decode_simt<float, DMAX>);
  return reinterpret_cast<const void*>(flash_decode_simt<__nv_bfloat16, DMAX>);
}

// The kernel of (route, dtype, D): the mma kernel reads the cache by tensor
// map when D is a multiple of 64.
const void* kernel_for(int route, int dtype, int D) {
  const bool tile = route == kMma && D % TILE_BOX == 0;
  if (D <= 64) return kernel_of<64>(route, dtype, tile);
  if (D <= 128) return kernel_of<128>(route, dtype, tile);
  return kernel_of<256>(route, dtype, tile);
}

// The launch configuration; `smem` bytes of shared memory are opted into,
// with the whole of the SM's carve-out given to shared memory so that two
// blocks of yi-6b's shape share an SM.
cudaError_t configure(const void* kernel, size_t smem, dim3 grid, int splits,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;   // one split: none
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = splits > 1 ? 1 : 0;
  return e;
}

}  // namespace

// q: (B, Hq, D); k, v: (B, Hkv, S, D); lo, hi: (B,) int32; out: (B, Hq, D).
// All contiguous, one dtype (0 = float32, 1 = bfloat16).  route: 0 simt,
// 1 mma; splits, per, step: the plan of kernels/flash_decode.py::decode_plan;
// vec16: cache rows are whole 16-byte chunks and k, v are 16-byte aligned.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* lo, const void* hi, void* out,
                                  int B, int Hq, int Hkv, int S, int D,
                                  float scale, int dtype, int route, int splits,
                                  int per, int step, int vec16, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  const int isz = dtype == 0 ? 4 : 2;
  const bool bad =
      (dtype != 0 && dtype != 1) || (route != kSimt && route != kMma) || Hkv <= 0 ||
      Hq % Hkv || D < 8 || D > MAX_D || S < 0 || B > 65535 || splits < 1 ||
      splits > MAX_SPLITS || step <= 0 || 32 % step || per <= 0 || per % step ||
      (long long)splits * per < S || (vec16 && (D * isz) % 16) ||
      (route == kMma && (dtype != 1 || D % 16 || step != MMA_STEP || !vec16));
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const int group = Hq / Hkv;
  Args g{q, k, v, static_cast<const int*>(lo), static_cast<const int*>(hi), out,
         Hq, Hkv, S, D, group, (group + HEADS - 1) / HEADS, scale * LOG2E,
         splits, per, step, vec16};
  if ((long long)Hkv * g.hgroups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernel_for(route, dtype, D);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure(kernel, smem_bytes(route, D, isz, step),
                            dim3(splits, Hkv * g.hgroups, B), splits,
                            static_cast<cudaStream_t>(stream), &cfg, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (route == kMma) {
    // The cache as (D, S, B * Hkv) for TMA, boxes of 64 x 16 slots.
    CUtensorMap map_k = {}, map_v = {};
    if (D % TILE_BOX == 0) {
      const long long rows = (long long)B * Hkv;
      if (!wg::encode_3d(&map_k, k, D, S, rows, D, (long long)S * D, TILE_BOX, MMA_STEP) ||
          !wg::encode_3d(&map_v, v, D, S, rows, D, (long long)S * D, TILE_BOX, MMA_STEP))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    e = cudaLaunchKernelEx(&cfg, reinterpret_cast<MmaKernel>(const_cast<void*>(kernel)),
                           map_k, map_v, g);
  } else {
    e = cudaLaunchKernelEx(&cfg, reinterpret_cast<SimtKernel>(const_cast<void*>(kernel)), g);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `splits` blocks of the (route, dtype, D, step)
// kernel the card holds at once (cudaOccupancyMaxActiveClusters): the
// plan keeps a launch's clusters within one such wave.  Returns the count,
// or minus a CUDA error.
extern "C" int repro_flash_decode_clusters(int route, int dtype, int D, int step, int splits) {
  if ((dtype != 0 && dtype != 1) || (route != kSimt && route != kMma) || D < 8 ||
      D > MAX_D || splits < 1 || splits > MAX_SPLITS || step <= 0 || 32 % step)
    return -static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kernel_for(route, dtype, D);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure(kernel, smem_bytes(route, D, dtype == 0 ? 4 : 2, step),
                            dim3(splits, 1, 1), splits, nullptr, &cfg, attr);
  cfg.numAttrs = 1;
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}
