// The flash-attention core shared by the attention kernels for Hopper
// (sm_90a): K2 and K6 (flash_hopper.cu), K3 (cross_view_hopper.cu) and K5
// (attention_full_hopper.cu). PTX helpers for TMA, mbarriers, bulk stores
// and wgmma; the producer warp's copies; the online softmax; the core's
// shape Core<DP>; and the host's tensor-map encoder.
//
//  * Tile layout. Every tile in shared memory is "interleaved": 8-column
//    chunks of 16 bytes, each chunk holding all rows of the tile at a
//    16-byte pitch, so an 8x8 core matrix is 128 contiguous bytes. This is
//    wgmma's canonical no-swizzle layout, K-major for Q and K (scores) and
//    MN-major for V (the transpose bit of the second product), so V is used
//    in its natural [key][column] layout and nothing is transposed by hand.
//    It needs no swizzle width, which an 80-byte row (d = 40) has none of.
//  * Copies. One TMA instruction moves a whole tile: the tensor map
//    describes q/k/v (and o) as 5-D (8 elements, T rows, d/8 chunks, heads,
//    batch) with strides (2, C·2, 16, d·2, batch stride·2) bytes, and the
//    box (8, rows, DP/8, 1, 1) lands in the interleaved layout. Chunks past
//    d/8 (d = 40 padded to 48) and rows past T fall outside the tensor: a
//    load fills them with zeros, never with the next head, and a store
//    skips them. K and V stream through a ring of stages with full/empty
//    mbarriers; one producer warp issues every copy.
//
// Everything here has internal linkage: each kernel file that includes it
// gets its own copy, and the library exports only the extern "C" entries.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may take

// ---------------------------------------------------------------------------
// PTX helpers: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed. A wait that
// never ends (a copy that was never issued) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One TMA tile copy of a 5-D box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c1, int c3,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(c1), "r"(0), "r"(c3), "r"(c4)
      : "memory");
}

// One TMA tile store of a 5-D box from shared memory, in the issuing
// thread's bulk group. Parts of the box outside the tensor are not written.
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c1, int c3,
                                             int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(0), "r"(c1), "r"(0), "r"(c3), "r"(c4)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's bulk stores still read shared
// memory (their source may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Writes through the generic proxy made visible to the async proxy (TMA,
// wgmma) that reads them next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers among the consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator (and register A operand) reads
// or writes across the asynchronous wgmma issue and wait: every definition
// of such a register must come before the wgmma.fence that opens a batch,
// or ptxas serializes the batch.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of wgmma, no-swizzle (interleaved)
// layout: start address, leading byte offset (the stride between core
// matrices along K) and stride byte offset (along M/N), all >> 4.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The thread's place in the wgmma accumulator of its warpgroup: accumulator
// entry 4j + e holds row 16·warp + g (+8 for e ≥ 2), column 8j + 2t + (e & 1).
struct Frag {
  int g, t, wrow;  // row group, thread in group, first row of the warp
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    wrow = ((threadIdx.x >> 5) & 3) * 16;
  }
};

// wgmma wrappers chosen by width at compile time
template <int N> struct Mma;
template <> struct Mma<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int s) { wgmma_ss_n16(d, a, b, s); }
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n16_tb(d, a, b); }
};
template <> struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n32_tb(d, a, b); }
};
template <> struct Mma<48> {
  static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n48_tb(d, a, b); }
};
template <> struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int s) { wgmma_ss_n64(d, a, b, s); }
};
template <> struct Mma<80> {
  static __device__ __forceinline__ void ss(float (&d)[40], uint64_t a, uint64_t b, int s) { wgmma_ss_n80(d, a, b, s); }
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n80_tb(d, a, b); }
};
template <> struct Mma<96> {
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t a, uint64_t b, int s) { wgmma_ss_n96(d, a, b, s); }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int s) { wgmma_ss_n128(d, a, b, s); }
};
template <> struct Mma<160> {
  static __device__ __forceinline__ void rs(float (&d)[80], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n160_tb(d, a, b); }
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// In-register tree reductions of r[0, N) into r[0] (every index a
// compile-time constant, so r stays in registers).
template <int N, int M>
__device__ __forceinline__ void tree_max(float (&r)[M]) {
  if constexpr (N > 1) {
    constexpr int H = (N + 1) / 2;
#pragma unroll
    for (int j = 0; j < N - H; ++j) r[j] = fmaxf(r[j], r[j + H]);
    tree_max<H>(r);
  }
}
template <int N, int M>
__device__ __forceinline__ void tree_sum(float (&r)[M]) {
  if constexpr (N > 1) {
    constexpr int H = (N + 1) / 2;
#pragma unroll
    for (int j = 0; j < N - H; ++j) r[j] += r[j + H];
    tree_sum<H>(r);
  }
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128u - (smem_u32(p) & 127u)) & 127u);
}

// ---------------------------------------------------------------------------
// The producer warp: Q once, then K/V tiles through the ring of stages
// ---------------------------------------------------------------------------

// K/V tiles 0 .. ntiles−1 of batch b, head h, as tiles i0 .. i0+ntiles−1 of
// the ring (the stage and phase follow the ring's running tile count).
// Called by the one thread that issues every copy.
template <typename L>
__device__ __forceinline__ void produce_kv(
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, unsigned char* Ks,
    unsigned char* Vs, uint64_t* full_k, uint64_t* full_v, uint64_t* empty_k,
    uint64_t* empty_v, int i0, int ntiles, int b, int h) {
  constexpr int BK = L::BK, STAGES = L::STAGES;
  for (int j = 0; j < ntiles; ++j) {
    const int i = i0 + j;
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    mbar_wait(&empty_k[s], ph ^ 1);
    mbar_expect_tx(&full_k[s], L::KV_BYTES);
    tma_load_5d(Ks + s * L::KV_BYTES, tm_k, &full_k[s], j * BK, h, b);
    mbar_wait(&empty_v[s], ph ^ 1);
    mbar_expect_tx(&full_v[s], L::KV_BYTES);
    tma_load_5d(Vs + s * L::KV_BYTES, tm_v, &full_v[s], j * BK, h, b);
  }
}

template <typename L>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    unsigned char* Qs, unsigned char* Ks, unsigned char* Vs, uint64_t* bar_q,
    uint64_t* full_k, uint64_t* full_v, uint64_t* empty_k, uint64_t* empty_v,
    int q0, int b, int h, int ntiles) {
  if ((threadIdx.x & 31) != 0) return;  // one thread issues every copy
  mbar_expect_tx(bar_q, L::Q_BYTES);
  tma_load_5d(Qs, tm_q, bar_q, q0, h, b);
  produce_kv<L>(tm_k, tm_v, Ks, Vs, full_k, full_v, empty_k, empty_v, 0,
                ntiles, b, h);
}

// Online softmax of one tile of scores t (the thread's accumulator
// entries of rows g and g + 8) in place: t becomes exp2 of the scaled
// scores less the new row maxima, (m0, m1) the new maxima of the raw
// scores, (l0, l1) the thread's running row sums, (a0, a1) the factors that
// rescale what was accumulated before. key0 is the key of entry 0; keys at
// or past Tk are masked when `tail`. Maxima are taken on the raw scores and
// the scale folded into one FFMA before each exp2; maxima and sums are
// reduced as trees.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&t)[BK / 2], int key0,
                                               bool tail, int Tk,
                                               float scale_log2, float& m0,
                                               float& m1, float& l0, float& l1,
                                               float& a0, float& a1) {
  if (tail) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * j + (e & 1) >= Tk) t[4 * j + e] = NEG_BIG;
  }
  float r0[BK / 8], r1[BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    r0[j] = fmaxf(t[4 * j], t[4 * j + 1]);
    r1[j] = fmaxf(t[4 * j + 2], t[4 * j + 3]);
  }
  tree_max<BK / 8>(r0);
  tree_max<BK / 8>(r1);
  const float mn0 = fmaxf(m0, quad_max(r0[0]));
  const float mn1 = fmaxf(m1, quad_max(r1[0]));
  a0 = fast_exp2((m0 - mn0) * scale_log2);
  a1 = fast_exp2((m1 - mn1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  const float b0 = -mn0 * scale_log2, b1 = -mn1 * scale_log2;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    t[4 * j] = fast_exp2(fmaf(t[4 * j], scale_log2, b0));
    t[4 * j + 1] = fast_exp2(fmaf(t[4 * j + 1], scale_log2, b0));
    t[4 * j + 2] = fast_exp2(fmaf(t[4 * j + 2], scale_log2, b1));
    t[4 * j + 3] = fast_exp2(fmaf(t[4 * j + 3], scale_log2, b1));
    r0[j] = t[4 * j] + t[4 * j + 1];
    r1[j] = t[4 * j + 2] + t[4 * j + 3];
  }
  tree_sum<BK / 8>(r0);
  tree_sum<BK / 8>(r1);
  l0 = l0 * a0 + r0[0];
  l1 = l1 * a1 + r1[0];
}

// P in place of S: the accumulator's (row, key pairs) are the A fragment's
// of the second product.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// The core's shape: d ≤ 160 (padded width DP = 16/32/48/80/160)
// ---------------------------------------------------------------------------

// A block owns 64·NWG query rows: NWG consumer warpgroups of 64 rows and the
// producer warp. Shapes, chosen in trials on the card (K2 at B = 8): three
// warpgroups and 96-key tiles at d ≤ 40 (DP 16/32/48), three and 64 keys at
// d = 80, two and 64 keys at d = 160, whose O accumulator needs the
// registers; 3 stages.
template <int DP>
struct Core {
  static constexpr int DPW = DP;
  static constexpr int NWG = DP <= 80 ? 3 : 2;  // consumer warpgroups
  static constexpr int CONS = NWG * 128;        // consumer threads
  static constexpr int THREADS = CONS + 32;     // plus the producer warp
  static constexpr int BQ = 64 * NWG;           // query rows per block
  static constexpr int BK = DP <= 48 ? 96 : 64;  // keys per tile
  static constexpr int STAGES = 3;
  static constexpr int NC = DP / 8;             // 16-byte column chunks
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  static constexpr size_t K_OFF = Q_BYTES;
  static constexpr size_t V_OFF = K_OFF + (size_t)STAGES * KV_BYTES;
  static constexpr size_t BAR_OFF = V_OFF + (size_t)STAGES * KV_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 128;
  static_assert(SMEM <= (size_t)SMEM_MAX, "core tile exceeds shared memory");
  static_assert(DP % 16 == 0 && DP <= 160, "core widths");
};

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the
// runtime's entry-point query, so the library needs no -lcuda link flag.
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// Errors of the tensor-map encoding are returned as 10000 + CUresult.
constexpr int ENCODE_ERROR = 10000;

// The 5-D interleaved view of one of q/k/v/o ([B, T, C] with heads of width
// d side by side, rows C apart, batches `bs` elements apart): (8 elements,
// T rows, d/8 chunks, heads, B), box (8, rows, nc, 1, 1).
int make_map(CUtensorMap* map, const void* base, long long bs, int B, int T,
             int C, int heads, int d, int rows, int nc) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return ENCODE_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[5] = {8, (cuuint64_t)T, (cuuint64_t)(d / 8),
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)C * 2, 16, (cuuint64_t)d * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)nc, 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                            const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

bool valid(int B, int Tq, int Tk, int C, int heads) {
  return B > 0 && Tq > 0 && Tk > 0 && heads > 0 && C % heads == 0 &&
         (C / heads) % 8 == 0 && B * heads <= 65535;
}

}  // namespace
