// Flash-attention forward on Hopper's asynchronous units (sm_90a): the
// inversion-lane self-attention (K2) and the streaming attention (K6), on
// one core of TMA copies, mbarriers and warpgroup matrix multiplies (wgmma).
//
// Replaces (JAX package, Pallas on TPU):
//   K2  gaussctrl_tpu/ops/flash_attention.py  flash_attention_t /
//       _attn_kernel_full_t — softmax(q kᵀ/√d) v per batch·head.
//   K6  gaussctrl_tpu/ops/flash_attention.py  flash_attention(kernel="stream")
//       / _flash_kernel — the same with Tq ≠ Tk, as an online softmax.
// Both compute softmax(q kᵀ/√d) v per (batch, head) on bf16 inputs in the
// JAX layout [B, T, C] (heads side by side in C): fp32 scores, max and sum;
// P rounded to bf16 only as the input of the second product; query and key
// tails masked. K/V may carry their own batch stride (a reference view of a
// [G, F, T, C] tensor is read in place).
//
// What bounds them on the H100. Per (batch, head) the work is 4·Tq·Tk·d
// tensor FLOP and Tq·Tk exponentials against 2·(Tq + Tk)·d·2 bytes: far
// above the ~295 FLOP/byte ridge. At d = 40 a score costs 160 FLOP and one
// exp2, so the SFU (~3.9e12 exp/s) and not the tensor cores (989 TFLOP/s)
// sets the floor; at d ≥ 80 the tensor cores do.
//
// Design.
//  * Tile layout. Every tile in shared memory is "interleaved": 8-column
//    chunks of 16 bytes, each chunk holding all rows of the tile at a
//    16-byte pitch, so an 8x8 core matrix is 128 contiguous bytes. This is
//    wgmma's canonical no-swizzle layout, K-major for Q and K (scores) and
//    MN-major for V (the transpose bit of the second product), so V is used
//    in its natural [key][column] layout and nothing is transposed by hand.
//    It needs no swizzle width, which an 80-byte row (d = 40) has none of.
//  * Copies. One TMA instruction moves a whole tile: the tensor map
//    describes q/k/v as 5-D (8 elements, T rows, d/8 chunks, heads, batch)
//    with strides (2, C·2, 16, d·2, batch stride·2) bytes, and the box
//    (8, rows, DP/8, 1, 1) lands in the interleaved layout. Chunks past d/8
//    (d = 40 padded to 48) and rows past T fall outside the tensor and are
//    filled with zeros by the copy engine, never read from the next head.
//    K and V stream through a ring of stages with full/empty mbarriers; one
//    producer warp issues every copy, so the copy of later tiles overlaps
//    the math of the current one. (A producer warp of cp.async copies into
//    the same layout was slower at d = 40 in trials on the card.)
//  * Core (d ≤ 160; K2 and K6's narrow widths). A block owns 64·W query
//    rows: W consumer warpgroups of 64 rows and the producer warp. S = Q·Kᵀ
//    is wgmma m64nBKk16 with Q and K from shared memory; the online softmax
//    (log2 domain, maxima on the raw scores, the scale folded into one FFMA
//    before each exp2) stays in registers; P is converted in place from
//    the S accumulator to bf16 A fragments (the accumulator and A layouts
//    line up), and O += P·V is wgmma with A from registers. Within a
//    warpgroup, S of tile i and P·V of tile i − 1 are issued together, and
//    the exponentials of tile i run while P·V of tile i − 1 is on the
//    tensor cores. Across warpgroups, a ring of named barriers hands the
//    turn to issue GEMMs from one warpgroup to the next, so one issues
//    while the others run their exponentials (FlashAttention-3's ping-pong).
//    Shapes, chosen in trials on the card (K2 at B = 8): W = 3 and BK = 96
//    keys at d ≤ 40 (DP 16/32/48), W = 3 and BK = 64 at d = 80, W = 2 and
//    BK = 64 at d = 160, whose O accumulator needs the registers; 3 stages.
//    Every register that a wgmma reads or accumulates into is defined
//    before the wgmma.fence that opens its batch (fence_regs), and the
//    first tile is peeled so that no wgmma sits under a branch: otherwise
//    ptxas serializes every wgmma of the kernel.
//  * Wide (d = 512, the VAE mid-block; K6). The O accumulator of 64 rows is
//    64x512 fp32, too much for one warpgroup, so two consumer warpgroups
//    share one 64-row Q tile and split O's columns (256 each, wgmma
//    m64n256k16). S is computed once: each warpgroup takes half of a 32-key
//    tile's keys (wgmma m64n16k16), they exchange row maxima through
//    shared memory and write P as bf16 into an interleaved tile that both
//    read as the A operand of P·V. Q 64 KB, K and V 32 KB a stage, 2
//    stages, P double-buffered: ~200 KB. (Splitting the depth of S instead
//    and exchanging fp32 partial scores was slower in a trial on the card:
//    ptxas serialized its wgmma.)
// The producer warp keeps the registers it was given (setmaxnreg applies to
// whole warpgroups, and the consumers fit without it).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may take
constexpr int CONSUMERS = 256;    // the wide variant's two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 32;  // plus one producer warp

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
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n80_tb(d, a, b); }
};
template <> struct Mma<96> {
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t a, uint64_t b, int s) { wgmma_ss_n96(d, a, b, s); }
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

template <typename L>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    unsigned char* Qs, unsigned char* Ks, unsigned char* Vs, uint64_t* bar_q,
    uint64_t* full_k, uint64_t* full_v, uint64_t* empty_k, uint64_t* empty_v,
    int q0, int b, int h, int ntiles) {
  constexpr int BK = L::BK, STAGES = L::STAGES;
  if ((threadIdx.x & 31) != 0) return;  // one thread issues every copy
  mbar_expect_tx(bar_q, L::Q_BYTES);
  tma_load_5d(Qs, tm_q, bar_q, q0, h, b);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    mbar_wait(&empty_k[s], ph ^ 1);
    mbar_expect_tx(&full_k[s], L::KV_BYTES);
    tma_load_5d(Ks + s * L::KV_BYTES, tm_k, &full_k[s], i * BK, h, b);
    mbar_wait(&empty_v[s], ph ^ 1);
    mbar_expect_tx(&full_v[s], L::KV_BYTES);
    tma_load_5d(Vs + s * L::KV_BYTES, tm_v, &full_v[s], i * BK, h, b);
  }
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

// ---------------------------------------------------------------------------
// The core: d ≤ 160 (padded width DP = 16/32/48/80/160)
// ---------------------------------------------------------------------------

template <int DP>
struct Core {
  static constexpr int DPW = DP;
  // consumer warpgroups: three at d ≤ 80, two at 160 (its O accumulator
  // needs the registers)
  static constexpr int NWG = DP <= 80 ? 3 : 2;
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

// grid (query blocks of 64·W, B·heads), 128·W + 32 threads: warpgroup w
// consumes query rows [64w, 64w + 64) of the block; the last warp copies.
template <typename L>
__global__ void __launch_bounds__(L::THREADS, 1)
flash_core_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ out, long long o_bs, int Tq,
                  int Tk, int C, int heads, int d, float scale_log2) {
  constexpr int DP = L::DPW, NWG = L::NWG, CONS = L::CONS;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + L::K_OFF;
  unsigned char* Vs = smem + L::V_OFF;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / heads, h = blockIdx.y - (blockIdx.y / heads) * heads;
  const int ntiles = (Tk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONS / 32);  // lane 0 of every consumer warp
      mbar_init(&empty_v[s], CONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp index, broadcast so that the compiler knows the roles below
  // are uniform over each warp and warpgroup (wgmma must not sit on a path
  // it thinks divergent)
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  if (warp >= CONS / 32) {  // the producer warp
    produce<L>(&tm_q, &tm_k, &tm_v, Qs, Ks, Vs, bar_q, full_k, full_v,
               empty_k, empty_v, q0, b, h, ntiles);
    return;
  }

  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const Frag f;
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 16;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m0 = NEG_BIG, m1 = NEG_BIG;  // running row maxima of the raw scores
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  // ping-pong: named barrier 1 + w opens warpgroup w's turn to issue GEMMs;
  // warpgroup 0 goes first, and the last one skips its last hand-over
  if (wg == NWG - 1) bar_arrive(1, 256);
  auto turn_begin = [&]() { bar_sync(1 + wg, 256); };
  auto turn_end = [&](int i) {
    if (!(wg == NWG - 1 && i == ntiles - 1))
      bar_arrive(1 + (wg + 1) % NWG, 256);
  };
  // S = Q·Kᵀ of the tile in stage st (issued, not waited for)
  auto issue_s = [&](int st) {
    const uint32_t k_addr = smem_u32(Ks) + st * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Mma<BK>::ss(s, make_desc(q_addr + kk * 2 * BQ * 16, BQ * 16, 128),
                  make_desc(k_addr + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
    wgmma_commit();
  };
  // O += P·V of the tile in stage st (issued, not waited for)
  auto issue_pv = [&](int st) {
    const uint32_t v_addr = smem_u32(Vs) + st * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Mma<DP>::rs(o, p[kk], make_desc(v_addr + kk * 16 * 16, 128, BK * 16));
    wgmma_commit();
  };
  // P in place of S: the accumulator's (row, key pairs) are the A
  // fragment's of the second product
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  {  // tile 0: its scores only
    mbar_wait(&full_k[0], 0);
    turn_begin();
    fence_regs(s);
    wgmma_fence();
    issue_s(0);
    turn_end(0);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty_k[0]);
    float a0, a1;
    online_softmax<BK>(s, 2 * f.t, BK > Tk, Tk, scale_log2, m0, m1, l0, l1,
                       a0, a1);
    pack_p();
  }
  for (int i = 1; i < ntiles; ++i) {
    const int st = i % STAGES;
    const int pst = (i - 1) % STAGES;
    mbar_wait(&full_k[st], (i / STAGES) & 1);
    mbar_wait(&full_v[pst], ((i - 1) / STAGES) & 1);
    turn_begin();
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_s(st);
    issue_pv(pst);  // the previous tile's
    turn_end(i);
    wgmma_wait<1>();  // the scores are in
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty_k[st]);

    // online softmax of this tile, overlapping the other warpgroup's GEMMs
    // and this warpgroup's P·V of the previous tile
    float a0, a1;
    online_softmax<BK>(s, i * BK + 2 * f.t, (i + 1) * BK > Tk, Tk, scale_log2,
                       m0, m1, l0, l1, a0, a1);
    wgmma_wait<0>();  // the previous P·V is done: its V stage and P are free
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&empty_v[pst]);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    pack_p();
  }
  {  // the last tile's P·V
    const int lst = (ntiles - 1) % STAGES;
    mbar_wait(&full_v[lst], ((ntiles - 1) / STAGES) & 1);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv(lst);
    wgmma_wait<0>();
    fence_regs(o);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + wg * 64 + f.wrow + f.g, row1 = row0 + 8;
  __nv_bfloat16* ob = out + b * o_bs + h * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * f.t;
    if (8 * j < d) {
      if (row0 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
            __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (row1 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide variant: d = 512 (the SD VAE's mid-block, one head)
// ---------------------------------------------------------------------------

struct Wide {
  static constexpr int DP = 512;
  static constexpr int THREADS = NTHREADS;
  static constexpr int BQ = 64;        // query rows per block, shared by both
  static constexpr int BK = 32;        // keys per tile; 16 per warpgroup in S
  static constexpr int STAGES = 2;
  static constexpr int NC = DP / 8;
  static constexpr int NW = DP / 2;    // O columns per warpgroup
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  static constexpr uint32_t P_BYTES = BQ * BK * 2;
  static constexpr size_t K_OFF = Q_BYTES;
  static constexpr size_t V_OFF = K_OFF + (size_t)STAGES * KV_BYTES;
  static constexpr size_t P_OFF = V_OFF + (size_t)STAGES * KV_BYTES;
  static constexpr size_t RED_OFF = P_OFF + 2 * P_BYTES;   // [2][2][BQ] fp32
  static constexpr size_t SUM_OFF = RED_OFF + 4 * BQ * 4;  // [2][BQ] fp32
  static constexpr size_t BAR_OFF = SUM_OFF + 2 * BQ * 4;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 128;
  static_assert(SMEM <= (size_t)SMEM_MAX, "wide tile exceeds shared memory");
};

// grid (query blocks of 64, B·heads), 288 threads: warpgroup w computes the
// scores of keys [16w, 16w + 16) of each tile and O's columns
// [256w, 256w + 256); warp 8 copies.
__global__ void __launch_bounds__(NTHREADS, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ out, long long o_bs, int Tq,
                  int Tk, int C, int heads, int d, float scale_log2) {
  using L = Wide;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + L::K_OFF;
  unsigned char* Vs = smem + L::V_OFF;
  unsigned char* Ps = smem + L::P_OFF;
  float* red = reinterpret_cast<float*>(smem + L::RED_OFF);
  float* sums = reinterpret_cast<float*>(smem + L::SUM_OFF);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / heads, h = blockIdx.y - (blockIdx.y / heads) * heads;
  const int ntiles = (Tk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONSUMERS / 32);
      mbar_init(&empty_v[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  if (warp >= CONSUMERS / 32) {  // the producer warp
    produce<L>(&tm_q, &tm_k, &tm_v, Qs, Ks, Vs, bar_q, full_k, full_v,
               empty_k, empty_v, q0, b, h, ntiles);
    return;
  }

  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const Frag f;
  const int r0 = f.wrow + f.g, r1 = r0 + 8;  // the thread's rows in the block
  const uint32_t q_addr = smem_u32(Qs);
  float o[L::NW / 2];
#pragma unroll
  for (int i = 0; i < L::NW / 2; ++i) o[i] = 0.f;
  float s[8];
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int par = i & 1;
    mbar_wait(&full_k[st], ph);
    fence_regs(s);
    fence_regs(o);
    wgmma_fence();
    const uint32_t k_addr = smem_u32(Ks) + st * L::KV_BYTES + wg * 16 * 16;
#pragma unroll 8
    for (int kk = 0; kk < L::DP / 16; ++kk)
      Mma<16>::ss(s, make_desc(q_addr + kk * 2 * BQ * 16, BQ * 16, 128),
                  make_desc(k_addr + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();  // also the previous tile's P·V
    fence_regs(s);
    fence_regs(o);
    if (lane == 0) {
      mbar_arrive(&empty_k[st]);
      if (i > 0) mbar_arrive(&empty_v[(i + STAGES - 1) % STAGES]);
    }

    const int key0 = i * BK + wg * 16 + 2 * f.t;
    const bool tail = (i + 1) * BK > Tk;
    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !tail || key0 + 8 * j + (e & 1) < Tk;
        s[4 * j + e] = ok ? s[4 * j + e] * scale_log2 : NEG_BIG;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float* rd = red + par * 2 * BQ;  // [warpgroup][row] of this parity
    if (f.t == 0) {
      rd[wg * BQ + r0] = mx0;
      rd[wg * BQ + r1] = mx1;
    }
    bar_sync(1, CONSUMERS);
    mx0 = fmaxf(rd[r0], rd[BQ + r0]);
    mx1 = fmaxf(rd[r1], rd[BQ + r1]);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[4 * j] = fast_exp2(s[4 * j] - mn0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mn1);
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < L::NW / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    // P (bf16) into the interleaved [64 rows][32 keys] tile of this parity:
    // key chunk 2·wg + j, rows r0 and r1
    unsigned char* pt = Ps + par * L::P_BYTES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * wg + j;
      *reinterpret_cast<uint32_t*>(pt + (c * BQ + r0) * 16 + 4 * f.t) =
          pack_bf16(s[4 * j], s[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(pt + (c * BQ + r1) * 16 + 4 * f.t) =
          pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    // P was written through the generic proxy; wgmma reads it through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(2, CONSUMERS);  // both halves of P are written

    mbar_wait(&full_v[st], ph);
    fence_regs(o);
    wgmma_fence();
    const uint32_t p_addr = smem_u32(pt);
    const uint32_t v_addr = smem_u32(Vs) + st * L::KV_BYTES + wg * (L::NW / 8) * BK * 16;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n256_tb(o, make_desc(p_addr + kk * 2 * BQ * 16, BQ * 16, 128),
                       make_desc(v_addr + kk * 16 * 16, 128, BK * 16), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (f.t == 0) {
    sums[wg * BQ + r0] = l0;
    sums[wg * BQ + r1] = l1;
  }
  bar_sync(1, CONSUMERS);
  l0 = sums[r0] + sums[BQ + r0];
  l1 = sums[r1] + sums[BQ + r1];
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0, row1 = q0 + r1;
  __nv_bfloat16* ob = out + b * o_bs + h * d + wg * L::NW;
#pragma unroll
  for (int j = 0; j < L::NW / 8; ++j) {
    const int col = 8 * j + 2 * f.t;
    if (row0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
          __floats2bfloat162_rn(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (row1 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
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

// The 5-D interleaved view of one of q/k/v ([B, T, C] with heads of width d
// side by side, rows C apart, batches `bs` elements apart): (8 elements,
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

template <typename L, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v, void* o,
           long long q_bs, long long kv_bs, int B, int Tq, int Tk, int C,
           int heads, int d, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, q_bs, B, Tq, C, heads, d, L::BQ, L::NC);
  if (err == 0) err = make_map(&mk, k, kv_bs, B, Tk, C, heads, d, L::BK, L::NC);
  if (err == 0) err = make_map(&mv, v, kv_bs, B, Tk, C, heads, d, L::BK, L::NC);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + L::BQ - 1) / L::BQ, B * heads);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, q_bs, Tq, Tk, C, heads, d,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_core(const void* q, const void* k, const void* v, void* o,
                long long q_bs, long long kv_bs, int B, int Tq, int Tk, int C,
                int heads, int d, cudaStream_t stream) {
  return launch<Core<DP>>(flash_core_kernel<Core<DP>>, q, k, v, o, q_bs, kv_bs,
                          B, Tq, Tk, C, heads, d, stream);
}

bool valid(int B, int Tq, int Tk, int C, int heads) {
  return B > 0 && Tq > 0 && Tk > 0 && heads > 0 && C % heads == 0 &&
         (C / heads) % 8 == 0 && B * heads <= 65535;
}

// Head width d (a multiple of 8) runs in the instantiation whose padded
// width DP = round_up(d, 16) matches: d = 8/16/32 (the tiny and nano
// configs), 40/80/160 (SD-1.5) on the core, and 512 (the SD VAE's
// mid-block) on the wide variant.
int dispatch(const void* q, const void* k, const void* v, void* o,
             long long q_bs, long long kv_bs, int B, int Tq, int Tk, int C,
             int heads, bool wide_ok, cudaStream_t s) {
  if (!valid(B, Tq, Tk, C, heads)) return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_core<16>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 32: return launch_core<32>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 48: return launch_core<48>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 80: return launch_core<80>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 160: return launch_core<160>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 512:
      if (!wide_ok) return (int)cudaErrorInvalidValue;
      return launch<Wide>(flash_wide_kernel, q, k, v, o, q_bs, kv_bs, B, Tq, Tk,
                          C, heads, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2: contiguous q [B, Tq, C], k/v [B, Tk, C]; widths up to 160.
extern "C" int gc_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Tq, int Tk, int C,
                                  int heads, void* stream) {
  return dispatch(q, k, v, o, (long long)Tq * C, (long long)Tk * C, B, Tq, Tk,
                  C, heads, false, (cudaStream_t)stream);
}

// K6: q (and o) contiguous with batch stride q_bs, k and v sharing the
// batch stride kv_bs; widths up to 160 and 512.
extern "C" int gc_attention_stream(const void* q, const void* k, const void* v,
                                   void* o, long long q_bs, long long kv_bs,
                                   int B, int Tq, int Tk, int C, int heads,
                                   void* stream) {
  return dispatch(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, true,
                  (cudaStream_t)stream);
}

// Dynamic shared memory of the instantiation for padded width dp (0: none).
extern "C" int gc_flash_smem_bytes(int dp) {
  switch (dp) {
    case 16: return (int)Core<16>::SMEM;
    case 32: return (int)Core<32>::SMEM;
    case 48: return (int)Core<48>::SMEM;
    case 80: return (int)Core<80>::SMEM;
    case 160: return (int)Core<160>::SMEM;
    case 512: return (int)Wide::SMEM;
    default: return 0;
  }
}

// Whether K2 takes head width d.
extern "C" int gc_supported_head_dim(int d) {
  if (d % 8 != 0) return 0;
  switch ((d + 15) / 16 * 16) {
    case 16: case 32: case 48: case 80: case 160: return 1;
    default: return 0;
  }
}
