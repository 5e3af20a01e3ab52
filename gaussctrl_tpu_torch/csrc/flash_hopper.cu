// Flash-attention forward on Hopper's asynchronous units (sm_90a): the
// inversion-lane self-attention (K2) and the streaming attention (K6), on
// the TMA + wgmma core of flash_core.cuh.
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
// Design (tile layout and copies: flash_core.cuh).
//  * Copies. The producer warp loads the Q tile once and streams K and V
//    through the ring, so the copy of later tiles overlaps the math of the
//    current one. (A producer warp of cp.async copies into the same layout
//    was slower at d = 40 in trials on the card.)
//  * Core (d ≤ 160; K2 and K6's narrow widths; shapes in Core<DP>). S = Q·Kᵀ
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

#include "flash_core.cuh"

namespace {

constexpr int CONSUMERS = 256;    // the wide variant's two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 32;  // plus one producer warp

// ---------------------------------------------------------------------------
// The core: d ≤ 160 (padded width DP = 16/32/48/80/160)
// ---------------------------------------------------------------------------

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
    pack_p<BK>(s, p);
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
    pack_p<BK>(s, p);
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
// Host side: launches
// ---------------------------------------------------------------------------

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
