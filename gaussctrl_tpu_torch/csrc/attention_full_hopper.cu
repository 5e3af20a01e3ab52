// Standard-layout single-shot attention (K5) on Hopper's asynchronous units
// (sm_90a), on the TMA + wgmma pieces of flash_core.cuh.
//
// Replaces (JAX package, Pallas on TPU):
//   K5  gaussctrl_tpu/ops/flash_attention.py  flash_attention(kernel="full")
//       / _attn_kernel_full — softmax(q kᵀ/√d) v per batch·head with the
//       whole key list at once: one row max, one exp pass, one sum, P
//       rounded to bf16 once as the input of the second product.
// bf16 [B, T, C] in the JAX layout (heads side by side in C), Tq ≠ Tk
// allowed, fp32 scores, max and sum, query and key tails masked. k and v
// share a batch stride, so one reference of a [G, F, T, C] tensor is read
// in place.
//
// What bounds it on the H100. K5's shapes are the text cross-attention
// (Tk = 77) and the composed cross-view references at 64 tokens: 4·Tq·Tk·d
// FLOP against 4·Tq·d bytes of q and o (K/V are a few KB), some 77
// FLOP/byte, far under the card's ~295 FLOP/byte ridge. It is bound by
// bytes: the design moves q in once and o out once, at full width, and
// keeps everything else on chip.
//
// Design.
//  * The whole key list is one key tile of NK = 80 or 128 rows (Tk ≤ 80 or
//    ≤ 128; more keys go to the streaming kernel K6). K and V are loaded
//    once per block by TMA into the interleaved layout; rows past Tk are
//    zeros from the copy engine and are masked. S = Q·Kᵀ is wgmma
//    m64nNKk16 from shared memory; one row max, one exp2 pass and one sum
//    in registers; P is packed in place to bf16 A fragments and O = P·V is
//    wgmma with A from registers and V read through the transpose bit. No
//    fp32 score panel, no running rescale.
//  * Persistent over query tiles. A block stays on one (batch, head) and
//    walks a run of 64-row query tiles (up to 16) that the producer warp
//    streams through a ring of up to 8 stages; the consumer warpgroups take
//    the tiles in turn. The grid is a few waves of one block an SM, not one
//    block per 64 rows. A stage is released as soon as its scores are in.
//  * O goes out through shared memory: each warpgroup writes its bf16 tile
//    into the interleaved layout (a warp's stores are 128 contiguous bytes,
//    free of bank conflicts) and one thread issues a TMA store of the tile,
//    which clips the row tail and the padded columns. The next tile's
//    writes wait only for that store to have read shared memory.
//  * Three consumer warpgroups where the tile's registers allow (d ≤ 80 at
//    NK = 80), else two. Every register a wgmma reads or writes is fenced
//    before the wgmma.fence of its batch and no wgmma sits under a branch.

#include "flash_core.cuh"

namespace {

// Layout of one K5 block for padded width DP and NK keys.
template <int DP, int NK>
struct Full {
  static constexpr int DPW = DP;
  static constexpr int NKW = NK;
  static constexpr int NWG = DP <= 80 && NK <= 80 ? 3 : 2;  // consumers
  static constexpr int CONS = NWG * 128;
  static constexpr int THREADS = CONS + 32;     // plus the producer warp
  static constexpr int BQ = 64;                 // query rows a tile
  static constexpr int NC = DP / 8;             // 16-byte column chunks
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;  // a Q tile, an O tile
  static constexpr uint32_t KV_BYTES = NK * DP * 2;
  static constexpr size_t V_OFF = KV_BYTES;
  static constexpr size_t O_OFF = 2 * (size_t)KV_BYTES;  // one per warpgroup
  static constexpr size_t Q_OFF = O_OFF + (size_t)NWG * Q_BYTES;
  static constexpr int MAX_STAGES = 8;
  static constexpr size_t RESERVE = 8 * (1 + 2 * MAX_STAGES) + 128;
  static constexpr int FIT = (int)((SMEM_MAX - Q_OFF - RESERVE) / Q_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr size_t BAR_OFF = Q_OFF + (size_t)STAGES * Q_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 128;
  static constexpr int MAX_TILES = 16;          // query tiles a block
  static_assert(STAGES >= 2 && SMEM <= (size_t)SMEM_MAX,
                "K5 tiles exceed shared memory");
  static_assert(DP % 16 == 0 && DP <= 160 && (NK == 80 || NK == 128),
                "K5 shapes");
};

// grid (runs of query tiles, B·heads): block (x, y) takes query tiles
// [x·tpb, x·tpb + tpb) of batch y / heads, head y % heads; warpgroup w takes
// the run's tiles w, w + NWG, …; the last warp copies.
template <typename L>
__global__ void __launch_bounds__(L::THREADS, 1)
attention_full_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, int qt,
                      int Tk, int heads, int tpb, float scale_log2) {
  constexpr int DP = L::DPW, NK = L::NKW, NWG = L::NWG, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::V_OFF;
  unsigned char* Os = smem + L::O_OFF;
  unsigned char* Qs = smem + L::Q_OFF;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_q = bar_kv + 1;
  uint64_t* empty_q = full_q + STAGES;

  const int b = blockIdx.y / heads, h = blockIdx.y - (blockIdx.y / heads) * heads;
  const int t0 = blockIdx.x * tpb;
  const int n = min(tpb, qt - t0);  // query tiles of this block

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_q[s], 1);
      mbar_init(&empty_q[s], 4);  // lane 0 of each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warp index, broadcast so that the compiler knows the roles below
  // are uniform over each warp and warpgroup
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  if (warp >= L::CONS / 32) {  // the producer warp
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
      tma_load_5d(Ks, &tm_k, bar_kv, 0, h, b);
      tma_load_5d(Vs, &tm_v, bar_kv, 0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty_q[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full_q[s], L::Q_BYTES);
        tma_load_5d(Qs + s * L::Q_BYTES, &tm_q, &full_q[s],
                    (t0 + i) * L::BQ, h, b);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  const Frag f;
  const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
  unsigned char* ot = Os + wg * L::Q_BYTES;  // this warpgroup's O tile
  float o[DP / 2];
  float s[NK / 2];
  uint32_t p[NK / 16][4];
  const bool tail = Tk < NK;

  mbar_wait(bar_kv, 0);
  for (int i = wg; i < n; i += NWG) {
    const int st = i % STAGES;
    mbar_wait(&full_q[st], (i / STAGES) & 1);
    // S = Q·Kᵀ over the whole key list
    const uint32_t q_addr = smem_u32(Qs) + st * L::Q_BYTES;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Mma<NK>::ss(s, make_desc(q_addr + kk * 2 * L::BQ * 16, L::BQ * 16, 128),
                  make_desc(k_addr + kk * 2 * NK * 16, NK * 16, 128), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty_q[st]);

    // one softmax over all keys: from a running max of NEG_BIG and a sum of
    // 0, the online step is the single shot (its rescale factors are 0)
    float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f, a0, a1;
    online_softmax<NK>(s, 2 * f.t, tail, Tk, scale_log2, m0, m1, l0, l1, a0,
                       a1);
    pack_p<NK>(s, p);
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o[j] = 0.f;

    // O = P·V
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      Mma<DP>::rs(o, p[kk], make_desc(v_addr + kk * 16 * 16, 128, NK * 16));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    const float i0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
    const float i1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
    // the O tile is free once the warpgroup's last store has read it
    if (leader) bulk_wait_read<0>();
    bar_sync(1 + wg, 128);
    const int r0 = f.wrow + f.g;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      *reinterpret_cast<uint32_t*>(ot + (j * L::BQ + r0) * 16 + 4 * f.t) =
          pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
      *reinterpret_cast<uint32_t*>(ot + (j * L::BQ + r0 + 8) * 16 + 4 * f.t) =
          pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (leader) tma_store_5d(&tm_o, ot, (t0 + i) * L::BQ, h, b);
  }
  if (leader) bulk_wait_read<0>();  // the last store has read the tile
}

template <int DP, int NK>
int launch_full(const void* q, const void* k, const void* v, void* o,
                long long q_bs, long long kv_bs, int B, int Tq, int Tk, int C,
                int heads, int d, cudaStream_t stream) {
  using L = Full<DP, NK>;
  CUtensorMap mq, mk, mv, mo;
  int err = make_map(&mq, q, q_bs, B, Tq, C, heads, d, L::BQ, L::NC);
  if (err == 0) err = make_map(&mo, o, q_bs, B, Tq, C, heads, d, L::BQ, L::NC);
  if (err == 0) err = make_map(&mk, k, kv_bs, B, Tk, C, heads, d, NK, L::NC);
  if (err == 0) err = make_map(&mv, v, kv_bs, B, Tk, C, heads, d, NK, L::NC);
  if (err != 0) return err;
  // the launch is on the host's path of every text cross-attention, so the
  // shared-memory opt-in and the SM count are taken once per device
  static uint32_t opted_in = 0;
  static int sm_count[32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(opted_in >> dev & 1u)) {
    e = cudaFuncSetAttribute(attention_full_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    opted_in |= 1u << dev;
  }
  const int sms = sm_count[dev];
  // tiles a block: about four waves of one block an SM, each warpgroup
  // with a tile, at most MAX_TILES
  const int qt = (Tq + L::BQ - 1) / L::BQ;
  const long long all = (long long)qt * B * heads;
  int tpb = (int)((all + 4LL * sms - 1) / (4LL * sms));
  tpb = tpb < L::NWG ? L::NWG : (tpb > L::MAX_TILES ? L::MAX_TILES : tpb);
  tpb = tpb < qt ? tpb : qt;
  const dim3 grid((qt + tpb - 1) / tpb, B * heads);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  attention_full_kernel<L><<<grid, L::THREADS, L::SMEM, stream>>>(
      mq, mk, mv, mo, qt, Tk, heads, tpb, scale_log2);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_width(const void* q, const void* k, const void* v, void* o,
                 long long q_bs, long long kv_bs, int B, int Tq, int Tk, int C,
                 int heads, int d, cudaStream_t s) {
  if (Tk <= 80)
    return launch_full<DP, 80>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
  return launch_full<DP, 128>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
}

}  // namespace

// K5: q (and o) contiguous with batch stride q_bs, k and v sharing the
// batch stride kv_bs, at most 128 keys. Head width d (a multiple of 8) runs
// in the instantiation whose padded width DP = round_up(d, 16) matches:
// d = 8/16/32 (the tiny and nano configs) and 40/80/160 (SD-1.5).
extern "C" int gc_attention_full(const void* q, const void* k, const void* v,
                                 void* o, long long q_bs, long long kv_bs,
                                 int B, int Tq, int Tk, int C, int heads,
                                 void* stream) {
  if (!valid(B, Tq, Tk, C, heads) || Tk > 128) return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_width<16>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 32: return launch_width<32>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 48: return launch_width<48>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 80: return launch_width<80>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 160: return launch_width<160>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the K5 instantiation for padded width dp and nk
// keys (0: none).
extern "C" int gc_attention_full_smem_bytes(int dp, int nk) {
#define GC_SMEM(DP)                                              \
  case DP:                                                       \
    return nk == 80 ? (int)Full<DP, 80>::SMEM                    \
                    : nk == 128 ? (int)Full<DP, 128>::SMEM : 0;
  switch (dp) {
    GC_SMEM(16) GC_SMEM(32) GC_SMEM(48) GC_SMEM(80) GC_SMEM(160)
    default: return 0;
  }
#undef GC_SMEM
}
