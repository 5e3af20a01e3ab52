// The fused cross-view attention of the edit lane (K3) on Hopper's
// asynchronous units (sm_90a), on the TMA + wgmma core of flash_core.cuh.
//
// Replaces (JAX package, Pallas on TPU):
//   K3  gaussctrl_tpu/ops/flash_attention.py  cross_view_attention /
//       _cross_view_kernel — c·attn(q, k_self, v_self)
//       + (1−c)/r·Σᵢ attn(q, k_refᵢ, v_refᵢ), one softmax per panel.
// bf16 q/k/v [G·F, T, C] in the JAX layout (heads side by side in C): view
// f of CFG group g is batch g·F + f, and a group's references are its first
// r views. fp32 scores, maxima, sums and blend; P rounded to bf16 only as
// the input of the second product; query and key tails masked. With c = 0
// (the ControlNet) the self panel is skipped, as the JAX kernel does.
//
// What bounds it on the H100. Per (view, head) the work is (1+r)·4·T²·d
// tensor FLOP and (1+r)·T² exponentials against (2 + 2(1+r))·T·d·2 bytes:
// far above the ~295 FLOP/byte ridge. At d = 40 (the 4096-token level, 87%
// of the kernel's time in an edit step) a score costs 160 FLOP and one exp2,
// so the SFUs (~3.9e12 exp/s) set the floor; at d ≥ 80 the tensor cores do.
//
// Design. The 1+r panels of one query tile run in one block, one after the
// other, on the core's loop:
//  * Grid (query tiles of 64·W rows, view f, group g · head h), the query
//    tile fastest, then the view: the blocks that share one (group, head)'s
//    reference K/V run together and find them in L2 (4 refs × 4096 × 40 ×
//    2 × 2 B ≈ 2.6 MB at the 4096-token level).
//  * Copies. The producer warp loads the Q tile once, then streams one
//    sequence of K/V tiles through the ring: panels 0 … r−1 from batch
//    g·F + i (the references), then the self panel from g·F + f. A panel is
//    only a batch coordinate of the same tensor map; rows past T are zeros
//    from the copy engine and are masked in the softmax.
//  * Consumers. Each panel runs the core's loop as K2 does (shapes of
//    Core<DP>): the first tile peeled; then S of tile i issued with P·V of
//    tile i − 1; then the last P·V; with its own running max, sum and O.
//    At the end of a panel O/l·wₚ is added to a blend accumulator and the
//    running state is reset. The warpgroups' ping-pong counts tiles over
//    all panels. The output is written once, masked at the row tail.
//  * The blend lives in shared memory, at every width: one fp32 slot per
//    thread-owned accumulator entry ([entry][thread], so the accesses are
//    conflict-free and no thread reads another's). In registers it would
//    add DP/2 registers to cores that already use 107–154 of the 152 (W = 3)
//    or 224 (W = 2) a thread may have (ptxas, the K2 instantiations): 114 +
//    40 at DP 80 and 154 + 80 at DP 160 are over, and a spill near a wgmma
//    serializes it. One block fills an SM at every width (registers bound
//    it), so the shared memory is otherwise idle; the fold costs DP/2
//    shared read-modify-writes per thread per panel, against the panel's
//    T/BK tiles of two GEMMs each. At DP 160 the blend (80 KB) leaves room
//    for two K/V stages, not three.
//  * wgmma stays uniform over the warpgroup: the warp index is broadcast,
//    the panel loop's bounds are kernel arguments, no wgmma sits under a
//    branch, and every register a wgmma reads or writes (o, s, p) is fenced
//    before the wgmma.fence of its batch; otherwise ptxas serializes every
//    wgmma of the kernel.

#include "flash_core.cuh"

namespace {

// The core's shape with a blend accumulator in shared memory.
template <int DP>
struct XView : Core<DP> {
  using C = Core<DP>;
  static constexpr int STAGES = DP <= 80 ? 3 : 2;
  static constexpr size_t K_OFF = C::Q_BYTES;
  static constexpr size_t V_OFF = K_OFF + (size_t)STAGES * C::KV_BYTES;
  static constexpr size_t BLEND_OFF = V_OFF + (size_t)STAGES * C::KV_BYTES;
  static constexpr size_t BLEND_BYTES = (size_t)C::BQ * DP * 4;
  static constexpr size_t BAR_OFF = BLEND_OFF + BLEND_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 128;
  static_assert(SMEM <= (size_t)SMEM_MAX, "K3 tile exceeds shared memory");
};

// grid (query tiles of 64·W, F views, G·heads), 128·W + 32 threads:
// warpgroup w consumes query rows [64w, 64w + 64) of the tile; the last
// warp copies.
template <typename L>
__global__ void __launch_bounds__(L::THREADS, 1)
cross_view_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ out, int F, int T, int C,
                  int heads, int d, int r, float self_coeff,
                  float scale_log2) {
  constexpr int DP = L::DPW, NWG = L::NWG, CONS = L::CONS;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + L::K_OFF;
  unsigned char* Vs = smem + L::V_OFF;
  float* blend = reinterpret_cast<float*>(smem + L::BLEND_OFF);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int q0 = blockIdx.x * BQ;
  const int fv = blockIdx.y;
  const int gi = blockIdx.z / heads, h = blockIdx.z - (blockIdx.z / heads) * heads;
  const int bq = gi * F + fv;                         // this view's batch
  const int nt = (T + BK - 1) / BK;                   // tiles a panel
  const int np = r + (self_coeff != 0.f ? 1 : 0);     // panels
  const int ntiles = np * nt;

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
  // are uniform over each warp and warpgroup
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  if (warp >= CONS / 32) {  // the producer warp
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      tma_load_5d(Qs, &tm_q, bar_q, q0, h, bq);
      for (int pn = 0; pn < np; ++pn)
        produce_kv<L>(&tm_k, &tm_v, Ks, Vs, full_k, full_v, empty_k, empty_v,
                      pn * nt, nt, pn < r ? gi * F + pn : bq, h);
    }
    return;
  }

  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const Frag f;
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 16;
  // this thread's blend entries: entry e at blend[e·CONS + thread]
  float* bl = blend + threadIdx.x;
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) bl[e * CONS] = 0.f;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m0 = NEG_BIG, m1 = NEG_BIG;  // running row maxima of the raw scores
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  const float ref_w = (1.f - self_coeff) / (float)r;

  mbar_wait(bar_q, 0);
  // ping-pong: named barrier 1 + w opens warpgroup w's turn to issue GEMMs;
  // warpgroup 0 goes first, and the last one skips its last hand-over. The
  // turns run over the tiles of all panels.
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

  for (int pn = 0; pn < np; ++pn) {
    const int i0 = pn * nt;  // the panel's first tile in the ring
    {  // its first tile: the scores only
      const int st = i0 % STAGES;
      mbar_wait(&full_k[st], (i0 / STAGES) & 1);
      turn_begin();
      fence_regs(s);
      wgmma_fence();
      issue_s(st);
      turn_end(i0);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(&empty_k[st]);
      float a0, a1;
      online_softmax<BK>(s, 2 * f.t, BK > T, T, scale_log2, m0, m1, l0, l1,
                         a0, a1);
      pack_p<BK>(s, p);
    }
    for (int j = 1; j < nt; ++j) {
      const int i = i0 + j;
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

      // online softmax of this tile, overlapping the other warpgroups'
      // GEMMs and this warpgroup's P·V of the previous tile
      float a0, a1;
      online_softmax<BK>(s, j * BK + 2 * f.t, (j + 1) * BK > T, T, scale_log2,
                         m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();  // the previous P·V is done: its V stage and P are free
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(&empty_v[pst]);
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
        o[4 * jj] *= a0;
        o[4 * jj + 1] *= a0;
        o[4 * jj + 2] *= a1;
        o[4 * jj + 3] *= a1;
      }
      pack_p<BK>(s, p);
    }
    {  // the panel's last P·V
      const int li = i0 + nt - 1;
      const int lst = li % STAGES;
      mbar_wait(&full_v[lst], (li / STAGES) & 1);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_pv(lst);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty_v[lst]);
    }
    // fold the panel into the blend: O/l times the panel's weight; then
    // start the next panel afresh
    const float w = pn < r ? ref_w : self_coeff;
    const float w0 = w / fmaxf(quad_sum(l0), 1e-30f);
    const float w1 = w / fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      bl[(4 * jj) * CONS] += o[4 * jj] * w0;
      bl[(4 * jj + 1) * CONS] += o[4 * jj + 1] * w0;
      bl[(4 * jj + 2) * CONS] += o[4 * jj + 2] * w1;
      bl[(4 * jj + 3) * CONS] += o[4 * jj + 3] * w1;
      o[4 * jj] = o[4 * jj + 1] = o[4 * jj + 2] = o[4 * jj + 3] = 0.f;
    }
    m0 = m1 = NEG_BIG;
    l0 = l1 = 0.f;
  }

  const int row0 = q0 + wg * 64 + f.wrow + f.g, row1 = row0 + 8;
  __nv_bfloat16* ob = out + (size_t)bq * T * C + h * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * f.t;
    if (8 * j < d) {
      if (row0 < T)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
            __floats2bfloat162_rn(bl[(4 * j) * CONS], bl[(4 * j + 1) * CONS]);
      if (row1 < T)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
            __floats2bfloat162_rn(bl[(4 * j + 2) * CONS], bl[(4 * j + 3) * CONS]);
    }
  }
}

template <int DP>
int launch_cross_view(const void* q, const void* k, const void* v, void* o,
                      int G, int F, int T, int C, int heads, int d, int r,
                      float self_coeff, cudaStream_t stream) {
  using L = XView<DP>;
  const long long bs = (long long)T * C;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, bs, G * F, T, C, heads, d, L::BQ, L::NC);
  if (err == 0) err = make_map(&mk, k, bs, G * F, T, C, heads, d, L::BK, L::NC);
  if (err == 0) err = make_map(&mv, v, bs, G * F, T, C, heads, d, L::BK, L::NC);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      cross_view_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + L::BQ - 1) / L::BQ, F, G * heads);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  cross_view_kernel<L><<<grid, L::THREADS, L::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, F, T, C, heads, d, r, self_coeff,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// K3: q/k/v (and o) contiguous [G·F, T, C]; head width d (a multiple of 8)
// runs in the instantiation whose padded width DP = round_up(d, 16)
// matches: SD-1.5's d = 40, 80 and 160 (DP 48, 80, 160) and the tiny
// config's d = 16 and 32.
extern "C" int gc_cross_view_attention(const void* q, const void* k,
                                       const void* v, void* o, int G, int F,
                                       int T, int C, int heads, int r,
                                       float self_coeff, void* stream) {
  if (G <= 0 || F <= 0 || T <= 0 || heads <= 0 || C % heads != 0 || r <= 0 ||
      r > F || (C / heads) % 8 != 0 || F > 65535 || G * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_cross_view<16>(q, k, v, o, G, F, T, C, heads, d, r, self_coeff, s);
    case 32: return launch_cross_view<32>(q, k, v, o, G, F, T, C, heads, d, r, self_coeff, s);
    case 48: return launch_cross_view<48>(q, k, v, o, G, F, T, C, heads, d, r, self_coeff, s);
    case 80: return launch_cross_view<80>(q, k, v, o, G, F, T, C, heads, d, r, self_coeff, s);
    case 160: return launch_cross_view<160>(q, k, v, o, G, F, T, C, heads, d, r, self_coeff, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the K3 instantiation for padded width dp (0:
// none).
extern "C" int gc_cross_view_smem_bytes(int dp) {
  switch (dp) {
    case 16: return (int)XView<16>::SMEM;
    case 32: return (int)XView<32>::SMEM;
    case 48: return (int)XView<48>::SMEM;
    case 80: return (int)XView<80>::SMEM;
    case 160: return (int)XView<160>::SMEM;
    default: return 0;
  }
}
