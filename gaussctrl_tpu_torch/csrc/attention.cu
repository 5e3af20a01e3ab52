// Flash-attention forward for Hopper (sm_90a): the inversion-lane
// self-attention (K2) and the fused cross-view attention of the edit lane (K3).
//
// Replaces (JAX package, Pallas on TPU):
//   K2  gaussctrl_tpu/ops/flash_attention.py  flash_attention_t /
//       _attn_kernel_full_t — softmax(q kᵀ/√d) v per batch·head.
//   K3  gaussctrl_tpu/ops/flash_attention.py  cross_view_attention /
//       _cross_view_kernel — c·attn(q, k_self, v_self)
//       + (1−c)/r·Σᵢ attn(q, k_refᵢ, v_refᵢ), one softmax per panel.
//
// What bounds it on the H100: at the SD-1.5 shapes (T = 4096/1024/256/64,
// head_dim 40/80/160) the work is 4·T²·d FLOP per (batch, head, panel)
// against 4·T·d bytes moved per panel, far above the card's
// ~295 FLOP/byte ridge: the kernel is bound by tensor-core operations.
//
// Design: one block of 4 warps owns a 64-row query block; each warp owns 16
// rows. Q is staged through shared memory once and kept in registers as
// mma.sync A fragments; K and V stream through shared memory in 64-key tiles
// (V stored transposed so both products read 32-bit fragment pairs). S = QKᵀ
// and O += P·V run on the tensor cores with mma.sync m16n8k16 (bf16 inputs,
// fp32 accumulation); the online softmax (running max and sum, in the log2
// domain) stays in fp32 registers, and P is rounded to bf16 only as the input
// of the second product, as the JAX kernel does. head_dim is padded to a
// multiple of 16 inside shared memory (zero fill), never in device memory;
// query and key tails are masked, so any T works. K3 runs its 1+r panels
// for a query block in one launch: Q is loaded once, each panel keeps its own
// softmax state, the weighted blend accumulates in shared memory (one slot
// per thread-owned output element) and the output is written once. Its grid
// puts the query block fastest, then the view, then (group, head), so the
// blocks that share one (group, head)'s reference K/V run together and find
// them in L2. This first version uses neither TMA nor wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NTHREADS = 128; // 4 warps x 16 query rows
constexpr float NEG_BIG = -1e30f;

template <int DP>
struct Layout {
  static constexpr int QS = DP + 8;   // bf16 row stride of Q and K tiles
  static constexpr int VS = BK + 8;   // bf16 row stride of the transposed V tile
  static constexpr int q_elems = BQ * QS;
  static constexpr int k_elems = BK * QS;
  static constexpr int v_elems = DP * VS;
  static constexpr size_t bf16_bytes =
      sizeof(__nv_bfloat16) * (q_elems + k_elems + v_elems);
  static constexpr size_t acc_bytes = sizeof(float) * BQ * DP;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy `BQ`/`BK` rows of one head ([row][d], row stride C elements) into a
// shared tile [row][DP] with zero fill past d and past the last valid row.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int t_valid, int C,
                                          int d) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * CH; i += NTHREADS) {
    const int r = i / CH, c = i - (i / CH) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_valid && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Layout<DP>::QS + c * 8) = val;
  }
}

// The same for V, stored transposed: dst[d][key].
template <int DP>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src, int row0,
                                            int t_valid, int C, int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < BK * CH; i += NTHREADS) {
    const int r = i / CH, c = i - (i / CH) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_valid && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * Layout<DP>::VS + r] = e[j];
  }
}

// Per-warp softmax state of one panel: running max (log2 domain) and the
// thread's partial row sums for its two rows (g and g + 8).
struct RowState {
  float m0, m1, l0, l1;
};

// One panel: online softmax of the warp's 16 query rows over all Tk keys of
// (kbase, vbase). On return o holds Σ p·v (unnormalised) and st the state.
template <int DP>
__device__ __forceinline__ void attend_panel(
    const __nv_bfloat16* kbase, const __nv_bfloat16* vbase, int Tk, int C,
    int d, float scale_log2, __nv_bfloat16* Ks, __nv_bfloat16* Vt,
    const uint32_t (&qa)[DP / 16][4], float (&o)[DP / 8][4], RowState& st) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  st.m0 = st.m1 = NEG_BIG;
  st.l0 = st.l1 = 0.f;

  for (int kt0 = 0; kt0 < Tk; kt0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<DP>(Ks, kbase, kt0, BK, Tk, C, d);
    load_rows_t<DP>(Vt, vbase, kt0, Tk, C, d);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * Layout<DP>::QS + kc * 16 + tig * 2;
        mma_bf16(s[nt], qa[kc], ld32(kp), ld32(kp + 8));
      }
    }

    float mx0 = NEG_BIG, mx1 = NEG_BIG;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const int key = kt0 + nt * 8 + tig * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key + (e & 1) < Tk;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG_BIG;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
    const float a0 = exp2f(st.m0 - mn0), a1 = exp2f(st.m1 - mn1);
    st.m0 = mn0;
    st.m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    st.l0 = st.l0 * a0 + rs0;
    st.l1 = st.l1 * a1 + rs1;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      o[nd][0] *= a0;
      o[nd][1] *= a0;
      o[nd][2] *= a1;
      o[nd][3] *= a1;
    }

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        const __nv_bfloat16* vp = Vt + (nd * 8 + g) * Layout<DP>::VS + kc * 16 + tig * 2;
        mma_bf16(o[nd], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }
  // full row sums: the four threads of a row group hold partial sums
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 1);
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 2);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 1);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 2);
}

// Stage the block's query rows and lift this warp's A fragments.
template <int DP>
__device__ __forceinline__ void load_q(const __nv_bfloat16* qbase, int q0,
                                       int Tq, int C, int d,
                                       __nv_bfloat16* Qs,
                                       uint32_t (&qa)[DP / 16][4]) {
  load_rows<DP>(Qs, qbase, q0, BQ, Tq, C, d);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* r0 = Qs + (warp * 16 + g) * Layout<DP>::QS + tig * 2;
  const __nv_bfloat16* r1 = r0 + 8 * Layout<DP>::QS;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    qa[kc][0] = ld32(r0 + kc * 16);
    qa[kc][1] = ld32(r1 + kc * 16);
    qa[kc][2] = ld32(r0 + kc * 16 + 8);
    qa[kc][3] = ld32(r1 + kc * 16 + 8);
  }
}

// K2: grid (query blocks, B·heads), query block fastest so one (b, h)'s K/V
// is reused from L2 by consecutive blocks.
template <int DP>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Tq, int Tk, int C,
                       int heads, int d, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + Layout<DP>::q_elems;
  __nv_bfloat16* Vt = Ks + Layout<DP>::k_elems;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / heads, h = blockIdx.y - (blockIdx.y / heads) * heads;
  const __nv_bfloat16* qb = q + (size_t)b * Tq * C + h * d;
  const __nv_bfloat16* kb = k + (size_t)b * Tk * C + h * d;
  const __nv_bfloat16* vb = v + (size_t)b * Tk * C + h * d;

  uint32_t qa[DP / 16][4];
  load_q<DP>(qb, q0, Tq, C, d, Qs, qa);
  float o[DP / 8][4];
  RowState st;
  attend_panel<DP>(kb, vb, Tk, C, d, scale_log2, Ks, Vt, qa, o, st);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const float i0 = 1.f / fmaxf(st.l0, 1e-30f), i1 = 1.f / fmaxf(st.l1, 1e-30f);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  __nv_bfloat16* ob = out + (size_t)b * Tq * C + h * d;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + tig * 2;
    if (col < d) {
      if (row0 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
            __floats2bfloat162_rn(o[nd][0] * i0, o[nd][1] * i0);
      if (row1 < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
            __floats2bfloat162_rn(o[nd][2] * i1, o[nd][3] * i1);
    }
  }
}

// K3: grid (query blocks, F views, G·heads). Batch index of view f in CFG
// group gi is gi·F + f; the references of a group are its first r views.
template <int DP>
__global__ void __launch_bounds__(NTHREADS)
cross_view_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int F, int T,
                            int C, int heads, int d, int r, float self_coeff,
                            float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + Layout<DP>::q_elems;
  __nv_bfloat16* Vt = Ks + Layout<DP>::k_elems;
  float* Acc = reinterpret_cast<float*>(smem + Layout<DP>::bf16_bytes);

  const int q0 = blockIdx.x * BQ;
  const int f = blockIdx.y;
  const int gi = blockIdx.z / heads, h = blockIdx.z - (blockIdx.z / heads) * heads;
  const size_t view_stride = (size_t)T * C;
  const int bq_idx = gi * F + f;

  uint32_t qa[DP / 16][4];
  load_q<DP>(q + bq_idx * view_stride + h * d, q0, T, C, d, Qs, qa);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int lrow0 = warp * 16 + g, lrow1 = lrow0 + 8;
  // each thread owns the same output elements in every panel
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + tig * 2;
    Acc[lrow0 * DP + col] = 0.f;
    Acc[lrow0 * DP + col + 1] = 0.f;
    Acc[lrow1 * DP + col] = 0.f;
    Acc[lrow1 * DP + col + 1] = 0.f;
  }

  const bool has_self = self_coeff != 0.f;
  const float ref_w = (1.f - self_coeff) / (float)r;
  float o[DP / 8][4];
  RowState st;
  for (int p = 0; p < r + (has_self ? 1 : 0); ++p) {
    const int bk_idx = p < r ? gi * F + p : bq_idx;
    const float w = p < r ? ref_w : self_coeff;
    attend_panel<DP>(k + bk_idx * view_stride + h * d,
                     v + bk_idx * view_stride + h * d, T, C, d, scale_log2, Ks,
                     Vt, qa, o, st);
    const float w0 = w / fmaxf(st.l0, 1e-30f), w1 = w / fmaxf(st.l1, 1e-30f);
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int col = nd * 8 + tig * 2;
      Acc[lrow0 * DP + col] += o[nd][0] * w0;
      Acc[lrow0 * DP + col + 1] += o[nd][1] * w0;
      Acc[lrow1 * DP + col] += o[nd][2] * w1;
      Acc[lrow1 * DP + col + 1] += o[nd][3] * w1;
    }
  }

  __nv_bfloat16* ob = out + bq_idx * view_stride + h * d;
  const int row0 = q0 + lrow0, row1 = q0 + lrow1;
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) {
    const int col = nd * 8 + tig * 2;
    if (col < d) {
      if (row0 < T)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
            __floats2bfloat162_rn(Acc[lrow0 * DP + col], Acc[lrow0 * DP + col + 1]);
      if (row1 < T)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
            __floats2bfloat162_rn(Acc[lrow1 * DP + col], Acc[lrow1 * DP + col + 1]);
    }
  }
}

template <int DP>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int Tq, int Tk, int C, int heads, int d,
                         cudaStream_t stream) {
  const size_t smem = Layout<DP>::bf16_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * heads);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  flash_attention_kernel<DP><<<grid, NTHREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Tq, Tk, C, heads, d,
      scale_log2);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_cross_view(const void* q, const void* k, const void* v,
                              void* o, int G, int F, int T, int C, int heads,
                              int d, int r, float self_coeff,
                              cudaStream_t stream) {
  const size_t smem = Layout<DP>::bf16_bytes + Layout<DP>::acc_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      cross_view_attention_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, F, G * heads);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  cross_view_attention_kernel<DP><<<grid, NTHREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, F, T, C, heads, d, r,
      self_coeff, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// head_dim d (a multiple of 8) runs in the instantiation whose padded width
// DP = round_up(d, 16) matches. Built: SD-1.5's d = 40, 80 and 160 (DP 48,
// 80, 160) and the tiny config's d = 16 and 32, which the card-against-CPU
// pipeline check runs.
#define GC_DISPATCH_DP(d, CALL)              \
  switch ((d + 15) / 16 * 16) {              \
    case 16: return CALL(16);                \
    case 32: return CALL(32);                \
    case 48: return CALL(48);                \
    case 80: return CALL(80);                \
    case 160: return CALL(160);              \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int gc_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Tq, int Tk, int C,
                                  int heads, void* stream) {
  const int d = C / heads;
  if (B <= 0 || Tq <= 0 || Tk <= 0 || d % 8 != 0) return (int)cudaErrorInvalidValue;
#define GC_CALL(DP) (int)launch_flash<DP>(q, k, v, o, B, Tq, Tk, C, heads, d, (cudaStream_t)stream)
  GC_DISPATCH_DP(d, GC_CALL)
#undef GC_CALL
}

extern "C" int gc_cross_view_attention(const void* q, const void* k,
                                       const void* v, void* o, int G, int F,
                                       int T, int C, int heads, int r,
                                       float self_coeff, void* stream) {
  const int d = C / heads;
  if (G <= 0 || F <= 0 || T <= 0 || r <= 0 || r > F || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
#define GC_CALL(DP) (int)launch_cross_view<DP>(q, k, v, o, G, F, T, C, heads, d, r, self_coeff, (cudaStream_t)stream)
  GC_DISPATCH_DP(d, GC_CALL)
#undef GC_CALL
}

extern "C" int gc_supported_head_dim(int d) {
  if (d % 8 != 0) return 0;
  switch ((d + 15) / 16 * 16) {
    case 16: case 32: case 48: case 80: case 160: return 1;
    default: return 0;
  }
}
