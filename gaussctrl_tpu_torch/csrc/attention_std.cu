// Standard-layout single-shot attention for Hopper (sm_90a): K5. It
// computes softmax(q kᵀ/√d) v per batch·head with Tq ≠ Tk allowed, on bf16
// inputs in the JAX layout [B, T, C] (heads side by side in C), with fp32
// scores, max and sum; P is rounded to bf16 only as the input of the second
// product, as the JAX kernel does, and both query and key tails are masked.
// The streaming kernel (K6) runs on the TMA/wgmma core in flash_hopper.cu.
//
// Replaces (JAX package, Pallas on TPU):
//   K5  gaussctrl_tpu/ops/flash_attention.py  flash_attention(kernel="full")
//       / _attn_kernel_full — the whole [bq, Tk] score panel on chip.
//
// What bounds it on the H100. K5's shapes are the text cross-attention
// (Tk = 77) and the composed cross-view references at t = 64: 4·Tq·Tk·d FLOP
// against about 4·Tq·d bytes, some 77 FLOP/byte, far under the card's ~295
// FLOP/byte ridge, so K5 is bound by bytes: it reads q once, K/V once per
// query block (from L2 after the first), and writes o once.
//
// Design. A grid (query blocks, B·heads), query block fastest, so the
// blocks of one (batch, head) share its K/V through L2. Products run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); V is
// stored transposed in shared memory so that both products read 32-bit
// fragment pairs; head_dim is padded to a multiple of 16 in shared memory
// only (zero fill). Batch strides are arguments, so a view such as one
// reference of a [G, F, T, C] tensor is read in place. One block of 4 warps
// owns 64 query rows, and holds all of K and V of its (batch, head) plus the
// whole [64, Tk] fp32 score panel in shared memory. Each warp computes its
// 16 rows' scores in one pass of QKᵀ, one max/exp/sum over the panel, and
// one P·V of depth Tk. The wrapper takes it only where the panel and K/V fit
// a block's 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr float NEG_BIG = -1e30f;
constexpr int SMEM_MAX = 232448; // 227 KB, the most a block may take

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

// Copy rows [row0, row0 + nrows) of one head (row stride C) into a shared
// tile [row][stride] of DP columns, with zero fill past d and past t_valid.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int t_valid, int C, int d) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * CH; i += blockDim.x) {
    const int r = i / CH, c = i - r * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_valid && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C + c * 8);
    *reinterpret_cast<uint4*>(dst + r * stride + c * 8) = val;
  }
}

// The same for V, stored transposed: dst[col][key] with row stride `stride`.
template <int DP>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst, int stride,
                                            const __nv_bfloat16* src, int row0,
                                            int nrows, int t_valid, int C,
                                            int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < nrows * CH; i += blockDim.x) {
    const int r = i / CH, c = i - r * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t_valid && c * 8 < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * stride + r] = e[j];
  }
}

// A fragment (16 rows x 16 columns at column c0) of a bf16 tile [row][stride]
// whose first row is r0.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* p0 = tile + (r0 + g) * stride + c0 + tig * 2;
  const __nv_bfloat16* p1 = p0 + 8 * stride;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory of K5 for padded width DP and Tk keys (the wrapper's
// `full_smem_bytes` computes the same).
__host__ __device__ constexpr int full_tk16(int Tk) { return (Tk + 15) / 16 * 16; }
template <int DP>
__host__ __device__ constexpr size_t full_smem(int Tk) {
  return sizeof(__nv_bfloat16) *
             ((size_t)BQ * (DP + 8) + (size_t)full_tk16(Tk) * (DP + 8) +
              (size_t)DP * (full_tk16(Tk) + 8)) +
         sizeof(float) * (size_t)BQ * (full_tk16(Tk) + 4);
}

// K5: grid (query blocks, B·heads), 4 warps.
template <int DP>
__global__ void __launch_bounds__(128)
attention_full_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, long long q_bs,
                      long long kv_bs, int Tq, int Tk, int C, int heads, int d,
                      float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tk16 = full_tk16(Tk);
  const int QS = DP + 8, VS = tk16 + 8, PS = tk16 + 4;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * QS;
  __nv_bfloat16* Vt = Ks + tk16 * QS;
  float* panel = reinterpret_cast<float*>(Vt + DP * VS);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / heads, h = blockIdx.y - b * heads;
  const __nv_bfloat16* qb = q + b * q_bs + h * d;
  const __nv_bfloat16* kb = k + b * kv_bs + h * d;
  const __nv_bfloat16* vb = v + b * kv_bs + h * d;

  load_rows<DP>(Qs, QS, qb, q0, BQ, Tq, C, d);
  load_rows<DP>(Ks, QS, kb, 0, tk16, Tk, C, d);
  load_rows_t<DP>(Vt, VS, vb, 0, tk16, Tk, C, d);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) frag_a(qa[kc], Qs, QS, warp * 16, kc * 16);

  // scores of the warp's 16 rows, scaled to the log2 domain, tail masked.
  // Each thread writes its own panel entries (rows g and g + 8, keys
  // nt·8 + 2·tig + {0, 1}) and later reads only those.
  float* p0 = panel + (warp * 16 + g) * PS;
  float* p1 = p0 + 8 * PS;
  float mx0 = NEG_BIG, mx1 = NEG_BIG;
  for (int nt = 0; nt < tk16 / 8; ++nt) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      const __nv_bfloat16* kp = Ks + (nt * 8 + g) * QS + kc * 16 + tig * 2;
      mma_bf16(s, qa[kc], ld32(kp), ld32(kp + 8));
    }
    const int key = nt * 8 + tig * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = key + (e & 1) < Tk ? s[e] * scale_log2 : NEG_BIG;
    p0[key] = s[0];
    p0[key + 1] = s[1];
    p1[key] = s[2];
    p1[key + 1] = s[3];
    mx0 = fmaxf(mx0, fmaxf(s[0], s[1]));
    mx1 = fmaxf(mx1, fmaxf(s[2], s[3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);

  float l0 = 0.f, l1 = 0.f;
  for (int nt = 0; nt < tk16 / 8; ++nt) {
    const int key = nt * 8 + tig * 2;
    p0[key] = exp2f(p0[key] - mx0);
    p0[key + 1] = exp2f(p0[key + 1] - mx0);
    p1[key] = exp2f(p1[key] - mx1);
    p1[key + 1] = exp2f(p1[key + 1] - mx1);
    l0 += p0[key] + p0[key + 1];
    l1 += p1[key] + p1[key + 1];
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // P·V of depth Tk: P's A fragments are the thread's own panel entries
  float o[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  for (int kc = 0; kc < tk16 / 16; ++kc) {
    const int key = kc * 16 + tig * 2;
    uint32_t pa[4];
    pa[0] = pack_bf16(p0[key], p0[key + 1]);
    pa[1] = pack_bf16(p1[key], p1[key + 1]);
    pa[2] = pack_bf16(p0[key + 8], p0[key + 9]);
    pa[3] = pack_bf16(p1[key + 8], p1[key + 9]);
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const __nv_bfloat16* vp = Vt + (nd * 8 + g) * VS + kc * 16 + tig * 2;
      mma_bf16(o[nd], pa, ld32(vp), ld32(vp + 8));
    }
  }

  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  __nv_bfloat16* ob = out + b * q_bs + h * d;
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

template <int DP>
cudaError_t launch_full(const void* q, const void* k, const void* v, void* o,
                        long long q_bs, long long kv_bs, int B, int Tq, int Tk,
                        int C, int heads, int d, cudaStream_t stream) {
  const size_t smem = full_smem<DP>(Tk);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_full_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * heads);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  attention_full_kernel<DP><<<grid, 128, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, q_bs, kv_bs, Tq, Tk, C,
      heads, d, scale_log2);
  return cudaGetLastError();
}

bool valid(int B, int Tq, int Tk, int C, int heads) {
  return B > 0 && Tq > 0 && Tk > 0 && heads > 0 && C % heads == 0 &&
         (C / heads) % 8 == 0 && B * heads <= 65535;
}

}  // namespace

// Head width d (a multiple of 8) runs in the instantiation whose padded width
// DP = round_up(d, 16) matches: d = 8/16/32 (the tiny and nano configs) and
// 40/80/160 (SD-1.5). q may have its own batch stride; k and v share one.
extern "C" int gc_attention_full(const void* q, const void* k, const void* v,
                                 void* o, long long q_bs, long long kv_bs,
                                 int B, int Tq, int Tk, int C, int heads,
                                 void* stream) {
  if (!valid(B, Tq, Tk, C, heads)) return (int)cudaErrorInvalidValue;
  const int d = C / heads;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((d + 15) / 16 * 16) {
    case 16: return (int)launch_full<16>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 32: return (int)launch_full<32>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 48: return (int)launch_full<48>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 80: return (int)launch_full<80>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    case 160: return (int)launch_full<160>(q, k, v, o, q_bs, kv_bs, B, Tq, Tk, C, heads, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
