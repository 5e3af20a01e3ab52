// What the splat-blend forward (K1, splat_blend_fwd.cu) and backward (K4,
// splat_blend_bwd.cu) share: the tile geometry, the packed instance record,
// its cp.async staging, and the alpha/transmittance step. K4 replays the
// weights K1 summed, so both take the step from here and compile it the
// same way (explicit _rn intrinsics: no contraction that could differ
// between the two kernels), bit for bit.
//
// The record. Each gaussian's blend inputs are packed once per render into
// 48 bytes (three 16-byte words): x, y, A, B | C, o, c0, c1 | c2, c3, 0, 0,
// where A = -½·log2(e)·a, B = -log2(e)·b, C = -½·log2(e)·c fold the conic's
// ½ and the change of base into it, so that
//   s = A·dx² + B·dx·dy + C·dy² = -log2(e)·σ,   e^-σ = 2^s,
// one ex2.approx per pair; σ ≥ 0 is s ≤ 0 (the scale is negative). The fold
// happens when the records are packed and not when a batch is staged,
// because cp.async copies bytes as they are.
//
// Staging. A block stages BATCH instances at a time into shared memory with
// 16-byte cp.async copies, gathered through the depth-sorted gauss_idx, into
// one of two buffers while the other is blended. TMA cannot gather
// arbitrary rows on sm_90 (its tensor copies take boxes of a tensor), so
// cp.async is the tool. Each pixel then reads an instance as three
// broadcast LDS.128.

#pragma once

#include <cuda_runtime.h>

namespace splat {

constexpr int TS = 16;
constexpr int P = TS * TS;       // pixels per tile
constexpr int PPT = 2;           // pixels per thread: two neighbours of one row
constexpr int NT = P / PPT;      // threads per block
constexpr int WARPS = NT / 32;
constexpr int BATCH = NT;        // instances staged per batch, one per thread
constexpr int REC4 = 3;          // 16-byte words per record
constexpr float ALPHA_THRESH = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.999f;
constexpr float T_EPS = 1e-4f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the gauss index this thread stages for the batch at `base` (-1: none)
__device__ __forceinline__ int batch_index(const int* __restrict__ gauss_idx,
                                           int base, int end, int tid) {
  return base + tid < end ? __ldg(gauss_idx + base + tid) : -1;
}

// this thread's record of a batch: three 16-byte copies
__device__ __forceinline__ void stage_record(float4* buf,
                                             const float4* __restrict__ rec,
                                             int gi, int tid) {
  if (gi < 0) return;
  const float4* src = rec + (size_t)REC4 * gi;
  float4* dst = buf + REC4 * tid;
  cp_async16(dst, src);
  cp_async16(dst + 1, src + 1);
  cp_async16(dst + 2, src + 2);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One instance at one pixel. From the row's shared B·dy and C·dy²: s, the
// exponential e2 = e^-σ, α_raw = o·e2 and α, kept (else 0) where σ ≥ 0 and
// min(0.999, α_raw) ≥ 1/255, as _make_fwd_kernel gates it.
struct Step {
  float e2, araw, alpha;
  bool keep;
};

__device__ __forceinline__ Step blend_step(float A, float o, float dx,
                                           float Bdy, float Cdy2) {
  Step r;
  const float s = __fmaf_rn(__fmaf_rn(A, dx, Bdy), dx, Cdy2);
  r.e2 = ex2(s);
  r.araw = __fmul_rn(o, r.e2);
  const float ac = fminf(ALPHA_MAX, r.araw);
  r.keep = s <= 0.f && ac >= ALPHA_THRESH;
  r.alpha = r.keep ? ac : 0.f;
  return r;
}

__device__ __forceinline__ float row_bdy(float B, float dy) {
  return __fmul_rn(B, dy);
}

__device__ __forceinline__ float row_cdy2(float C, float dy) {
  return __fmul_rn(__fmul_rn(C, dy), dy);
}

// the transmittance before the next instance: T keeps multiplying after the
// pixel saturates, so T_fin is the full product
__device__ __forceinline__ float next_t(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.f, alpha));
}

}  // namespace splat
