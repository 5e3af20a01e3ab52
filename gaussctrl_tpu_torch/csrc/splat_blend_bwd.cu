// Splat-blend backward for Hopper (sm_90a) — kernel K4.
//
// Replaces (JAX package, Pallas on TPU): gaussctrl_tpu/ops/splat_blend.py
// _blend_bwd → _backward_call / _make_bwd_kernel: the VJP of the
// front-to-back alpha blend (K1) as one row per sorted instance,
// [xy(2), conic(3), colour(ch), opacity(1)], which splat/rasterize.py then
// sums per gaussian (reduce_by_slot). For out_p = Σ_i w_i c_i + T_fin·bg,
// w_i = α_i T_i m_i, m_i = [T_i > 1e-4]:
//   ∂L/∂α_i = (g·c_i) T_i m_i − [S_i + (g·bg − g_A)·T_fin] / (1 − α_i),
//   S_i = Σ_{j>i} (g·c_j) w_j,
// gated to α_raw < 0.999 where α is kept; σ, e^−σ and the chain to
// (x, y, a, b, c, opacity) as in _make_bwd_kernel.
//
// What bounds it on the H100: fp32 operations on the CUDA cores
// (67 TFLOP/s). Per (instance, pixel) pair at ch = 4, pass B does 35 for
// the replay, 31 for dL/dalpha and the 10 row values, and 10 for their sum
// over the tile's pixels (76, which is what the VJP needs); pass A repeats
// 34 of the replay's, so the kernel does about 1.45x the needed work. The
// single-replay Pallas kernel, which reads the forward's per-block
// transmittance checkpoints, avoids that.
//
// Design: one block per tile, one thread per pixel, instances staged 256 at
// a time through shared memory, as in K1. The transmittance cannot be
// recovered by division in a reverse sweep (K1 keeps multiplying after a
// pixel saturates, so T_fin underflows toward 0 on dense tiles), so the
// kernel replays the forward twice over exactly the n_done[t] instances
// that K1 blended: pass A accumulates the per-pixel total
// Q = Σ_j (g·c_j) w_j and T_fin, pass B replays with the running prefix so
// that S_i = Q − prefix_i. Each warp sums an instance's values with
// shuffles (skipped when no pixel of the warp keeps that instance) and
// leaves its partial in shared memory; after the batch, thread j sums the
// eight warps' partials of instance j and writes its row once. Each
// instance belongs to exactly one tile, so there are no atomics and the
// result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int TS = 16;
constexpr int P = TS * TS;  // pixels per tile = threads per block
constexpr int WARPS = P / 32;
constexpr float ALPHA_THRESH = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

template <int CH>
__global__ void __launch_bounds__(P)
splat_blend_bwd_kernel(const int* __restrict__ gauss_idx,
                       const int* __restrict__ starts,
                       const int* __restrict__ n_done,
                       const float* __restrict__ xys,
                       const float* __restrict__ conics,
                       const float* __restrict__ colors,
                       const float* __restrict__ opac,
                       const float* __restrict__ g_tiles,
                       const float* __restrict__ g_alpha,
                       const float* __restrict__ bg,
                       float* __restrict__ rows, float* __restrict__ tfin,
                       int n_tiles_x) {
  constexpr int D = 6 + CH;
  __shared__ float sx[P], sy[P], sa[P], sb[P], sc[P], so[P];
  __shared__ float scol[P * CH];
  extern __shared__ float part[];  // [WARPS][P][D] per-warp partial sums

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float px = (float)((tile % n_tiles_x) * TS + (tid % TS)) + 0.5f;
  const float py = (float)((tile / n_tiles_x) * TS + (tid / TS)) + 0.5f;
  const int start = starts[tile];
  const int end = start + n_done[tile];

  float go[CH];
  float gbg = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    go[c] = g_tiles[((size_t)tile * P + tid) * CH + c];
    gbg += go[c] * bg[c];
  }
  const float ga_out = g_alpha[(size_t)tile * P + tid];

  auto stage = [&](int base, int n) {
    __syncthreads();  // the previous batch's shared reads are done
    if (tid < n) {
      const int gi = gauss_idx[base + tid];
      sx[tid] = xys[2 * gi];
      sy[tid] = xys[2 * gi + 1];
      sa[tid] = conics[3 * gi];
      sb[tid] = conics[3 * gi + 1];
      sc[tid] = conics[3 * gi + 2];
      so[tid] = opac[gi];
#pragma unroll
      for (int c = 0; c < CH; ++c) scol[tid * CH + c] = colors[gi * CH + c];
    }
    __syncthreads();
  };

  // pass A: Q = Σ_j (g·c_j) w_j and T_fin, exactly as K1 blends
  float T = 1.f, Q = 0.f;
  for (int base = start; base < end; base += P) {
    const int n = min(P, end - base);
    stage(base, n);
    for (int j = 0; j < n; ++j) {
      const float dx = sx[j] - px;
      const float dy = sy[j] - py;
      const float sigma = 0.5f * (sa[j] * dx * dx + sc[j] * dy * dy) + sb[j] * dx * dy;
      const float alpha_c = fminf(0.999f, so[j] * expf(-sigma));
      const float alpha = (sigma >= 0.f && alpha_c >= ALPHA_THRESH) ? alpha_c : 0.f;
      if (T > T_EPS) {
        float gc = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) gc += go[c] * scol[j * CH + c];
        Q += gc * (alpha * T);
      }
      T = T * (1.f - alpha);
    }
  }
  tfin[(size_t)tile * P + tid] = T;
  const float gterm = (gbg - ga_out) * T;

  // pass B: replay with the running prefix; one row per instance
  T = 1.f;
  float pre = 0.f;
  for (int base = start; base < end; base += P) {
    const int n = min(P, end - base);
    stage(base, n);
    for (int j = 0; j < n; ++j) {
      const float dx = sx[j] - px;
      const float dy = sy[j] - py;
      const float a = sa[j], b = sb[j], c = sc[j];
      const float sigma = 0.5f * (a * dx * dx + c * dy * dy) + b * dx * dy;
      const float e_sig = expf(-sigma);
      const float araw = so[j] * e_sig;
      const float alpha_c = fminf(0.999f, araw);
      const bool keep = sigma >= 0.f && alpha_c >= ALPHA_THRESH;
      const float alpha = keep ? alpha_c : 0.f;
      float v[D];
      if (__any_sync(0xffffffffu, keep)) {
        const float m = T > T_EPS ? 1.f : 0.f;
        const float w = alpha * T * m;
        float gc = 0.f;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) gc += go[ch] * scol[j * CH + ch];
        const float q = gc * w;
        pre += q;
        const float s_after = Q - pre;
        const float ga = (keep && araw < 0.999f)
                             ? gc * T * m - (s_after + gterm) / (1.f - alpha)
                             : 0.f;
        const float g_sigma = -ga * alpha;
        v[0] = g_sigma * (a * dx + b * dy);
        v[1] = g_sigma * (c * dy + b * dx);
        v[2] = g_sigma * 0.5f * dx * dx;
        v[3] = g_sigma * dx * dy;
        v[4] = g_sigma * 0.5f * dy * dy;
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) v[5 + ch] = w * go[ch];
        v[5 + CH] = ga * e_sig;
#pragma unroll
        for (int k = 0; k < D; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        }
      } else {
        // no pixel of this warp keeps instance j: every term is zero
#pragma unroll
        for (int k = 0; k < D; ++k) v[k] = 0.f;
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) part[((size_t)warp * P + j) * D + k] = v[k];
      }
      T = T * (1.f - alpha);
    }
    __syncthreads();
    if (tid < n) {
      float* row = rows + (size_t)(base + tid) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += part[((size_t)w * P + tid) * D + k];
        row[k] = acc;
      }
    }
  }
}

template <int CH>
int launch(const int* gauss_idx, const int* starts, const int* n_done,
           const float* xys, const float* conics, const float* colors,
           const float* opac, const float* g_tiles, const float* g_alpha,
           const float* bg, float* rows, float* tfin, int n_tiles,
           int n_tiles_x, cudaStream_t s) {
  const size_t smem = sizeof(float) * WARPS * P * (6 + CH);
  cudaError_t e = cudaFuncSetAttribute(
      splat_blend_bwd_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  splat_blend_bwd_kernel<CH><<<n_tiles, P, smem, s>>>(
      gauss_idx, starts, n_done, xys, conics, colors, opac, g_tiles, g_alpha,
      bg, rows, tfin, n_tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gc_splat_blend_bwd(const int* gauss_idx, const int* starts,
                                  const int* n_done, const float* xys,
                                  const float* conics, const float* colors,
                                  const float* opac, const float* g_tiles,
                                  const float* g_alpha, const float* bg,
                                  float* rows, float* tfin, int n_tiles,
                                  int n_tiles_x, int ch, void* stream) {
  if (n_tiles <= 0 || n_tiles_x <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 3:
      return launch<3>(gauss_idx, starts, n_done, xys, conics, colors, opac,
                       g_tiles, g_alpha, bg, rows, tfin, n_tiles, n_tiles_x, s);
    case 4:
      return launch<4>(gauss_idx, starts, n_done, xys, conics, colors, opac,
                       g_tiles, g_alpha, bg, rows, tfin, n_tiles, n_tiles_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
