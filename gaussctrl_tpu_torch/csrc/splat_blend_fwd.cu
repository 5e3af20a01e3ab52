// Splat-blend forward for Hopper (sm_90a) — kernel K1.
//
// Replaces (JAX package, Pallas on TPU): gaussctrl_tpu/ops/splat_blend.py
// blend_pallas → _blend_fwd_impl → _forward_call / _make_fwd_kernel: the
// front-to-back alpha blend of each 16×16 tile's depth-sorted instances.
// Per instance and pixel: σ = ½(a·dx² + c·dy²) + b·dx·dy,
// α = min(0.999, o·e^−σ), kept only if σ ≥ 0 and α ≥ 1/255; the
// transmittance T is an exact running product, the weight is
// w = α·T·[T > 1e-4]. Outputs are the per-pixel channel sums and final T
// (background compositing and alpha = 1 − T stay in PyTorch).
//
// What bounds it on the H100: about 30 fp32 operations and one exp per
// (instance, pixel) pair against ~4·(7+ch) bytes read per instance, so it is
// bound by fp32 operations on the CUDA cores (67 TFLOP/s), with a serial
// dependence along each pixel's list.
//
// Design: one block per tile, one thread per pixel. The block reads its own
// [starts[t], ends[t]) range of the sorted gauss_idx the binning produced
// (the TPU kernel's static work-list packing is not needed: blocks are
// scheduled dynamically). Instances are staged 256 at a time through shared
// memory (one gather per thread), so every pixel reads them as broadcasts;
// T and the channel sums stay in registers. Before each batch the block
// votes with __syncthreads_or and leaves once every pixel has T ≤ 1e-4 —
// everything after that point would add exactly zero. `n_done` records how
// many instances each tile blended, for the bound of a run.

#include <cuda_runtime.h>

namespace {

constexpr int TS = 16;
constexpr int P = TS * TS;  // pixels per tile = threads per block
constexpr float ALPHA_THRESH = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

template <int CH>
__global__ void __launch_bounds__(P)
splat_blend_fwd_kernel(const int* __restrict__ gauss_idx,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const float* __restrict__ xys,
                       const float* __restrict__ conics,
                       const float* __restrict__ colors,
                       const float* __restrict__ opac,
                       float* __restrict__ out, float* __restrict__ tfin,
                       int* __restrict__ n_done, int n_tiles_x) {
  __shared__ float sx[P], sy[P], sa[P], sb[P], sc[P], so[P];
  __shared__ float scol[P * CH];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % n_tiles_x) * TS + (tid % TS)) + 0.5f;
  const float py = (float)((tile / n_tiles_x) * TS + (tid / TS)) + 0.5f;
  const int start = starts[tile], end = ends[tile];

  float T = 1.f;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.f;
  int done = 0;

  for (int base = start; base < end; base += P) {
    // also orders the previous batch's shared reads before this batch's writes
    if (!__syncthreads_or(T > T_EPS)) break;
    const int n = min(P, end - base);
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
    for (int j = 0; j < n; ++j) {
      const float dx = sx[j] - px;
      const float dy = sy[j] - py;
      const float sigma = 0.5f * (sa[j] * dx * dx + sc[j] * dy * dy) + sb[j] * dx * dy;
      const float alpha_c = fminf(0.999f, so[j] * expf(-sigma));
      const float alpha = (sigma >= 0.f && alpha_c >= ALPHA_THRESH) ? alpha_c : 0.f;
      if (T > T_EPS) {
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] += w * scol[j * CH + c];
      }
      T = T * (1.f - alpha);
    }
    done += n;
  }

#pragma unroll
  for (int c = 0; c < CH; ++c) out[((size_t)tile * P + tid) * CH + c] = acc[c];
  tfin[(size_t)tile * P + tid] = T;
  if (tid == 0) n_done[tile] = done;
}

}  // namespace

extern "C" int gc_splat_blend_fwd(const int* gauss_idx, const int* starts,
                                  const int* ends, const float* xys,
                                  const float* conics, const float* colors,
                                  const float* opac, float* out, float* tfin,
                                  int* n_done, int n_tiles, int n_tiles_x,
                                  int ch, void* stream) {
  if (n_tiles <= 0 || n_tiles_x <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ch) {
    case 3:
      splat_blend_fwd_kernel<3><<<n_tiles, P, 0, s>>>(
          gauss_idx, starts, ends, xys, conics, colors, opac, out, tfin,
          n_done, n_tiles_x);
      break;
    case 4:
      splat_blend_fwd_kernel<4><<<n_tiles, P, 0, s>>>(
          gauss_idx, starts, ends, xys, conics, colors, opac, out, tfin,
          n_done, n_tiles_x);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
