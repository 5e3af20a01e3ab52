// Splat-blend forward for Hopper (sm_90a) — kernel K1.
//
// Replaces (JAX package, Pallas on TPU): gaussctrl_tpu/ops/splat_blend.py
// blend_pallas → _blend_fwd_impl → _forward_call / _make_fwd_kernel: the
// front-to-back alpha blend of each 16×16 tile's depth-sorted instances.
// Per instance and pixel: σ = ½(a·dx² + c·dy²) + b·dx·dy,
// α = min(0.999, o·e^−σ), kept only if σ ≥ 0 and α ≥ 1/255; the
// transmittance T is an exact running product, the weight is
// w = α·T·[T > 1e-4]. Outputs: the per-pixel channel sums `acc` and final
// T (what K4 reads), and beside them the composited tiles acc + T·bg and
// alpha = 1 − T.
//
// What bounds it on the H100: about 30 fp32 operations per (instance,
// pixel) pair against 48 bytes read per instance, so the fp32 instruction
// rate of the CUDA cores (67 TFLOP/s), with a serial dependence along each
// pixel's list.
//
// Design: one block of 128 threads per tile, two neighbouring pixels of one
// row per thread, so the row's B·dy and C·dy² and every shared-memory read
// serve two pairs, and each thread carries two independent T chains. A
// pre-pass packs every gaussian into one 48-byte record
// (splat_blend_common.cuh: the conic folded with ½ and log2 e, so a pair
// takes one ex2.approx). The block walks its own [starts[t], ends[t]) range
// of the sorted gauss_idx in batches of 128: batch b + 1 is gathered by
// cp.async into the second of two shared buffers while batch b is blended,
// the gauss indices are loaded a batch earlier still, and each instance is
// read as three LDS.128 broadcasts. A warp skips an instance that none of
// its 64 pixels keeps (α = 0 leaves T and the sums as they are). Before
// each batch the block votes with __syncthreads_or and leaves once every
// pixel has T ≤ 1e-4; n_done counts the instances blended until then, in
// whole batches, and K4 replays exactly those.

#include "splat_blend_common.cuh"

namespace {

using namespace splat;

__global__ void pack_records_kernel(const float* __restrict__ xys,
                                    const float* __restrict__ conics,
                                    const float* __restrict__ colors,
                                    const float* __restrict__ opac,
                                    float4* __restrict__ rec, int n, int ch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < ch; ++k) c[k] = colors[(size_t)i * ch + k];
  const float* q = conics + 3 * (size_t)i;
  float4* r = rec + (size_t)REC4 * i;
  r[0] = make_float4(xys[2 * (size_t)i], xys[2 * (size_t)i + 1],
                     q[0] * (-0.5f * LOG2E), q[1] * -LOG2E);
  r[1] = make_float4(q[2] * (-0.5f * LOG2E), opac[i], c[0], c[1]);
  r[2] = make_float4(c[2], c[3], 0.f, 0.f);
}

template <int CH>
__global__ void __launch_bounds__(NT)
splat_blend_fwd_kernel(const int* __restrict__ gauss_idx,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const float4* __restrict__ rec,
                       const float* __restrict__ bg,
                       float* __restrict__ acc_out,
                       float* __restrict__ tiles_out,
                       float* __restrict__ alpha_out,
                       float* __restrict__ tfin_out,
                       int* __restrict__ n_done, int n_tiles_x) {
  __shared__ float4 buf[2][BATCH * REC4];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = tid / (TS / PPT), col = (tid % (TS / PPT)) * PPT;
  const float px = (float)((tile % n_tiles_x) * TS + col) + 0.5f;
  const float py = (float)((tile / n_tiles_x) * TS + row) + 0.5f;
  const int start = starts[tile], end = ends[tile];

  float T[PPT], acc[PPT][CH];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = 1.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[k][c] = 0.f;
  }

  stage_record(buf[0], rec, batch_index(gauss_idx, start, end, tid), tid);
  cp_async_commit();
  int gi_next = batch_index(gauss_idx, start + BATCH, end, tid);
  int done = 0;
  for (int b = 0, base = start; base < end; ++b, base += BATCH) {
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= T[k] > T_EPS;
    // also: every thread is done reading the buffer that is refilled next
    if (!__syncthreads_or(live)) break;
    stage_record(buf[(b + 1) & 1], rec, gi_next, tid);
    cp_async_commit();
    gi_next = batch_index(gauss_idx, base + 2 * BATCH, end, tid);
    cp_async_wait<1>();
    __syncthreads();

    const float4* s = buf[b & 1];
    const int n = min(BATCH, end - base);
    for (int j = 0; j < n; ++j) {
      const float4 r0 = s[REC4 * j], r1 = s[REC4 * j + 1], r2 = s[REC4 * j + 2];
      const float cj[4] = {r1.z, r1.w, r2.x, r2.y};
      const float dy = r0.y - py;
      const float Bdy = row_bdy(r0.w, dy), Cdy2 = row_cdy2(r1.x, dy);
      Step st[PPT];
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        st[k] = blend_step(r0.z, r1.y, r0.x - (px + (float)k), Bdy, Cdy2);
        any |= st[k].keep;
      }
      if (!__any_sync(FULL, any)) continue;  // α = 0 at all 64 pixels
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (T[k] > T_EPS) {
          const float w = __fmul_rn(st[k].alpha, T[k]);
#pragma unroll
          for (int c = 0; c < CH; ++c) acc[k][c] = __fmaf_rn(w, cj[c], acc[k][c]);
        }
        T[k] = next_t(T[k], st[k].alpha);
      }
    }
    done += n;
  }
  cp_async_wait<0>();  // no copy in flight when the block leaves

  static_assert(PPT == 2, "T and alpha are stored as one float2 a thread");
  const size_t p0 = (size_t)tile * P + row * TS + col;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      acc_out[(p0 + k) * CH + c] = acc[k][c];
      tiles_out[(p0 + k) * CH + c] = __fmaf_rn(T[k], bg[c], acc[k][c]);
    }
  }
  *reinterpret_cast<float2*>(tfin_out + p0) = make_float2(T[0], T[1]);
  *reinterpret_cast<float2*>(alpha_out + p0) =
      make_float2(1.f - T[0], 1.f - T[1]);
  if (tid == 0) n_done[tile] = done;
}

template <int CH>
void launch_fwd(const int* gauss_idx, const int* starts, const int* ends,
                const float4* rec, const float* bg,
                float* acc, float* tiles, float* alpha, float* tfin,
                int* n_done, int n_tiles, int n_tiles_x, cudaStream_t s) {
  splat_blend_fwd_kernel<CH><<<n_tiles, NT, 0, s>>>(
      gauss_idx, starts, ends, rec, bg, acc, tiles, alpha, tfin,
      n_done, n_tiles_x);
}

}  // namespace

// Packs the records (into `rec`, [n, 12] float32), then blends every tile.
extern "C" int gc_splat_blend_fwd(const int* gauss_idx, const int* starts,
                                  const int* ends, const float* xys,
                                  const float* conics, const float* colors,
                                  const float* opac,
                                  const float* bg, float* rec, float* acc,
                                  float* tiles, float* alpha, float* tfin,
                                  int* n_done, int n, int n_tiles,
                                  int n_tiles_x, int ch, void* stream) {
  if (n_tiles <= 0 || n_tiles_x <= 0 || n < 0 || (ch != 3 && ch != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float4* r = reinterpret_cast<float4*>(rec);
  if (n > 0)
    pack_records_kernel<<<(n + 255) / 256, 256, 0, s>>>(xys, conics, colors,
                                                        opac, r, n, ch);
  if (ch == 3)
    launch_fwd<3>(gauss_idx, starts, ends, r, bg, acc, tiles, alpha,
                  tfin, n_done, n_tiles, n_tiles_x, s);
  else
    launch_fwd<4>(gauss_idx, starts, ends, r, bg, acc, tiles, alpha,
                  tfin, n_done, n_tiles, n_tiles_x, s);
  return (int)cudaGetLastError();
}

// Registers, static shared memory, local memory (bytes) and resident blocks
// per SM of K1's instantiation for `ch`, into out[0..3].
extern "C" int gc_splat_blend_fwd_attrs(int ch, int* out) {
  const void* fn = ch == 3 ? (const void*)splat_blend_fwd_kernel<3>
                           : (const void*)splat_blend_fwd_kernel<4>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  return (int)e;
}
