// Splat-blend backward for Hopper (sm_90a) — kernel K4.
//
// Replaces (JAX package, Pallas on TPU): gaussctrl_tpu/ops/splat_blend.py
// _blend_bwd → _backward_call / _make_bwd_kernel: the VJP of the
// front-to-back alpha blend (K1) as one row per sorted instance,
// [xy(2), conic(3), colour(ch), opacity(1)], which splat/rasterize.py then
// sums per gaussian (reduce_by_slot). For out_p = Σ_i w_i c_i + T_fin·bg,
// w_i = α_i T_i m_i, m_i = [T_i > 1e-4]:
//   ∂L/∂α_i = (g·c_i) T_i m_i − [S_i + (g·bg − g_A)·T_fin] / (1 − α_i),
//   S_i = Σ_{j>i} (g·c_j) w_j = Q − Σ_{j≤i} (g·c_j) w_j,  Q = g·acc,
// gated to α_raw < 0.999 where α is kept; σ, e^−σ and the chain to
// (x, y, a, b, c, opacity) as in _make_bwd_kernel.
//
// What bounds it on the H100: the fp32 instruction rate of the CUDA cores
// (67 TFLOP/s), about 76 operations per (instance, pixel) pair, and the sum
// of each instance's values over the tile's 256 pixels.
//
// Design: one block of 128 threads per tile, two neighbouring pixels of one
// row per thread, with the records, staging and alpha/transmittance step of
// K1 (splat_blend_common.cuh). The transmittance cannot be recovered by
// division in a reverse sweep (K1 keeps multiplying after a pixel saturates,
// so T_fin underflows toward 0 on dense tiles), so the kernel replays the
// forward once over exactly the n_done[t] instances K1 blended, taking the
// per-pixel Q = g·acc and T_fin from K1's outputs: the same step on the
// same records gives the same T chain and mask, so Q and the running prefix
// describe the same weights. Per pair a thread accumulates, over its two
// pixels, the moments Σ gα·dx, Σ gα·dx² and Σ gα (gα = ∂L/∂α·α; dy is the
// row's), the colour and opacity terms; that gives the D = 6 + ch values
// from which the row follows (the conic terms are moments of gα, the xy
// terms the conic times them). A warp sums its D values with a
// reduce-scatter butterfly (at each of the five xor levels a lane keeps
// half of its values and sends the other half: 5+3+2+1+1 = 12 shuffles for
// D = 9 or 10), skipped when no pixel of the warp keeps the instance, and
// leaves them in shared memory; after each batch thread j sums the four
// warps' partials of instance j in warp order and writes its row once.
// Rows of [start + n_done, end) are written as zeros, so the caller need not
// clear the buffer. Each instance belongs to exactly one tile: there are no
// atomics, and two calls give the same bits.

#include "splat_blend_common.cuh"

namespace {

using namespace splat;

template <int N, int MASK>
__device__ __forceinline__ void rs_level(const float (&in)[N],
                                         float (&out)[(N + 1) / 2], bool up) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float lo = in[k];
    const float hi = k + H < N ? in[k + H] : 0.f;
    out[k] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, MASK);
  }
}

// The warp's total of one of the D values (which one: warp_slot), by a
// reduce-scatter over the 32 lanes.
template <int D>
__device__ __forceinline__ float warp_reduce_scatter(const float (&v)[D],
                                                     int lane) {
  constexpr int N1 = (D + 1) / 2, N2 = (N1 + 1) / 2, N3 = (N2 + 1) / 2;
  static_assert((N3 + 1) / 2 == 1, "five levels hold at most 16 values");
  float a[N1], b[N2], c[N3], d[1];
  rs_level<D, 16>(v, a, lane & 16);
  rs_level<N1, 8>(a, b, lane & 8);
  rs_level<N2, 4>(b, c, lane & 4);
  rs_level<N3, 2>(c, d, lane & 2);
  return d[0] + __shfl_xor_sync(FULL, d[0], 1);
}

// Which value warp_reduce_scatter leaves in `lane`, or -1 where it holds
// padding or its even neighbour holds the same value.
template <int D>
__device__ __forceinline__ int warp_slot(int lane) {
  int slot = 0, n = D, len = D;
#pragma unroll
  for (int mask = 16; mask >= 2; mask >>= 1) {
    const int h = (len + 1) / 2;
    if (lane & mask) {
      slot += h;
      n = max(0, n - h);
    } else {
      n = min(n, h);
    }
    len = h;
  }
  return n == 1 && !(lane & 1) ? slot : -1;
}

template <int CH>
__global__ void __launch_bounds__(NT)
splat_blend_bwd_kernel(const int* __restrict__ gauss_idx,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const int* __restrict__ n_done,
                       const float4* __restrict__ rec,
                       const float* __restrict__ acc,
                       const float* __restrict__ tfin,
                       const float* __restrict__ g_tiles,
                       const float* __restrict__ g_alpha,
                       const float* __restrict__ bg,
                       float* __restrict__ rows, int n_tiles_x) {
  constexpr int D = 6 + CH;
  constexpr int DP = D | 1;  // odd stride: the epilogue reads without conflicts
  __shared__ float4 buf[2][BATCH * REC4];
  __shared__ float part[WARPS][BATCH][DP];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = tid / (TS / PPT), col = (tid % (TS / PPT)) * PPT;
  const float px = (float)((tile % n_tiles_x) * TS + col) + 0.5f;
  const float py = (float)((tile / n_tiles_x) * TS + row) + 0.5f;
  const int start = starts[tile], end = ends[tile];
  const int stop = start + n_done[tile];
  const int slot = warp_slot<D>(lane);

  // per pixel: the cotangent, Q = g·acc over K1's sums, the T_fin term
  float go[PPT][CH], Q[PPT], gterm[PPT], T[PPT], pre[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t p = (size_t)tile * P + row * TS + col + k;
    float q = 0.f, gbg = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      go[k][c] = g_tiles[p * CH + c];
      q += go[k][c] * acc[p * CH + c];
      gbg += go[k][c] * bg[c];
    }
    Q[k] = q;
    gterm[k] = (gbg - g_alpha[p]) * tfin[p];
    T[k] = 1.f;
    pre[k] = 0.f;
  }

  stage_record(buf[0], rec, batch_index(gauss_idx, start, stop, tid), tid);
  cp_async_commit();
  int gi_next = batch_index(gauss_idx, start + BATCH, stop, tid);
  for (int b = 0, base = start; base < stop; ++b, base += BATCH) {
    // the last batch's blend and rows are done with `part` and the buffer
    // refilled next
    __syncthreads();
    stage_record(buf[(b + 1) & 1], rec, gi_next, tid);
    cp_async_commit();
    gi_next = batch_index(gauss_idx, base + 2 * BATCH, stop, tid);
    cp_async_wait<1>();
    __syncthreads();

    const float4* s = buf[b & 1];
    const int n = min(BATCH, stop - base);
    for (int j = 0; j < n; ++j) {
      const float4 r0 = s[REC4 * j], r1 = s[REC4 * j + 1], r2 = s[REC4 * j + 2];
      const float cj[4] = {r1.z, r1.w, r2.x, r2.y};
      const float dy = r0.y - py;
      const float Bdy = row_bdy(r0.w, dy), Cdy2 = row_cdy2(r1.x, dy);
      Step st[PPT];
      float dx[PPT];
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        dx[k] = r0.x - (px + (float)k);
        st[k] = blend_step(r0.z, r1.y, dx[k], Bdy, Cdy2);
        any |= st[k].keep;
      }
      if (!__any_sync(FULL, any)) {  // every term is zero at all 64 pixels
        if (slot >= 0) part[warp][j][slot] = 0.f;
        continue;
      }
      // this thread's sums: Σ gα, Σ gα·dx, Σ gα·dx², colour, opacity
      float h = 0.f, hx = 0.f, hxx = 0.f, op = 0.f, colr[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) colr[c] = 0.f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float alpha = st[k].alpha;
        float gc = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) gc = __fmaf_rn(go[k][c], cj[c], gc);
        const bool m = T[k] > T_EPS;
        const float w = m ? __fmul_rn(alpha, T[k]) : 0.f;
        pre[k] += gc * w;
        if (st[k].keep && st[k].araw < ALPHA_MAX) {
          const float ga = (m ? gc * T[k] : 0.f) -
                           __fdividef(Q[k] - pre[k] + gterm[k], 1.f - alpha);
          const float gal = ga * alpha;
          h += gal;
          hx = fmaf(gal, dx[k], hx);
          hxx = fmaf(gal * dx[k], dx[k], hxx);
          op = fmaf(ga, st[k].e2, op);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) colr[c] = fmaf(w, go[k][c], colr[c]);
        T[k] = next_t(T[k], alpha);
      }
      float v[D];
      v[0] = hx;            // Σ gα·dx
      v[1] = h * dy;        // Σ gα·dy
      v[2] = hxx;           // Σ gα·dx²
      v[3] = hx * dy;       // Σ gα·dx·dy
      v[4] = h * dy * dy;   // Σ gα·dy²
#pragma unroll
      for (int c = 0; c < CH; ++c) v[5 + c] = colr[c];
      v[5 + CH] = op;
      const float tot = warp_reduce_scatter<D>(v, lane);
      if (slot >= 0) part[warp][j][slot] = tot;
    }
    __syncthreads();

    // thread j: instance j's row. With g_σ = −gα and the folded conic
    // (a, b, c) = −ln 2·(2A, B, 2C): xy = Σ g_σ·(a·dx + b·dy, c·dy + b·dx),
    // conic = Σ g_σ·(½dx², dx·dy, ½dy²).
    if (tid < n) {
      float m[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float t = part[0][tid][k];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) t += part[w][tid][k];
        m[k] = t;
      }
      const float4 r0 = s[REC4 * tid];
      const float A = r0.z, B = r0.w, C = s[REC4 * tid + 1].x;
      float* out = rows + (size_t)(base + tid) * D;
      out[0] = LN2 * (2.f * A * m[0] + B * m[1]);
      out[1] = LN2 * (2.f * C * m[1] + B * m[0]);
      out[2] = -0.5f * m[2];
      out[3] = -m[3];
      out[4] = -0.5f * m[4];
#pragma unroll
      for (int k = 5; k < D; ++k) out[k] = m[k];
    }
  }
  cp_async_wait<0>();

  // the instances K1 did not blend: zero rows
  float* z = rows + (size_t)stop * D;
  const size_t count = (size_t)(end - stop) * D;
  for (size_t i = tid; i < count; i += NT) z[i] = 0.f;
}

template <int CH>
void launch_bwd(const int* gauss_idx, const int* starts, const int* ends,
                const int* n_done, const float4* rec, const float* acc,
                const float* tfin, const float* g_tiles, const float* g_alpha,
                const float* bg, float* rows, int n_tiles, int n_tiles_x,
                cudaStream_t s) {
  splat_blend_bwd_kernel<CH><<<n_tiles, NT, 0, s>>>(
      gauss_idx, starts, ends, n_done, rec, acc, tfin, g_tiles, g_alpha, bg,
      rows, n_tiles_x);
}

}  // namespace

// `rec` is K1's packed records.
extern "C" int gc_splat_blend_bwd(const int* gauss_idx, const int* starts,
                                  const int* ends, const int* n_done,
                                  const float* rec, const float* acc,
                                  const float* tfin, const float* g_tiles,
                                  const float* g_alpha, const float* bg,
                                  float* rows, int n_tiles, int n_tiles_x,
                                  int ch, void* stream) {
  if (n_tiles <= 0 || n_tiles_x <= 0 || (ch != 3 && ch != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float4* r = reinterpret_cast<const float4*>(rec);
  if (ch == 3)
    launch_bwd<3>(gauss_idx, starts, ends, n_done, r, acc, tfin, g_tiles,
                  g_alpha, bg, rows, n_tiles, n_tiles_x, s);
  else
    launch_bwd<4>(gauss_idx, starts, ends, n_done, r, acc, tfin, g_tiles,
                  g_alpha, bg, rows, n_tiles, n_tiles_x, s);
  return (int)cudaGetLastError();
}

// Registers, static shared memory, local memory (bytes) and resident blocks
// per SM of K4's instantiation for `ch`, into out[0..3].
extern "C" int gc_splat_blend_bwd_attrs(int ch, int* out) {
  const void* fn = ch == 3 ? (const void*)splat_blend_bwd_kernel<3>
                           : (const void*)splat_blend_bwd_kernel<4>;
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
