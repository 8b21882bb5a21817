// Backward tile blend: the vector-Jacobian product of the forward blend
// (blend.cu) with respect to the packed per-Gaussian rows, scatter-added
// into grad_rows (N, 10).
//
// Replaces: animatablegaussians_tpu/ops/rasterize/blend_pallas.py,
//   _bwd_kernel (rect layout, via _bwd_pallas / the blend_tiles custom_vjp)
//   and _bwd_chunk_kernel (ragged layout, via _bwd_chunks_pallas / the
//   blend_chunks custom_vjp), together with the scatter-add of per-slot
//   gradients back to rows that follows them (api.py _sc_bwd and
//   _gtc_bwd). As in the forward, a tile is a [start, end) range of the
//   sorted pair list, so one kernel covers both layouts.
//
// Math (blend_pallas.py:189-240, jax.grad semantics of blend_ref.py): walk
// each pixel's list front to back, recomputing the transmittance T (the
// exclusive product) and the inclusive prefixes of w c over the four
// channels (r g b depth). For a contributing pair, with totals tot_c, final
// transmittance T_f and cotangents g_c, g_T:
//   suffix_c = tot_c - prefix_c                   (sum over later pairs)
//   galpha   = T sum_c c_c g_c - sum_c suffix_c g_c / (1 - alpha)
//              - g_T T_f / (1 - alpha)
// zeroed where op G >= 0.99 (the clamp gate: jax.grad of the minimum; the
// original CUDA rasterizer ignores it, this follows JAX). Then
//   d/dop = galpha G, gpower = galpha op G, d/dx = -gpower (ca dx + cb dy),
//   d/dy = -gpower (cc dy + cb dx), d/dca = -dx^2 gpower / 2,
//   d/dcb = -dx dy gpower, d/dcc = -dy^2 gpower / 2, d/dc = w g_c.
// Non-contributing pairs (skipped, or at and past the 1e-4 cutoff) get 0.
//
// What bounds it on an H100: issue rate of the per-pixel inner loop (one
// expf, two divisions and ~90 FP32 operations per pixel per pair up to the
// pixel's cutoff) and the reduction of ten per-pair sums over the tile's
// pixels; device-memory traffic is small (40-byte rows read once per tile,
// five image planes of totals and five of cotangents read once, 40 bytes
// written per Gaussian by atomics).
//
// What the design does about it: the forward kernel's layout. One CTA of
// 256 threads per tile, one thread per pixel, walking the tile's range in
// batches of 256 pairs staged in shared memory (row and gid), stopping when
// every pixel is past its cutoff (__syncthreads_count) and, inside a batch,
// when every pixel of a warp is (__all_sync). The TPU kernels emitted a
// (16, K) gradient block per tile that XLA then scatter-added to rows; here
// each warp reduces its 32 pixels' ten terms with shuffles and adds them to
// grad_rows[gid] with one atomicAdd per channel, so the scatter needs no
// second pass and no per-slot buffer. A warp with no contributing pixel for
// a pair skips the reduction. The order of the atomic sums varies from run
// to run, so results vary by float32 rounding. Kept simple on purpose: a
// CTA-wide reduction before the atomics, and a persistent schedule, are
// later work.

#include <cuda_runtime.h>

#define TILE 16
#define BLOCK (TILE * TILE)
#define ROW 10  // packed row: x y ca cb cc op r g b depth
#define FULL_MASK 0xffffffffu

__global__ void __launch_bounds__(BLOCK)
blend_backward_kernel(const float* __restrict__ rows,
                      const int* __restrict__ gids,
                      const long long* __restrict__ starts, int grid_x,
                      int img_w, int img_h, const float* __restrict__ color,
                      const float* __restrict__ depth,
                      const float* __restrict__ t_final,
                      const float* __restrict__ g_color,
                      const float* __restrict__ g_depth,
                      const float* __restrict__ g_tfinal,
                      float* __restrict__ grad_rows) {
  __shared__ float sh[ROW][BLOCK];
  __shared__ int sh_gid[BLOCK];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int px = (t % grid_x) * TILE + tid % TILE;
  const int py = (t / grid_x) * TILE + tid / TILE;
  const bool inside = px < img_w && py < img_h;
  const float pxf = (float)px, pyf = (float)py;
  const long long start = starts[t], end = starts[t + 1];

  // per-pixel totals and cotangents; pixels past the image edge read
  // nothing and take no part (done from the start, zero terms)
  float tot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float gout[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tfin = 1.0f, g_t = 0.0f;
  if (inside) {
    const long long p = (long long)py * img_w + px;
    tot[0] = color[3 * p + 0];
    tot[1] = color[3 * p + 1];
    tot[2] = color[3 * p + 2];
    tot[3] = depth[p];
    tfin = t_final[p];
    gout[0] = g_color[3 * p + 0];
    gout[1] = g_color[3 * p + 1];
    gout[2] = g_color[3 * p + 2];
    gout[3] = g_depth[p];
    g_t = g_tfinal[p];
  }

  float T = 1.0f;
  float prefix[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool done = !inside;
  for (long long base = start; base < end; base += BLOCK) {
    // also the barrier that keeps the previous batch alive until read
    if (__syncthreads_count(done) == BLOCK) break;
    const long long k = base + tid;
    if (k < end) {
      const int gi = gids[k];
      sh_gid[tid] = gi;
      const float* r = rows + (long long)gi * ROW;
#pragma unroll
      for (int c = 0; c < ROW; ++c) sh[c][tid] = r[c];
    }
    __syncthreads();
    const int n = (int)min((long long)BLOCK, end - base);
    for (int j = 0; j < n; ++j) {
      if (__all_sync(FULL_MASK, done)) break;  // warp-uniform
      float v[ROW];
#pragma unroll
      for (int c = 0; c < ROW; ++c) v[c] = 0.0f;
      bool contrib = false;
      if (!done) {
        const float dx = sh[0][j] - pxf;
        const float dy = sh[1][j] - pyf;
        const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
        const float op = sh[5][j];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) -
                            cb * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha_raw = op * G;
          const float alpha = fminf(0.99f, alpha_raw);
          if (alpha >= 1.0f / 255.0f) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < 1e-4f) {
              done = true;
            } else {
              contrib = true;
              const float w = alpha * T;
              const float one_minus = 1.0f - alpha;
              float direct = 0.0f, suffix_dot = 0.0f;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float ck = sh[6 + c][j];
                prefix[c] += w * ck;
                direct += ck * gout[c];
                suffix_dot += (tot[c] - prefix[c]) * gout[c];
              }
              float galpha = T * direct - suffix_dot / one_minus -
                             g_t * tfin / one_minus;
              if (alpha_raw >= 0.99f) galpha = 0.0f;  // the clamp gate
              const float gpower = galpha * op * G;
              v[0] = -gpower * (ca * dx + cb * dy);
              v[1] = -gpower * (cc * dy + cb * dx);
              v[2] = -0.5f * dx * dx * gpower;
              v[3] = -dx * dy * gpower;
              v[4] = -0.5f * dy * dy * gpower;
              v[5] = galpha * G;
#pragma unroll
              for (int c = 0; c < 4; ++c) v[6 + c] = w * gout[c];
              T = test_t;
            }
          }
        }
      }
      if (__any_sync(FULL_MASK, contrib)) {
        float* dst = grad_rows + (long long)sh_gid[j] * ROW;
#pragma unroll
        for (int c = 0; c < ROW; ++c) {
          float s = v[c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_down_sync(FULL_MASK, s, off);
          if (lane == 0) atomicAdd(dst + c, s);
        }
      }
    }
  }
}

extern "C" int ag_blend_backward(const void* rows, const void* gids,
                                 const void* starts, int grid_x, int grid_y,
                                 int img_w, int img_h, const void* color,
                                 const void* depth, const void* t_final,
                                 const void* g_color, const void* g_depth,
                                 const void* g_tfinal, void* grad_rows,
                                 void* stream) {
  const int n_tiles = grid_x * grid_y;
  if (n_tiles > 0) {
    blend_backward_kernel<<<n_tiles, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const int*)gids, (const long long*)starts,
        grid_x, img_w, img_h, (const float*)color, (const float*)depth,
        (const float*)t_final, (const float*)g_color, (const float*)g_depth,
        (const float*)g_tfinal, (float*)grad_rows);
  }
  return (int)cudaGetLastError();
}
