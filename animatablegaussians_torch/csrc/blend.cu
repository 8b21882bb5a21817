// Forward tile blend: front-to-back alpha compositing of each 16x16 tile's
// depth-sorted Gaussian list.
//
// Replaces: animatablegaussians_tpu/ops/rasterize/blend_pallas.py,
//   _fwd_chunk_kernel (ragged layout, via _fwd_chunks_pallas / blend_chunks)
//   and _fwd_kernel (rect layout, via _fwd_pallas / blend_tiles). Both read
//   one tile's depth-ordered list; here a tile is simply a [start, end)
//   range of the sorted pair list, so one kernel covers both layouts.
//
// What bounds it on an H100: issue rate of the per-pixel inner loop (one
// expf and ~20 FP32 operations per pixel per pair, for every pair of the
// tile up to the pixel's saturation) and, behind it, the dependent gather
// of each pair's 40-byte row by gid. Device-memory traffic is small: the
// rows of the 1.29M pairs of the full-width fixture are ~52 MB, read once
// per tile they touch.
//
// What the design does about it: one CTA of 256 threads per tile, one thread
// per pixel (the reference CUDA rasterizer's renderCUDA pattern). The CTA
// walks its tile's range in batches of 256 pairs: each thread gathers one
// pair's row into shared memory, then every thread composites the batch
// from shared memory, so a row is read from device memory once per tile
// and not once per pixel. The CTA stops as soon as every pixel is
// saturated (__syncthreads_count). The TPU kernel's 128-lane log-step
// cumprod/cumsum scans are not ported: a sequential loop per pixel computes
// the same transmittance. Kept simple on purpose; staging with cp.async or
// TMA and the tensor-core blend are later work.
//
// Semantics (blend_ref.py, blend_pallas.py:89-107): integer pixel
// coordinates with no +0.5; power = -1/2 (ca dx^2 + cc dy^2) - cb dx dy;
// skip when power > 0 or alpha < 1/255; alpha = min(0.99, op e^power); a
// Gaussian contributes only while the transmittance including it stays
// >= 1e-4; T_final is the last contributing transmittance, 1 for an empty
// tile.

#include <cuda_runtime.h>

#define TILE 16
#define BLOCK (TILE * TILE)
#define ROW 10  // packed row: x y ca cb cc op r g b depth

__global__ void __launch_bounds__(BLOCK)
blend_forward_kernel(const float* __restrict__ rows,
                     const int* __restrict__ gids,
                     const long long* __restrict__ starts, int grid_x,
                     int img_w, int img_h, float* __restrict__ color,
                     float* __restrict__ depth_out,
                     float* __restrict__ t_final) {
  __shared__ float sh[ROW][BLOCK];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (t % grid_x) * TILE + tid % TILE;
  const int py = (t / grid_x) * TILE + tid / TILE;
  const bool inside = px < img_w && py < img_h;
  const float pxf = (float)px, pyf = (float)py;
  const long long start = starts[t], end = starts[t + 1];

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  bool done = !inside;
  for (long long base = start; base < end; base += BLOCK) {
    // also the barrier that keeps the previous batch alive until read
    if (__syncthreads_count(done) == BLOCK) break;
    const long long k = base + tid;
    if (k < end) {
      const float* r = rows + (long long)gids[k] * ROW;
#pragma unroll
      for (int c = 0; c < ROW; ++c) sh[c][tid] = r[c];
    }
    __syncthreads();
    const int n = (int)min((long long)BLOCK, end - base);
    for (int j = 0; j < n && !done; ++j) {
      const float dx = sh[0][j] - pxf;
      const float dy = sh[1][j] - pyf;
      const float power =
          -0.5f * (sh[2][j] * dx * dx + sh[4][j] * dy * dy) -
          sh[3][j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(0.99f, sh[5][j] * expf(power));
      if (alpha < 1.0f / 255.0f) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < 1e-4f) {
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 += w * sh[6][j];
      c1 += w * sh[7][j];
      c2 += w * sh[8][j];
      dep += w * sh[9][j];
      T = test_t;
    }
  }
  if (inside) {
    const long long p = (long long)py * img_w + px;
    color[3 * p + 0] = c0;
    color[3 * p + 1] = c1;
    color[3 * p + 2] = c2;
    depth_out[p] = dep;
    t_final[p] = T;
  }
}

extern "C" int ag_blend_forward(const void* rows, const void* gids,
                                const void* starts, int grid_x, int grid_y,
                                int img_w, int img_h, void* color,
                                void* depth, void* t_final, void* stream) {
  const int n_tiles = grid_x * grid_y;
  if (n_tiles > 0) {
    blend_forward_kernel<<<n_tiles, BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const int*)gids, (const long long*)starts,
        grid_x, img_w, img_h, (float*)color, (float*)depth,
        (float*)t_final);
  }
  return (int)cudaGetLastError();
}
