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
// written per Gaussian by atomics). With the design below the walk itself
// is most of the time, the reduction the smaller part.
//
// What the design does about it: the forward kernel's layout, with the
// reduction over pixels done inside the CTA. One CTA of 256 threads per
// tile, one thread per pixel, walking the tile's range in batches of 128
// pairs staged in shared memory (row and gid), stopping when every pixel is
// past its cutoff (__syncthreads_count) and, inside a batch, when every
// pixel of a warp is (__all_sync). The TPU kernels emitted a (16, K)
// gradient block per tile that XLA then scatter-added to rows; here the
// scatter is folded into the kernel in two steps:
// - per pair, a warp with a contributing pixel reduce-scatters its lanes'
//   ten terms (padded to 16) with a butterfly of xor shuffles: 8 + 4 + 2 +
//   1 exchanges leave lanes 2c and 2c + 1 with the sum of channel c over
//   the warp's pixels, and one more adds them, 16 shuffles in all where
//   ten full shuffle chains took 50; the sums go to the warp's slots of a
//   shared (warp, pair, channel) buffer, zeroed at the batch's start, so a
//   warp with nothing to add writes nothing;
// - after the batch, each (pair, channel) of it sums its 8 warps' slots in
//   warp order and adds a non-zero sum to grad_rows[gid] with one
//   atomicAdd: 8x fewer atomics than one per warp, and none from the
//   warps that did not contribute.
// The order of the atomic sums across tiles still varies from run to run,
// so results vary by float32 rounding. The buffer (40 KB) and the staged
// rows fit the 48 KB of static shared memory, so four CTAs share an SM.

#include <cuda_runtime.h>

#define TILE 16
#define BLOCK (TILE * TILE)
#define WARPS (BLOCK / 32)
#define BATCH 128  // pairs staged per batch
#define ROW 10     // packed row: x y ca cb cc op r g b depth
#define FULL_MASK 0xffffffffu

// One step of the butterfly: lanes with bit O set keep the upper N/2 of
// their N partial sums, the others the lower half, each adding its xor
// partner's copy of the half it keeps.
template <int N, int O>
__device__ __forceinline__ void scatter_step(float (&a)[16], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? a[i] : a[i + N / 2];
    const float keep = upper ? a[i + N / 2] : a[i];
    a[i] = keep + __shfl_xor_sync(FULL_MASK, send, O);
  }
}

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
  __shared__ float sh[ROW][BATCH];
  __shared__ int sh_gid[BATCH];
  // per (warp, pair, channel) sums of the batch, zero where a warp added
  // nothing
  __shared__ __align__(16) float red[WARPS][BATCH * ROW];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
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
  for (long long base = start; base < end; base += BATCH) {
    // also the barrier that keeps the previous batch's rows and sums alive
    // until its reduction has read them
    if (__syncthreads_count(done) == BLOCK) break;
    const long long k = base + tid;
    if (tid < BATCH && k < end) {
      const int gi = gids[k];
      sh_gid[tid] = gi;
      const float* r = rows + (long long)gi * ROW;
#pragma unroll
      for (int c = 0; c < ROW; ++c) sh[c][tid] = r[c];
    }
    float4* red4 = reinterpret_cast<float4*>(&red[0][0]);
    for (int i = tid; i < WARPS * BATCH * ROW / 4; i += BLOCK)
      red4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const int n = (int)min((long long)BATCH, end - base);
    for (int j = 0; j < n; ++j) {
      if (__all_sync(FULL_MASK, done)) break;  // warp-uniform
      float v[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) v[c] = 0.0f;
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
        scatter_step<16, 16>(v, lane);
        scatter_step<8, 8>(v, lane);
        scatter_step<4, 4>(v, lane);
        scatter_step<2, 2>(v, lane);
        v[0] += __shfl_xor_sync(FULL_MASK, v[0], 1);
        const int ch = lane >> 1;  // the channel lanes 2ch, 2ch + 1 hold
        if ((lane & 1) == 0 && ch < ROW) red[warp][j * ROW + ch] = v[0];
      }
    }
    __syncthreads();
    // one atomic per (pair, channel) of the batch, its warps summed in order
    for (int i = tid; i < n * ROW; i += BLOCK) {
      float s = red[0][i];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += red[w][i];
      if (s != 0.0f)
        atomicAdd(grad_rows + (long long)sh_gid[i / ROW] * ROW + i % ROW, s);
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
