// Forward tile blend: front-to-back alpha compositing of each 16x16 tile's
// depth-sorted Gaussian list.
//
// Replaces: animatablegaussians_tpu/ops/rasterize/blend_pallas.py,
//   _fwd_chunk_kernel (ragged layout, via _fwd_chunks_pallas / blend_chunks)
//   and _fwd_kernel (rect layout, via _fwd_pallas / blend_tiles). Both read
//   one tile's depth-ordered list; here a tile is simply a [start, end)
//   range of the sorted pair list, so one kernel covers both layouts.
//
// Semantics (blend_ref.py, blend_pallas.py:89-107): integer pixel
// coordinates with no +0.5; power = -1/2 (ca dx^2 + cc dy^2) - cb dx dy;
// skip when power > 0 or alpha < 1/255; alpha = min(0.99, op e^power); a
// Gaussian contributes only while the transmittance including it stays
// >= 1e-4; T_final is the last contributing transmittance, 1 for an empty
// tile.
//
// What bounds it on an H100: the instruction rate of the per-pixel walk
// (one expf and ~20 FP32 operations per evaluated (pixel, pair)). A tile's
// pairs are binned by a 3-sigma square, so a pixel that evaluates every
// pair of its tile finds only a few percent of them inside the footprint
// where alpha reaches 1/255; device-memory traffic (40-byte rows, 4-byte
// gids, five output planes) is small beside that walk.
//
// What the design does about it:
// - A cull box per pair. The pixels where a pair can pass both tests lie in
//   the ellipse d^T Q d <= 2 tau, tau = ln(255 op), Q = [[ca, cb], [cb, cc]];
//   its bounding box has half-widths sqrt(2 tau cc / det) in x and
//   sqrt(2 tau ca / det) in y (det = ca cc - cb^2). The box carries a margin
//   that covers float32 rounding (cull_box, below): a pair is culled for a
//   pixel only where the blend's tests would skip it, so the output is bit for
//   bit that of a walk over every pair.
// - A warp per 8x4 pixel rectangle: lane l takes pixel (l % 8, l / 8) of its
//   warp's rectangle, warp w the rectangle at ((w % 2) 8, (w / 2) 4). Per
//   batch of 256 pairs each lane tests 8 pairs' boxes against its warp's
//   rectangle; __ballot_sync makes that a 256-bit mask, whose set bits the
//   warp walks in ascending order (__ffs), so the order stays front to back
//   and the loop is the same for every lane. The step has no branch: every
//   lane computes the pair and keeps or drops it with selects (a divergent
//   `continue` per test was slower on an H100), and the per-pixel
//   arithmetic and its rounding stay those of the plain loop. A
//   warp whose pixels are all saturated skips its walk and keeps joining
//   the barriers; the CTA stops when all of its pixels are
//   (__syncthreads_count).
// - Heaviest tiles first, empty tiles last: a one-block pre-pass orders the
//   tiles by pair count (buckets of 8 pairs, warp-aggregated shared
//   atomics), and CTA b blends the b-th tile of that order, so the long
//   tiles start in the first wave and the tail is short. An empty tile's CTA
//   only writes colour 0, depth 0 and T_final 1; those CTAs run beside the
//   busy ones. Two alternatives measured no better on an H100: persistent
//   CTAs claiming tiles through an atomic counter (slower), and CTAs that
//   each fill a run of empty tiles (no change).
// - The gather overlaps the walk: rows are staged by cp.async in two stages
//   (a row is 40 bytes at 40 gid, 8-byte aligned: five 8-byte copies), so
//   batch b + 1's rows arrive while batch b is walked, and the gid of batch
//   b + 2 is loaded into a register one batch ahead. The staging thread of
//   a pair computes its box once its own copies have landed.
// Kept as they were: expf (not __expf), the sequential front-to-back
// transmittance per pixel, the 1e-4 stop, the CTA's saturation exit.
// Not done: TC-GS's tensor-core blend (PAPERS.md). Forming power as a TF32
// or bf16 matrix product rounds it unlike the plain version: alpha >= 1/255
// decisions would flip and the ATOL_BLEND = 1e-5 parity would not hold.
//
// Why the box is safe (cull_box). Write u = 2^-24 and M = ca dx^2 + cc dy^2
// + 2 |cb dx dy|. With -fmad=false, power is computed as 5 rounded products
// and 2 rounded sums from dx = x - px (itself rounded), so |power_f -
// (-q/2)| <= 3 u M to first order, q = d^T Q d exact. |Q| (cb -> |cb|) has
// Q's eigenvalues, so M <= lmax |d|^2 and q >= lmin |d|^2: M <= kappa q
// with kappa = lmax / lmin. A pixel passes only if op (x) expf(power_f) >=
// 1/255 in float32; expf is within 2 ulp and G <= 1 + 2^-22 for power <= 0,
// so power_f >= -tau - 4e-7. Hence q (1 - 6 u kappa) <= 2 (tau + 4e-7). The
// box takes tau_m = tau_f (1 + 2^-16) + 2^-16 (logf is within 1 ulp) and
// T = tau_m (1 + 2^-18 kappa_f): 2^-18 = 64 u covers the 6 u kappa of
// power, the 4 u kappa of the rounded det (ca cc <= lmax^2 = kappa det),
// the few roundings of the half-width and kappa_f against kappa. The box
// edges x -+ hx are rounded too, so each is moved out by 2^-20 (|x| + hx +
// 1) more. The argument needs finite, bounded values: |x|, |y| <= 2^24 and
// ca, cc, |cb| <= 2^40 keep every product of power finite for a pixel
// below 2^24, det >= 1e-30 keeps det out of the subnormals, and kappa_f <=
// 1e4 keeps 6 u kappa under 4e-3. A pair that fails any of these gets an
// infinite box (never culled), as does a NaN or infinite op, since
// fminf(0.99, NaN) passes. A finite op below (1/255)(1 - 1e-5) can never
// pass: its box is empty. tests/test_torch_rasterize.py emulates the box
// and the warp walk in numpy (adversarial pairs included).

#include <cuda_runtime.h>

#define TILE 16
#define BLOCK (TILE * TILE)
#define BATCH 256  // pairs staged per batch, one per thread
#define ROW 10     // packed row: x y ca cb cc op r g b depth
#define WARP_W 8   // a warp's pixel rectangle
#define WARP_H 4
#define FULL_MASK 0xffffffffu
#define ORDER_THREADS 1024
#define ORDER_BUCKETS 256  // bucket 255: empty tiles; 254 - c / 8: others

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the youngest has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void stage_row(float* dst, const float* rows,
                                          int gid) {
  const float* src = rows + (long long)gid * ROW;
#pragma unroll
  for (int c = 0; c < ROW; c += 2) cp_async8(dst + c, src + c);
}

// (x0, x1, y0, y1): outside it the pair fails power <= 0 and alpha >=
// 1/255 at every pixel (the argument is in the note above)
__device__ __forceinline__ float4 cull_box(const float* r) {
  const float x = r[0], y = r[1], ca = r[2], cb = r[3], cc = r[4], op = r[5];
  const float inf = __int_as_float(0x7f800000);
  const float4 never = make_float4(-inf, inf, -inf, inf);
  const float big = 1099511627776.0f;  // 2^40
  // comparisons with NaN are false, so NaN lands here too
  if (!(fabsf(x) <= 16777216.0f && fabsf(y) <= 16777216.0f && ca > 0.0f &&
        ca <= big && cc > 0.0f && cc <= big && fabsf(cb) <= big &&
        fabsf(op) <= 3.4028234e38f))
    return never;
  if (op < (1.0f / 255.0f) * 0.99999f)
    return make_float4(inf, -inf, inf, -inf);  // empty: culled everywhere
  const float det = ca * cc - cb * cb;
  if (!(det >= 1e-30f)) return never;
  const float hd = 0.5f * (ca - cc);
  const float lmax = 0.5f * (ca + cc) + sqrtf(hd * hd + cb * cb);
  const float kappa = lmax * lmax / det;
  if (!(kappa <= 1e4f)) return never;
  const float tau = logf(255.0f * op);
  const float tau_m = fmaxf(tau * (1.0f + 0x1p-16f) + 0x1p-16f, 0.0f);
  const float t2 = 2.0f * tau_m * (1.0f + 0x1p-18f * kappa);
  const float hx = sqrtf(t2 * cc / det);
  const float hy = sqrtf(t2 * ca / det);
  const float sx = (fabsf(x) + hx + 1.0f) * 0x1p-20f;
  const float sy = (fabsf(y) + hy + 1.0f) * 0x1p-20f;
  return make_float4(x - hx - sx, x + hx + sx, y - hy - sy, y + hy + sy);
}

__device__ __forceinline__ int order_bucket(const long long* starts, int t) {
  const long long c = starts[t + 1] - starts[t];
  return c == 0 ? ORDER_BUCKETS - 1
                : ORDER_BUCKETS - 2 -
                      (int)min(c >> 3, (long long)(ORDER_BUCKETS - 2));
}

// order[0:n_tiles]: every tile once, by descending pair count in buckets of
// 8, empty tiles last. One block; lanes of a warp that share a bucket add
// to it with one shared atomic.
__global__ void __launch_bounds__(ORDER_THREADS)
tile_order_kernel(const long long* __restrict__ starts, int n_tiles,
                  int* __restrict__ order) {
  __shared__ int hist[ORDER_BUCKETS];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < ORDER_BUCKETS; i += ORDER_THREADS) hist[i] = 0;
  __syncthreads();
  const int rounds = (n_tiles + ORDER_THREADS - 1) / ORDER_THREADS;
  for (int r = 0; r < rounds; ++r) {
    const int t = r * ORDER_THREADS + tid;
    const int b = t < n_tiles ? order_bucket(starts, t) : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, b);
    if (b >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[b], __popc(peers));
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan: 8 buckets a lane, then across lanes
    const int per = ORDER_BUCKETS / 32;
    int v[per], sum = 0;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      v[i] = sum;
      sum += hist[tid * per + i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += up;
    }
#pragma unroll
    for (int i = 0; i < per; ++i) hist[tid * per + i] = v[i] + incl - sum;
  }
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    const int t = r * ORDER_THREADS + tid;
    const int b = t < n_tiles ? order_bucket(starts, t) : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, b);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (b >= 0 && lane == leader) base = atomicAdd(&hist[b], __popc(peers));
    base = __shfl_sync(FULL_MASK, base, leader);
    if (b >= 0) order[base + __popc(peers & ((1u << lane) - 1u))] = t;
  }
}

__global__ void __launch_bounds__(BLOCK)
blend_forward_kernel(const float* __restrict__ rows,
                     const int* __restrict__ gids,
                     const long long* __restrict__ starts,
                     const int* __restrict__ order, int grid_x, int img_w,
                     int img_h, float* __restrict__ color,
                     float* __restrict__ depth_out,
                     float* __restrict__ t_final) {
  __shared__ __align__(16) float sh_row[2][BATCH][ROW];
  __shared__ float4 sh_box[BATCH];
  const int t = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rx0 = (t % grid_x) * TILE + (warp & 1) * WARP_W;
  const int ry0 = (t / grid_x) * TILE + (warp >> 1) * WARP_H;
  const int px = rx0 + lane % WARP_W;
  const int py = ry0 + lane / WARP_W;
  const bool inside = px < img_w && py < img_h;
  const float pxf = (float)px, pyf = (float)py;
  const float wx0 = (float)rx0, wx1 = (float)(rx0 + WARP_W - 1);
  const float wy0 = (float)ry0, wy1 = (float)(ry0 + WARP_H - 1);
  const long long start = starts[t], end = starts[t + 1];

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  bool done = !inside;
  if (start < end) {  // the same for the whole CTA
    const long long k0 = start + tid;
    if (k0 < end) stage_row(sh_row[0][tid], rows, gids[k0]);
    cp_async_commit();
    int g_next = k0 + BATCH < end ? gids[k0 + BATCH] : 0;
    int s = 0;
    for (long long base = start; base < end; base += BATCH, s ^= 1) {
      // also the barrier after which stage s ^ 1 and the boxes are free
      if (__syncthreads_count(done) == BLOCK) break;
      const long long kn = base + BATCH + tid;
      if (kn < end) stage_row(sh_row[s ^ 1][tid], rows, g_next);
      cp_async_commit();  // possibly empty, so one group is always younger
      if (kn + BATCH < end) g_next = gids[kn + BATCH];
      cp_async_wait_prev();  // this thread's rows of batch b have landed
      const int n = (int)min((long long)BATCH, end - base);
      if (tid < n) sh_box[tid] = cull_box(sh_row[s][tid]);
      __syncthreads();
      if (__all_sync(FULL_MASK, done)) continue;  // warp-uniform
      for (int i = 0; i < n; i += 32) {           // warp-uniform
        const int j = i + lane;
        bool hit = false;
        if (j < n) {
          const float4 b = sh_box[j];
          hit = !(b.y < wx0 || b.x > wx1 || b.w < wy0 || b.z > wy1);
        }
        unsigned m = __ballot_sync(FULL_MASK, hit);
        while (m) {
          const float* r = sh_row[s][i + __ffs(m) - 1];
          m &= m - 1;
          const float2 xy = *reinterpret_cast<const float2*>(r);
          const float2 ab = *reinterpret_cast<const float2*>(r + 2);
          const float2 co = *reinterpret_cast<const float2*>(r + 4);
          const float2 rg = *reinterpret_cast<const float2*>(r + 6);
          const float2 bz = *reinterpret_cast<const float2*>(r + 8);
          const float dx = xy.x - pxf;
          const float dy = xy.y - pyf;
          const float power =
              -0.5f * (ab.x * dx * dx + co.x * dy * dy) - ab.y * dx * dy;
          const float alpha = fminf(0.99f, co.y * expf(power));
          const float test_t = T * (1.0f - alpha);
          const bool ok = !done && power <= 0.0f && alpha >= 1.0f / 255.0f;
          // test_t is finite (alpha <= 0.99), so this is !(test_t < 1e-4f)
          const bool use = ok && test_t >= 1e-4f;
          done = done || (ok && !use);
          const float w = alpha * T;
          c0 = use ? c0 + w * rg.x : c0;
          c1 = use ? c1 + w * rg.y : c1;
          c2 = use ? c2 + w * bz.x : c2;
          dep = use ? dep + w * bz.y : dep;
          T = use ? test_t : T;
        }
        if (__all_sync(FULL_MASK, done)) break;
      }
    }
    cp_async_wait_all();  // no copy may land after the CTA has exited
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

// rows must be 8-byte aligned (the wrapper sees to it); order is scratch
// of grid_x * grid_y ints
extern "C" int ag_blend_forward(const void* rows, const void* gids,
                                const void* starts, void* order, int grid_x,
                                int grid_y, int img_w, int img_h, void* color,
                                void* depth, void* t_final, void* stream) {
  const int n_tiles = grid_x * grid_y;
  if (n_tiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    tile_order_kernel<<<1, ORDER_THREADS, 0, st>>>(
        (const long long*)starts, n_tiles, (int*)order);
    blend_forward_kernel<<<n_tiles, BLOCK, 0, st>>>(
        (const float*)rows, (const int*)gids, (const long long*)starts,
        (const int*)order, grid_x, img_w, img_h, (float*)color,
        (float*)depth, (float*)t_final);
  }
  return (int)cudaGetLastError();
}
