// Pair expansion: one (tile, Gaussian) sort entry per tile a Gaussian's
// screen rectangle touches.
//
// Replaces: animatablegaussians_tpu/ops/rasterize/expand_pallas.py,
//   _expand_kernel (called through expand_pairs_pallas).
//
// What bounds it on an H100: device-memory writes. Every pair costs one
// 8-byte key and one 4-byte gid store (about 15 MB for the 1.29M pairs of
// the full-width fixture) against 28 bytes read per Gaussian; there is no
// arithmetic to speak of.
//
// What the design does about it: the work goes over slots, not Gaussians,
// so the stores are fully coalesced whatever the counts. A block owns a
// run of EXPAND_GAUSS consecutive Gaussians and therefore the consecutive
// slots [offs[g0], offs[g0 + EXPAND_GAUSS]); it stages their offsets, rects
// and depth bits in shared memory with coalesced loads, and its threads
// then walk those slots one a thread per step, neighbouring lanes on
// neighbouring slots (8-byte keys, 4-byte gids). A slot's owner is
// upper_bound(offs, s) - 1, found by a binary search in the staged
// offsets that starts from the thread's previous owner (a thread's slots
// only grow). The owner always has cnt > 0, because offs[i + 1] = offs[i] +
// cnt[i], so runs of zero-count Gaussians need no special case, and a
// Gaussian with many slots simply makes its block's walk longer. Lanes on
// neighbouring slots mostly share an owner, so the shared reads broadcast.
// The pair count is read on the host first and the outputs are sized to it
// exactly, so there are no caps, no sentinel rows and none of the 8-aligned
// windows the TPU kernel needed for Mosaic. The key is (tile << 32) |
// float_bits(depth): depth > 0.2 for every binned Gaussian, so its bits
// order like the floats, and a stable sort of keys laid out in ascending
// gid order breaks (tile, depth) ties by ascending gid, as the JAX
// package's two-key stable sort does (binning.py:282-298).
// tests/test_torch_rasterize.py emulates the blocks' search in numpy.

#include <cuda_runtime.h>
#include <stdint.h>

#define EXPAND_THREADS 256
#define EXPAND_GAUSS 256  // Gaussians a block owns

__global__ void __launch_bounds__(EXPAND_THREADS)
expand_pairs_kernel(const int4* __restrict__ rect,
                    const float* __restrict__ depth,
                    const long long* __restrict__ offs, int n, int grid_x,
                    long long* __restrict__ keys, int* __restrict__ gids) {
  __shared__ long long sh_offs[EXPAND_GAUSS + 1];
  __shared__ int4 sh_rect[EXPAND_GAUSS];  // (rx0, ry0, width, cnt)
  __shared__ unsigned sh_dbits[EXPAND_GAUSS];
  const int g0 = blockIdx.x * EXPAND_GAUSS;
  const int m = min(EXPAND_GAUSS, n - g0);
  for (int i = threadIdx.x; i <= m; i += EXPAND_THREADS)
    sh_offs[i] = offs[g0 + i];
  for (int i = threadIdx.x; i < m; i += EXPAND_THREADS) {
    sh_rect[i] = rect[g0 + i];
    sh_dbits[i] = __float_as_uint(depth[g0 + i]);
  }
  __syncthreads();
  const long long hi = sh_offs[m];
  int a = 0;  // sh_offs[a] <= s for every slot s this thread takes
  for (long long s = sh_offs[0] + threadIdx.x; s < hi; s += EXPAND_THREADS) {
    int b = m;  // sh_offs[b] > s
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (sh_offs[mid] <= s)
        a = mid;
      else
        b = mid;
    }
    const int4 r = sh_rect[a];
    const int d = (int)(s - sh_offs[a]);
    const int ty = r.y + d / r.z;
    const int tx = r.x + d % r.z;
    keys[s] = ((long long)(ty * grid_x + tx) << 32) | (long long)sh_dbits[a];
    gids[s] = g0 + a;
  }
}

extern "C" int ag_expand_pairs(const void* rect, const void* depth,
                               const void* offs, int n, int grid_x,
                               void* keys, void* gids, void* stream) {
  if (n > 0) {
    expand_pairs_kernel<<<(n + EXPAND_GAUSS - 1) / EXPAND_GAUSS,
                          EXPAND_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)rect, (const float*)depth, (const long long*)offs, n,
        grid_x, (long long*)keys, (int*)gids);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
