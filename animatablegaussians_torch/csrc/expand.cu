// Pair expansion: one (tile, Gaussian) sort entry per tile a Gaussian's
// screen rectangle touches.
//
// Replaces: animatablegaussians_tpu/ops/rasterize/expand_pallas.py,
//   _expand_kernel (called through expand_pairs_pallas).
//
// What bounds it on an H100: device-memory writes. Every pair costs one
// 8-byte key and one 4-byte gid store (about 15 MB for the 1.29M pairs of
// the full-width fixture) against 24 bytes read per Gaussian; there is no
// arithmetic to speak of.
//
// What the design does about it: one thread per Gaussian writes its `cnt`
// slots contiguously at its exclusive-cumsum offset, so each thread's
// stores are sequential and neighbouring threads write neighbouring runs.
// The pair count is read on the host first and the outputs are sized to
// it exactly, so there are no caps, no sentinel rows and none of the
// 8-aligned windows the TPU kernel needed for Mosaic. The key is
// (tile << 32) | float_bits(depth): depth > 0.2 for every binned Gaussian,
// so its bits order like the floats, and a stable sort of keys laid out in
// ascending gid order breaks (tile, depth) ties by ascending gid, as the
// JAX package's two-key stable sort does (binning.py:282-298).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void expand_pairs_kernel(const int4* __restrict__ rect,
                                    const float* __restrict__ depth,
                                    const long long* __restrict__ offs,
                                    int n, int grid_x,
                                    long long* __restrict__ keys,
                                    int* __restrict__ gids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int4 r = rect[i];  // (rx0, ry0, width, cnt)
  const long long o = offs[i];
  const long long dbits = (long long)__float_as_uint(depth[i]);
  for (int d = 0; d < r.w; ++d) {
    const int ty = r.y + d / r.z;
    const int tx = r.x + d % r.z;
    keys[o + d] = ((long long)(ty * grid_x + tx) << 32) | dbits;
    gids[o + d] = i;
  }
}

extern "C" int ag_expand_pairs(const void* rect, const void* depth,
                               const void* offs, int n, int grid_x,
                               void* keys, void* gids, void* stream) {
  if (n > 0) {
    const int threads = 256;
    expand_pairs_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (const int4*)rect, (const float*)depth, (const long long*)offs, n,
        grid_x, (long long*)keys, (int*)gids);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ag_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
