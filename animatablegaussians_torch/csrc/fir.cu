// Separable up-FIR-down resampling (upfirdn2d) of an NCHW float32 tensor:
// zero-stuff by `up`, pad (negative pads crop), convolve with the outer
// product of a vertical and a horizontal tap vector (each at most 4 taps),
// keep every `down`-th sample; up and down are 1 or 2.
//
// Replaces: animatablegaussians_tpu/ops/fir_pallas.py, _vhfir_kernel (the
//   fused vertical + horizontal body that _pallas_core launches through
//   pl.pallas_call, and that the upfirdn2d_pallas custom VJP launches again
//   on the cotangent). _vfir_kernel and _hfir_kernel are never launched
//   there and have no counterpart here.
//
// Math (fir_pallas.py:115-153,180-200): a true convolution, so the taps are
// used reversed (the C entry reverses them once). For output o and tap m of
// an axis, the zero-stuffed coordinate is u = o * down + m - pad0; it
// contributes tap * x[u / up] when u >= 0, u % up == 0 and u / up < n, and
// nothing otherwise (the zero padding, the stuffed zeros and the crop of a
// negative pad all fall out of that one test). As in the TPU kernel, the
// vertical taps are summed first, for each horizontal tap's input column,
// and the horizontal sum of those follows, in float32, in tap order. Built
// with -fmad=false, each product and sum rounds as the plain PyTorch
// version's (ops/fir.py: upfirdn2d_fir_plain) element-wise ops do.
//
// What bounds it on an H100: device-memory traffic. At most 16 multiply-adds
// per output element against 8 bytes moved per element (one read of the
// input, one write of the output): ~2 operations per byte, far below the
// card's ~20 FP32 operations per byte of HBM. The largest call on the
// render path, 64 channels at 513^2 -> 512^2, moves ~135 MB (~0.04 ms at
// 3.35 TB/s).
//
// What the design does about it: little yet. One thread per output column
// and row of a 32 x 8 tile, one block per (tile, image plane); up and down
// are template parameters, so the phase tests and the index arithmetic
// compile to shifts and masks. A thread works out its up to 4 input rows
// and columns once; consecutive threads take consecutive output columns,
// so the stores coalesce and the up to 16 reads of a warp fall on a few
// rows that L1 serves after the first touch. The taps travel as launch
// arguments, not device memory. Staging the block's input rows in shared
// memory, and several outputs per thread, are later work.

#include <cuda_runtime.h>

#define MAX_TAPS 4
#define TX 32
#define TY 8
#define MAX_PLANES 65535  // gridDim.z limit; planes beyond it loop

struct Taps {
  float v[MAX_TAPS];  // vertical taps, reversed (zero past nv)
  float h[MAX_TAPS];  // horizontal taps, reversed (zero past nh)
  int nv, nh;
};

// input index of tap m at output o along one axis, or -1 for a zero
template <int UP, int DOWN>
__device__ __forceinline__ int tap_index(int o, int m, int pad0, int n) {
  const int u = o * DOWN + m - pad0;
  if (u < 0 || u % UP != 0 || u / UP >= n) return -1;
  return u / UP;
}

template <int UP, int DOWN>
__global__ void __launch_bounds__(TX * TY)
fir_kernel(const float* __restrict__ x, float* __restrict__ out, int planes,
           int H, int W, int OH, int OW, int px0, int py0, Taps k) {
  const int ox = blockIdx.x * TX + threadIdx.x;
  const int oy = blockIdx.y * TY + threadIdx.y;
  if (ox >= OW || oy >= OH) return;
  int rows[MAX_TAPS], cols[MAX_TAPS];
#pragma unroll
  for (int t = 0; t < MAX_TAPS; ++t) {
    rows[t] = t < k.nv ? tap_index<UP, DOWN>(oy, t, py0, H) : -1;
    cols[t] = t < k.nh ? tap_index<UP, DOWN>(ox, t, px0, W) : -1;
  }
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    const float* xp = x + (long long)p * H * W;
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < MAX_TAPS; ++m) {
      if (cols[m] < 0) continue;
      float vs = 0.0f;
#pragma unroll
      for (int t = 0; t < MAX_TAPS; ++t) {
        if (rows[t] >= 0) vs = vs + xp[rows[t] * W + cols[m]] * k.v[t];
      }
      acc = acc + vs * k.h[m];
    }
    out[((long long)p * OH + oy) * OW + ox] = acc;
  }
}

extern "C" int ag_upfirdn2d_fir(const void* x, void* out, int N, int C, int H,
                                int W, int OH, int OW, int up, int down,
                                int px0, int py0, int nv, int nh, float v0,
                                float v1, float v2, float v3, float h0,
                                float h1, float h2, float h3, void* stream) {
  if (nv < 1 || nv > MAX_TAPS || nh < 1 || nh > MAX_TAPS || up < 1 ||
      up > 2 || down < 1 || down > 2 || OH < 1 || OW < 1)
    return (int)cudaErrorInvalidValue;
  const float v[MAX_TAPS] = {v0, v1, v2, v3};
  const float h[MAX_TAPS] = {h0, h1, h2, h3};
  Taps k = {};
  k.nv = nv;
  k.nh = nh;
  for (int t = 0; t < nv; ++t) k.v[t] = v[nv - 1 - t];
  for (int m = 0; m < nh; ++m) k.h[m] = h[nh - 1 - m];
  const int planes = N * C;
  if (planes > 0) {
    const dim3 block(TX, TY);
    const dim3 grid((OW + TX - 1) / TX, (OH + TY - 1) / TY,
                    planes < MAX_PLANES ? planes : MAX_PLANES);
    cudaStream_t s = (cudaStream_t)stream;
    const float* xi = (const float*)x;
    float* o = (float*)out;
    if (up == 1 && down == 1)
      fir_kernel<1, 1><<<grid, block, 0, s>>>(xi, o, planes, H, W, OH, OW,
                                               px0, py0, k);
    else if (up == 1)
      fir_kernel<1, 2><<<grid, block, 0, s>>>(xi, o, planes, H, W, OH, OW,
                                               px0, py0, k);
    else if (down == 1)
      fir_kernel<2, 1><<<grid, block, 0, s>>>(xi, o, planes, H, W, OH, OW,
                                               px0, py0, k);
    else
      fir_kernel<2, 2><<<grid, block, 0, s>>>(xi, o, planes, H, W, OH, OW,
                                               px0, py0, k);
  }
  return (int)cudaGetLastError();
}
