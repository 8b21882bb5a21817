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
// used reversed (the C entry reverses them once). Along an axis, output o
// and tap m read the zero-stuffed coordinate u = o * down + m - pad0, which
// holds x[u / up] when u % up == 0 and 0 <= u / up < n, and zero otherwise.
// Rounding is the plain version's (ops/fir.py: upfirdn2d_fir_plain) term
// for term: that version stuffs and pads with zeros and adds them as
// terms, vertical taps first over every input column, then horizontal taps
// over those sums, in tap order, the first term taken as the sum; built
// with -fmad=false, each product and sum here rounds as its element-wise
// ops do, so the two are bitwise equal (signed zeros included).
//
// What bounds it on an H100: device-memory traffic for the large maps (at
// most 16 multiply-adds per output against one input read and one output
// write, ~2 FP32 operations per byte; the largest call of a render, 64
// planes of 513^2 -> 512^2, moves 134.5 MB, ~0.040 ms at 3.35 TB/s), and
// launch latency plus the host's wrapper for the many small calls (bounds
// of 0.0001-0.005 ms).
//
// What the design does about it:
// - A block of 256 threads owns a 64 x 16 output tile and walks several
//   image planes: as many as make about four waves of resident blocks on
//   the 132 SMs (the launch reads the SM count and the kernel's occupancy
//   once). Four waves, not one: the tiles at a ragged edge (maps of 2^k + 1
//   rows and columns) finish early, and with one wave their SMs then idle.
// - The input window the tile's taps reach, rows and columns through the
//   stuffing and the stride, is copied into shared memory with cp.async
//   (16 bytes a thread where the rows are 16-byte aligned, else 4), zero-
//   filled outside the image, in two stages: the next plane's window is in
//   flight while the block computes the current one.
// - A vertical pass writes one sum per (output row, input column) into a
//   second shared buffer; a thread covers 8 rows of a column and loads the
//   window rows they reach once into registers. A horizontal pass reads the
//   sums with 8- or 16-byte loads. Each vertical sum is computed once, not
//   once per output column.
// - A thread makes 4 consecutive outputs of one row and stores them as one
//   float4 where the rows are 16-byte aligned, else as 4 floats (staging
//   those through shared memory, for a warp to store 32 consecutive
//   floats, was slower on the whole on the H100). A tile at the ragged
//   edge computes only the rows and columns its outputs need.
// - At up = 2 the stuffed zeros are never loaded: the phase of each
//   (output, tap) is known when the thread's code is compiled (the tile's
//   phase is a template argument), so only the taps that meet a real sample
//   read one, and the stuffed ones are a constant 0 term, as in the plain
//   version.
// - The host side is one call with four arguments: the shape, pads and taps
//   travel in a parameter block the wrapper builds once per call shape.

#include <cuda_runtime.h>

#include <cstdint>

#define MAX_TAPS 4
#define TW 64   // output tile width
#define TH 16   // output tile height
#define NT 256  // threads: TW / 4 quads x TH rows
#define RB 8    // output rows a thread's vertical pass covers
#define MAX_GRID_Z 65535
#define WAVES 4  // grid waves: short blocks at ragged edges balance out

// What the wrapper passes (ops/fir.py: _Params), taps in call order.
struct FirParams {
  int n, c, h, w, oh, ow, up, down, px0, py0, nv, nh;
  float v[MAX_TAPS], hz[MAX_TAPS];
};

struct Taps {
  float v[MAX_TAPS];  // vertical taps, reversed
  float h[MAX_TAPS];  // horizontal taps, reversed
  int nv, nh;
};

// Shapes of the shared buffers for one (up, down).
template <int UP, int DOWN>
struct Geo {
  // vertical sums between the spans of two neighbouring threads of a row
  static constexpr int STEP = 4 * DOWN / UP;
  static constexpr int VEC = STEP < 4 ? STEP : 4;  // floats a load reads
  // vertical sums one thread's 4 outputs read, rounded up to whole loads
  static constexpr int NEED = (3 * DOWN + MAX_TAPS - 1 + UP - 1) / UP + 1;
  static constexpr int SPAN = (NEED + VEC - 1) / VEC * VEC;
  static constexpr int VS_W = (TW / 4 - 1) * STEP + SPAN;
  // input columns: the vertical sums' plus the 16-byte alignment of the
  // window's first column (up to 3 more)
  static constexpr int WIN_W = (VS_W + 3 + 3) / 4 * 4;
  static constexpr int WIN_H =
      ((TH - 1) * DOWN + MAX_TAPS - 1 + UP - 1) / UP + 1;
  static constexpr int WIN = WIN_H * WIN_W;  // floats a stage holds
  // two windows and the vertical sums, within the 48 KB a launch gets
  // without opting in
  static constexpr int SMEM_BYTES = (2 * WIN + TH * VS_W) * 4;
  static_assert(SMEM_BYTES <= 48 * 1024, "shared memory per block");
};

template <int UP>
__device__ __forceinline__ int floor_div(int a) {
  return UP == 1 ? a : (a >> 1);  // arithmetic shift: floor for a < 0
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool inside) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(inside ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool inside) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(inside ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group (the youngest) is in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The vertical pass of one thread: the sums of RB consecutive output rows
// (from r0, a multiple of RB; the first nrows of them are kept) over one
// window column, from the window rows they reach, loaded once into
// registers. col points at the column's first window row, dst at vs[r0][c].
// PH is the tile's phase at up = 2, as in the horizontal pass.
template <int UP, int DOWN, int PH, int WIN_W, int VS_W>
__device__ __forceinline__ void vertical(const float* col, int r0, int nrows,
                                         const Taps& k, float* dst) {
  constexpr int NR = (PH + (RB - 1) * DOWN + MAX_TAPS - 1) / UP + 1;
  col += r0 * DOWN / UP * WIN_W;  // RB * DOWN is a multiple of UP
  float xr[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) xr[i] = col[i * WIN_W];
#pragma unroll
  for (int rl = 0; rl < RB; ++rl) {
    if (rl < nrows) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < MAX_TAPS; ++t) {
        if (t < k.nv) {
          const int u = PH + rl * DOWN + t;
          const float xv =
              UP == 1 ? xr[u] : ((u & 1) ? 0.0f : xr[u >> 1]);  // stuffed: 0
          const float term = xv * k.v[t];
          acc = t == 0 ? term : acc + term;
        }
      }
      dst[rl * VS_W] = acc;
    }
  }
}

// The horizontal pass of one thread: 4 outputs of row r from the vertical
// sums a[] it loaded (a[i] is the sum at column STEP * q + i). PH is the
// tile's phase at up = 2 (the parity of its first stuffed coordinate).
template <int UP, int DOWN, int PH>
__device__ __forceinline__ void horizontal(const float* a, const Taps& k,
                                           float* o) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < MAX_TAPS; ++m) {
      if (m < k.nh) {
        const int u = PH + j * DOWN + m;
        const float xv =
            UP == 1 ? a[u] : ((u & 1) ? 0.0f : a[u >> 1]);  // stuffed: 0
        const float term = xv * k.h[m];
        acc = m == 0 ? term : acc + term;
      }
    }
    o[j] = acc;
  }
}

template <int UP, int DOWN, bool VEC16>
__global__ void __launch_bounds__(NT)
fir_kernel(const float* __restrict__ x, float* __restrict__ out, int planes,
           int H, int W, int OH, int OW, int px0, int py0, bool vec_out,
           Taps k) {
  using G = Geo<UP, DOWN>;
  // two input windows, then the vertical sums
  extern __shared__ __align__(16) float smem[];
  float(*win)[G::WIN_H][G::WIN_W] =
      reinterpret_cast<float(*)[G::WIN_H][G::WIN_W]>(smem);
  float(*vs)[G::VS_W] =
      reinterpret_cast<float(*)[G::VS_W]>(smem + 2 * G::WIN);
  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;
  // first stuffed coordinate of the tile on each axis, and the first input
  // row and column the window holds
  const int ulx = ox0 * DOWN - px0, uly = oy0 * DOWN - py0;
  const int fx = floor_div<UP>(ulx), fy = floor_div<UP>(uly);
  const int phx = ulx - fx * UP, phy = uly - fy * UP;
  const int cbase = fx & ~3;  // 16-byte aligned first column
  const int offx = fx - cbase;
  const long long in_plane = (long long)H * W, out_plane = (long long)OH * OW;
  // a tile at the ragged edge computes only the rows and vertical-sum
  // columns its outputs read
  const int rows_t = min(TH, OH - oy0);
  const int cols_t =
      min(G::VS_W, (phx + (min(TW, OW - ox0) - 1) * DOWN + MAX_TAPS - 1) / UP +
                       1);

  auto prefetch = [&](int p, int s) {
    const float* xp = x + p * in_plane;
    if (VEC16) {
      constexpr int CPR = G::WIN_W / 4;
      for (int i = tid; i < G::WIN_H * CPR; i += NT) {
        const int row = i / CPR, c4 = i - row * CPR;
        const int iy = fy + row, ix = cbase + 4 * c4;
        const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
        cp_async16(&win[s][row][4 * c4], in ? xp + iy * W + ix : xp, in);
      }
    } else {
      for (int i = tid; i < G::WIN_H * G::WIN_W; i += NT) {
        const int row = i / G::WIN_W, col = i - row * G::WIN_W;
        const int iy = fy + row, ix = cbase + col;
        const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
        cp_async4(&win[s][row][col], in ? xp + iy * W + ix : xp, in);
      }
    }
  };

  int p = blockIdx.z;
  if (p >= planes) return;
  const int dz = gridDim.z;
  prefetch(p, 0);
  cp_async_commit();
  for (int s = 0; p < planes; p += dz, s ^= 1) {
    // the next plane's window into the stage the previous plane used
    if (p + dz < planes) prefetch(p + dz, s ^ 1);
    cp_async_commit();  // possibly empty, so one group is always younger
    cp_async_wait_prev();
    __syncthreads();  // this plane's window is in; vs is free again

    // vertical pass: vs[r][c] over input column fx + c, a thread for RB
    // rows of a column; a column outside the image is the plain version's
    // zero padding of the vertical result
    for (int i = tid; i < (TH / RB) * G::VS_W; i += NT) {
      const int g = i / G::VS_W, c = i - g * G::VS_W;
      const int r0 = g * RB, nrows = min(RB, rows_t - r0);
      if (c >= cols_t || nrows <= 0) continue;
      const int ix = fx + c;
      if (ix < 0 || ix >= W) {
        for (int rl = 0; rl < nrows; ++rl) vs[r0 + rl][c] = 0.0f;
      } else if (UP == 2 && phy) {
        vertical<UP, DOWN, 1, G::WIN_W, G::VS_W>(&win[s][0][c + offx], r0,
                                                 nrows, k, &vs[r0][c]);
      } else {
        vertical<UP, DOWN, 0, G::WIN_W, G::VS_W>(&win[s][0][c + offx], r0,
                                                 nrows, k, &vs[r0][c]);
      }
    }
    __syncthreads();  // vs is complete; the window's stage may be refilled

    // horizontal pass: 4 consecutive outputs of one row per thread
    const int q = tid % (TW / 4), r = tid / (TW / 4);
    const int oy = oy0 + r, ox = ox0 + 4 * q;
    if (oy < OH && ox < OW) {
      float a[G::SPAN];
      const float* src = &vs[r][q * G::STEP];
#pragma unroll
      for (int i = 0; i < G::SPAN; i += G::VEC) {
        if (G::VEC == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(src + i);
          a[i] = t4.x, a[i + 1] = t4.y, a[i + 2] = t4.z, a[i + 3] = t4.w;
        } else {
          const float2 t2 = *reinterpret_cast<const float2*>(src + i);
          a[i] = t2.x, a[i + 1] = t2.y;
        }
      }
      float o[4];
      if (UP == 2 && phx)
        horizontal<UP, DOWN, 1>(a, k, o);
      else
        horizontal<UP, DOWN, 0>(a, k, o);
      float* dst = out + p * out_plane + (long long)oy * OW + ox;
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ox + j < OW) dst[j] = o[j];
      }
    }
  }
}

template <int UP, int DOWN, bool VEC16>
static int launch(const float* x, float* out, const FirParams& prm,
                  const Taps& k, cudaStream_t stream) {
  using G = Geo<UP, DOWN>;
  auto kernel = fir_kernel<UP, DOWN, VEC16>;
  // blocks the card holds at once for this instance, read once
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                  G::SMEM_BYTES);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int planes = prm.n * prm.c;
  const int tx = (prm.ow + TW - 1) / TW, ty = (prm.oh + TH - 1) / TH;
  // planes a block walks: the fewest that keep the grid within WAVES waves
  // of resident blocks
  const long long work = (long long)tx * ty * planes;
  const long long per = (work + WAVES * resident - 1) / (WAVES * resident);
  long long zb = (planes + per - 1) / per;
  if (zb > MAX_GRID_Z) zb = MAX_GRID_Z;
  const bool vec_out =
      prm.ow % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  kernel<<<dim3(tx, ty, (unsigned)zb), NT, G::SMEM_BYTES, stream>>>(
      x, out, planes, prm.h, prm.w, prm.oh, prm.ow, prm.px0, prm.py0, vec_out,
      k);
  return (int)cudaGetLastError();
}

template <int UP, int DOWN>
static int launch_aligned(const float* x, float* out, const FirParams& prm,
                          const Taps& k, cudaStream_t stream) {
  const bool vec16 =
      prm.w % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  return vec16 ? launch<UP, DOWN, true>(x, out, prm, k, stream)
               : launch<UP, DOWN, false>(x, out, prm, k, stream);
}

extern "C" int ag_upfirdn2d_fir(const void* x, void* out, const void* params,
                                void* stream) {
  const FirParams& prm = *(const FirParams*)params;
  if (prm.nv < 1 || prm.nv > MAX_TAPS || prm.nh < 1 || prm.nh > MAX_TAPS ||
      prm.up < 1 || prm.up > 2 || prm.down < 1 || prm.down > 2 || prm.oh < 1 ||
      prm.ow < 1 || prm.oh > MAX_GRID_Z * TH)
    return (int)cudaErrorInvalidValue;
  Taps k = {};
  k.nv = prm.nv;
  k.nh = prm.nh;
  for (int t = 0; t < prm.nv; ++t) k.v[t] = prm.v[prm.nv - 1 - t];
  for (int m = 0; m < prm.nh; ++m) k.h[m] = prm.hz[prm.nh - 1 - m];
  if (prm.n * prm.c == 0) return (int)cudaGetLastError();
  const float* xi = (const float*)x;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (prm.up == 1 && prm.down == 1)
    return launch_aligned<1, 1>(xi, o, prm, k, s);
  if (prm.up == 1) return launch_aligned<1, 2>(xi, o, prm, k, s);
  if (prm.down == 1) return launch_aligned<2, 1>(xi, o, prm, k, s);
  return launch_aligned<2, 2>(xi, o, prm, k, s);
}
