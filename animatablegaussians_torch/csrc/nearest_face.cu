// Nearest face: for each query point, the face of a triangle mesh whose
// closest point is nearest, that distance and the closest point's
// barycentric weights, by brute force over every (point, face) pair.
//
// Replaces no Pallas kernel: the JAX package computes the search in plain
// jnp (animatablegaussians_tpu/ops/geometry3d.py, nearest_face). Its
// counterpart is the published code's CUDA extension (utils/
// posevocab_custom_ops/nearest_face.py:30-61, point_mesh.h:41-73). It was
// added because the plain PyTorch version (ops/geometry3d.py:
// nearest_face_plain) writes some thirty float32 intermediates of every
// pair to device memory and reads them back, ~100 launches a chunk of 2^25
// pairs: 1.57e9 pairs a template step took ~680 ms at ~1.4 KB a pair.
//
// What bounds it on an H100: FP32 operations. A pair needs no memory at
// all, and the benchmark counts 48 operations a pair (portbench/yardstick/
// template_work.py): a template step's 1.57e9 pairs are ~1.1 ms at 67
// TFLOP/s. Matching the plain version's rounding costs more than that
// count: the closest point is formed in the plain version's order, with
// no contraction and two correctly rounded divisions (each a reciprocal,
// its Newton steps and a check that branches to a slow path): well over
// a hundred instructions a pair.
//
// What the design does about it:
// - A thread holds one point in registers; a block of NF_THREADS points
//   walks the faces in tiles of NF_TILE, staged in shared memory (a, b, c,
//   b - a, c - a: 15 floats in four float4, read by all lanes at once as a
//   broadcast). Each pair is evaluated in registers, and a thread keeps
//   only its best (distance, face) so far: nothing of a pair reaches
//   device memory.
// - The (point block, face tile) pairs are cut into one contiguous range
//   per resident block (the SM count times the kernel's occupancy, read
//   once), so every SM gets the same number of tiles whatever the counts:
//   65,536 points against 20,908 faces (256 point blocks, 82 tiles), the
//   hands' 1,552 faces (7 tiles), or a 128^3 grid's 2.1M points. A range
//   that ends inside a point block leaves that block's points to another
//   range; the ranges merge through a 64-bit atomicMin per point and range.
// - The merge key is (d2 bits + 1) << 32 | face, with 0 in the high half
//   for a NaN distance. For d2 >= +0 the bits order as the values, and at
//   equal d2 the lower face wins: torch.argmin's rule, NaN first included
//   (its LessOrNan). So the result does not depend on how the ranges are
//   cut or in which order the atomics land.
// - Of the seven regions (vertex A, B, C, edge AB, AC, BC, the interior;
//   the first true one wins, as in the plain version) a pair divides
//   twice: v's quotient (the interior's or edge AB's) and w's (the
//   interior's, edge AC's or edge BC's), each the first true region's
//   that has one. The numerators and denominators are picked before the
//   divisions, so each is clamped once and the regions cost selects, not
//   branches; the vertices' constant weights are picked after. Picking a region's
//   numerator and denominator in one chain of selects, constants 0 / 1
//   included, took 12.4 ms against 7.4 for the body's search (H100).
// - A last pass recomputes the winning face's weights with the same code
//   and writes sqrt(d2), the index and (1 - v - w, v, w).
//
// Rounding: built with -fmad=false, each product, sum and difference here
// rounds as the plain version's element-wise ops do. Its torch.sum over a
// contiguous last dimension of 3 runs, on the card, as a reduce block two
// lanes wide: lane 0 adds elements 0 and 2, lane 1 element 1, each from a
// +0 accumulator, and one shuffle adds the lanes; sum3 below repeats that
// ((x0 + x2) + x1, then + 0 so that a -0 result reads +0). torch.clamp(x,
// min=eps) keeps a NaN; the divisions and the square root are IEEE. The
// kernel and the plain version agree bit for bit on the card
// (tests/test_torch_nearest_face.py's gpu tests).

#include <cuda_runtime.h>
#include <stdint.h>

#define NF_THREADS 256  // points a block, one a thread
#define NF_TILE 256     // faces a shared-memory tile: one a thread to stage

// the plain version's torch.clamp(..., min=1e-12), rounded as its scalar is
#define NF_EPS ((float)1e-12)

struct FaceTile {
  float4 q[4];  // (ax, ay, az, abx) (aby, abz, acx, acy) (acz, bx, by, bz)
                // (cx, cy, cz, 0)
};

__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return ((x0 + x2) + x1) + 0.0f;
}

__device__ __forceinline__ float clamp_eps(float x) {
  return x < NF_EPS ? NF_EPS : x;  // NaN stays NaN
}

// Barycentric (v, w) of the closest point of face f to p, and its squared
// distance; ops/geometry3d.py's _closest_vw and nearest_face_plain's
// closest point, op for op.
__device__ __forceinline__ float closest_vw(float px, float py, float pz,
                                            const FaceTile& f, float& v,
                                            float& w) {
  const float ax = f.q[0].x, ay = f.q[0].y, az = f.q[0].z;
  const float abx = f.q[0].w, aby = f.q[1].x, abz = f.q[1].y;
  const float acx = f.q[1].z, acy = f.q[1].w, acz = f.q[2].x;
  const float bx = f.q[2].y, by = f.q[2].z, bz = f.q[2].w;
  const float cx = f.q[3].x, cy = f.q[3].y, cz = f.q[3].z;

  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float d1 = sum3(abx * apx, aby * apy, abz * apz);
  const float d2 = sum3(acx * apx, acy * apy, acz * apz);
  const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
  const float d3 = sum3(abx * bpx, aby * bpy, abz * bpz);
  const float d4 = sum3(acx * bpx, acy * bpy, acz * bpz);
  const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
  const float d5 = sum3(abx * cpx, aby * cpy, abz * cpz);
  const float d6 = sum3(acx * cpx, acy * cpy, acz * cpz);

  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;

  const float e43 = d4 - d3, e56 = d5 - d6;
  const bool r_a = d1 <= 0.0f && d2 <= 0.0f;
  const bool r_b = d3 >= 0.0f && d4 <= d3;
  const bool r_c = d6 >= 0.0f && d5 <= d6;
  const bool r_ab = vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f;
  const bool r_ac = vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f;
  const bool r_bc = va <= 0.0f && e43 >= 0.0f && e56 >= 0.0f;
  // the two quotients any region needs: x for v (the interior's, or edge
  // AB's), y for w (the interior's, edge AC's or edge BC's), each of the
  // first true region among those that use it
  const float den = (va + vb) + vc;
  const float x = (r_ab ? d1 : vb) / clamp_eps(r_ab ? d1 - d3 : den);
  const float y = (r_ac ? d2 : r_bc ? e43 : vc) /
                  clamp_eps(r_ac ? d2 - d6 : r_bc ? e43 + e56 : den);
  if (r_a) {
    v = 0.0f, w = 0.0f;
  } else if (r_b) {
    v = 1.0f, w = 0.0f;
  } else if (r_c) {
    v = 0.0f, w = 1.0f;
  } else if (r_ab) {
    v = x, w = 0.0f;
  } else if (r_ac) {
    v = 0.0f, w = y;
  } else if (r_bc) {
    v = 1.0f - y, w = y;
  } else {
    v = x, w = y;
  }

  const float qx = (ax + v * abx) + w * acx - px;
  const float qy = (ay + v * aby) + w * acy - py;
  const float qz = (az + v * abz) + w * acz - pz;
  return (qx * qx + qz * qz) + qy * qy;  // sum3 of squares: never -0
}

// The merge key's high half: NaN first, then d2 in order of its bits.
__device__ __forceinline__ unsigned rank_of(float d2) {
  return d2 != d2 ? 0u : __float_as_uint(d2) + 1u;
}

// Gathers each face's corners and edges once; sets every point's key to
// "no face yet". A vertex index outside [0, n_verts) stops the kernel
// with an error, as the plain version's gather does on the card.
__global__ void __launch_bounds__(NF_THREADS)
nearest_face_stage(const float* __restrict__ verts, int n_verts,
                   const long long* __restrict__ faces, int fs0, int fs1,
                   int n_faces, int n, FaceTile* __restrict__ staged,
                   unsigned long long* __restrict__ keys) {
  const int i = blockIdx.x * NF_THREADS + threadIdx.x;
  if (i < n) keys[i] = ~0ull;
  if (i >= n_faces) return;
  const long long* fi = faces + (long long)i * fs0;
  const long long ia = fi[0], ib = fi[fs1], ic = fi[2 * fs1];
  if ((unsigned long long)ia >= (unsigned long long)n_verts ||
      (unsigned long long)ib >= (unsigned long long)n_verts ||
      (unsigned long long)ic >= (unsigned long long)n_verts)
    __trap();
  const float* a = verts + 3 * ia;
  const float* b = verts + 3 * ib;
  const float* c = verts + 3 * ic;
  const float ax = a[0], ay = a[1], az = a[2];
  const float bx = b[0], by = b[1], bz = b[2];
  const float cx = c[0], cy = c[1], cz = c[2];
  FaceTile t;
  t.q[0] = make_float4(ax, ay, az, bx - ax);
  t.q[1] = make_float4(by - ay, bz - az, cx - ax, cy - ay);
  t.q[2] = make_float4(cz - az, bx, by, bz);
  t.q[3] = make_float4(cx, cy, cz, 0.0f);
  staged[i] = t;
}

__global__ void __launch_bounds__(NF_THREADS)
nearest_face_search(const float* __restrict__ points, int n,
                    const FaceTile* __restrict__ staged, int n_faces,
                    unsigned long long* __restrict__ keys) {
  __shared__ float4 tile[4][NF_TILE];
  const int n_tiles = (n_faces + NF_TILE - 1) / NF_TILE;
  const long long total =
      (long long)((n + NF_THREADS - 1) / NF_THREADS) * n_tiles;
  const long long hi = total * (blockIdx.x + 1) / gridDim.x;
  long long it = total * blockIdx.x / gridDim.x;
  while (it < hi) {  // one point block's run of tiles a turn
    const int pb = (int)(it / n_tiles);
    const int t1 = (int)(min(hi, (long long)(pb + 1) * n_tiles) -
                         (long long)pb * n_tiles);
    const int i = pb * NF_THREADS + threadIdx.x;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (i < n) {
      px = points[3 * i];
      py = points[3 * i + 1];
      pz = points[3 * i + 2];
    }
    unsigned best = ~0u, best_f = 0;
    for (int t = (int)(it - (long long)pb * n_tiles); t < t1; ++t) {
      const int f0 = t * NF_TILE;
      const int nf = min(NF_TILE, n_faces - f0);
      __syncthreads();  // the previous tile is consumed
      if (threadIdx.x < nf) {
        const FaceTile s = staged[f0 + threadIdx.x];
#pragma unroll
        for (int k = 0; k < 4; ++k) tile[k][threadIdx.x] = s.q[k];
      }
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < nf; ++j) {
        FaceTile f;
#pragma unroll
        for (int k = 0; k < 4; ++k) f.q[k] = tile[k][j];
        float v, w;
        const unsigned r = rank_of(closest_vw(px, py, pz, f, v, w));
        if (r < best) best = r, best_f = (unsigned)(f0 + j);
      }
    }
    if (i < n)
      atomicMin(keys + i, ((unsigned long long)best << 32) | best_f);
    it = (long long)pb * n_tiles + t1;
  }
}

__global__ void __launch_bounds__(NF_THREADS)
nearest_face_finish(const float* __restrict__ points, int n,
                    const FaceTile* __restrict__ staged,
                    const unsigned long long* __restrict__ keys,
                    float* __restrict__ dist, long long* __restrict__ index,
                    float* __restrict__ bary) {
  const int i = blockIdx.x * NF_THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  const unsigned r = (unsigned)(key >> 32), f = (unsigned)key;
  const float d2 = r == 0u ? __uint_as_float(0x7fc00000u)
                           : __uint_as_float(r - 1u);
  float v, w;
  closest_vw(points[3 * i], points[3 * i + 1], points[3 * i + 2], staged[f],
             v, w);
  dist[i] = sqrtf(d2);
  index[i] = (long long)f;
  bary[3 * i] = (1.0f - v) - w;
  bary[3 * i + 1] = v;
  bary[3 * i + 2] = w;
}

// points (n, 3) and verts (n_verts, 3) float32 contiguous, faces
// (n_faces, 3) int64 with element strides fs0, fs1; staged
// (n_faces, 16) float32 and keys (n,) int64 scratch; out: dist (n,)
// float32, index (n,) int64, bary (n, 3) float32. n_faces >= 1.
extern "C" int ag_nearest_face(const void* points, int n, const void* verts,
                               int n_verts, const void* faces, int fs0,
                               int fs1,
                               int n_faces, void* staged, void* keys,
                               void* dist, void* index, void* bary,
                               void* stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nearest_face_search, NF_THREADS, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
  }
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int m = n > n_faces ? n : n_faces;
  nearest_face_stage<<<(m + NF_THREADS - 1) / NF_THREADS, NF_THREADS, 0, s>>>(
      (const float*)verts, n_verts, (const long long*)faces, fs0, fs1,
      n_faces, n,
      (FaceTile*)staged, (unsigned long long*)keys);
  const long long total = (long long)((n + NF_THREADS - 1) / NF_THREADS) *
                          ((n_faces + NF_TILE - 1) / NF_TILE);
  const int grid = (int)(total < resident ? total : resident);
  nearest_face_search<<<grid, NF_THREADS, 0, s>>>(
      (const float*)points, n, (const FaceTile*)staged, n_faces,
      (unsigned long long*)keys);
  nearest_face_finish<<<(n + NF_THREADS - 1) / NF_THREADS, NF_THREADS, 0,
                        s>>>((const float*)points, n, (const FaceTile*)staged,
                             (const unsigned long long*)keys, (float*)dist,
                             (long long*)index, (float*)bary);
  return (int)cudaGetLastError();
}
