// The overlapped Jacobi step for Hopper (sm_90a), float32: B7.
//
// Replaces stencil_tpu/ops/pallas_overlap.py:55 jacobi7_overlap_pallas.
// The TPU kernel is one program per shard: a neighbour barrier, the
// four face slabs sent by remote DMA, the interior computed from owned
// data while they fly, a wait, then the two y rows and two z planes
// recomputed from the landed slabs. Here the same step is two launches
// per shard, on that shard's own CUDA stream, bound through plain
// extern "C" launchers (ctypes; stencil_tpu_torch/ops/_build.py and
// ops/cuda_overlap.py, which also holds the plain PyTorch twin):
//
//   launch A (jacobi7_overlap_inner_launch): the blocks of blockIdx.z
//     == 0 store the shard's four face slabs straight into the receive
//     buffers of its neighbours (plain global stores through the
//     neighbours' device pointers; across cards they go over NVLink
//     once peer access is on); the other blocks compute every point
//     with 1 <= z <= Z-2 and 1 <= y <= Y-2 from owned data (phase 3 of
//     the TPU kernel; its face placeholders are not written at all).
//   launch B (jacobi7_overlap_faces_launch): the y rows (1 <= z <= Z-2,
//     phase 5a) and the z planes (all y, phase 5b) from the shard and
//     its landed slabs. The regions are disjoint, so one launch writes
//     what 5a and then 5b leave in the TPU kernel's output.
//
// The barrier and the DMA waits become two ordering rules, carried by
// CUDA events between the per-shard streams (ops/cuda_overlap.py):
//   (a) shard i's launch A at step t writes into shard j's receive
//       buffers only after j's launch B at step t-1 has read them;
//   (b) j's launch B at step t starts only after every neighbour's
//       launch A at step t.
// No kernel spins on a flag another launch sets: a waiting grid that
// fills the card would keep the setter's blocks off it.
//
// Slabs, per shard (Z, Y, X): zlo (1, Y, X) is the z-1 neighbour's plane
// Z-1, zhi its z+1 neighbour's plane 0, ylo (Z, 1, X) the y-1
// neighbour's row Y-1 at every z, yhi the y+1 neighbour's row 0; on a
// one-shard axis the neighbour is the shard itself. x is never sharded:
// it wraps in the kernel.
//
// Order of operations, copied from the TPU kernel (every add and
// multiply rounded as written: __fadd_rn / __fmul_rn, built
// -fmad=false), then * (1/6) in float32, then the spheres:
//   phase 3 (:213):  zm + zp + ym + yp + xm + xp
//   phase 5a (:269): zm + zp + y_in + y_slab + xm + xp
//   phase 5b (:299): ym + yp + z_in + z_slab + xm + xp, with ym at y = 0
//                    from ylo[z] and yp at y = Y-1 from yhi[z]
// (left to right). This differs from B5's order, so the overlap path is
// not bitwise equal to the halo path.
//
// Bound on this card: bytes. One read and one write of the shard, 8 B a
// point (2 x 128 MiB for a 512 x 256 x 256 quarter shard: 0.080 ms at
// 3.35 TB/s), against 7 flops a point; the slabs are < 1 % more.
// Design: K1's (csrc/jacobi7.cu), a simple kernel that is right: a
// (32, 8) block of threads, one thread per (y, x) column walking kZRun
// z planes with the planes below and at z in registers; y and x
// neighbours are re-reads that L1/L2 serve. Launch B is one thread per
// face point.

#include <cuda_runtime.h>

namespace {

constexpr float kSixth = static_cast<float>(1.0 / 6.0);

struct Spheres {
  int hx, hy, hz;  // hot centre
  int cx, cy, cz;  // cold centre
  int r2;          // radius squared
};

struct Recv {  // one shard's four receive slabs
  float* zlo;
  float* zhi;
  float* ylo;
  float* yhi;
};

__device__ __forceinline__ float impose(float v, int gx, int gy, int gz,
                                        const Spheres& s) {
  int dx = gx - s.hx, dy = gy - s.hy, dz = gz - s.hz;
  if (dx * dx + dy * dy + dz * dz <= s.r2) v = 1.0f;
  dx = gx - s.cx;
  dy = gy - s.cy;
  dz = gz - s.cz;
  if (dx * dx + dy * dy + dz * dz <= s.r2) v = 0.0f;  // cold wins
  return v;
}

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kZRun = 16;

// Launch A. `to` holds the NEIGHBOURS' receive slabs this shard writes:
// to.zlo is the z+1 neighbour's zlo (<- plane Z-1), to.zhi the z-1
// neighbour's zhi (<- plane 0), to.ylo the y+1 neighbour's ylo (<- row
// Y-1), to.yhi the y-1 neighbour's yhi (<- row 0).
__global__ void __launch_bounds__(kBX * kBY)
jacobi7_overlap_inner_kernel(const float* __restrict__ in,
                             float* __restrict__ out, Recv to, int Z, int Y,
                             int X, int oz, int oy, int ox, Spheres s) {
  const size_t plane = static_cast<size_t>(Y) * X;
  if (blockIdx.z == 0) {
    // the sends: 2 planes of Y*X and 2 rows of Z*X, grid-stride over the
    // blocks of this layer
    const size_t zpart = 2 * plane;
    const size_t total = zpart + 2 * static_cast<size_t>(Z) * X;
    const size_t nthreads =
        static_cast<size_t>(gridDim.x) * gridDim.y * kBX * kBY;
    for (size_t t = (static_cast<size_t>(blockIdx.y) * gridDim.x +
                     blockIdx.x) * (kBX * kBY) +
                    threadIdx.y * kBX + threadIdx.x;
         t < total; t += nthreads) {
      if (t < plane) {
        to.zlo[t] = in[(Z - 1) * plane + t];
      } else if (t < zpart) {
        to.zhi[t - plane] = in[t - plane];
      } else {
        const size_t u = t - zpart;
        const size_t zx = static_cast<size_t>(Z) * X;
        const size_t v = u < zx ? u : u - zx;
        const size_t z = v / X, x = v - z * X;
        if (u < zx) {
          to.ylo[v] = in[z * plane + static_cast<size_t>(Y - 1) * X + x];
        } else {
          to.yhi[v] = in[z * plane + x];
        }
      }
    }
    return;
  }
  // phase 3: every point with 1 <= z <= Z-2, 1 <= y <= Y-2
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = max((static_cast<int>(blockIdx.z) - 1) * kZRun, 1);
  const int z1 = min(static_cast<int>(blockIdx.z) * kZRun, Z - 1);
  if (x >= X || y < 1 || y > Y - 2 || z0 >= z1) return;
  const int xm = x == 0 ? X - 1 : x - 1;
  const int xp = x == X - 1 ? 0 : x + 1;
  const size_t col = static_cast<size_t>(y) * X + x;
  float below = in[(z0 - 1) * plane + col];
  float centre = in[z0 * plane + col];
  for (int z = z0; z < z1; ++z) {
    const float* p = in + z * plane;
    const float above = in[(z + 1) * plane + col];
    float v = __fadd_rn(below, above);
    v = __fadd_rn(v, p[col - X]);
    v = __fadd_rn(v, p[col + X]);
    v = __fadd_rn(v, p[static_cast<size_t>(y) * X + xm]);
    v = __fadd_rn(v, p[static_cast<size_t>(y) * X + xp]);
    v = __fmul_rn(v, kSixth);
    out[z * plane + col] = impose(v, ox + x, oy + y, oz + z, s);
    below = centre;
    centre = above;
  }
}

// Launch B: the face points from the shard and its own landed slabs.
__global__ void __launch_bounds__(256)
jacobi7_overlap_faces_kernel(const float* __restrict__ in,
                             float* __restrict__ out, Recv sl, int Z, int Y,
                             int X, int oz, int oy, int ox, Spheres s) {
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t zpart = 2 * plane;
  const size_t rows = static_cast<size_t>(Z - 2) * X;
  const size_t total = zpart + 2 * rows;
  for (size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int x, y, z;
    float v;
    if (t < zpart) {
      // phase 5b: plane z = 0 or Z-1, every y
      const bool top = t >= plane;
      const size_t r = top ? t - plane : t;
      z = top ? Z - 1 : 0;
      y = static_cast<int>(r / X);
      x = static_cast<int>(r - static_cast<size_t>(y) * X);
      const float* c = in + z * plane;
      const float* zin = in + (top ? Z - 2 : 1) * plane;
      const float* zsl = top ? sl.zhi : sl.zlo;
      const size_t zx = static_cast<size_t>(z) * X + x;
      const float ym = y == 0 ? sl.ylo[zx] : c[(y - 1) * X + x];
      const float yp = y == Y - 1 ? sl.yhi[zx] : c[(y + 1) * X + x];
      const int xm = x == 0 ? X - 1 : x - 1;
      const int xp = x == X - 1 ? 0 : x + 1;
      v = __fadd_rn(ym, yp);
      v = __fadd_rn(v, zin[r]);
      v = __fadd_rn(v, zsl[r]);
      v = __fadd_rn(v, c[static_cast<size_t>(y) * X + xm]);
      v = __fadd_rn(v, c[static_cast<size_t>(y) * X + xp]);
    } else {
      // phase 5a: row y = 0 or Y-1, 1 <= z <= Z-2
      const size_t u = t - zpart;
      const bool top = u >= rows;
      const size_t r = top ? u - rows : u;
      y = top ? Y - 1 : 0;
      z = 1 + static_cast<int>(r / X);
      x = static_cast<int>(r - static_cast<size_t>(z - 1) * X);
      const size_t at = z * plane + static_cast<size_t>(y) * X;
      const size_t row_in = static_cast<size_t>(top ? Y - 2 : 1) * X;
      const float y_in = in[z * plane + row_in + x];
      const float y_slab =
          (top ? sl.yhi : sl.ylo)[static_cast<size_t>(z) * X + x];
      const int xm = x == 0 ? X - 1 : x - 1;
      const int xp = x == X - 1 ? 0 : x + 1;
      v = __fadd_rn(in[at - plane + x], in[at + plane + x]);
      v = __fadd_rn(v, y_in);
      v = __fadd_rn(v, y_slab);
      v = __fadd_rn(v, in[at + xm]);
      v = __fadd_rn(v, in[at + xp]);
    }
    v = __fmul_rn(v, kSixth);
    out[z * plane + static_cast<size_t>(y) * X + x] =
        impose(v, ox + x, oy + y, oz + z, s);
  }
}

inline unsigned blocks(long long n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

extern "C" {

cudaError_t jacobi7_overlap_inner_launch(
    const float* in, float* out, float* to_zlo, float* to_zhi, float* to_ylo,
    float* to_yhi, int Z, int Y, int X, int oz, int oy, int ox, int hx,
    int hy, int hz, int cx, int cy, int cz, int r2, void* stream) {
  if (Z < 4 || Y < 2 || X < 1) return cudaErrorInvalidValue;
  const Recv to{to_zlo, to_zhi, to_ylo, to_yhi};
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  // layer 0 sends; layers 1.. compute kZRun planes each
  const dim3 grid(blocks(X, kBX), blocks(Y, kBY), 1 + blocks(Z, kZRun));
  jacobi7_overlap_inner_kernel<<<grid, dim3(kBX, kBY), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      in, out, to, Z, Y, X, oz, oy, ox, s);
  return cudaGetLastError();
}

cudaError_t jacobi7_overlap_faces_launch(
    const float* in, float* out, float* zlo, float* zhi, float* ylo,
    float* yhi, int Z, int Y, int X, int oz, int oy, int ox, int hx, int hy,
    int hz, int cx, int cy, int cz, int r2, void* stream) {
  if (Z < 4 || Y < 2 || X < 1) return cudaErrorInvalidValue;
  const Recv sl{zlo, zhi, ylo, yhi};
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  const long long total =
      2LL * Y * X + 2LL * (Z - 2) * static_cast<long long>(X);
  long long nb = (total + 255) / 256;
  if (nb > 132 * 16) nb = 132 * 16;
  jacobi7_overlap_faces_kernel<<<static_cast<unsigned>(nb), 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      in, out, sl, Z, Y, X, oz, oy, ox, s);
  return cudaGetLastError();
}

}  // extern "C"
