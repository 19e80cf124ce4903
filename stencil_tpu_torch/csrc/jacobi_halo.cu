// Jacobi-3D halo kernels for Hopper (sm_90a), float32: the multi-device
// step on an interior-resident shard whose halo arrives as four slab
// arrays (stencil_tpu_torch/parallel/exchange.py exchange_interior_slabs).
//
// Two kernels, each the hand-written counterpart of one Pallas TPU
// kernel of stencil_tpu/ops/pallas_halo.py, bound to Python through a
// plain extern "C" launcher (ctypes; stencil_tpu_torch/ops/_build.py and
// ops/cuda_halo.py, which also holds each kernel's plain PyTorch twin).
// As in csrc/jacobi7.cu, every add and multiply is in the order of the
// JAX kernel (__fadd_rn / __fmul_rn, built -fmad=false), so kernel and
// twin agree bitwise.
//
// Slab layout (the exchange's alignment contract), shard (Z, Y, X):
//   zlo (rz, Y, X): rows z = -rz..-1, the adjacent row is zlo[rz-1];
//   zhi (rz, Y, X): rows z = Z..Z+rz-1, the adjacent row is zhi[0];
//   ylo (Zs, e, X): columns y = -e..-1, the adjacent column is e-1;
//   yhi (Zs, e, X): columns y = Y..Y+e-1, the adjacent column is 0;
// with Zs = Z for B5 and Zs = Z + 2*rz (rows z = -rz..Z+rz-1, "z
// extended", so yz corners ride along) for B6. x is never sharded: it
// wraps in the kernel.

#include <cuda_runtime.h>

namespace {

constexpr float kSixth = static_cast<float>(1.0 / 6.0);

struct Spheres {
  int hx, hy, hz;  // hot centre
  int cx, cy, cz;  // cold centre
  int r2;          // radius squared
};

struct Slabs {
  const float* zlo;
  const float* zhi;
  const float* ylo;
  const float* yhi;
  int rz;  // rows of zlo/zhi (and the z offset of a z-extended y slab)
  int e;   // columns of ylo/yhi
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

// floor modulo: a ring coordinate below 0 must wrap to the top, which
// C's % (truncating) does not do
__device__ __forceinline__ int wrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kZRun = 16;

// ---------------------------------------------------------------------
// B5. Replaces stencil_tpu/ops/pallas_halo.py:115 jacobi7_halo_pallas.
// One Jacobi step plus the spheres on an interior-resident (Z, Y, X)
// shard with radius-1 slabs. The stencil reads the shard inside
// [0,Lz) x [0,Ly), zlo[rz-1] / zhi[0] across z, ylo[:, e-1] / yhi[:, 0]
// across y, and wraps x. (Lz, Ly) are the shard's actual extents: on a
// short (+-1) shard the row Lz-1 and column Ly-1 read the hi slabs, and
// the dead capacity cells beyond hold what the JAX kernel puts there
// (their z-/y- neighbours come from the shard, their z+/y+ from the
// slab). Spheres at org + local coordinates, no modulo (:207-224).
// Bound on this card: bytes. One read and one write of the shard, 8 B a
// point (1.07 GB at 512^3, 0.32 ms at 3.35 TB/s), against 7 flops a
// point; the slabs are ~1 % more.
// Design: K1's (csrc/jacobi7.cu): a (32, 8) block of threads, one thread
// per (y, x) column walking kZRun z planes and carrying the in-shard
// planes below and at z in registers; y and x neighbours are re-reads
// that L1/L2 serve. Only the edge rows and columns branch to a slab.
// Order (:201, :219): ((((ym+yp)+xm)+xp)+zm)+zp, *1/6.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kBX * kBY)
jacobi7_halo_kernel(const float* __restrict__ in, float* __restrict__ out,
                    Slabs sl, int Z, int Y, int X, int Lz, int Ly, int oz,
                    int oy, int ox, Spheres s) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZRun;
  if (x >= X || y >= Y || z0 >= Z) return;
  const int xm = x == 0 ? X - 1 : x - 1;
  const int xp = x == X - 1 ? 0 : x + 1;
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t col = static_cast<size_t>(y) * X + x;
  const int e = sl.e;
  const int z1 = min(z0 + kZRun, Z);
  float below = z0 == 0
                    ? sl.zlo[static_cast<size_t>(sl.rz - 1) * plane + col]
                    : in[(z0 - 1) * plane + col];
  float centre = in[z0 * plane + col];
  for (int z = z0; z < z1; ++z) {
    const float* p = in + z * plane;
    const float nxt = z + 1 < Z ? in[(z + 1) * plane + col] : 0.0f;
    const float above = z + 1 >= Lz ? sl.zhi[col] : nxt;
    const size_t yrow = static_cast<size_t>(z) * e;
    const float ym = y == 0 ? sl.ylo[(yrow + e - 1) * X + x]
                            : p[col - X];
    const float yp = y + 1 >= Ly ? sl.yhi[yrow * X + x] : p[col + X];
    float v = __fadd_rn(ym, yp);
    v = __fadd_rn(v, p[static_cast<size_t>(y) * X + xm]);
    v = __fadd_rn(v, p[static_cast<size_t>(y) * X + xp]);
    v = __fadd_rn(v, below);
    v = __fadd_rn(v, above);
    v = __fmul_rn(v, kSixth);
    out[z * plane + col] = impose(v, ox + x, oy + y, oz + z, s);
    below = centre;
    centre = nxt;
  }
}

// ---------------------------------------------------------------------
// B6. Replaces stencil_tpu/ops/pallas_halo.py:317 jacobi7_halon_pallas
// (and its steps=2 alias jacobi7_halo2_pallas, :555).
// N Jacobi steps per radius-N slab exchange (temporal blocking): level 0
// is the shard extended by N on each side in z and y, read through
// `fetch` (the y slabs first, at any z, since they are z-extended; then
// the z slabs; then the shard — the sequential-sweep corner rule of
// :439-452), x wrapping; each level k computes one step on a window one
// cell narrower, and after every step the spheres are re-imposed at the
// GLOBAL coordinates wrapped modulo the global grid (`sources`,
// :388-402), since ring cells belong to neighbouring shards.
// Bound on this card: bytes. One read and one write of the shard per N
// steps, 8 B a point (0.32 ms a launch at 512^3), against 7 flops a
// point a step.
// Design: K2's (csrc/jacobi7.cu): a (32, 8) block of threads streams a
// 32 x 32 (x, y) window down z, kZRunN output planes; shared memory
// holds, for each step level 0..N-1, a ring of that level's last three
// planes (N * 12 KB); each arriving plane lets every level compute one
// more plane, and level N goes to device memory. The block recomputes a
// ring of N cells in x and y around its (32-2N)^2 outputs.
// Order (:404-410): ((zm+zp)+(ym+yp))+(xm+xp), *1/6.
// ---------------------------------------------------------------------
constexpr int kWX = 32;
constexpr int kWY = 32;
constexpr int kRows = kWY / kBY;
constexpr int kZRunN = 32;
constexpr int kMaxSteps = 8;
constexpr int kWPlane = kWX * kWY;
static_assert(kWX == kBX, "one thread per window column");
static_assert(kWY % kBY == 0 && 2 * kMaxSteps < kWY, "window rows");

struct Global {
  int oz, oy, ox;  // the shard's global origin
  int gz, gy, gx;  // the global grid
};

__global__ void __launch_bounds__(kBX * kBY)
jacobi7_halon_kernel(const float* __restrict__ in, float* __restrict__ out,
                     Slabs sl, int Z, int Y, int X, Global g, Spheres s,
                     int N) {
  extern __shared__ float ring[];  // [level 0..N-1][p mod 3][kWY][kWX]
  const int tx = threadIdx.x, ty = threadIdx.y;
  // shard-local (unwrapped) coordinates of window cell (0, 0)
  const int ox = blockIdx.x * (kWX - 2 * N) - N;
  const int oy = blockIdx.y * (kWY - 2 * N) - N;
  const int z0 = blockIdx.z * kZRunN;
  const size_t plane = static_cast<size_t>(Y) * X;
  const int x = ox + tx;
  const int lx = wrap(x, X);             // x wraps inside the shard
  const int gxg = wrap(g.ox + lx, g.gx);  // global, for the spheres
  // per window row: where its level-0 values come from (0 the shard or
  // a z slab, 1 ylo, 2 yhi, 3 nothing: outside [-N, Y+N), never read
  // by an output), the column in that source, and the global y
  int kind[kRows], ycol[kRows], gyg[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = oy + ty + kBY * j;
    if (y < -N || y >= Y + N) {
      kind[j] = 3;
      ycol[j] = 0;
    } else if (y < 0) {
      kind[j] = 1;
      ycol[j] = sl.e + y;
    } else if (y >= Y) {
      kind[j] = 2;
      ycol[j] = y - Y;
    } else {
      kind[j] = 0;
      ycol[j] = y;
    }
    gyg[j] = wrap(g.oy + y, g.gy);
  }
  auto fetch = [&](int z, int j) -> float {
    const int c = ycol[j];
    switch (kind[j]) {
      case 1:
        return sl.ylo[(static_cast<size_t>(sl.rz + z) * sl.e + c) * X + lx];
      case 2:
        return sl.yhi[(static_cast<size_t>(sl.rz + z) * sl.e + c) * X + lx];
      case 3:
        return 0.0f;
      default:
        if (z < 0)
          return sl.zlo[static_cast<size_t>(sl.rz + z) * plane +
                        static_cast<size_t>(c) * X + lx];
        if (z >= Z)
          return sl.zhi[static_cast<size_t>(z - Z) * plane +
                        static_cast<size_t>(c) * X + lx];
        return in[static_cast<size_t>(z) * plane +
                  static_cast<size_t>(c) * X + lx];
    }
  };
  auto slot = [&](int level, int p) {
    return ring + (level * 3 + wrap(p, 3)) * kWPlane;
  };
  const int T = min(kZRunN, Z - z0) + 2 * N;  // input planes to stream
  float next[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) next[j] = fetch(z0 - N, j);
  for (int t = 0; t < T; ++t) {
    const int p0 = z0 - N + t;  // the input plane arriving now
    float* l0 = slot(0, p0);
#pragma unroll
    for (int j = 0; j < kRows; ++j) l0[(ty + kBY * j) * kWX + tx] = next[j];
    if (t + 1 < T) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) next[j] = fetch(p0 + 1, j);
    }
    __syncthreads();
    for (int k = 1; k <= N; ++k) {
      // level k computes plane p0 - k once planes p0-2k .. p0 of level 0
      // have arrived; its window cells are [k, W-k) in x and y
      if (t >= 2 * k && tx >= k && tx < kWX - k) {
        const int p = p0 - k;
        const float* lo = slot(k - 1, p - 1);
        const float* mid = slot(k - 1, p);
        const float* hi = slot(k - 1, p + 1);
        const int gzg = wrap(g.oz + p, g.gz);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int ly = ty + kBY * j;
          if (ly < k || ly >= kWY - k) continue;
          const int c = ly * kWX + tx;
          const float zs = __fadd_rn(lo[c], hi[c]);
          const float ys = __fadd_rn(mid[c - kWX], mid[c + kWX]);
          const float xs = __fadd_rn(mid[c - 1], mid[c + 1]);
          const float v = impose(
              __fmul_rn(__fadd_rn(__fadd_rn(zs, ys), xs), kSixth), gxg,
              gyg[j], gzg, s);
          if (k < N) {
            slot(k, p)[c] = v;
          } else if (x < X && oy + ly < Y) {
            out[p * plane + static_cast<size_t>(oy + ly) * X + x] = v;
          }
        }
      }
      __syncthreads();
    }
  }
}

inline unsigned blocks(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

extern "C" {

cudaError_t jacobi7_halo_launch(const float* in, float* out,
                                const float* zlo, const float* zhi,
                                const float* ylo, const float* yhi, int Z,
                                int Y, int X, int rz, int e, int Lz, int Ly,
                                int oz, int oy, int ox, int hx, int hy,
                                int hz, int cx, int cy, int cz, int r2,
                                void* stream) {
  const Slabs sl{zlo, zhi, ylo, yhi, rz, e};
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  const dim3 grid(blocks(X, kBX), blocks(Y, kBY), blocks(Z, kZRun));
  jacobi7_halo_kernel<<<grid, dim3(kBX, kBY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in, out, sl, Z, Y, X, Lz, Ly, oz, oy, ox, s);
  return cudaGetLastError();
}

cudaError_t jacobi7_halon_launch(const float* in, float* out,
                                 const float* zlo, const float* zhi,
                                 const float* ylo, const float* yhi, int Z,
                                 int Y, int X, int rz, int e, int oz,
                                 int oy, int ox, int gz, int gy, int gx,
                                 int hx, int hy, int hz, int cx, int cy,
                                 int cz, int r2, int N, void* stream) {
  if (N < 1 || N > kMaxSteps) return cudaErrorInvalidValue;
  const Slabs sl{zlo, zhi, ylo, yhi, rz, e};
  const Global g{oz, oy, ox, gz, gy, gx};
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  const size_t smem = sizeof(float) * static_cast<size_t>(N) * 3 * kWPlane;
  cudaError_t err = cudaFuncSetAttribute(
      jacobi7_halon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(X, kWX - 2 * N), blocks(Y, kWY - 2 * N),
                  blocks(Z, kZRunN));
  jacobi7_halon_kernel<<<grid, dim3(kBX, kBY), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      in, out, sl, Z, Y, X, g, s, N);
  return cudaGetLastError();
}

}  // extern "C"
