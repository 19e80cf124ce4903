// Jacobi-3D halo kernels for Hopper (sm_90a), float32: the multi-device
// step on an interior-resident shard whose halo arrives as four slab
// arrays (stencil_tpu_torch/parallel/exchange.py exchange_interior_slabs).
//
// Two kernels, each the hand-written counterpart of one Pallas TPU
// kernel of stencil_tpu/ops/pallas_halo.py, bound to Python through a
// plain extern "C" launcher (ctypes; stencil_tpu_torch/ops/_build.py and
// ops/cuda_halo.py, which also holds each kernel's plain PyTorch twin).
// B6 is the z-streaming N-step ring kernel of csrc/jacobi_ring.cuh, which
// K2 (csrc/jacobi7.cu) launches too; this file chooses its window rows
// (SlabSrc there). As in csrc/jacobi7.cu, every add and multiply is in
// the order of the JAX kernel (__fadd_rn / __fmul_rn, built -fmad=false),
// so kernel and twin agree bitwise.
//
// Slab layout (the exchange's alignment contract), shard (Z, Y, X):
//   zlo (rz, Y, X): rows z = -rz..-1, the adjacent row is zlo[rz-1];
//   zhi (rz, Y, X): rows z = Z..Z+rz-1, the adjacent row is zhi[0];
//   ylo (Zs, e, X): columns y = -e..-1, the adjacent column is e-1;
//   yhi (Zs, e, X): columns y = Y..Y+e-1, the adjacent column is 0;
// with Zs = Z for B5 and Zs = Z + 2*rz (rows z = -rz..Z+rz-1, "z
// extended", so yz corners ride along) for B6. x is never sharded: it
// wraps in the kernel.

#include "jacobi_ring.cuh"

namespace {

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
                    SlabSrc sl, int Z, int Y, int X, int Lz, int Ly, int oz,
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

}  // namespace

extern "C" {

cudaError_t jacobi7_halo_launch(const float* in, float* out,
                                const float* zlo, const float* zhi,
                                const float* ylo, const float* yhi, int Z,
                                int Y, int X, int rz, int e, int Lz, int Ly,
                                int oz, int oy, int ox, int hx, int hy,
                                int hz, int cx, int cy, int cz, int r2,
                                void* stream) {
  const SlabSrc sl{zlo, zhi, ylo, yhi, rz, e};
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  const dim3 grid(blocks(X, kBX), blocks(Y, kBY), blocks(Z, kZRun));
  jacobi7_halo_kernel<<<grid, dim3(kBX, kBY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in, out, sl, Z, Y, X, Lz, Ly, oz, oy, ox, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// B6. Replaces stencil_tpu/ops/pallas_halo.py:317 jacobi7_halon_pallas
// (and its steps=2 alias jacobi7_halo2_pallas, :555).
// N Jacobi steps per radius-N slab exchange (temporal blocking): level 0
// is the shard extended by N on each side in z and y, x wrapping; after
// every step the spheres are re-imposed at the GLOBAL coordinates
// wrapped modulo the global grid (`sources`, :388-402), since ring cells
// belong to neighbouring shards.
// Bound on this card: bytes. One read and one write of the shard per N
// steps, 8 B a point (0.32 ms a launch at 512^3), plus the slab rows,
// against 7 flops a point a step.
// Design: csrc/jacobi_ring.cuh with kSlabRows, K2's kernel body. The row
// table gives each window row its source once a block: the shard's row
// (zlo / zhi beyond its z ends), or, beyond its y ends, the z-extended
// y slab's row at every plane (the sequential-sweep corner rule of
// :439-452). No source is chosen per plane or per cell.
// Order (:404-410): ((zm+zp)+(ym+yp))+(xm+xp), *1/6.
// ---------------------------------------------------------------------

cudaError_t jacobi7_halon_launch(const float* in, float* out,
                                 const float* zlo, const float* zhi,
                                 const float* ylo, const float* yhi, int Z,
                                 int Y, int X, int rz, int e, int oz,
                                 int oy, int ox, int gz, int gy, int gx,
                                 int hx, int hy, int hz, int cx, int cy,
                                 int cz, int r2, int N, int ty, int depth,
                                 int zrun, void* stream) {
  if (rz < N || e < N) return cudaErrorInvalidValue;
  const SlabSrc sl{zlo, zhi, ylo, yhi, rz, e};
  const Global g{oz, oy, ox, gz, gy, gx};
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  return launch_jacobi_ring<kSlabRows>(
      in, out, sl, Z, Y, X, g, s, N, RingPlan{ty, depth, zrun},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
