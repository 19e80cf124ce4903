// Jacobi-3D 7-point stencil kernels for Hopper (sm_90a), float32 and
// bfloat16 storage.
//
// Three kernels, each the hand-written counterpart of one Pallas TPU
// kernel of stencil_tpu/ops/pallas_stencil.py, and each bound to
// Python through a plain extern "C" launcher (ctypes; see
// stencil_tpu_torch/ops/_build.py and ops/cuda_stencil.py, which also
// holds each kernel's plain PyTorch twin). K2 is the z-streaming N-step
// ring kernel of csrc/jacobi_ring.cuh, which B6 (csrc/jacobi_halo.cu)
// launches too; this file chooses its window rows.
//
// Every kernel adds and multiplies in the order of the JAX kernel it
// replaces, with __fadd_rn / __fmul_rn, and the library is built with
// -fmad=false: a contracted a*c+b (FMA) would round once where the
// twin rounds twice and break bitwise agreement.
//
// The stencil averages the six face neighbours (the centre is not
// read) and then re-imposes the Dirichlet hot (T=1) and cold (T=0)
// spheres (reference: bin/jacobi3d.cu:40-85).
//
// bfloat16: every launcher takes `is_bf16`. K1 and K3 have bfloat16
// kernels of their own, in which a thread owns two adjacent x cells, so
// that a warp still covers 128-byte rows, and each add and the multiply
// by bf16(1/6) round to bfloat16 at once, in the same order
// (csrc/bf16_math.cuh); K2 is the ring kernel's bfloat16 instance.

#include "jacobi_ring.cuh"

namespace {

// K1 and K3: a (32, 8) block of threads in (x, y), one thread per
// output column, each walking kZRun z planes and carrying the planes
// below and at z in registers. A warp reads 32 neighbouring x: every
// load and store is one coalesced 128-byte row.
constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kZRun = 16;

// ---------------------------------------------------------------------
// K1. Replaces stencil_tpu/ops/pallas_stencil.py:134 jacobi7_wrap_pallas.
// One periodic step on an unpadded (Z, Y, X) field; z, y and x wrap in
// the kernel, then the spheres.
// Bound on this card: bytes. It must read the field once and write it
// once, 8 B per point (1.07 GB at 512^3, 0.32 ms at 3.35 TB/s), against
// 7 flops per point (0.014 ms at 67 TFLOP/s).
// Design: the z loop reads each plane once per column and keeps it in
// registers for the next two z; the y +-1 and x +-1 neighbours are
// re-reads that hit L1/L2 (the block's rows overlap by one), so device
// memory sees about one read and one write per point.
// Order (pallas_stencil.py:198, :207): ((((ym+yp)+xm)+xp)+zm)+zp, *1/6.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kBX * kBY)
jacobi7_wrap_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int Z, int Y, int X, Spheres s) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZRun;
  if (x >= X || y >= Y || z0 >= Z) return;
  const int xm = x == 0 ? X - 1 : x - 1;
  const int xp = x == X - 1 ? 0 : x + 1;
  const int ym = y == 0 ? Y - 1 : y - 1;
  const int yp = y == Y - 1 ? 0 : y + 1;
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t col = static_cast<size_t>(y) * X + x;
  const int z1 = min(z0 + kZRun, Z);
  float below = in[(z0 == 0 ? Z - 1 : z0 - 1) * plane + col];
  float centre = in[z0 * plane + col];
  for (int z = z0; z < z1; ++z) {
    const float* p = in + z * plane;
    const float above = in[(z == Z - 1 ? 0 : z + 1) * plane + col];
    float v = __fadd_rn(p[static_cast<size_t>(ym) * X + x],
                        p[static_cast<size_t>(yp) * X + x]);
    v = __fadd_rn(v, p[static_cast<size_t>(y) * X + xm]);
    v = __fadd_rn(v, p[static_cast<size_t>(y) * X + xp]);
    v = __fadd_rn(v, below);
    v = __fadd_rn(v, above);
    v = __fmul_rn(v, kSixth);
    out[z * plane + col] = impose(v, x, y, z, s);
    below = centre;
    centre = above;
  }
}

// ---------------------------------------------------------------------
// K3. Replaces stencil_tpu/ops/pallas_stencil.py:72 jacobi7_pallas.
// The 7-point average over a halo-padded (Zp, Yp, Xp) shard with an
// asymmetric low pad (lz, ly, lx); writes the (Z, Y, X) interior only.
// No spheres (the caller imposes them).
// Bound on this card: bytes. One read of the padded field and one write
// of the interior, (Zp*Yp*Xp + Z*Y*X) * 4 B (1.08 GB at 512^3,
// 0.32 ms at 3.35 TB/s).
// Design: as K1, with the halo in memory instead of index wrapping.
// Order (pallas_stencil.py:89-94): (((((z-1)+(z+1))+(y-1))+(y+1))+(x-1))
// +(x+1), *1/6.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kBX * kBY)
jacobi7_padded_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int Z, int Y, int X, int Yp, int Xp,
                      int lz, int ly, int lx) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZRun;
  if (x >= X || y >= Y || z0 >= Z) return;
  const size_t pplane = static_cast<size_t>(Yp) * Xp;
  const size_t pcol = static_cast<size_t>(y + ly) * Xp + (x + lx);
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t col = static_cast<size_t>(y) * X + x;
  const int z1 = min(z0 + kZRun, Z);
  float below = in[(z0 + lz - 1) * pplane + pcol];
  float centre = in[(z0 + lz) * pplane + pcol];
  for (int z = z0; z < z1; ++z) {
    const float* p = in + (z + lz) * pplane + pcol;
    const float above = in[(z + lz + 1) * pplane + pcol];
    float v = __fadd_rn(below, above);
    v = __fadd_rn(v, p[-Xp]);
    v = __fadd_rn(v, p[Xp]);
    v = __fadd_rn(v, p[-1]);
    v = __fadd_rn(v, p[1]);
    out[z * plane + col] = __fmul_rn(v, kSixth);
    below = centre;
    centre = above;
  }
}

// K1 in bfloat16: the thread of column pair (y, x), x even, walks kZRun
// planes with the pairs below and at z in registers; the left neighbour
// of x and the right one of x + 1 are single cells (wrapped), the others
// the pair itself. Order as float32's, rounded after every operation.
template <bool kVec>
__global__ void __launch_bounds__(kBX * kBY)
jacobi7_wrap_bf16_kernel(const bf16* __restrict__ in,
                         bf16* __restrict__ out, int Z, int Y, int X,
                         Spheres s) {
  const int x = 2 * (blockIdx.x * kBX + threadIdx.x);
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZRun;
  if (x >= X || y >= Y || z0 >= Z) return;
  const bool two = x + 1 < X;
  const int xm = x == 0 ? X - 1 : x - 1;        // left of x
  const int xr = x + 1 < X ? x + 1 : 0;         // right of x
  const int xp = x + 2 < X ? x + 2 : x + 2 - X; // right of x + 1
  const int ym = y == 0 ? Y - 1 : y - 1;
  const int yp = y == Y - 1 ? 0 : y + 1;
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t col = static_cast<size_t>(y) * X + x;
  const int z1 = min(z0 + kZRun, Z);
  float2 below = pair<kVec>(in + (z0 == 0 ? Z - 1 : z0 - 1) * plane + col,
                            two);
  float2 centre = pair<kVec>(in + z0 * plane + col, two);
  for (int z = z0; z < z1; ++z) {
    const bf16* p = in + z * plane;
    const float2 above =
        pair<kVec>(in + (z == Z - 1 ? 0 : z + 1) * plane + col, two);
    const float2 m = pair<kVec>(p + static_cast<size_t>(ym) * X + x, two);
    const float2 q = pair<kVec>(p + static_cast<size_t>(yp) * X + x, two);
    const bf16* row = p + static_cast<size_t>(y) * X;
    float v0 = add_bf16(m.x, q.x);
    v0 = add_bf16(v0, ld1(row + xm));
    v0 = add_bf16(v0, two ? centre.y : ld1(row + xr));
    v0 = add_bf16(v0, below.x);
    v0 = add_bf16(v0, above.x);
    v0 = impose(mul_bf16(v0, kSixthBf16), x, y, z, s);
    float v1 = 0.0f;
    if (two) {
      v1 = add_bf16(m.y, q.y);
      v1 = add_bf16(v1, centre.x);
      v1 = add_bf16(v1, ld1(row + xp));
      v1 = add_bf16(v1, below.y);
      v1 = add_bf16(v1, above.y);
      v1 = impose(mul_bf16(v1, kSixthBf16), x + 1, y, z, s);
    }
    put_pair<kVec>(out + z * plane + col, v0, v1, two);
    below = centre;
    centre = above;
  }
}

// K3 in bfloat16: a thread owns interior cells x and x + 1 (x even) of a
// (y, z) run, all loads single cells (the radius-1 pad puts the pair at
// an odd offset of the padded row). Order as float32's, rounded after
// every operation.
__global__ void __launch_bounds__(kBX * kBY)
jacobi7_padded_bf16_kernel(const bf16* __restrict__ in,
                           bf16* __restrict__ out, int Z, int Y, int X,
                           int Yp, int Xp, int lz, int ly, int lx) {
  const int x = 2 * (blockIdx.x * kBX + threadIdx.x);
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZRun;
  if (x >= X || y >= Y || z0 >= Z) return;
  const bool two = x + 1 < X;
  const size_t pplane = static_cast<size_t>(Yp) * Xp;
  const size_t pcol = static_cast<size_t>(y + ly) * Xp + (x + lx);
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t col = static_cast<size_t>(y) * X + x;
  const int z1 = min(z0 + kZRun, Z);
  float2 below = pair<false>(in + (z0 + lz - 1) * pplane + pcol, two);
  float2 centre = pair<false>(in + (z0 + lz) * pplane + pcol, two);
  for (int z = z0; z < z1; ++z) {
    const bf16* p = in + (z + lz) * pplane + pcol;
    const float2 above = pair<false>(in + (z + lz + 1) * pplane + pcol, two);
    float v0 = add_bf16(below.x, above.x);
    v0 = add_bf16(v0, ld1(p - Xp));
    v0 = add_bf16(v0, ld1(p + Xp));
    v0 = add_bf16(v0, ld1(p - 1));
    v0 = add_bf16(v0, two ? centre.y : ld1(p + 1));
    v0 = mul_bf16(v0, kSixthBf16);
    float v1 = 0.0f;
    if (two) {
      v1 = add_bf16(below.y, above.y);
      v1 = add_bf16(v1, ld1(p + 1 - Xp));
      v1 = add_bf16(v1, ld1(p + 1 + Xp));
      v1 = add_bf16(v1, centre.x);
      v1 = add_bf16(v1, ld1(p + 2));
      v1 = mul_bf16(v1, kSixthBf16);
    }
    put_pair<false>(out + z * plane + col, v0, v1, two);
    below = centre;
    centre = above;
  }
}

inline bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

}  // namespace

extern "C" {

cudaError_t jacobi7_wrap_launch(const void* in, void* out, int Z, int Y,
                                int X, int hx, int hy, int hz, int cx,
                                int cy, int cz, int r2, int is_bf16,
                                void* stream) {
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const dim3 grid(blocks(X, kBX), blocks(Y, kBY), blocks(Z, kZRun));
    jacobi7_wrap_kernel<<<grid, dim3(kBX, kBY), 0, st>>>(
        static_cast<const float*>(in), static_cast<float*>(out), Z, Y, X,
        s);
    return cudaGetLastError();
  }
  const dim3 grid(blocks(X, 2 * kBX), blocks(Y, kBY), blocks(Z, kZRun));
  const bf16* bi = static_cast<const bf16*>(in);
  bf16* bo = static_cast<bf16*>(out);
  if (X % 2 == 0 && aligned4(in) && aligned4(out))
    jacobi7_wrap_bf16_kernel<true><<<grid, dim3(kBX, kBY), 0, st>>>(
        bi, bo, Z, Y, X, s);
  else
    jacobi7_wrap_bf16_kernel<false><<<grid, dim3(kBX, kBY), 0, st>>>(
        bi, bo, Z, Y, X, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// K2. Replaces stencil_tpu/ops/pallas_stencil.py:246 jacobi7_wrapn_pallas
// (and its steps=2 alias jacobi7_wrap2_pallas, :412).
// N periodic steps per pass over device memory (temporal blocking), the
// spheres re-imposed after every step at the wrapped global coordinates,
// as the JAX kernel's `sources` does (:308-320).
// Bound on this card: bytes. One read and one write of the field per N
// steps, 8 B per point (1.07 GB at 512^3: 0.32 ms a launch, 0.16 ms a
// step at N=2), against 7 flops per point per step.
// Design: csrc/jacobi_ring.cuh with kWrappedRows: each window row is the
// field's own row wrap(y, Y) at plane wrap(p, Z), x wrapped in the row.
// Unlike the TPU kernel, which held whole x rows in VMEM and rolled them,
// x is tiled too, so the recomputed ring runs round the tile in x as well.
// Order (pallas_stencil.py:325-330): ((zm+zp)+(ym+yp))+(xm+xp), *1/6.
// bfloat16 (is_bf16): the ring kernel's bfloat16 instance, N <= 8 a
// launch; ops/cuda_stencil.py runs N > 8 as two launches.
// ---------------------------------------------------------------------

// How many blocks of the ring kernel one SM holds at a tile and depth
// (K2's instantiation; B6's is the same body): ops/cuda_stencil.py
// ring_blocks_per_sm models it, and jacobi_ring_plan plans with that.
cudaError_t jacobi7_ring_blocks_per_sm(int N, int ty, int depth,
                                       int is_bf16, int* blocks_per_sm) {
  return is_bf16 ? ring_blocks_per_sm<kWrappedRows, bf16>(N, ty, depth,
                                                          blocks_per_sm)
                 : ring_blocks_per_sm<kWrappedRows, float>(N, ty, depth,
                                                           blocks_per_sm);
}

cudaError_t jacobi7_wrapn_launch(const void* in, void* out, int Z, int Y,
                                 int X, int hx, int hy, int hz, int cx,
                                 int cy, int cz, int r2, int N, int ty,
                                 int depth, int zrun, int is_bf16,
                                 void* stream) {
  const Spheres s{hx, hy, hz, cx, cy, cz, r2};
  const Global g{0, 0, 0, Z, Y, X};
  const Box bx{0, 0, Z, Y};
  const RingPlan pl{ty, depth, zrun};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_jacobi_ring<kWrappedRows, bf16>(
        static_cast<const bf16*>(in), static_cast<bf16*>(out),
        SlabSrc<bf16>{}, Z, Y, X, bx, g, s, N, pl, st);
  return launch_jacobi_ring<kWrappedRows, float>(
      static_cast<const float*>(in), static_cast<float*>(out),
      SlabSrc<float>{}, Z, Y, X, bx, g, s, N, pl, st);
}

cudaError_t jacobi7_padded_launch(const void* in, void* out, int Z, int Y,
                                  int X, int Yp, int Xp, int lz, int ly,
                                  int lx, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid(blocks(X, 2 * kBX), blocks(Y, kBY), blocks(Z, kZRun));
    jacobi7_padded_bf16_kernel<<<grid, dim3(kBX, kBY), 0, st>>>(
        static_cast<const bf16*>(in), static_cast<bf16*>(out), Z, Y, X, Yp,
        Xp, lz, ly, lx);
    return cudaGetLastError();
  }
  const dim3 grid(blocks(X, kBX), blocks(Y, kBY), blocks(Z, kZRun));
  jacobi7_padded_kernel<<<grid, dim3(kBX, kBY), 0, st>>>(
      static_cast<const float*>(in), static_cast<float*>(out), Z, Y, X, Yp,
      Xp, lz, ly, lx);
  return cudaGetLastError();
}

}  // extern "C"
