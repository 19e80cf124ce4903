// 6th-order Laplacian kernel for Hopper (sm_90a), float32.
//
// B8 laplace6_kernel replaces stencil_tpu/ops/pallas_stencil.py:432
// laplace6_pallas: the sum over x, y and z of the 6th-order central
// second derivative (reference: astaroth/user_kernels.h:49-62
// second_derivative) on a radius-3 halo-padded (Zp, Yp, Xp) shard,
// writing the (Z, Y, X) interior. Bound to Python through a plain
// extern "C" launcher (ctypes; ops/cuda_stencil.py laplace6_cuda, beside
// its plain twin laplace6_plain).
//
// Order (pallas_stencil.py:451-465): accx, accy and accz each start at
// D2_C * centre and add w_i * (hi + lo) for i = 1..3; then
// out = (accx * ix2 + accy * iy2) + accz * iz2. Built with -fmad=false,
// so each multiply and add rounds as the twin's do: kernel and twin
// agree bitwise.
//
// Bound on this card: bytes. One read of the padded field and one write
// of the interior, (Zp*Yp*Xp + Z*Y*X) * 4 B (139 MB at 256^3, 0.042 ms
// at 3.35 TB/s), against 34 flops per point (0.009 ms at 67 TFLOP/s).
// Design: as the Jacobi kernel K3 (csrc/jacobi7.cu): a (32, 8) block of
// threads in (x, y), one thread per output column, each walking kZRun z
// planes with the 7 planes of its column's z pencil in registers, so
// device memory sees about one read per input point; the x and y
// neighbours are re-reads that L1/L2 serve. A warp reads 32 neighbouring
// x: every load and store is a coalesced 128-byte row.

#include <cuda_runtime.h>

namespace {

// pallas_stencil.py _D2_C, _D2: each rounded once from double to float
constexpr float kC = static_cast<float>(-49.0 / 18.0);
constexpr float kW1 = static_cast<float>(3.0 / 2.0);
constexpr float kW2 = static_cast<float>(-3.0 / 20.0);
constexpr float kW3 = static_cast<float>(1.0 / 90.0);
constexpr int R = 3;

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kZRun = 16;

__global__ void __launch_bounds__(kBX * kBY)
laplace6_kernel(const float* __restrict__ in, float* __restrict__ out, int Z,
                int Y, int X, int Yp, int Xp, int lz, int ly, int lx,
                float ix2, float iy2, float iz2) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z0 = blockIdx.z * kZRun;
  if (x >= X || y >= Y || z0 >= Z) return;
  const size_t pplane = static_cast<size_t>(Yp) * Xp;
  const size_t pcol = static_cast<size_t>(y + ly) * Xp + (x + lx);
  const size_t plane = static_cast<size_t>(Y) * X;
  const size_t col = static_cast<size_t>(y) * X + x;
  const int z1 = min(z0 + kZRun, Z);
  // zc[R + d] holds the column at z + d, d = -R..R
  float zc[2 * R + 1];
#pragma unroll
  for (int d = -R; d < R; ++d) zc[R + d] = in[(z0 + lz + d) * pplane + pcol];
  for (int z = z0; z < z1; ++z) {
    zc[2 * R] = in[(z + lz + R) * pplane + pcol];
    const float* p = in + (z + lz) * pplane + pcol;
    const float ctr = zc[R];
    float accx = kC * ctr;
    float accy = accx;
    float accz = kC * ctr;
    accx = accx + kW1 * (p[1] + p[-1]);
    accy = accy + kW1 * (p[Xp] + p[-Xp]);
    accz = accz + kW1 * (zc[R + 1] + zc[R - 1]);
    accx = accx + kW2 * (p[2] + p[-2]);
    accy = accy + kW2 * (p[2 * Xp] + p[-2 * Xp]);
    accz = accz + kW2 * (zc[R + 2] + zc[R - 2]);
    accx = accx + kW3 * (p[3] + p[-3]);
    accy = accy + kW3 * (p[3 * Xp] + p[-3 * Xp]);
    accz = accz + kW3 * (zc[R + 3] + zc[R - 3]);
    out[z * plane + col] = accx * ix2 + accy * iy2 + accz * iz2;
#pragma unroll
    for (int d = 0; d < 2 * R; ++d) zc[d] = zc[d + 1];
  }
}

inline unsigned blocks(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

extern "C" {

cudaError_t laplace6_launch(const float* in, float* out, int Z, int Y, int X,
                            int Yp, int Xp, int lz, int ly, int lx,
                            float ix2, float iy2, float iz2, void* stream) {
  const dim3 grid(blocks(X, kBX), blocks(Y, kBY), blocks(Z, kZRun));
  laplace6_kernel<<<grid, dim3(kBX, kBY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      in, out, Z, Y, X, Yp, Xp, lz, ly, lx, ix2, iy2, iz2);
  return cudaGetLastError();
}

}  // extern "C"
