// Fused MHD RK3 substep kernels for Hopper (sm_90a), float32.
//
// Four kernels, each the hand-written counterpart of one Pallas TPU
// kernel of stencil_tpu/ops/, bound to Python through a plain extern "C"
// launcher (ctypes; see stencil_tpu_torch/ops/_build.py and
// ops/cuda_mhd.py, which also holds each kernel's plain PyTorch twin):
//
//   B9  mhd_substep_wrap_kernel    <- pallas_mhd.py:186 mhd_substep_wrap_pallas
//   B10 mhd_substep01_wrap_kernel  <- pallas_mhd.py:347 mhd_substep01_wrap_pallas
//   B11 mhd_substep_halo_kernel    <- pallas_halo.py:852 mhd_substep_halo_pallas
//   B12 mhd_substep01_halo_kernel  <- pallas_halo.py:969 mhd_substep01_halo_pallas
//
// All evaluate the Astaroth right-hand sides (models/astaroth.py
// mhd_rates; reference: astaroth/user_kernels.h:383-453) on 8 unpadded
// (Z, Y, X) fields with the 6th-order operators of ops/fd6.py, and
// apply the Williamson RK3 update. B9/B10 read a field periodic in all
// three axes; B11/B12 read a shard of a z/y-sharded mesh and, across
// its z and y edges, the halo slabs of parallel/exchange.py
// exchange_interior_slabs (x wraps in the kernel in all four). Every
// derivative, every term of the rates and the update is formed in the
// twin's order of operations; the library is built with -fmad=false, so
// no a*b+c is contracted into one rounding. exp is expf (never __expf),
// which differs from PyTorch's exp by an ulp at most: kernel and twin
// agree to a few ulps of each field, not bitwise.
//
// Field order (FIELDS): lnrho, uux, uuy, uuz, ax, ay, az, ss.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kNF = 8;
constexpr int R = 3;  // stencil radius (6th order)
enum Field { LNRHO = 0, UUX, UUY, UUZ, AX, AY, AZ, SS };

// fd6.py coefficient tables, each rounded once from double to float
constexpr float kD1_1 = static_cast<float>(3.0 / 4.0);
constexpr float kD1_2 = static_cast<float>(-3.0 / 20.0);
constexpr float kD1_3 = static_cast<float>(1.0 / 60.0);
constexpr float kD2_C = static_cast<float>(-49.0 / 18.0);
constexpr float kD2_1 = static_cast<float>(3.0 / 2.0);
constexpr float kD2_2 = static_cast<float>(-3.0 / 20.0);
constexpr float kD2_3 = static_cast<float>(1.0 / 90.0);
constexpr float kDC_1 = static_cast<float>(270.0 / 720.0);
constexpr float kDC_2 = static_cast<float>(-27.0 / 720.0);
constexpr float kDC_3 = static_cast<float>(2.0 / 720.0);

// The run's constants, computed in double on the host exactly as
// mhd_rates and fd6 compute them and rounded once to float
// (ops/cuda_mhd.py kernel_consts, same order). mhd_rates' literals
// (third ... c0001) travel here too: as constexpr immediates they give
// the same values, but ptxas then allots B10 128 registers instead of
// 130 and B10 runs 13 % slower on an H100 (PERF.md, Findings).
struct Consts {
  float inv_ds[3];             // 1/ds (der1)
  float inv_ds2[3];            // (1/ds)^2 (der2)
  float inv_xy, inv_xz, inv_yz;  // 1/(ds_a ds_b) (der_cross)
  float third, two_thirds, half, inv_mu0, eta, cs2_sound, gamma_cp,
      gamma_m1, lnrho0, inv_cp, nu_visc, two, zeta, lnT0, eta_mu0, two_nu,
      gamma, one, c0001, cp;
  float dt, alpha, beta;       // B9: the substep's RK3 coefficients
  float beta0, alpha1, beta1;  // B10: substeps 0 and 1
};
constexpr int kNConsts = 35;
static_assert(sizeof(Consts) == kNConsts * sizeof(float), "Consts layout");

struct InPtrs {
  const float* p[kNF];
};
struct OutPtrs {
  float* p[kNF];
};

// value, gradient and the hessian entries mhd_rates reads of one field
// (fd6.FieldData); h[a][b] for a <= b
struct Fd {
  float v;
  float g[3];
  float h[3][3];
  __device__ __forceinline__ float hs(int a, int b) const {
    return a <= b ? h[a][b] : h[b][a];
  }
  // FieldData.laplace: (h00 + h11) + h22
  __device__ __forceinline__ float lap() const {
    return (h[0][0] + h[1][1]) + h[2][2];
  }
};

// ---------------------------------------------------------------------
// fd6 operators on an accessor at(dx, dy, dz); AX: 0=x, 1=y, 2=z
// ---------------------------------------------------------------------
template <int AX, class At>
__device__ __forceinline__ float on_axis(const At& at, int i) {
  return at(AX == 0 ? i : 0, AX == 1 ? i : 0, AX == 2 ? i : 0);
}

// fd6.der1: c_i * (hi - lo) summed over i = 1..3, then * 1/ds
template <int AX, class At>
__device__ __forceinline__ float der1(const At& at, float inv) {
  float acc = kD1_1 * (on_axis<AX>(at, 1) - on_axis<AX>(at, -1));
  acc = acc + kD1_2 * (on_axis<AX>(at, 2) - on_axis<AX>(at, -2));
  acc = acc + kD1_3 * (on_axis<AX>(at, 3) - on_axis<AX>(at, -3));
  return acc * inv;
}

// fd6.der2: D2_C * centre, + c_i * (hi + lo), then * (1/ds)^2
template <int AX, class At>
__device__ __forceinline__ float der2(const At& at, float inv2) {
  float acc = kD2_C * at(0, 0, 0);
  acc = acc + kD2_1 * (on_axis<AX>(at, 1) + on_axis<AX>(at, -1));
  acc = acc + kD2_2 * (on_axis<AX>(at, 2) + on_axis<AX>(at, -2));
  acc = acc + kD2_3 * (on_axis<AX>(at, 3) + on_axis<AX>(at, -3));
  return acc * inv2;
}

template <int A, int B, class At>
__device__ __forceinline__ float diag(const At& at, int sa, int sb) {
  return at((A == 0 ? sa : 0) + (B == 0 ? sb : 0),
            (A == 1 ? sa : 0) + (B == 1 ? sb : 0),
            (A == 2 ? sa : 0) + (B == 2 ? sb : 0));
}

// fd6.der_cross: c_i * (((at(i,i) + at(-i,-i)) - at(i,-i)) - at(-i,i))
template <int A, int B, class At>
__device__ __forceinline__ float cross_term(const At& at, int i) {
  return ((diag<A, B>(at, i, i) + diag<A, B>(at, -i, -i)) -
          diag<A, B>(at, i, -i)) -
         diag<A, B>(at, -i, i);
}

template <int A, int B, class At>
__device__ __forceinline__ float der_cross(const At& at, float inv_ab) {
  float acc = kDC_1 * cross_term<A, B>(at, 1);
  acc = acc + kDC_2 * cross_term<A, B>(at, 2);
  acc = acc + kDC_3 * cross_term<A, B>(at, 3);
  return acc * inv_ab;
}

// value, gradient and the three second derivatives (lnrho, ss)
template <class At>
__device__ __forceinline__ void scalar_data(const At& at, const Consts& c,
                                            Fd& d) {
  d.v = at(0, 0, 0);
  d.g[0] = der1<0>(at, c.inv_ds[0]);
  d.g[1] = der1<1>(at, c.inv_ds[1]);
  d.g[2] = der1<2>(at, c.inv_ds[2]);
  d.h[0][0] = der2<0>(at, c.inv_ds2[0]);
  d.h[1][1] = der2<1>(at, c.inv_ds2[1]);
  d.h[2][2] = der2<2>(at, c.inv_ds2[2]);
}

// component K of uu or aa: also the two mixed derivatives grad-div reads
template <int K, class At>
__device__ __forceinline__ void vector_data(const At& at, const Consts& c,
                                            Fd& d) {
  scalar_data(at, c, d);
  if (K != 2) d.h[0][1] = der_cross<0, 1>(at, c.inv_xy);
  if (K != 1) d.h[0][2] = der_cross<0, 2>(at, c.inv_xz);
  if (K != 0) d.h[1][2] = der_cross<1, 2>(at, c.inv_yz);
}

// all 8 fields' data from one accessor factory mk(q)
template <class Mk>
__device__ __forceinline__ void field_data(const Mk& mk, const Consts& c,
                                           Fd* F) {
  scalar_data(mk(LNRHO), c, F[LNRHO]);
  vector_data<0>(mk(UUX), c, F[UUX]);
  vector_data<1>(mk(UUY), c, F[UUY]);
  vector_data<2>(mk(UUZ), c, F[UUZ]);
  vector_data<0>(mk(AX), c, F[AX]);
  vector_data<1>(mk(AY), c, F[AY]);
  vector_data<2>(mk(AZ), c, F[AZ]);
  scalar_data(mk(SS), c, F[SS]);
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// ---------------------------------------------------------------------
// models/astaroth.py mhd_rates, expression for expression (Python's
// left-to-right association written out); r[] in FIELDS order.
// 242 flops per point (the 4 expf counted as one each).
// ---------------------------------------------------------------------
__device__ __forceinline__ void mhd_rates(const Fd* F, const Consts& c,
                                          float* r) {
  const Fd& L = F[LNRHO];
  const Fd& S_ = F[SS];
  const Fd* U = F + UUX;
  const Fd* A = F + AX;
  const float u[3] = {U[0].v, U[1].v, U[2].v};
  const float* gl = L.g;
  const float* gs = S_.g;

  const float div_u = (U[0].g[0] + U[1].g[1]) + U[2].g[2];
  // continuity
  r[LNRHO] = -dot(u, gl) - div_u;

  // traceless rate-of-strain tensor
  float S[3][3];
  S[0][0] = c.two_thirds * U[0].g[0] - c.third * (U[1].g[1] + U[2].g[2]);
  S[1][1] = c.two_thirds * U[1].g[1] - c.third * (U[0].g[0] + U[2].g[2]);
  S[2][2] = c.two_thirds * U[2].g[2] - c.third * (U[0].g[0] + U[1].g[1]);
  S[0][1] = S[1][0] = c.half * (U[0].g[1] + U[1].g[0]);
  S[0][2] = S[2][0] = c.half * (U[0].g[2] + U[2].g[0]);
  S[1][2] = S[2][1] = c.half * (U[1].g[2] + U[2].g[1]);

  // current j and B = curl A
  float lap_a[3], j[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float gda = (A[0].hs(i, 0) + A[1].hs(i, 1)) + A[2].hs(i, 2);
    lap_a[i] = A[i].lap();
    j[i] = c.inv_mu0 * (gda - lap_a[i]);
  }
  const float B[3] = {A[2].g[1] - A[1].g[2], A[0].g[2] - A[2].g[0],
                      A[1].g[0] - A[0].g[1]};

  // induction
  float uxB[3];
  cross(u, B, uxB);
#pragma unroll
  for (int i = 0; i < 3; ++i) r[AX + i] = uxB[i] + c.eta * lap_a[i];

  // momentum
  const float cs2 =
      c.cs2_sound * expf(c.gamma_cp * S_.v + c.gamma_m1 * (L.v - c.lnrho0));
  const float inv_rho = expf(-L.v);
  float jxB[3];
  cross(j, B, jxB);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float adv = dot(U[i].g, u);
    const float gdu = (U[0].hs(i, 0) + U[1].hs(i, 1)) + U[2].hs(i, 2);
    const float sdg = dot(S[i], gl);
    r[UUX + i] = -adv - cs2 * (c.inv_cp * gs[i] + gl[i]) +
                 inv_rho * jxB[i] +
                 c.nu_visc * (U[i].lap() + c.third * gdu + c.two * sdg) +
                 c.zeta * gdu;
  }

  // entropy
  const float lnT =
      c.lnT0 + c.gamma_cp * S_.v + c.gamma_m1 * (L.v - c.lnrho0);
  const float rho = expf(L.v);
  const float inv_pT = expf(-L.v - lnT);
  float contract = S[0][0] * S[0][0];
#pragma unroll
  for (int k = 1; k < 9; ++k) contract = contract + S[k / 3][k % 3] * S[k / 3][k % 3];
  const float rhs = c.eta_mu0 * dot(j, j) + c.two_nu * rho * contract +
                    c.zeta * rho * div_u * div_u;
  // heat conduction, chi = 0.001 / (rho cp)
  const float gm1 = c.gamma - c.one;  // (gamma_ - c(1.0)), at run time
  const float first = c.gamma * c.inv_cp * S_.lap() + gm1 * L.lap();
  float second[3], third_t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    second[i] = c.gamma * c.inv_cp * gs[i] + gm1 * gl[i];
    third_t[i] = c.gamma * (c.inv_cp * gs[i] + gl[i]) - gl[i];
  }
  const float chi = c.c0001 * inv_rho * c.inv_cp;
  const float heat = c.cp * chi * (first + dot(second, third_t));
  r[SS] = -dot(u, gs) + inv_pT * rhs + heat;
}

__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

// Periodic offsets of the 7 x columns, 7 y rows and 7 z planes around
// one point, wrapped once per point (21 modulo operations) so that no
// neighbour access divides.
struct Idx {
  int x[2 * R + 1], y[2 * R + 1], z[2 * R + 1];
  __device__ __forceinline__ Idx(int px, int py, int pz, int X, int Y,
                                 int Z) {
    const int XY = X * Y;
#pragma unroll
    for (int d = -R; d <= R; ++d) {
      x[d + R] = wrap(px + d, X);
      y[d + R] = wrap(py + d, Y) * X;
      z[d + R] = wrap(pz + d, Z) * XY;
    }
  }
  __device__ __forceinline__ int at(int dx, int dy, int dz) const {
    return z[dz + R] + y[dy + R] + x[dx + R];
  }
};

// a field in device memory around one point, through the read-only path
struct GlobalAt {
  const float* __restrict__ p;
  const Idx& I;
  __device__ __forceinline__ float operator()(int dx, int dy, int dz) const {
    return __ldg(p + I.at(dx, dy, dz));
  }
};

// ---------------------------------------------------------------------
// B9. Replaces stencil_tpu/ops/pallas_mhd.py:186 mhd_substep_wrap_pallas.
// One RK3 substep s: rates at every point, then
//   wq = dt * rates;  wq = alpha * w + wq  (only when w is read);
//   w_out = wq (only when written);  f_out = value + beta * wq.
// kReadW=false is w=None (alpha_0 == 0: substep 0 never reads w);
// kWriteW=false is write_w=False (nothing reads substep 2's w).
// Bound on this card: bytes. At 256^3 a field is 64 MiB; s=0 reads 8
// fields and writes 16 (24 passes, 0.48 ms at 3.35 TB/s), s=1 reads 16
// and writes 16 (32, 0.64 ms), s=2 reads 16 and writes 8 (0.48 ms);
// 958 flops per point (676 for the derivatives, 242 for the rates, 40
// for the update; 942 without the w read) make 0.24 ms at 67 TFLOP/s.
// Design (first, simple version): one thread per output point, a (32,
// 8) block over (x, y) and one z plane per block row of the grid. Each
// thread reads its radius-3 neighbourhood of all 8 fields straight from
// device memory (__ldg; neighbouring threads share it through L1/L2),
// builds each field's value, gradient and hessian entries in registers
// and evaluates the rates there. Shared-memory windows and z-streaming,
// which would cut the ~450 loads per point, are left for later.
// Registers: the rates want about 128 a thread; __launch_bounds__(256,
// 2) holds every variant to 128 so that two blocks (16 warps) fit an SM
// (without it the variant that reads and writes w took 130, one block
// per SM, and ran 1.7x slower than the others).
// ---------------------------------------------------------------------
constexpr int kBX = 32;
constexpr int kBY = 8;

template <bool kReadW, bool kWriteW>
__global__ void __launch_bounds__(kBX * kBY, 2)
mhd_substep_wrap_kernel(InPtrs f, InPtrs w, OutPtrs of, OutPtrs ow, int Z,
                        int Y, int X, Consts c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= X || y >= Y) return;
  const Idx I(x, y, z, X, Y, Z);
  Fd F[kNF];
  field_data([&](int q) { return GlobalAt{f.p[q], I}; }, c, F);
  float r[kNF];
  mhd_rates(F, c, r);
  const int o = I.at(0, 0, 0);
#pragma unroll
  for (int q = 0; q < kNF; ++q) {
    float wq = c.dt * r[q];
    if (kReadW) wq = c.alpha * __ldg(w.p[q] + o) + wq;
    if (kWriteW) ow.p[q][o] = wq;
    of.p[q][o] = F[q].v + c.beta * wq;
  }
}

// ---------------------------------------------------------------------
// B10. Replaces stencil_tpu/ops/pallas_mhd.py:347
// mhd_substep01_wrap_pallas. RK3 substeps 0 and 1 in one launch
// (alpha_0 == 0, so no w is read):
//   phase 1: w1 = dt * rates0;  f1 = value + beta0 * w1
//            on the block's tile extended by R on every side;
//   phase 2: wq = alpha1 * w1 + dt * rates1(f1);  w_out = wq;
//            f_out = f1 + beta1 * wq  on the tile.
// Bound on this card: bytes. 8 fields read, 16 written: 24 passes of a
// 64 MiB field at 256^3, 0.48 ms; the work the function needs is two
// substep evaluations per point, 942 + 958 = 1,900 flops (0.48 ms at
// 67 TFLOP/s), so the two bounds nearly meet.
// Design (first, simple version): a block owns a kT^3 tile (x tiled
// too, unlike the TPU kernel, which held whole x rows). Phase 1
// computes f1 at the (kT+2R)^3 extended tile, reading device memory as
// B9 does, and keeps it in shared memory with w1 of the tile's own
// points; phase 2 reads only shared memory. The ring is recomputed, not
// approximated, so B10 equals B9(s=0) followed by B9(s=1) point for
// point; it pays (kT+2R)^3 / kT^3 = 5.4 substep-0 evaluations per
// point for it. It takes about 130 registers a thread, so one block
// runs per SM; holding it to 128 for a second block (which the 104,192 B
// of shared memory would allow) measured slower, 17.4 ms against 15.0
// at 256^3 on an H100.
// ---------------------------------------------------------------------
constexpr int kT = 8;                 // tile edge, z, y and x
constexpr int kE = kT + 2 * R;        // extended tile edge
constexpr int kE3 = kE * kE * kE;     // 2744 extended points
constexpr int kT3 = kT * kT * kT;     // 512 tile points
constexpr int kPairThreads = 256;
constexpr size_t kPairSmem = sizeof(float) * kNF * (kE3 + kT3);  // 104,192 B

// f1 of one field in shared memory, around one tile point
struct SharedAt {
  const float* p;  // the point's f1 in field q's extended tile
  __device__ __forceinline__ float operator()(int dx, int dy, int dz) const {
    return p[(dz * kE + dy) * kE + dx];
  }
};

__global__ void __launch_bounds__(kPairThreads)
mhd_substep01_wrap_kernel(InPtrs f, OutPtrs of, OutPtrs ow, int Z, int Y,
                          int X, Consts c) {
  extern __shared__ float smem[];
  float* sF = smem;              // [kNF][kE][kE][kE] f1, extended tile
  float* sW = smem + kNF * kE3;  // [kNF][kT][kT][kT] w1, tile
  const int x0 = blockIdx.x * kT, y0 = blockIdx.y * kT, z0 = blockIdx.z * kT;

  // phase 1: substep 0 on the extended tile
  for (int e = threadIdx.x; e < kE3; e += kPairThreads) {
    const int ex = e % kE, ey = (e / kE) % kE, ez = e / (kE * kE);
    const Idx I(x0 - R + ex, y0 - R + ey, z0 - R + ez, X, Y, Z);
    Fd F[kNF];
    field_data([&](int q) { return GlobalAt{f.p[q], I}; }, c, F);
    float r[kNF];
    mhd_rates(F, c, r);
    const bool core = ex >= R && ex < R + kT && ey >= R && ey < R + kT &&
                      ez >= R && ez < R + kT;
    const int t = ((ez - R) * kT + (ey - R)) * kT + (ex - R);
#pragma unroll
    for (int q = 0; q < kNF; ++q) {
      const float w1 = c.dt * r[q];
      sF[q * kE3 + e] = F[q].v + c.beta0 * w1;
      if (core) sW[q * kT3 + t] = w1;
    }
  }
  __syncthreads();

  // phase 2: substep 1 on the tile, from shared memory only
  for (int t = threadIdx.x; t < kT3; t += kPairThreads) {
    const int cx = t % kT, cy = (t / kT) % kT, cz = t / (kT * kT);
    const int x = x0 + cx;
    if (x >= X) continue;
    const int e = ((cz + R) * kE + (cy + R)) * kE + (cx + R);
    Fd F[kNF];
    field_data([&](int q) { return SharedAt{sF + q * kE3 + e}; }, c, F);
    float r[kNF];
    mhd_rates(F, c, r);
    const int o = ((z0 + cz) * Y + (y0 + cy)) * X + x;
#pragma unroll
    for (int q = 0; q < kNF; ++q) {
      const float wq = c.alpha1 * sW[q * kT3 + t] + c.dt * r[q];
      ow.p[q][o] = wq;
      of.p[q][o] = F[q].v + c.beta1 * wq;
    }
  }
}

// ---------------------------------------------------------------------
// The slab layout of B11/B12 (ops/cuda_mhd.py halo_window; the window
// semantics of pallas_halo.py _mhd_window_plan's select_window). Per
// field, zlo/zhi (rz, Y, X) hold the z neighbours' rows (zlo's last row
// is z = -1, zhi's first z = Z) and the z-extended ylo/yhi (Z + 2 rz,
// ry, X) the y neighbours' rows at every z in [-rz, Z + rz) (ylo's last
// row is y = -1, yhi's first y = Y). Row (z, y) of the radius-rr window
// comes from the y slabs where y is outside [0, Y) (so the yz corners
// come from them), else from the z slabs where z is outside [0, Z), else
// from the shard.
// ---------------------------------------------------------------------
struct SlabPtrs {
  const float* zlo[kNF];
  const float* zhi[kNF];
  const float* ylo[kNF];
  const float* yhi[kNF];
};

struct HaloGeom {
  int Z, Y, X, rz, ry;
};

// the source of window row (z, y) of field q
__device__ __forceinline__ const float* halo_row(const InPtrs& f,
                                                 const SlabPtrs& sl, int q,
                                                 const HaloGeom& g, int y,
                                                 int z) {
  if (y < 0) return sl.ylo[q] + ((z + g.rz) * g.ry + g.ry + y) * g.X;
  if (y >= g.Y) return sl.yhi[q] + ((z + g.rz) * g.ry + y - g.Y) * g.X;
  if (z < 0) return sl.zlo[q] + ((z + g.rz) * g.Y + y) * g.X;
  if (z >= g.Z) return sl.zhi[q] + ((z - g.Z) * g.Y + y) * g.X;
  return f.p[q] + (z * g.Y + y) * g.X;
}

// B11/B12, step 1: the (Z + 2rr, Y + 2rr, X) window of every field,
// gathered from the shard and its slabs; one block per window row, so
// the source is chosen once per row (block-uniform) and the row copied
// coalesced.
constexpr int kWinBX = 128;

__global__ void __launch_bounds__(kWinBX)
halo_window_kernel(InPtrs f, SlabPtrs sl, OutPtrs win, HaloGeom g, int rr) {
  const int x = blockIdx.x * kWinBX + threadIdx.x;
  if (x >= g.X) return;
  const int wy = blockIdx.y, wz = blockIdx.z;
  const int o = (wz * (g.Y + 2 * rr) + wy) * g.X + x;
#pragma unroll
  for (int q = 0; q < kNF; ++q)
    win.p[q][o] = __ldg(halo_row(f, sl, q, g, wy - rr, wz - rr) + x);
}

// Offsets of the 7 x columns, 7 y rows and 7 z planes around one point
// of the (Z + 2rr, Y + 2rr, X) window: x wrapped, y and z shifted by rr
// (B9's Idx, with the window's rows in place of y/z wrapping).
struct PadIdx {
  int x[2 * R + 1], y[2 * R + 1], z[2 * R + 1];
  __device__ __forceinline__ PadIdx(int px, int py, int pz, int X, int Yw,
                                    int rr) {
#pragma unroll
    for (int d = -R; d <= R; ++d) {
      x[d + R] = wrap(px + d, X);
      y[d + R] = (py + rr + d) * X;
      z[d + R] = (pz + rr + d) * Yw * X;
    }
  }
  __device__ __forceinline__ int at(int dx, int dy, int dz) const {
    return z[dz + R] + y[dy + R] + x[dx + R];
  }
};

struct PadAt {
  const float* __restrict__ p;
  const PadIdx& I;
  __device__ __forceinline__ float operator()(int dx, int dy, int dz) const {
    return __ldg(p + I.at(dx, dy, dz));
  }
};

// ---------------------------------------------------------------------
// B11. Replaces stencil_tpu/ops/pallas_halo.py:852
// mhd_substep_halo_pallas. One RK3 substep s on a shard of a z/y-sharded
// mesh, B9's arithmetic point for point:
//   wq = dt * rates;  wq = alpha * w + wq  (only when w is read);
//   w_out = wq (only when written);  f_out = value + beta * wq,
// with B9's dead-w elision (kReadW=false is w=None, kWriteW=false is
// write_w=False). On a (1,1,1) mesh the slabs are the shard's own
// wrapped rows, so B11 computes B9's values bitwise.
// Bound on this card: bytes, as B9, plus the slab rows (0.3 % more at a
// 256^3 shard); the window costs another 16 passes of device memory.
// Design: two launches. halo_window_kernel gathers the radius-R window
// of all 8 fields (source chosen once per row); this kernel is then
// B9's, one thread per output point, a (32, 8) block over (x, y), one z
// plane per block row, reading the window through PadIdx. The first
// version chose the source for each of the ~450 taps of a point inside
// the kernel (warp-uniform branches): 105 registers, but 20 ms a launch
// on a 256^3 shard of an H100 against B9's 1.8, its unrolled code ten
// times B9's (nvcc took 104 s for this file), most likely instruction-
// cache bound (PERF.md, Findings). __launch_bounds__(256, 2) as B9.
// ---------------------------------------------------------------------
template <bool kReadW, bool kWriteW>
__global__ void __launch_bounds__(kBX * kBY, 2)
mhd_substep_halo_kernel(InPtrs win, InPtrs w, OutPtrs of, OutPtrs ow,
                        HaloGeom g, Consts c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= g.X || y >= g.Y) return;
  const PadIdx I(x, y, z, g.X, g.Y + 2 * R, R);
  Fd F[kNF];
  field_data([&](int q) { return PadAt{win.p[q], I}; }, c, F);
  float r[kNF];
  mhd_rates(F, c, r);
  const int o = (z * g.Y + y) * g.X + x;
#pragma unroll
  for (int q = 0; q < kNF; ++q) {
    float wq = c.dt * r[q];
    if (kReadW) wq = c.alpha * __ldg(w.p[q] + o) + wq;
    if (kWriteW) ow.p[q][o] = wq;
    of.p[q][o] = F[q].v + c.beta * wq;
  }
}

// ---------------------------------------------------------------------
// B12. Replaces stencil_tpu/ops/pallas_halo.py:969
// mhd_substep01_halo_pallas. RK3 substeps 0 and 1 on a shard whose slabs
// hold 2R = 6 rows, B10's arithmetic point for point. Bound on this
// card: bytes, as B10, plus the window's 16 passes. Design: two
// launches, as B11: halo_window_kernel gathers the radius-2R window
// (phase 1 evaluates substep 0 on the tile extended by R, whose taps
// reach 2R beyond the shard's edges); this kernel is then B10's (kT^3
// tile, ring recomputed, f1 in shared memory), phase 1 reading the
// window through PadIdx, phase 2 from shared memory only. The first
// version, with the per-tap source choice in phase 1, took 149 ms a
// launch on a 256^3 shard of an H100 (B10 15.0).
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kPairThreads)
mhd_substep01_halo_kernel(InPtrs win, OutPtrs of, OutPtrs ow, HaloGeom g,
                          Consts c) {
  extern __shared__ float smem[];
  float* sF = smem;              // [kNF][kE][kE][kE] f1, extended tile
  float* sW = smem + kNF * kE3;  // [kNF][kT][kT][kT] w1, tile
  const int x0 = blockIdx.x * kT, y0 = blockIdx.y * kT, z0 = blockIdx.z * kT;

  // phase 1: substep 0 on the extended tile, from the radius-2R window
  for (int e = threadIdx.x; e < kE3; e += kPairThreads) {
    const int ex = e % kE, ey = (e / kE) % kE, ez = e / (kE * kE);
    const PadIdx I(x0 - R + ex, y0 - R + ey, z0 - R + ez, g.X,
                   g.Y + 4 * R, 2 * R);
    Fd F[kNF];
    field_data([&](int q) { return PadAt{win.p[q], I}; }, c, F);
    float r[kNF];
    mhd_rates(F, c, r);
    const bool core = ex >= R && ex < R + kT && ey >= R && ey < R + kT &&
                      ez >= R && ez < R + kT;
    const int t = ((ez - R) * kT + (ey - R)) * kT + (ex - R);
#pragma unroll
    for (int q = 0; q < kNF; ++q) {
      const float w1 = c.dt * r[q];
      sF[q * kE3 + e] = F[q].v + c.beta0 * w1;
      if (core) sW[q * kT3 + t] = w1;
    }
  }
  __syncthreads();

  // phase 2: substep 1 on the tile, from shared memory only (B10's)
  for (int t = threadIdx.x; t < kT3; t += kPairThreads) {
    const int cx = t % kT, cy = (t / kT) % kT, cz = t / (kT * kT);
    const int x = x0 + cx;
    if (x >= g.X) continue;
    const int e = ((cz + R) * kE + (cy + R)) * kE + (cx + R);
    Fd F[kNF];
    field_data([&](int q) { return SharedAt{sF + q * kE3 + e}; }, c, F);
    float r[kNF];
    mhd_rates(F, c, r);
    const int o = ((z0 + cz) * g.Y + (y0 + cy)) * g.X + x;
#pragma unroll
    for (int q = 0; q < kNF; ++q) {
      const float wq = c.alpha1 * sW[q * kT3 + t] + c.dt * r[q];
      ow.p[q][o] = wq;
      of.p[q][o] = F[q].v + c.beta1 * wq;
    }
  }
}

inline unsigned blocks(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

InPtrs in_ptrs(const void* const* src) {
  InPtrs out{};
  if (src != nullptr)
    for (int q = 0; q < kNF; ++q) out.p[q] = static_cast<const float*>(src[q]);
  return out;
}

OutPtrs out_ptrs(void* const* src) {
  OutPtrs out{};
  if (src != nullptr)
    for (int q = 0; q < kNF; ++q) out.p[q] = static_cast<float*>(src[q]);
  return out;
}

bool shape_ok(int Z, int Y, int X) {
  return Z > 0 && Y > 0 && X > 0 && Z % kT == 0 && Y % kT == 0 &&
         static_cast<long long>(Z) * Y * X < (1LL << 31);
}

SlabPtrs slab_ptrs(const void* const* src) {
  SlabPtrs out{};
  for (int q = 0; q < kNF; ++q) {
    out.zlo[q] = static_cast<const float*>(src[q]);
    out.zhi[q] = static_cast<const float*>(src[kNF + q]);
    out.ylo[q] = static_cast<const float*>(src[2 * kNF + q]);
    out.yhi[q] = static_cast<const float*>(src[3 * kNF + q]);
  }
  return out;
}

// slabs of rz z rows and ry y rows feed a window of radius rr, whose
// offsets fit 32 bits
bool halo_ok(int Z, int Y, int X, int rz, int ry, int rr) {
  return rz >= rr && ry >= rr &&
         static_cast<long long>(Z + 2 * rr) * (Y + 2 * rr) * X < (1LL << 31);
}

}  // namespace

extern "C" {

// fields/w: 8 device pointers each (w NULL for w=None); out_f/out_w: 8
// each (out_w NULL for write_w=False); consts: kNConsts host floats.
cudaError_t mhd_substep_wrap_launch(const void* const* fields,
                                    const void* const* w,
                                    void* const* out_f, void* const* out_w,
                                    int Z, int Y, int X,
                                    const float* consts, int n_consts,
                                    void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X)) return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  const InPtrs fp = in_ptrs(fields), wp = in_ptrs(w);
  const OutPtrs op = out_ptrs(out_f), owp = out_ptrs(out_w);
  const dim3 grid(blocks(X, kBX), blocks(Y, kBY), Z);
  const dim3 block(kBX, kBY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr && out_w != nullptr)
    mhd_substep_wrap_kernel<true, true><<<grid, block, 0, s>>>(fp, wp, op, owp, Z, Y, X, c);
  else if (w != nullptr)
    mhd_substep_wrap_kernel<true, false><<<grid, block, 0, s>>>(fp, wp, op, owp, Z, Y, X, c);
  else if (out_w != nullptr)
    mhd_substep_wrap_kernel<false, true><<<grid, block, 0, s>>>(fp, wp, op, owp, Z, Y, X, c);
  else
    mhd_substep_wrap_kernel<false, false><<<grid, block, 0, s>>>(fp, wp, op, owp, Z, Y, X, c);
  return cudaGetLastError();
}

cudaError_t mhd_substep01_wrap_launch(const void* const* fields,
                                      void* const* out_f,
                                      void* const* out_w, int Z, int Y,
                                      int X, const float* consts,
                                      int n_consts, void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X)) return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  cudaError_t err = cudaFuncSetAttribute(
      mhd_substep01_wrap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPairSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(X, kT), Y / kT, Z / kT);
  mhd_substep01_wrap_kernel<<<grid, kPairThreads, kPairSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      in_ptrs(fields), out_ptrs(out_f), out_ptrs(out_w), Z, Y, X, c);
  return cudaGetLastError();
}

// fields/w: 8 device pointers each (w NULL for w=None); slabs: 32
// (zlo, zhi, ylo, yhi, each in field order); window: 8 scratch buffers
// of (Z + 2R) (Y + 2R) X floats; out_f/out_w: 8 each (out_w NULL for
// write_w=False); consts: kNConsts host floats.
cudaError_t mhd_substep_halo_launch(const void* const* fields,
                                    const void* const* w,
                                    const void* const* slabs,
                                    void* const* window,
                                    void* const* out_f, void* const* out_w,
                                    int Z, int Y, int X, int rz, int ry,
                                    const float* consts, int n_consts,
                                    void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !halo_ok(Z, Y, X, rz, ry, R))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  const HaloGeom g{Z, Y, X, rz, ry};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  halo_window_kernel<<<dim3(blocks(X, kWinBX), Y + 2 * R, Z + 2 * R),
                       kWinBX, 0, s>>>(in_ptrs(fields), slab_ptrs(slabs),
                                       out_ptrs(window), g, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const InPtrs wp = in_ptrs(window), wr = in_ptrs(w);
  const OutPtrs op = out_ptrs(out_f), owp = out_ptrs(out_w);
  const dim3 grid(blocks(X, kBX), blocks(Y, kBY), Z);
  const dim3 block(kBX, kBY);
  if (w != nullptr && out_w != nullptr)
    mhd_substep_halo_kernel<true, true><<<grid, block, 0, s>>>(wp, wr, op, owp, g, c);
  else if (w != nullptr)
    mhd_substep_halo_kernel<true, false><<<grid, block, 0, s>>>(wp, wr, op, owp, g, c);
  else if (out_w != nullptr)
    mhd_substep_halo_kernel<false, true><<<grid, block, 0, s>>>(wp, wr, op, owp, g, c);
  else
    mhd_substep_halo_kernel<false, false><<<grid, block, 0, s>>>(wp, wr, op, owp, g, c);
  return cudaGetLastError();
}

// as mhd_substep_halo_launch, with no w; window: 8 scratch buffers of
// (Z + 4R) (Y + 4R) X floats
cudaError_t mhd_substep01_halo_launch(const void* const* fields,
                                      const void* const* slabs,
                                      void* const* window,
                                      void* const* out_f,
                                      void* const* out_w, int Z, int Y,
                                      int X, int rz, int ry,
                                      const float* consts, int n_consts,
                                      void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !halo_ok(Z, Y, X, rz, ry, 2 * R))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  cudaError_t err = cudaFuncSetAttribute(
      mhd_substep01_halo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPairSmem));
  if (err != cudaSuccess) return err;
  const HaloGeom g{Z, Y, X, rz, ry};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  halo_window_kernel<<<dim3(blocks(X, kWinBX), Y + 4 * R, Z + 4 * R),
                       kWinBX, 0, s>>>(in_ptrs(fields), slab_ptrs(slabs),
                                       out_ptrs(window), g, 2 * R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(X, kT), Y / kT, Z / kT);
  mhd_substep01_halo_kernel<<<grid, kPairThreads, kPairSmem, s>>>(
      in_ptrs(window), out_ptrs(out_f), out_ptrs(out_w), g, c);
  return cudaGetLastError();
}

}  // extern "C"
