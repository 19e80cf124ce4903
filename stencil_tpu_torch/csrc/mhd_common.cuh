// Device code shared by the MHD kernels for Hopper (sm_90a):
// csrc/mhd.cu (B9-B12), csrc/mhd_overlap.cu (B13, B14) and the ring
// kernel both launch (csrc/mhd_ring.cuh). Fields are stored in float32
// or bfloat16 (Store, below); every value is computed in float32.
//
// The Astaroth right-hand sides (models/astaroth.py mhd_rates;
// reference: astaroth/user_kernels.h:383-453) with the 6th-order
// operators of ops/fd6.py, the run's constants (struct Consts, filled by
// ops/cuda_mhd.py kernel_consts) and the halo-slab layout of B11-B14
// (halo_row_of). Every derivative and every term is formed in the
// plain twins' order of operations; the libraries are built -fmad=false,
// so no a*b+c is contracted into one rounding.
//
// Field order (FIELDS): lnrho, uux, uuy, uuz, ax, ay, az, ss.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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
// the same values, but ptxas then allotted the first fused pair kernel
// 128 registers instead of 130, and it ran 13 % slower on an H100
// (PERF.md, Findings).
struct Consts {
  float inv_ds[3];             // 1/ds (der1)
  float inv_ds2[3];            // (1/ds)^2 (der2)
  float inv_xy, inv_xz, inv_yz;  // 1/(ds_a ds_b) (der_cross)
  float third, two_thirds, half, inv_mu0, eta, cs2_sound, gamma_cp,
      gamma_m1, lnrho0, inv_cp, nu_visc, two, zeta, lnT0, eta_mu0, two_nu,
      gamma, one, c0001, cp;
  float dt, alpha, beta;       // the substep's RK3 coefficients
  float beta0, alpha1, beta1;  // the pair's: substeps 0 and 1
};
constexpr int kNConsts = 35;
static_assert(sizeof(Consts) == kNConsts * sizeof(float), "Consts layout");

// The storage types: float32, or bfloat16 (stored half-width, widened
// exactly to float32 on load, the float32 result rounded once to
// nearest even on store, as a PyTorch .to(torch.bfloat16) rounds it).
using bf16 = __nv_bfloat16;

// a bfloat16's bits as the float32 of the same value (exact)
__device__ __forceinline__ float widen(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16* p) {
  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 field pointers of one storage type T
template <class T>
struct InP {
  const T* p[kNF];
};
template <class T>
struct OutP {
  T* p[kNF];
};
using InPtrs = InP<float>;
using OutPtrs = OutP<float>;

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

constexpr int kBX = 32;

// Z and Y of every MHD field or shard are multiples of kT, the TPU's
// float32 sublane tile (ops/cuda_mhd.py mhd_tile), so that a grid takes
// the same path in both packages.
constexpr int kT = 8;

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
template <class T>
struct SlabP {
  const T* zlo[kNF];
  const T* zhi[kNF];
  const T* ylo[kNF];
  const T* yhi[kNF];
};
using SlabPtrs = SlabP<float>;

struct HaloGeom {
  int Z, Y, X, rz, ry;
};

// the source of window row (z, y) of one field: its shard fq and its
// four slabs
template <class T>
__device__ __forceinline__ const T* halo_row_of(
    const T* fq, const T* zlo, const T* zhi, const T* ylo, const T* yhi,
    const HaloGeom& g, int y, int z) {
  if (y < 0) return ylo + ((z + g.rz) * g.ry + g.ry + y) * g.X;
  if (y >= g.Y) return yhi + ((z + g.rz) * g.ry + y - g.Y) * g.X;
  if (z < 0) return zlo + ((z + g.rz) * g.Y + y) * g.X;
  if (z >= g.Z) return zhi + ((z - g.Z) * g.Y + y) * g.X;
  return fq + (z * g.Y + y) * g.X;
}

inline unsigned blocks(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

template <class T = float>
InP<T> in_ptrs(const void* const* src) {
  InP<T> out{};
  if (src != nullptr)
    for (int q = 0; q < kNF; ++q) out.p[q] = static_cast<const T*>(src[q]);
  return out;
}

template <class T = float>
OutP<T> out_ptrs(void* const* src) {
  OutP<T> out{};
  if (src != nullptr)
    for (int q = 0; q < kNF; ++q) out.p[q] = static_cast<T*>(src[q]);
  return out;
}

bool shape_ok(int Z, int Y, int X) {
  return Z > 0 && Y > 0 && X > 0 && Z % kT == 0 && Y % kT == 0 &&
         static_cast<long long>(Z) * Y * X < (1LL << 31);
}

template <class T = float>
SlabP<T> slab_ptrs(const void* const* src) {
  SlabP<T> out{};
  for (int q = 0; q < kNF; ++q) {
    out.zlo[q] = static_cast<const T*>(src[q]);
    out.zhi[q] = static_cast<const T*>(src[kNF + q]);
    out.ylo[q] = static_cast<const T*>(src[2 * kNF + q]);
    out.yhi[q] = static_cast<const T*>(src[3 * kNF + q]);
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
