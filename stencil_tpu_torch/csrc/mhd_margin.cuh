// Substep 0 just outside a shard, for Hopper (sm_90a): the
// margin kernel that B12 (csrc/mhd.cu) and the pair form of B14
// (csrc/mhd_overlap.cu) launch between their two substeps, and the
// constants of the substep pair both read.
//
// The margin: substep 0 at the points within R outside a shard, which
// substep 1 reads there, written in the layout of the R-row slabs that
// B11 reads (mhd_common.cuh): the z strips z in [-R, 0) and [Z, Z + R)
// at y in [0, Y), walked in z (the ring's z instance), and the
// z-extended y strips y in [-R, 0) and [Y, Y + R) at z in [-R, Z + R),
// walked in y with z along the tile's 16 rows (its y instance). Their
// rows reach 2R outside the shard, all within the shard's slabs of 2R
// rows, by B11's source rule. Planned on the host (ops/cuda_mhd.py
// margin_plan), whose MarginPlan ints the launchers copy in as they
// are: tile index b (blockIdx.y) counts the near z strip's tiles, the
// far one's, then the near and the far y strip's; a strip's points go
// through its OutMap into the 8 fields' margin buffers. The shard and
// its slabs are float32 or bfloat16 (TIn); the margin, like the pair's
// f1 and w1, is float32 in both.

#pragma once

#include "mhd_common.cuh"
#include "mhd_ring.cuh"

#include <cstring>

namespace {

struct MarginPlan {
  int tz, ty;    // row tiles of a z strip (over y) and of a y strip (over z)
  int zlo, zhi;  // OutMap::off of the near and the far z strip
  int ylo, yhi;  // OutMap::off of the near and the far y strip
  int zs, ys;    // OutMap::zs of the z strips and of the y strips
};
constexpr int kMarginPlanInts = 8;
static_assert(sizeof(MarginPlan) == kMarginPlanInts * sizeof(int),
              "MarginPlan layout");

template <class TIn = float>
__global__ void __launch_bounds__(RingTile::kThreads, 1)
mhd_margin_kernel(InP<TIn> f, SlabP<TIn> sl, OutPtrs of, HaloGeom h,
                  MarginPlan p, Consts c) {
  extern __shared__ float ring[];  // [kRing][kNF][kPY][kPX]
  __shared__ RowSrc<TIn> rows[RingTile::kRows];
  constexpr int kTY = RingTile::kTY;
  const int x0 = blockIdx.x * kBX;
  int b = blockIdx.y;
  if (b < 2 * p.tz) {
    const bool far = b >= p.tz;
    b -= far ? p.tz : 0;
    const int s0 = far ? h.Z : -R;
    ring_run<kStreamZ, false, false>(
        f, InP<TIn>{}, sl, of, OutPtrs{}, h,
        OutMap{far ? p.zhi : p.zlo, p.zs},
        kHaloRows, x0, b * kTY, h.Y, s0, s0 + R, c, ring, rows);
  } else {
    b -= 2 * p.tz;
    const bool far = b >= p.ty;
    b -= far ? p.ty : 0;
    const int s0 = far ? h.Y : -R;
    ring_run<kStreamY, false, false>(
        f, InP<TIn>{}, sl, of, OutPtrs{}, h,
        OutMap{far ? p.yhi : p.ylo, p.ys},
        kHaloRows, x0, -R + b * kTY, h.Z + R, s0, s0 + R, c, ring, rows);
  }
}

// The output offsets of plan p lie in [0, n) for every point of its
// strips (the margin buffers hold n floats a field), and its tiles fit
// a grid; false otherwise.
bool margin_ok(const MarginPlan& p, int Z, int Y, int X, long long n) {
  if (p.tz < 1 || p.ty < 1 || 2LL * (p.tz + p.ty) > 65535 || p.zs < X ||
      p.ys < X)
    return false;
  // (off, zs, z range, y range) of the four strips; each map is
  // increasing in z, y and x
  const long long s[4][6] = {{p.zlo, p.zs, -R, -1, 0, Y - 1},
                             {p.zhi, p.zs, Z, Z + R - 1, 0, Y - 1},
                             {p.ylo, p.ys, -R, Z + R - 1, -R, -1},
                             {p.yhi, p.ys, -R, Z + R - 1, Y, Y + R - 1}};
  for (const auto& t : s) {
    const long long lo = t[0] + t[2] * t[1] + t[4] * X;
    const long long hi = t[0] + t[3] * t[1] + t[5] * X + X - 1;
    if (lo < 0 || hi >= n) return false;
  }
  return true;
}

// The margin kernel over plan p (checked by margin_ok) on shard f with
// its slabs sl of 2R rows, substep constants c, into the buffers of.
template <class TIn = float>
cudaError_t launch_margin(const InP<TIn>& f, const SlabP<TIn>& sl,
                          const OutPtrs& of, const HaloGeom& h,
                          const MarginPlan& p, const Consts& c,
                          cudaStream_t s) {
  auto kernel = mhd_margin_kernel<TIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(RingTile::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(h.X, kBX), 2 * (p.tz + p.ty));
  kernel<<<grid, dim3(kBX, RingTile::kTY), RingTile::kSmem, s>>>(
      f, sl, of, h, p, c);
  return cudaGetLastError();
}

// substep 0's and substep 1's constants from the host's kNConsts floats
// (ops/cuda_mhd.py kernel_consts: the pair's beta0, alpha1, beta1)
void pair_consts(const float* src, Consts& c0, Consts& c1) {
  std::memcpy(&c0, src, sizeof c0);
  c0.alpha = 0.0f;  // alpha_0: w=None reads no w
  c0.beta = c0.beta0;
  c1 = c0;
  c1.alpha = c0.alpha1;
  c1.beta = c0.beta1;
}

}  // namespace
