// MHD RK3 substep launchers for Hopper (sm_90a), float32.
//
// Four launchers, each the hand-written counterpart of one Pallas TPU
// kernel of stencil_tpu/ops/, bound to Python through a plain extern "C"
// launcher (ctypes; see stencil_tpu_torch/ops/_build.py and
// ops/cuda_mhd.py, which also holds each kernel's plain PyTorch twin):
//
//   B9  mhd_substep_wrap_launch    <- pallas_mhd.py:186 mhd_substep_wrap_pallas
//   B10 mhd_substep01_wrap_launch  <- pallas_mhd.py:347 mhd_substep01_wrap_pallas
//   B11 mhd_substep_halo_launch    <- pallas_halo.py:852 mhd_substep_halo_pallas
//   B12 mhd_substep01_halo_launch  <- pallas_halo.py:969 mhd_substep01_halo_pallas
//
// All evaluate the Astaroth right-hand sides (models/astaroth.py
// mhd_rates; reference: astaroth/user_kernels.h:383-453) on 8 unpadded
// (Z, Y, X) fields with the 6th-order operators of ops/fd6.py, and
// apply the Williamson RK3 update. B9/B10 read a field periodic in all
// three axes; B11/B12 read a shard of a z/y-sharded mesh and, across
// its z and y edges, the halo slabs of parallel/exchange.py
// exchange_interior_slabs (x wraps in the kernel in all four). Every
// launch is the z-streaming shared-memory ring of mhd_ring.cuh
// (mhd_substep_ring_kernel, which also computes B13's interior in
// csrc/mhd_overlap.cu): B9 launches it with the field's own wrapped rows
// as its margin, B11 with the shard's slabs, so on a (1,1,1) mesh the
// two are the same computation bit for bit. The substep pairs B10 and
// B12 (substeps 0 and 1; alpha_0 == 0, so no w is read) are those
// launches twice: B10 is B9 s=0 then B9 s=1; B12 is B11 s=0 over the
// shard, substep 0 over the R rows around it that substep 1 reads (the
// margin kernel below, from slabs of 2R rows), then B11 s=1 from those
// rows. So B10 and B12 equal their one-substep chains bit for bit. Every
// derivative, every term of the rates and the update is formed in the
// twin's order of operations; the library is built with -fmad=false, so
// no a*b+c is contracted into one rounding. exp is expf (never __expf),
// which differs from PyTorch's exp by an ulp at most: kernel and twin
// agree to a few ulps of each field, not bitwise. The device code they
// share with B13/B14 — the constants, fd6's operators, mhd_rates, the
// index helpers and the slab layout — is in mhd_common.cuh.
//
// Field order (FIELDS): lnrho, uux, uuy, uuz, ax, ay, az, ss.

#include "mhd_common.cuh"
#include "mhd_ring.cuh"

#include <cstring>

namespace {

// ---------------------------------------------------------------------
// B12's margin: substep 0 at the points within R outside a shard, which
// substep 1 reads there, written in the layout of the R-row slabs that
// B11 reads (mhd_common.cuh): the z strips z in [-R, 0) and [Z, Z + R)
// at y in [0, Y), walked in z (the ring's z instance), and the
// z-extended y strips y in [-R, 0) and [Y, Y + R) at z in [-R, Z + R),
// walked in y with z along the tile's 16 rows (its y instance). Their
// rows reach 2R outside the shard, all within the shard's slabs of 2R
// rows, by B11's source rule. Planned on the host (ops/cuda_mhd.py
// margin_plan), whose MarginPlan ints the launcher copies in as they
// are: tile index b (blockIdx.y) counts the near z strip's tiles, the
// far one's, then the near and the far y strip's; a strip's points go
// through its OutMap into the 8 fields' margin buffers.
// ---------------------------------------------------------------------
struct MarginPlan {
  int tz, ty;    // row tiles of a z strip (over y) and of a y strip (over z)
  int zlo, zhi;  // OutMap::off of the near and the far z strip
  int ylo, yhi;  // OutMap::off of the near and the far y strip
  int zs, ys;    // OutMap::zs of the z strips and of the y strips
};
constexpr int kMarginPlanInts = 8;
static_assert(sizeof(MarginPlan) == kMarginPlanInts * sizeof(int),
              "MarginPlan layout");

__global__ void __launch_bounds__(RingTile::kThreads, 1)
mhd_margin_kernel(InPtrs f, SlabPtrs sl, OutPtrs of, HaloGeom h,
                  MarginPlan p, Consts c) {
  extern __shared__ float ring[];  // [kRing][kNF][kPY][kPX]
  __shared__ RowSrc rows[RingTile::kRows];
  constexpr int kTY = RingTile::kTY;
  const int x0 = blockIdx.x * kBX;
  int b = blockIdx.y;
  if (b < 2 * p.tz) {
    const bool far = b >= p.tz;
    b -= far ? p.tz : 0;
    const int s0 = far ? h.Z : -R;
    ring_run<kStreamZ, false, false>(
        f, InPtrs{}, sl, of, OutPtrs{}, h, OutMap{far ? p.zhi : p.zlo, p.zs},
        kHaloRows, x0, b * kTY, h.Y, s0, s0 + R, c, ring, rows);
  } else {
    b -= 2 * p.tz;
    const bool far = b >= p.ty;
    b -= far ? p.ty : 0;
    const int s0 = far ? h.Y : -R;
    ring_run<kStreamY, false, false>(
        f, InPtrs{}, sl, of, OutPtrs{}, h, OutMap{far ? p.yhi : p.ylo, p.ys},
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

extern "C" {

// ---------------------------------------------------------------------
// B9. Replaces stencil_tpu/ops/pallas_mhd.py:186 mhd_substep_wrap_pallas:
// one RK3 substep on a field periodic in all three axes, the ring kernel
// (mhd_ring.cuh) over the whole field with its own wrapped rows as the
// margin (kWrappedRows). Bound on this card: bytes. At 256^3 a field is
// 64 MiB; s=0 reads 8 fields and writes 16 (24 passes, 0.48 ms at 3.35
// TB/s), s=1 reads 16 and writes 16 (32, 0.64 ms), s=2 reads 16 and
// writes 8 (0.48 ms); 958 flops per point (676 for the derivatives, 242
// for the rates, 40 for the update; 942 without the w read) make 0.24 ms
// at 67 TFLOP/s. Its first version was one thread per point reading
// its ~450 taps through L1/L2, 16-23 % slower (PERF.md, Findings).
//
// fields/w: 8 device pointers each (w NULL for w=None); out_f/out_w: 8
// each (out_w NULL for write_w=False); zrun: z planes a block walks;
// consts: kNConsts host floats.
// ---------------------------------------------------------------------
cudaError_t mhd_substep_wrap_launch(const void* const* fields,
                                    const void* const* w,
                                    void* const* out_f, void* const* out_w,
                                    int Z, int Y, int X, int zrun,
                                    const float* consts, int n_consts,
                                    void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X)) return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  const RingGeom g{{Z, Y, X, 0, 0}, 0, Z, 0, Y, zrun, kWrappedRows};
  return launch_ring(in_ptrs(fields), in_ptrs(w), SlabPtrs{},
                     out_ptrs(out_f), out_ptrs(out_w), g, c,
                     static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------
// B10. Replaces stencil_tpu/ops/pallas_mhd.py:347
// mhd_substep01_wrap_pallas: RK3 substeps 0 and 1 on a periodic field as
// two launches of B9's ring kernel, s=0 with w=None into the scratch
// f1, w1, then s=1 from them. Bound on this card: bytes. The function
// reads 8 fields and writes 16: 24 passes of a 64 MiB field at 256^3,
// 0.48 ms at 3.35 TB/s; two substep evaluations a point, 1,900 flops
// (0.48 ms at 67 TFLOP/s). The two launches move 24 + 32 passes (1.12
// ms). Its first design fused both substeps into one launch of 8^3
// tiles, recomputing substep 0 on the tile extended by R (5.4
// evaluations a point): 15.0 ms on an H100 (PERF.md, Findings).
//
// fields: 8 device pointers; f1/w1: 8 scratch fields each; out_f/out_w:
// 8 each; zrun: z planes a block walks; consts: kNConsts host floats.
// ---------------------------------------------------------------------
cudaError_t mhd_substep01_wrap_launch(const void* const* fields,
                                      void* const* f1, void* const* w1,
                                      void* const* out_f,
                                      void* const* out_w, int Z, int Y,
                                      int X, int zrun, const float* consts,
                                      int n_consts, void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X)) return cudaErrorInvalidValue;
  Consts c0, c1;
  pair_consts(consts, c0, c1);
  const RingGeom g{{Z, Y, X, 0, 0}, 0, Z, 0, Y, zrun, kWrappedRows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_ring(in_ptrs(fields), InPtrs{}, SlabPtrs{}, out_ptrs(f1),
                  out_ptrs(w1), g, c0, s);
  if (err != cudaSuccess) return err;
  const InPtrs f1p = in_ptrs(f1), w1p = in_ptrs(w1);
  return launch_ring(f1p, w1p, SlabPtrs{}, out_ptrs(out_f), out_ptrs(out_w),
                     g, c1, s);
}

// ---------------------------------------------------------------------
// B11. Replaces stencil_tpu/ops/pallas_halo.py:852
// mhd_substep_halo_pallas: one RK3 substep on a shard of a z/y-sharded
// mesh, the ring kernel over the whole shard with its margin rows from
// the shard and its slabs (kHaloRows). Bound on this card: bytes, as
// B9, plus the slab rows (0.3 % more at a 256^3 shard): 0.49 / 0.65 /
// 0.49 ms for s = 0 / 1 / 2 at 3.35 TB/s. Its first versions chose
// each tap's source inside the kernel (20 ms), then gathered a
// (Z + 6, Y + 6, X) window of the 8 fields into scratch first (16 more
// passes of device memory, 2.2 ms; PERF.md, Findings).
//
// fields/w: 8 device pointers each (w NULL for w=None); slabs: 32
// (zlo, zhi, ylo, yhi, each in field order); out_f/out_w: 8 each (out_w
// NULL for write_w=False); zrun: z planes a block walks; consts:
// kNConsts host floats.
// ---------------------------------------------------------------------
cudaError_t mhd_substep_halo_launch(const void* const* fields,
                                    const void* const* w,
                                    const void* const* slabs,
                                    void* const* out_f, void* const* out_w,
                                    int Z, int Y, int X, int rz, int ry,
                                    int zrun,
                                    const float* consts, int n_consts,
                                    void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !halo_ok(Z, Y, X, rz, ry, R))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  const RingGeom g{{Z, Y, X, rz, ry}, 0, Z, 0, Y, zrun, kHaloRows};
  return launch_ring(in_ptrs(fields), in_ptrs(w), slab_ptrs(slabs),
                     out_ptrs(out_f), out_ptrs(out_w), g, c,
                     static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------
// B12. Replaces stencil_tpu/ops/pallas_halo.py:969
// mhd_substep01_halo_pallas: RK3 substeps 0 and 1 on a shard whose slabs
// hold 2R rows, as three launches of the ring kernel: (1) B11 s=0 with
// w=None over the shard, from the shard and the slabs (halo_row_of takes
// any rz, ry >= R), into the scratch f1, w1; (2) substep 0 over the R
// rows around the shard (mhd_margin_kernel), from the same slabs, into
// f1's R-row slabs; (3) B11 s=1 over the shard from f1, w1 and those
// slabs. Bound on this card: bytes, as B10, plus the slab rows (0.5 %
// more at a 256^3 shard): 0.50 ms. Its first designs fused both substeps
// into one launch of 8^3 tiles, the taps chosen in the kernel (149 ms a
// 256^3 shard on an H100), then read from a radius-2R window gathered
// into scratch first (17.9 ms; PERF.md, Findings).
//
// fields: 8 device pointers; slabs: 32 (zlo, zhi, ylo, yhi, each in
// field order; rz, ry >= 2R rows); f1/w1: 8 scratch fields each;
// margin: 8 scratch buffers of n_margin floats, into which plan
// (n_plan = kMarginPlanInts ints, ops/cuda_mhd.py margin_plan) maps the
// margin; slabs1: 32, the same R-row slabs of f1 in B11's layout, views
// of margin; out_f/out_w: 8 each; zrun: z planes a block of launches (1)
// and (3) walks; consts: kNConsts host floats.
// ---------------------------------------------------------------------
cudaError_t mhd_substep01_halo_launch(
    const void* const* fields, const void* const* slabs, void* const* f1,
    void* const* w1, void* const* margin, const void* const* slabs1,
    void* const* out_f, void* const* out_w, int Z, int Y, int X, int rz,
    int ry, int zrun, const int* plan, int n_plan, int n_margin,
    const float* consts, int n_consts, void* stream) {
  if (n_consts != kNConsts || n_plan != kMarginPlanInts ||
      !shape_ok(Z, Y, X) || !halo_ok(Z, Y, X, rz, ry, 2 * R))
    return cudaErrorInvalidValue;
  MarginPlan p;
  std::memcpy(&p, plan, sizeof p);
  if (!margin_ok(p, Z, Y, X, n_margin)) return cudaErrorInvalidValue;
  Consts c0, c1;
  pair_consts(consts, c0, c1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const InPtrs fp = in_ptrs(fields);
  const SlabPtrs sp = slab_ptrs(slabs);
  const HaloGeom h{Z, Y, X, rz, ry};
  cudaError_t err = launch_ring(fp, InPtrs{}, sp, out_ptrs(f1), out_ptrs(w1),
                                RingGeom{h, 0, Z, 0, Y, zrun, kHaloRows},
                                c0, s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mhd_margin_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(RingTile::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(X, kBX), 2 * (p.tz + p.ty));
  mhd_margin_kernel<<<grid, dim3(kBX, RingTile::kTY), RingTile::kSmem, s>>>(
      fp, sp, out_ptrs(margin), h, p, c0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_ring(in_ptrs(f1), in_ptrs(w1), slab_ptrs(slabs1),
                     out_ptrs(out_f), out_ptrs(out_w),
                     RingGeom{{Z, Y, X, R, R}, 0, Z, 0, Y, zrun, kHaloRows},
                     c1, s);
}

}  // extern "C"
