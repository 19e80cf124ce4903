// MHD RK3 substep launchers for Hopper (sm_90a), float32 or bfloat16
// storage (float32 arithmetic).
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
// margin kernel of mhd_margin.cuh, which B14's pair form launches too,
// from slabs of 2R rows), then B11 s=1 from those rows. So B10 and B12
// equal their one-substep chains bit for bit. Every derivative, every
// term of the rates and the update is formed in the twin's order of
// operations; the library is built with -fmad=false, so no a*b+c is
// contracted into one rounding. exp is expf (never __expf),
// which differs from PyTorch's exp by an ulp at most: kernel and twin
// agree to a few ulps of each field, not bitwise. The device code they
// share with B13/B14 — the constants, fd6's operators, mhd_rates, the
// index helpers and the slab layout — is in mhd_common.cuh.
//
// Every launcher takes is_bf16: 0 for float32 fields, 1 for bfloat16 ones
// (stored half-width, computed in float32; mhd_ring.cuh). With bf16 the
// pairs' scratch f1, w1 and margin stay float32, as in the JAX pair
// kernels, which never round them: so a bf16 pair does not equal two
// bf16 substeps, which round f1 and w1 to bfloat16 in between.
//
// Field order (FIELDS): lnrho, uux, uuy, uuz, ax, ay, az, ss.

#include "mhd_common.cuh"
#include "mhd_margin.cuh"
#include "mhd_ring.cuh"

#include <cstring>

namespace {

// B9 (kWrappedRows) and B11 (kHaloRows) in storage type S
template <class S>
cudaError_t substep(const void* const* fields, const void* const* w,
                    const void* const* slabs, void* const* out_f,
                    void* const* out_w, const RingGeom& g,
                    const float* consts, cudaStream_t s) {
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  return launch_ring(in_ptrs<S>(fields), in_ptrs<S>(w),
                     slabs ? slab_ptrs<S>(slabs) : SlabP<S>{},
                     out_ptrs<S>(out_f), out_ptrs<S>(out_w), g, c, s);
}

// B10 in storage type S: B9 s=0 into the float32 scratch, then s=1
template <class S>
cudaError_t substep01_wrap(const void* const* fields, void* const* f1,
                           void* const* w1, void* const* out_f,
                           void* const* out_w, const RingGeom& g,
                           const float* consts, cudaStream_t s) {
  Consts c0, c1;
  pair_consts(consts, c0, c1);
  const cudaError_t err =
      launch_ring(in_ptrs<S>(fields), InP<S>{}, SlabP<S>{}, out_ptrs(f1),
                  out_ptrs(w1), g, c0, s);
  if (err != cudaSuccess) return err;
  return launch_ring(in_ptrs(f1), in_ptrs(w1), SlabPtrs{},
                     out_ptrs<S>(out_f), out_ptrs<S>(out_w), g, c1, s);
}

// B12 in storage type S: its three launches (below), the scratch and
// the margin float32
template <class S>
cudaError_t substep01_halo(const void* const* fields,
                           const void* const* slabs, void* const* f1,
                           void* const* w1, void* const* margin,
                           const void* const* slabs1, void* const* out_f,
                           void* const* out_w, const HaloGeom& h, int zrun,
                           const MarginPlan& p, const float* consts,
                           cudaStream_t s) {
  Consts c0, c1;
  pair_consts(consts, c0, c1);
  const InP<S> fp = in_ptrs<S>(fields);
  const SlabP<S> sp = slab_ptrs<S>(slabs);
  const int Z = h.Z, Y = h.Y, X = h.X;
  cudaError_t err = launch_ring(fp, InP<S>{}, sp, out_ptrs(f1), out_ptrs(w1),
                                RingGeom{h, 0, Z, 0, Y, zrun, kHaloRows},
                                c0, s);
  if (err != cudaSuccess) return err;
  err = launch_margin(fp, sp, out_ptrs(margin), h, p, c0, s);
  if (err != cudaSuccess) return err;
  return launch_ring(in_ptrs(f1), in_ptrs(w1), slab_ptrs(slabs1),
                     out_ptrs<S>(out_f), out_ptrs<S>(out_w),
                     RingGeom{{Z, Y, X, R, R}, 0, Z, 0, Y, zrun, kHaloRows},
                     c1, s);
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
// consts: kNConsts host floats; is_bf16: the storage type (0 float32, 1
// bfloat16) of fields, w and outputs.
// ---------------------------------------------------------------------
cudaError_t mhd_substep_wrap_launch(const void* const* fields,
                                    const void* const* w,
                                    void* const* out_f, void* const* out_w,
                                    int Z, int Y, int X, int zrun,
                                    const float* consts, int n_consts,
                                    int is_bf16, void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X)) return cudaErrorInvalidValue;
  const RingGeom g{{Z, Y, X, 0, 0}, 0, Z, 0, Y, zrun, kWrappedRows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? substep<bf16>(fields, w, nullptr, out_f, out_w, g, consts, s)
             : substep<float>(fields, w, nullptr, out_f, out_w, g, consts, s);
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
// fields: 8 device pointers; f1/w1: 8 float32 scratch fields each;
// out_f/out_w: 8 each; zrun: z planes a block walks; consts: kNConsts
// host floats; is_bf16: the storage type of fields and outputs.
// ---------------------------------------------------------------------
cudaError_t mhd_substep01_wrap_launch(const void* const* fields,
                                      void* const* f1, void* const* w1,
                                      void* const* out_f,
                                      void* const* out_w, int Z, int Y,
                                      int X, int zrun, const float* consts,
                                      int n_consts, int is_bf16,
                                      void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X)) return cudaErrorInvalidValue;
  const RingGeom g{{Z, Y, X, 0, 0}, 0, Z, 0, Y, zrun, kWrappedRows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? substep01_wrap<bf16>(fields, f1, w1, out_f, out_w, g,
                                     consts, s)
              : substep01_wrap<float>(fields, f1, w1, out_f, out_w, g,
                                      consts, s);
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
// kNConsts host floats; is_bf16: the storage type of all of them.
// ---------------------------------------------------------------------
cudaError_t mhd_substep_halo_launch(const void* const* fields,
                                    const void* const* w,
                                    const void* const* slabs,
                                    void* const* out_f, void* const* out_w,
                                    int Z, int Y, int X, int rz, int ry,
                                    int zrun,
                                    const float* consts, int n_consts,
                                    int is_bf16, void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !halo_ok(Z, Y, X, rz, ry, R))
    return cudaErrorInvalidValue;
  const RingGeom g{{Z, Y, X, rz, ry}, 0, Z, 0, Y, zrun, kHaloRows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? substep<bf16>(fields, w, slabs, out_f, out_w, g, consts, s)
             : substep<float>(fields, w, slabs, out_f, out_w, g, consts, s);
}

// ---------------------------------------------------------------------
// B12. Replaces stencil_tpu/ops/pallas_halo.py:969
// mhd_substep01_halo_pallas: RK3 substeps 0 and 1 on a shard whose slabs
// hold 2R rows, as three launches of the ring kernel: (1) B11 s=0 with
// w=None over the shard, from the shard and the slabs (halo_row_of takes
// any rz, ry >= R), into the scratch f1, w1; (2) substep 0 over the R
// rows around the shard (mhd_margin.cuh mhd_margin_kernel), from the
// same slabs, into f1's R-row slabs; (3) B11 s=1 over the shard from
// f1, w1 and those slabs. Bound on this card: bytes, as B10, plus the slab rows (0.5 %
// more at a 256^3 shard): 0.50 ms. Its first designs fused both substeps
// into one launch of 8^3 tiles, the taps chosen in the kernel (149 ms a
// 256^3 shard on an H100), then read from a radius-2R window gathered
// into scratch first (17.9 ms; PERF.md, Findings).
//
// fields: 8 device pointers; slabs: 32 (zlo, zhi, ylo, yhi, each in
// field order; rz, ry >= 2R rows); f1/w1: 8 float32 scratch fields each;
// margin: 8 float32 scratch buffers of n_margin floats, into which plan
// (n_plan = kMarginPlanInts ints, ops/cuda_mhd.py margin_plan) maps the
// margin; slabs1: 32, the same R-row slabs of f1 in B11's layout, views
// of margin; out_f/out_w: 8 each; zrun: z planes a block of launches (1)
// and (3) walks; consts: kNConsts host floats; is_bf16: the storage type of
// fields, slabs and outputs.
// ---------------------------------------------------------------------
cudaError_t mhd_substep01_halo_launch(
    const void* const* fields, const void* const* slabs, void* const* f1,
    void* const* w1, void* const* margin, const void* const* slabs1,
    void* const* out_f, void* const* out_w, int Z, int Y, int X, int rz,
    int ry, int zrun, const int* plan, int n_plan, int n_margin,
    const float* consts, int n_consts, int is_bf16, void* stream) {
  if (n_consts != kNConsts || n_plan != kMarginPlanInts ||
      !shape_ok(Z, Y, X) || !halo_ok(Z, Y, X, rz, ry, 2 * R))
    return cudaErrorInvalidValue;
  MarginPlan p;
  std::memcpy(&p, plan, sizeof p);
  if (!margin_ok(p, Z, Y, X, n_margin)) return cudaErrorInvalidValue;
  const HaloGeom h{Z, Y, X, rz, ry};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? substep01_halo<bf16>(fields, slabs, f1, w1, margin, slabs1,
                                     out_f, out_w, h, zrun, p, consts, s)
              : substep01_halo<float>(fields, slabs, f1, w1, margin, slabs1,
                                      out_f, out_w, h, zrun, p, consts, s);
}

}  // extern "C"
