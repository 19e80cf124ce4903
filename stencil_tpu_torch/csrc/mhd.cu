// Fused MHD RK3 substep kernels for Hopper (sm_90a), float32.
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
// exchange_interior_slabs (x wraps in the kernel in all four). B9 and
// B11 are one kernel, the z-streaming shared-memory ring of
// mhd_ring.cuh (mhd_substep_ring_kernel, which also computes B13's
// interior in csrc/mhd_overlap.cu): B9 launches it with the field's own
// wrapped rows as its margin, B11 with the shard's slabs, so on a
// (1,1,1) mesh the two are the same computation bit for bit. B10 and
// B12 are the pair kernels below. Every derivative, every term of the
// rates and the update is formed in the twin's order of operations; the
// library is built with -fmad=false, so no a*b+c is contracted into one
// rounding. exp is expf (never __expf), which differs from PyTorch's exp
// by an ulp at most: kernel and twin agree to a few ulps of each field,
// not bitwise. The device code they share with B13/B14 — the constants,
// fd6's operators, mhd_rates, the index helpers and the slab layout — is
// in mhd_common.cuh.
//
// Field order (FIELDS): lnrho, uux, uuy, uuz, ax, ay, az, ss.

#include "mhd_common.cuh"
#include "mhd_ring.cuh"

#include <cstring>

namespace {

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
// computes f1 at the (kT+2R)^3 extended tile, reading device memory
// tap by tap (GlobalAt), and keeps it in shared memory with w1 of the tile's own
// points; phase 2 reads only shared memory. The ring is recomputed, not
// approximated, so B10 equals B9(s=0) followed by B9(s=1) point for
// point; it pays (kT+2R)^3 / kT^3 = 5.4 substep-0 evaluations per
// point for it. It takes about 130 registers a thread, so one block
// runs per SM; holding it to 128 for a second block (which the 104,192 B
// of shared memory would allow) measured slower, 17.4 ms against 15.0
// at 256^3 on an H100.
// ---------------------------------------------------------------------

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

// B12, step 1: the (Z + 4R, Y + 4R, X) window of every field, gathered
// from the shard and its slabs; one block per window row, so the source
// is chosen once per row (block-uniform) and the row copied coalesced.
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

// ---------------------------------------------------------------------
// B12. Replaces stencil_tpu/ops/pallas_halo.py:969
// mhd_substep01_halo_pallas. RK3 substeps 0 and 1 on a shard whose slabs
// hold 2R = 6 rows, B10's arithmetic point for point. Bound on this
// card: bytes, as B10, plus the window's 16 passes. Design: two
// launches: halo_window_kernel gathers the radius-2R window
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

// fields: 8 device pointers; slabs: 32 (zlo, zhi, ylo, yhi, each in
// field order); window: 8 scratch buffers of (Z + 4R) (Y + 4R) X floats;
// out_f/out_w: 8 each; consts: kNConsts host floats.
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
