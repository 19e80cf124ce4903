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
// agree to a few ulps of each field, not bitwise. The device code they
// share with B13/B14 (csrc/mhd_overlap.cu) — the constants, fd6's
// operators, mhd_rates, the index helpers and the slab layout — is in
// mhd_common.cuh.
//
// Field order (FIELDS): lnrho, uux, uuy, uuz, ax, ay, az, ss.

#include "mhd_common.cuh"

#include <cstring>

namespace {

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
// B11. Replaces stencil_tpu/ops/pallas_halo.py:852
// mhd_substep_halo_pallas. One RK3 substep s on a shard of a z/y-sharded
// mesh, B9's arithmetic point for point:
//   wq = dt * rates;  wq = alpha * w + wq  (only when w is read);
//   w_out = wq (only when written);  f_out = value + beta * wq,
// with B9's dead-w elision (kReadW=false is w=None, kWriteW=false is
// write_w=False). On a (1,1,1) mesh the slabs are the shard's own
// wrapped rows, so B11 computes B9's values bitwise.
// Bound on this card: bytes, as B9, plus the slab rows (0.3 % more at a
// 256^3 shard): 0.49 / 0.65 / 0.49 ms for s = 0 / 1 / 2 at 3.35 TB/s.
// Design (the first versions chose each tap's source inside the
// kernel, 20 ms, then gathered a (Z + 6, Y + 6, X) window of the 8
// fields into scratch first, 16 more passes of device memory, 2.2 ms;
// PERF.md, Findings): one launch, no window, no scratch. A block owns a
// 32 x 16 (x, y) tile of the shard and walks a run of `zrun` z planes.
// Shared memory holds, per field, a ring of 8 planes of the tile and its
// radius-3 margin (22 x 38 floats each): 7 for the point's
// neighbourhood and one that cp.async fills with plane z + 4 while
// plane z is computed. Each margin row is copied by one warp, coalesced,
// x wrapped, from the source halo_row_of chooses for it (the shard, a z
// slab or a z-extended y slab; warp-uniform), found in a table of the
// block's rows set up once (RowSrc: the choice depends on the plane
// only at the shard's two z faces), so every
// tap of the ~300 a point is a shared-memory load with an immediate
// offset from one of 7 per-thread plane registers. The arithmetic is
// field_data and mhd_rates, unchanged, through a shared-memory accessor
// (RingAt) in place of the window's PadAt. A 32 x 16 tile is 512
// threads, 16 warps and 214 KB a block, one block an SM, at most 128
// registers a thread (96-111 used, no spill); 32 x 8 and 32 x 4 tiles
// hold 8 warps an SM and ran slower on an H100 (PERF.md).
// ops/cuda_mhd.py picks the z run (b11_zrun: the fewest waves x planes
// loaded for the shard and card).
// ---------------------------------------------------------------------
constexpr int kRing = 8;  // ring slots per field: 2R + 1 planes + 1 loading

struct HaloTile {
  static constexpr int kTY = 16;               // the tile's y rows
  static constexpr int kPX = kBX + 2 * R;      // 38 floats a margin row
  static constexpr int kPY = kTY + 2 * R;      // margin rows a plane
  static constexpr int kPlane = kPX * kPY;     // one field's plane
  static constexpr int kSlot = kNF * kPlane;   // one plane of 8 fields
  static constexpr int kRows = kNF * kPY;      // margin rows of a slot
  static constexpr int kThreads = kBX * kTY;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowsPerWarp = kRows / kWarps;
  static constexpr size_t kSmem = sizeof(float) * kRing * kSlot;
  static_assert(kRows % kWarps == 0, "every warp copies as many rows");
};

// Where margin row (q, y) of plane p comes from, set up once a block:
// base[k] is the row at plane pref = -1, 0, Z (for p < 0, 0 <= p < Z,
// p >= Z) as halo_row_of chooses it, and the row at plane p is then
// base[k] + (p - pref) * stride (the slab or shard's plane pitch); dst
// is the row's offset in a ring slot (-1: the row lies beyond Y + R and
// only masked points would read it).
struct RowSrc {
  const float* base[3];
  int stride;
  int dst;
};

// a field's ring around one point: o[k] is the point's offset in the
// slot of plane z + k - R, p the field's first float in a slot
template <int PX>
struct RingAt {
  const float* p;
  const int* o;
  __device__ __forceinline__ float operator()(int dx, int dy, int dz) const {
    return p[o[dz + R] + dy * PX + dx];
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool kReadW, bool kWriteW>
__global__ void __launch_bounds__(HaloTile::kThreads, 1)
mhd_substep_halo_kernel(InPtrs f, InPtrs w, SlabPtrs sl, OutPtrs of,
                        OutPtrs ow, HaloGeom g, int zrun, Consts c) {
  using T = HaloTile;
  extern __shared__ float ring[];  // [kRing][kNF][kPY][kPX]
  __shared__ RowSrc rows[T::kRows];  // row k = q * kPY + ry
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x0 = blockIdx.x * kBX, y0 = blockIdx.y * T::kTY;
  const int z0 = blockIdx.z * zrun;
  const int z1 = min(z0 + zrun, g.Z);
  for (int k = warp * kBX + lane; k < T::kRows; k += T::kThreads) {
    const int qk = k / T::kPY, ry = k - qk * T::kPY;
    const int y = y0 - R + ry;
    RowSrc r;
    // field qk's pointers, each a kernel parameter read at a constant
    // index (a run-time index would copy the structs to local memory)
#pragma unroll
    for (int q = 0; q < kNF; ++q) {
      if (q != qk) continue;
      const int pref[3] = {-1, 0, g.Z};
#pragma unroll
      for (int j = 0; j < 3; ++j)
        r.base[j] = halo_row_of(f.p[q], sl.zlo[q], sl.zhi[q], sl.ylo[q],
                                sl.yhi[q], g, y, pref[j]);
    }
    r.stride = (y < 0 || y >= g.Y ? g.ry : g.Y) * g.X;
    r.dst = y < g.Y + R ? qk * T::kPlane + ry * T::kPX : -1;
    rows[k] = r;
  }
  __syncthreads();
  const int xa = wrap(x0 - R + lane, g.X);             // margin column lane
  const int xb = wrap(x0 - R + kBX + lane, g.X);       // column 32 + lane

  // plane p of every field into its ring slot, one margin row a warp
  auto load_plane = [&](int p) {
    float* slot = ring + ((p + kRing) % kRing) * T::kSlot;
    const int j = p < 0 ? 0 : (p < g.Z ? 1 : 2);
    const int dp = p - (j == 0 ? -1 : (j == 1 ? 0 : g.Z));
#pragma unroll
    for (int i = 0; i < T::kRowsPerWarp; ++i) {
      const RowSrc& r = rows[warp + T::kWarps * i];
      if (r.dst < 0) continue;
      const float* row = r.base[j] + dp * r.stride;
      float* d = slot + r.dst;
      cp_async4(d + lane, row + xa);
      if (lane < 2 * R) cp_async4(d + kBX + lane, row + xb);
    }
  };

  for (int p = z0 - R; p <= z0 + R; ++p) load_plane(p);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int x = x0 + lane, y = y0 + warp;
  const bool live = x < g.X && y < g.Y;
  const int here = (warp + R) * T::kPX + (lane + R);
  for (int z = z0; z < z1; ++z) {
    if (z + 1 < z1) load_plane(z + 1 + R);
    cp_async_commit();
    if (live) {
      int o[2 * R + 1];
#pragma unroll
      for (int k = 0; k <= 2 * R; ++k)
        o[k] = ((z + k - R + kRing) % kRing) * T::kSlot + here;
      Fd F[kNF];
      field_data(
          [&](int q) { return RingAt<T::kPX>{ring + q * T::kPlane, o}; }, c,
          F);
      float r[kNF];
      mhd_rates(F, c, r);
      const int og = (z * g.Y + y) * g.X + x;
#pragma unroll
      for (int q = 0; q < kNF; ++q) {
        float wq = c.dt * r[q];
        if (kReadW) wq = c.alpha * __ldg(w.p[q] + og) + wq;
        if (kWriteW) ow.p[q][og] = wq;
        of.p[q][og] = F[q].v + c.beta * wq;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
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

template <bool kReadW, bool kWriteW>
cudaError_t launch_halo(const InPtrs& f, const InPtrs& w, const SlabPtrs& sl,
                        const OutPtrs& of, const OutPtrs& ow,
                        const HaloGeom& g, int zrun, const Consts& c,
                        cudaStream_t s) {
  using T = HaloTile;
  auto kernel = mhd_substep_halo_kernel<kReadW, kWriteW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(g.X, kBX), blocks(g.Y, T::kTY), blocks(g.Z, zrun));
  kernel<<<grid, dim3(kBX, T::kTY), T::kSmem, s>>>(f, w, sl, of, ow, g, zrun,
                                                   c);
  return cudaGetLastError();
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
// (zlo, zhi, ylo, yhi, each in field order); out_f/out_w: 8 each (out_w
// NULL for write_w=False); zrun: z planes a block walks; consts:
// kNConsts host floats.
cudaError_t mhd_substep_halo_launch(const void* const* fields,
                                    const void* const* w,
                                    const void* const* slabs,
                                    void* const* out_f, void* const* out_w,
                                    int Z, int Y, int X, int rz, int ry,
                                    int zrun,
                                    const float* consts, int n_consts,
                                    void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !halo_ok(Z, Y, X, rz, ry, R) || zrun < 1)
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  const HaloGeom g{Z, Y, X, rz, ry};
  const bool rw = w != nullptr, ww = out_w != nullptr;
  const InPtrs fp = in_ptrs(fields), wp = in_ptrs(w);
  const SlabPtrs sp = slab_ptrs(slabs);
  const OutPtrs op = out_ptrs(out_f), owp = out_ptrs(out_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rw && ww) return launch_halo<true, true>(fp, wp, sp, op, owp, g, zrun, c, s);
  if (rw) return launch_halo<true, false>(fp, wp, sp, op, owp, g, zrun, c, s);
  if (ww) return launch_halo<false, true>(fp, wp, sp, op, owp, g, zrun, c, s);
  return launch_halo<false, false>(fp, wp, sp, op, owp, g, zrun, c, s);
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
