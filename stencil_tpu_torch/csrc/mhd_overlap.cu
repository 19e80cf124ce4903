// The overlapped MHD RK3 substep for Hopper (sm_90a), float32: B13, B14.
//
//   B13 mhd_substep_overlap_launch <- pallas_mhd_overlap.py:67
//                                     mhd_substep_overlap_pallas
//   B14 mhd_substep_fixup_launch   <- pallas_mhd_overlap.py:360
//                                     mhd_substep_fixup_pallas
//
// The TPU kernel B13 is one program per shard: a neighbour barrier, the
// radius-hr z slabs and z-extended y slabs of all 8 fields sent by
// remote DMA, every (bz, by, X) block computed from clamped in-shard
// windows while they fly (the edge blocks are placeholders), and the yz
// corner pieces forwarded from the landed z slabs. B14's strip kernels
// then recompute the edge blocks from the landed slabs through B11's
// window plan. Here the substep is two launches per shard, on that
// shard's own CUDA stream, bound through plain extern "C" launchers
// (ctypes; stencil_tpu_torch/ops/_build.py and ops/cuda_mhd_overlap.py,
// which also holds the plain PyTorch twins):
//
//   launch A (B13): send_rows_kernel stores the shard's boundary rows of
//     all 8 fields straight into its neighbours' receive buffers (plain
//     global stores through their device pointers; across cards they go
//     over NVLink once peer access is on): the hr z rows to z+-1, the Z
//     interior rows of the hr y rows to y+-1, and the four hr x hr yz
//     corners directly to the diagonal shards (z+-1, y+-1), which gives
//     the values the TPU kernel forwards from its landed z slabs without
//     a third ordering step. Then the interior: with one substep every
//     point z in [R, Z-R), y in [R, Y-R), computed by B11's own kernel
//     (the z-streaming ring of mhd_ring.cuh, its margin rows read from
//     the shard itself: the radius-R neighbourhood of those points lies
//     in the shard, so the values are B11's bit for bit); with the pair
//     (substeps 0+1, hr = 2R) the kT^3 pair tiles (B12's first design)
//     whose ring reads stay in the shard, z and y in [kT, n-kT), the
//     shard read as their window.
//   launch B (B14): the exterior shell that launch A left, as up to four
//     strips (z in [0, e) and [Z-e, Z) at every y, then y in [0, e) and
//     [Y-e, Y) between them; e = R, or kT with the pair). With one
//     substep, one launch a shard of the ring kernel (mhd_shell_kernel
//     below, on mhd_ring.cuh's ring_run, its strips and tiles as the
//     host's fixup_plan passes them): each block takes a 32 x 16
//     tile of a strip's broad face and walks the strip across its thin
//     axis, the z strips in z, the y strips in y (z along the tile's
//     rows), its margin rows read straight from the shard and the landed
//     rows by B11's source rule (halo_row_of); there is no window and no
//     scratch. With the pair (rr = 2R), each strip's radius-rr window is
//     gathered from the shard and the landed rows by the same rule and
//     the pair tiles run on it. B14 after B13 is therefore B11 (with
//     the pair, B11 s=0 -> a slab round -> B11 s=1, which is B12) point
//     for point: bitwise.
//
// The barrier and the DMA waits become two ordering rules, carried by
// CUDA events between the per-shard streams (ops/cuda_overlap.py
// ShardOrdering): (a) shard i's launch A writes into shard j's receive
// buffers only after j's previous launch B has read them; (b) j's launch
// B starts only after the launch A of every shard that writes into it,
// up to 8 (four faces, four diagonals). No kernel spins on a flag another
// launch sets.
//
// Receive buffers of a shard (Z, Y, X), per field, exact rows (the
// layout of parallel/exchange.py exchange_interior_slabs with rz = ry =
// hr, y_z_extended): zlo/zhi (hr, Y, X), ylo/yhi (Z + 2hr, hr, X).
//
// Bound on this card: bytes. B13 reads the shard (and w) and writes the
// new state at the interior points, as B9 (24 / 32 / 24 passes of a
// field for s = 0 / 1 / 2, 24 with the pair), plus the slab rows it
// stores; B14 reads the shard rows within e + hr of a z or y face and
// the slab rows, and writes the shell. Design: B13's interior and B14's
// shell (one substep) are the ring kernel that computes B9 and B11
// (mhd_ring.cuh), one launch a shard each. A strip is only R deep, so
// each of B14's blocks loads 3R slices for the R it computes, and at one
// 512-thread block an SM the shell of a 256^3 shard is 512 blocks, ~3.9
// waves on 132 SMs (PERF.md). The pair keeps the first, simple design
// (B12's first design): its interior and its shell are kT^3 pair tiles
// (mhd_region01_kernel) on a window, the shell's strip windows gathered
// into scratch first.

#include "mhd_common.cuh"
#include "mhd_ring.cuh"

#include <cstring>

namespace {

// ---------------------------------------------------------------------
// launch A, step 1: the sends. Eight pieces per field, each a box of
// nz x ny rows of X floats copied from the shard at (sz0, sy0) into a
// receive buffer (of dY rows per z) at (dz0, dy0).
// ---------------------------------------------------------------------
constexpr int kPieces = 8;
constexpr int kPieceInts = 7;

struct Piece {
  int nz, ny, sz0, sy0, dz0, dy0, dY;
};
struct Pieces {
  Piece p[kPieces];
};
struct DstPtrs {
  float* p[kPieces][kNF];
};

constexpr int kCopyBX = 128;
constexpr int kCopyRows = 64;  // grid rows; a block strides over a piece

__global__ void __launch_bounds__(kCopyBX)
send_rows_kernel(InPtrs f, DstPtrs dst, Pieces pc, int Y, int X) {
  const int x = blockIdx.x * kCopyBX + threadIdx.x;
  if (x >= X) return;
  const int k = blockIdx.z / kNF, q = blockIdx.z % kNF;
  const Piece P = pc.p[k];
  const int rows = P.nz * P.ny;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int rz = r / P.ny, ry = r % P.ny;
    dst.p[k][q][((P.dz0 + rz) * P.dY + P.dy0 + ry) * X + x] =
        __ldg(f.p[q] + ((P.sz0 + rz) * Y + P.sy0 + ry) * X + x);
  }
}

// ---------------------------------------------------------------------
// Regions: the output points z in [z0, z0 + nz), y in [y0, y0 + ny) (all
// x) of a shard, computed from a window whose row (0, 0) is shard row
// (wz0, wy0), Yw rows per z, at offset woff of each field's window
// buffer (for launch A's interior the window is the shard itself).
// nrows (the window rows of the gather) is filled on the host.
// ---------------------------------------------------------------------
constexpr int kMaxRegions = 4;
constexpr int kRegionInts = 9;

struct Region {
  int z0, nz, y0, ny, wz0, wy0, Zw, Yw, woff;
  int nrows;
};
struct Regions {
  Region r[kMaxRegions];
  int n;
};

// the region of window row b of the gather, and b's row inside it; the
// loop over regions is unrolled so that each region is read from the
// kernel parameters at a fixed offset (an indexed read would copy the
// whole table to local memory)
__device__ __forceinline__ Region find_region(const Regions& rs, int& b) {
  Region g = rs.r[0];
#pragma unroll
  for (int k = 1; k < kMaxRegions; ++k) {
    const int n = g.nrows;
    if (k < rs.n && b >= n) {
      b -= n;
      g = rs.r[k];
    }
  }
  return g;
}

// B14, step 1: every strip's window, gathered from the shard and the
// landed rows (B11's halo_window_kernel on the strips' rows only); one
// block per window row and 128 x columns, 1-D grid.
__global__ void __launch_bounds__(kCopyBX)
strip_window_kernel(InPtrs f, SlabPtrs sl, OutPtrs win, HaloGeom g,
                    Regions rs) {
  const int nxb = (g.X + kCopyBX - 1) / kCopyBX;
  int b = blockIdx.x / nxb;
  const int x = (blockIdx.x % nxb) * kCopyBX + threadIdx.x;
  if (x >= g.X) return;
  const Region r = find_region(rs, b);
  const int wy = b % r.Yw, wz = b / r.Yw;
  const int o = r.woff + (wz * r.Yw + wy) * g.X + x;
#pragma unroll
  for (int q = 0; q < kNF; ++q)
    win.p[q][o] = __ldg(halo_row(f, sl, q, g, r.wy0 + wy, r.wz0 + wz) + x);
}

// The geometry of one region for the pair kernel below: its first
// output point and rows, and its window's first row and rows per z.
struct RegionGeom {
  int z0, y0, ny, wz0, wy0, Yw;
};

// ---------------------------------------------------------------------
// RK3 substeps 0 and 1 on the kT^3 tiles of one region (nz, ny multiples
// of kT), the first design of B12 point for point: phase 1 evaluates substep 0 on
// the tile extended by R from the region's window (rr = 2R beyond the
// tile), keeping f1 in shared memory; phase 2 substep 1 on the tile from
// shared memory only. Grid: blocks(X, kT) x ny/kT x nz/kT tiles, one
// launch per region as above.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kPairThreads)
mhd_region01_kernel(InPtrs win, OutPtrs of, OutPtrs ow, RegionGeom g, int Y,
                    int X, Consts c) {
  extern __shared__ float smem[];
  float* sF = smem;              // [kNF][kE][kE][kE] f1, extended tile
  float* sW = smem + kNF * kE3;  // [kNF][kT][kT][kT] w1, tile
  const int x0 = blockIdx.x * kT;
  const int y0 = g.y0 + blockIdx.y * kT, z0 = g.z0 + blockIdx.z * kT;

  // phase 1: substep 0 on the extended tile, from the region's window
  for (int e = threadIdx.x; e < kE3; e += kPairThreads) {
    const int ex = e % kE, ey = (e / kE) % kE, ez = e / (kE * kE);
    const PadIdx I(x0 - R + ex, y0 - R + ey - g.wy0, z0 - R + ez - g.wz0, X,
                   g.Yw, 0);
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

// The regions from the host's kRegionInts ints each, with the block and
// row counts of the kernels filled in; false if a region does not fit
// the shard or its window, or (pair) is not made of whole tiles.
bool read_regions(const int* src, int n, int Z, int Y, int X, bool pair,
                  Regions& rs) {
  if (n < 0 || n > kMaxRegions) return false;
  rs = Regions{};
  rs.n = n;
  for (int k = 0; k < n; ++k) {
    Region& r = rs.r[k];
    const int* v = src + k * kRegionInts;
    r = Region{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], 0};
    if (r.nz <= 0 || r.ny <= 0 || r.z0 < 0 || r.y0 < 0 ||
        r.z0 + r.nz > Z || r.y0 + r.ny > Y || r.woff < 0)
      return false;
    if (pair && (r.nz % kT || r.ny % kT)) return false;
    const long long rows = static_cast<long long>(r.Zw) * r.Yw;
    if (rows * blocks(X, kCopyBX) >= (1LL << 31)) return false;
    r.nrows = static_cast<int>(rows);
  }
  return true;
}

// every region's window lies in [zlo, zhi) x [ylo, yhi) of shard rows
// and holds the rr rows its points read on each side
bool windows_ok(const Regions& rs, int rr, int zlo, int zhi, int ylo,
                int yhi) {
  for (int k = 0; k < rs.n; ++k) {
    const Region& r = rs.r[k];
    if (r.wz0 < zlo || r.wz0 + r.Zw > zhi || r.wy0 < ylo ||
        r.wy0 + r.Yw > yhi || r.z0 - r.wz0 < rr || r.y0 - r.wy0 < rr ||
        r.wz0 + r.Zw < r.z0 + r.nz + rr || r.wy0 + r.Yw < r.y0 + r.ny + rr)
      return false;
  }
  return true;
}

long long total_rows(const Regions& rs) {
  long long t = 0;
  for (int k = 0; k < rs.n; ++k) t += rs.r[k].nrows;
  return t;
}

// The pair tiles' compute over the regions on window win, one launch
// per region; nothing to do for an empty set
cudaError_t launch_pair_regions(const InPtrs& win, void* const* out_f,
                                void* const* out_w, const Regions& rs,
                                int Y, int X, const Consts& c,
                                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      mhd_region01_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPairSmem));
  if (err != cudaSuccess) return err;
  for (int k = 0; k < rs.n; ++k) {
    const Region& r = rs.r[k];
    InPtrs rw = win;
    for (int q = 0; q < kNF; ++q) rw.p[q] += r.woff;
    const RegionGeom g{r.z0, r.y0, r.ny, r.wz0, r.wy0, r.Yw};
    mhd_region01_kernel<<<dim3(blocks(X, kT), r.ny / kT, r.nz / kT),
                          kPairThreads, kPairSmem, s>>>(
        rw, out_ptrs(out_f), out_ptrs(out_w), g, Y, X, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// B14 with one substep: the exterior shell as four strips, planned on
// the host (ops/cuda_mhd_overlap.py fixup_plan, whose ShellLaunch ints
// the launcher copies in as they are): the z strips z in [0, min(R, Z))
// and, with two, [zt, Z) at every y, walked in z; the y strips y in [0,
// min(R, Y)) and, with two, [yt, Y) at z in [R, Z - R), walked in y.
// Each strip is cut into tiles of 32 columns by kTY rows of its broad
// axis (y for a z strip, z for a y strip); tile index b (blockIdx.y)
// counts the near z strip's tiles, then the far one's, then the y
// strips' in that order.
// ---------------------------------------------------------------------
struct ShellPlan {
  int zt, yt;    // first slice of the far z strip, of the far y strip
  int nzs, nys;  // z strips (1 or 2) and y strips (0, 1 or 2)
  int tz, ty;    // row tiles of a z strip and of a y strip
};
constexpr int kShellPlanInts = 6;
static_assert(sizeof(ShellPlan) == kShellPlanInts * sizeof(int),
              "ShellPlan layout");

// the row tiles of plan p; -1 if p would have a block read or write
// outside the shard and its landed rows (a wrong but safe plan computes
// wrong points: the card tests hold it bitwise against B11)
long long shell_tiles(const ShellPlan& p, int Z, int Y) {
  if (p.zt < 0 || p.zt > Z || p.yt < 0 || p.yt > Y || p.nzs < 1 ||
      p.nzs > 2 || p.nys < 0 || p.nys > 2 || p.tz < 0 || p.ty < 0)
    return -1;
  return static_cast<long long>(p.nzs) * p.tz +
         static_cast<long long>(p.nys) * p.ty;
}

// One launch a shard: block (bx, b) walks column tile bx of row tile b
// through its strip's whole depth, on the ring kernel's z instance (z
// strips) or y instance (y strips), its margin rows read straight from
// the shard and the landed rows by B11's rule (kHaloRows): no window, no
// scratch. The choice is uniform per block, so each block runs one
// instance's code.
template <bool kReadW, bool kWriteW>
__global__ void __launch_bounds__(RingTile::kThreads, 1)
mhd_shell_kernel(InPtrs f, InPtrs w, SlabPtrs sl, OutPtrs of, OutPtrs ow,
                 HaloGeom h, ShellPlan p, Consts c) {
  extern __shared__ float ring[];  // [kRing][kNF][kPY][kPX]
  __shared__ RowSrc rows[RingTile::kRows];
  constexpr int kTY = RingTile::kTY;
  const int x0 = blockIdx.x * kBX;
  const OutMap om{0, h.Y * h.X};
  int b = blockIdx.y;
  if (b < p.nzs * p.tz) {
    const bool far = b >= p.tz;
    b -= far ? p.tz : 0;
    ring_run<kStreamZ, kReadW, kWriteW>(
        f, w, sl, of, ow, h, om, kHaloRows, x0, b * kTY, h.Y,
        far ? p.zt : 0, far ? h.Z : min(R, h.Z), c, ring, rows);
  } else {
    b -= p.nzs * p.tz;
    const bool far = b >= p.ty;
    b -= far ? p.ty : 0;
    ring_run<kStreamY, kReadW, kWriteW>(
        f, w, sl, of, ow, h, om, kHaloRows, x0, R + b * kTY, h.Z - R,
        far ? p.yt : 0, far ? h.Y : min(R, h.Y), c, ring, rows);
  }
}

template <bool kReadW, bool kWriteW>
cudaError_t launch_shell_variant(const InPtrs& f, const InPtrs& w,
                                 const SlabPtrs& sl, const OutPtrs& of,
                                 const OutPtrs& ow, const HaloGeom& h,
                                 const ShellPlan& p, unsigned tiles,
                                 const Consts& c, cudaStream_t s) {
  using T = RingTile;
  auto kernel = mhd_shell_kernel<kReadW, kWriteW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(h.X, kBX), tiles);
  kernel<<<grid, dim3(kBX, T::kTY), T::kSmem, s>>>(f, w, sl, of, ow, h, p,
                                                   c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B13, launch A. fields/w: 8 device pointers each (w NULL for w=None, and
// with the pair); dst: 64 receive-buffer pointers, piece-major (8 pieces
// x 8 fields); pieces: 8 x 7 host ints (nz, ny, sz0, sy0, dz0, dy0, dY);
// out_f/out_w: 8 each (out_w NULL for write_w=False); regions: n x 9 host
// ints (z0, nz, y0, ny, wz0, wy0, Zw, Yw, woff) of the interior, read
// from the shard itself; zrun: z planes a block of the ring kernel walks
// (one substep); consts: kNConsts host floats.
cudaError_t mhd_substep_overlap_launch(
    const void* const* fields, const void* const* w, void* const* dst,
    const int* pieces, void* const* out_f, void* const* out_w,
    const int* regions, int n_regions, int Z, int Y, int X, int pair,
    int zrun, const float* consts, int n_consts, void* stream) {
  Regions rs;
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !read_regions(regions, n_regions, Z, Y, X, pair != 0, rs) ||
      !windows_ok(rs, pair ? 2 * R : R, 0, Z, 0, Y) ||
      (pair && (w != nullptr || out_w == nullptr)))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  Pieces pc;
  static_assert(sizeof(Piece) == kPieceInts * sizeof(int), "Piece layout");
  std::memcpy(&pc, pieces, sizeof pc);
  DstPtrs dp;
  std::memcpy(&dp, dst, sizeof dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const InPtrs fp = in_ptrs(fields);
  send_rows_kernel<<<dim3(blocks(X, kCopyBX), kCopyRows, kPieces * kNF),
                     kCopyBX, 0, s>>>(fp, dp, pc, Y, X);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (pair) return launch_pair_regions(fp, out_f, out_w, rs, Y, X, c, s);
  // one substep: the ring kernel over each region, its margin rows from
  // the shard (windows_ok above keeps every row it reads inside it)
  for (int k = 0; k < rs.n; ++k) {
    const Region& r = rs.r[k];
    const RingGeom g{{Z, Y, X, 0, 0}, r.z0, r.nz, r.y0, r.ny, zrun,
                     kWrappedRows};
    err = launch_ring(fp, in_ptrs(w), SlabPtrs{}, out_ptrs(out_f),
                      out_ptrs(out_w), g, c, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// B14, launch B. fields/w: the pre-substep shard and w (w NULL for
// w=None, and with the pair); slabs: 32 landed-row pointers (zlo, zhi,
// ylo, yhi, each in field order; rz = ry rows); out_f/out_w: B13's
// outputs, completed in place (out_w NULL for write_w=False). One
// substep: plan holds the kShellPlanInts host ints of ShellPlan
// (ops/cuda_mhd_overlap.py fixup_plan; n_plan = kShellPlanInts), and
// one launch of mhd_shell_kernel reads the shard and the landed rows
// itself (window NULL). The pair: plan is the pair's shell as n_plan
// regions for launch A, window 8 scratch buffers holding every region's
// window at its woff; the strip windows are gathered, then the pair
// tiles run per region.
cudaError_t mhd_substep_fixup_launch(
    const void* const* fields, const void* const* w, const void* const* slabs,
    void* const* window, void* const* out_f, void* const* out_w,
    const int* plan, int n_plan, int Z, int Y, int X, int rz, int ry,
    int pair, const float* consts, int n_consts, void* stream) {
  const int rr = pair ? 2 * R : R;
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !halo_ok(Z, Y, X, rz, ry, rr) ||
      (pair && (w != nullptr || out_w == nullptr || window == nullptr)))
    return cudaErrorInvalidValue;
  Consts c;
  std::memcpy(&c, consts, sizeof c);
  const HaloGeom g{Z, Y, X, rz, ry};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pair) {
    if (n_plan != kShellPlanInts) return cudaErrorInvalidValue;
    ShellPlan p;
    std::memcpy(&p, plan, sizeof p);
    const long long tiles = shell_tiles(p, Z, Y);
    if (tiles < 1 || tiles > 65535) return cudaErrorInvalidValue;
    const unsigned t = static_cast<unsigned>(tiles);
    const InPtrs fp = in_ptrs(fields), wp = in_ptrs(w);
    const SlabPtrs sp = slab_ptrs(slabs);
    const OutPtrs op = out_ptrs(out_f), owp = out_ptrs(out_w);
    if (w != nullptr && out_w != nullptr)
      return launch_shell_variant<true, true>(fp, wp, sp, op, owp, g, p, t,
                                              c, s);
    if (w != nullptr)
      return launch_shell_variant<true, false>(fp, wp, sp, op, owp, g, p, t,
                                               c, s);
    if (out_w != nullptr)
      return launch_shell_variant<false, true>(fp, wp, sp, op, owp, g, p, t,
                                               c, s);
    return launch_shell_variant<false, false>(fp, wp, sp, op, owp, g, p, t,
                                              c, s);
  }
  Regions rs;
  if (!read_regions(plan, n_plan, Z, Y, X, true, rs) ||
      !windows_ok(rs, rr, -rz, Z + rz, -ry, Y + ry))
    return cudaErrorInvalidValue;
  const long long rows = total_rows(rs);
  if (rows == 0) return cudaSuccess;
  strip_window_kernel<<<static_cast<unsigned>(rows * blocks(X, kCopyBX)),
                        kCopyBX, 0, s>>>(in_ptrs(fields), slab_ptrs(slabs),
                                         out_ptrs(window), g, rs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pair_regions(in_ptrs(window), out_f, out_w, rs, Y, X, c, s);
}

// How many blocks of B14's one-substep kernel one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, the instantiation that
// reads and writes w; ops/cuda_mhd_overlap.py plans with one,
// FIXUP_BLOCKS_PER_SM).
cudaError_t mhd_fixup_blocks_per_sm(int* blocks_per_sm) {
  auto kernel = mhd_shell_kernel<true, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(RingTile::kSmem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, RingTile::kThreads, RingTile::kSmem);
}

}  // extern "C"
