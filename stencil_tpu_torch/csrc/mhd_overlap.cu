// The overlapped MHD RK3 substep for Hopper (sm_90a), float32 or
// bfloat16 storage (float32 arithmetic): B13, B14.
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
// window plan. Here each is one call a shard, on that shard's own CUDA
// stream, bound through plain extern "C" launchers (ctypes;
// stencil_tpu_torch/ops/_build.py and ops/cuda_mhd_overlap.py, which
// also holds the plain PyTorch twins and the launch plans). Every
// compute launch is the z-streaming ring kernel of B9 and B11
// (mhd_ring.cuh):
//
//   launch A (B13): send_rows_kernel stores the shard's boundary rows of
//     all 8 fields straight into its neighbours' receive buffers (plain
//     global stores through their device pointers; across cards they go
//     over NVLink once peer access is on): the hr z rows to z+-1, the Z
//     interior rows of the hr y rows to y+-1, and the four hr x hr yz
//     corners directly to the diagonal shards (z+-1, y+-1), which gives
//     the values the TPU kernel forwards from its landed z slabs without
//     a third ordering step. Then the interior, by the ring kernel with
//     its margin rows read from the shard alone (kWrappedRows over
//     regions whose radius-R neighbourhood lies in the shard, so no row
//     wraps). One substep: every point z in [R, Z-R), y in [R, Y-R).
//     The pair (substeps 0+1, hr = 2R): substep 0 over that region into
//     the scratch f1, w1, then substep 1 over z, y in [kT, n-kT) from
//     f1, w1, whose rows it reads all lie in [R, n-R).
//   launch B (B14): the exterior shell that launch A left, as up to four
//     strips (z in [0, e) and [Z-e, Z) at every y, then y in [0, e) and
//     [Y-e, Y) between them), one launch of mhd_shell_kernel below: each
//     block takes a 32 x 16 tile of a strip's broad face and walks the
//     strip across its thin axis, the z strips in z, the y strips in y
//     (z along the tile's rows), its margin rows read straight from the
//     shard and the landed rows by B11's source rule (halo_row_of);
//     there is no window. One substep: the shell of depth e = R. The
//     pair: substep 0 over the shell of depth R from the shard and the
//     landed 2R rows into f1, w1 (which then hold B11 s=0 over the whole
//     shard); substep 0 over the R rows around the shard from the same
//     rows, into the margin buffer in the R-row slab layout (B12's
//     margin kernel, mhd_margin.cuh); then substep 1 over the shell of
//     depth e = kT from f1, w1 and the margin's slabs.
//
// Every point is therefore computed from the same values, in the same
// order, as B11 computes it (B12 with the pair: B11 s=0, the margin,
// B11 s=1): B14 after B13 equals them bit for bit. With the pair, launch
// B reads launch A's f1 and w1; both run on the shard's stream, and the
// host refuses a launch B whose launch A was for other fields
// (ops/cuda_mhd_overlap.py).
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
// the slab rows, and writes the shell. A strip is only e deep, so each
// of B14's blocks loads e + 2R slices for the e it computes, and at one
// 512-thread block an SM the shell of a 256^3 shard is 512 blocks, ~3.9
// waves on 132 SMs (PERF.md). The pair's first design ran the kT^3
// tiles of B12's first design on windows gathered into scratch: 12.65
// ms (B13) and 2.05 ms (B14) a 256^3 shard on an H100 (PERF.md,
// Findings).
//
// Both launchers take is_bf16: 0 for float32 fields, 1 for bfloat16 ones
// (the fields, w, receive buffers and outputs; mhd_ring.cuh). The pair's
// scratch f1, w1 and margin are float32 in both, as in mhd.cu's B10 and
// B12.

#include "mhd_common.cuh"
#include "mhd_margin.cuh"
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
template <class T>
struct DstPtrs {
  T* p[kPieces][kNF];
};

constexpr int kCopyBX = 128;
constexpr int kCopyRows = 64;  // grid rows; a block strides over a piece

template <class T>
__global__ void __launch_bounds__(kCopyBX)
send_rows_kernel(InP<T> f, DstPtrs<T> dst, Pieces pc, int Y, int X) {
  const int x = blockIdx.x * kCopyBX + threadIdx.x;
  if (x >= X) return;
  const int k = blockIdx.z / kNF, q = blockIdx.z % kNF;
  const Piece P = pc.p[k];
  const int rows = P.nz * P.ny;
  // a cell's bits: float, or a bfloat16's as an unsigned short
  using Bits = typename std::conditional<std::is_same<T, float>::value, float,
                                         unsigned short>::type;
  const Bits* src = reinterpret_cast<const Bits*>(f.p[q]);
  Bits* out = reinterpret_cast<Bits*>(dst.p[k][q]);
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int rz = r / P.ny, ry = r % P.ny;
    out[((P.dz0 + rz) * P.dY + P.dy0 + ry) * X + x] =
        __ldg(src + ((P.sz0 + rz) * Y + P.sy0 + ry) * X + x);
  }
}

// ---------------------------------------------------------------------
// launch A, step 2: the interior regions of the ring kernel, the points
// z in [z0, z0 + nz), y in [y0, y0 + ny) (all x), each block walking
// zrun planes; planned on the host (ops/cuda_mhd_overlap.py
// interior_plan). One substep: one region from the shard; the pair:
// substep 0's region from the shard, then substep 1's (if any) from f1.
// ---------------------------------------------------------------------
struct Interior {
  int z0, nz, y0, ny, zrun;
};
constexpr int kInteriorInts = 5;
constexpr int kMaxInteriors = 2;
static_assert(sizeof(Interior) == kInteriorInts * sizeof(int),
              "Interior layout");

// every row region r's points read, [z0 - R, z0 + nz + R) x [y0 - R, y0
// + ny + R), lies in [zlo, zhi) x [ylo, yhi), and it computes something
bool reads_inside(const Interior& r, int zlo, int zhi, int ylo, int yhi) {
  return r.nz > 0 && r.ny > 0 && r.zrun > 0 && r.z0 - R >= zlo &&
         r.z0 + r.nz + R <= zhi && r.y0 - R >= ylo && r.y0 + r.ny + R <= yhi;
}

RingGeom interior_geom(const Interior& r, int Z, int Y, int X) {
  return RingGeom{{Z, Y, X, 0, 0}, r.z0, r.nz, r.y0, r.ny, r.zrun,
                  kWrappedRows};
}

// ---------------------------------------------------------------------
// B14: the exterior shell of depth e as four strips, planned on the host
// (ops/cuda_mhd_overlap.py fixup_plan, whose ShellLaunch ints the
// launcher copies in as they are): the z strips z in [0, min(e, Z)) and,
// with two, [zt, Z) at every y, walked in z; the y strips y in [0,
// min(e, Y)) and, with two, [yt, Y) at z in [e, Z - e), walked in y.
// Each strip is cut into tiles of 32 columns by kTY rows of its broad
// axis (y for a z strip, z for a y strip); tile index b (blockIdx.y)
// counts the near z strip's tiles, then the far one's, then the y
// strips' in that order.
// ---------------------------------------------------------------------
struct ShellPlan {
  int zt, yt;    // first slice of the far z strip, of the far y strip
  int nzs, nys;  // z strips (1 or 2) and y strips (0, 1 or 2)
  int tz, ty;    // row tiles of a z strip and of a y strip
  int e;         // the shell's depth: R, or kT for the pair's substep 1
};
constexpr int kShellPlanInts = 7;
static_assert(sizeof(ShellPlan) == kShellPlanInts * sizeof(int),
              "ShellPlan layout");

// The pair's launch B: substep 0 over the shell of depth R, the margin,
// substep 1 over the shell of depth kT (fixup_plan's three launches)
struct PairPlan {
  ShellPlan shell0;
  MarginPlan margin;
  ShellPlan shell1;
};
constexpr int kPairPlanInts = 2 * kShellPlanInts + kMarginPlanInts;
static_assert(sizeof(PairPlan) == kPairPlanInts * sizeof(int),
              "PairPlan layout");

// the row tiles of plan p; -1 if p would have a block read or write
// outside the shard and its landed rows (a wrong but safe plan computes
// wrong points: the card tests hold it bitwise against B11)
long long shell_tiles(const ShellPlan& p, int Z, int Y) {
  if (p.zt < 0 || p.zt > Z || p.yt < 0 || p.yt > Y || p.nzs < 1 ||
      p.nzs > 2 || p.nys < 0 || p.nys > 2 || p.tz < 0 || p.ty < 0 ||
      p.e < R || p.e > Z || p.e > Y)
    return -1;
  return static_cast<long long>(p.nzs) * p.tz +
         static_cast<long long>(p.nys) * p.ty;
}

// One launch a shard: block (bx, b) walks column tile bx of row tile b
// through its strip's whole depth, on the ring kernel's z instance (z
// strips) or y instance (y strips), its margin rows read straight from
// the shard and the landed rows by B11's rule (kHaloRows). The choice is
// uniform per block, so each block runs one instance's code.
template <bool kReadW, bool kWriteW, class TIn = float, class TOut = float>
__global__ void __launch_bounds__(RingTile::kThreads, 1)
mhd_shell_kernel(InP<TIn> f, InP<TIn> w, SlabP<TIn> sl, OutP<TOut> of,
                 OutP<TOut> ow, HaloGeom h, ShellPlan p, Consts c) {
  extern __shared__ float ring[];  // [kRing][kNF][kPY][kPX]
  __shared__ RowSrc<TIn> rows[RingTile::kRows];
  constexpr int kTY = RingTile::kTY;
  const int x0 = blockIdx.x * kBX;
  const OutMap om{0, h.Y * h.X};
  int b = blockIdx.y;
  if (b < p.nzs * p.tz) {
    const bool far = b >= p.tz;
    b -= far ? p.tz : 0;
    ring_run<kStreamZ, kReadW, kWriteW>(
        f, w, sl, of, ow, h, om, kHaloRows, x0, b * kTY, h.Y,
        far ? p.zt : 0, far ? h.Z : min(p.e, h.Z), c, ring, rows);
  } else {
    b -= p.nzs * p.tz;
    const bool far = b >= p.ty;
    b -= far ? p.ty : 0;
    ring_run<kStreamY, kReadW, kWriteW>(
        f, w, sl, of, ow, h, om, kHaloRows, x0, p.e + b * kTY, h.Z - p.e,
        far ? p.yt : 0, far ? h.Y : min(p.e, h.Y), c, ring, rows);
  }
}

template <bool kReadW, bool kWriteW, class TIn, class TOut>
cudaError_t launch_shell_variant(const InP<TIn>& f, const InP<TIn>& w,
                                 const SlabP<TIn>& sl, const OutP<TOut>& of,
                                 const OutP<TOut>& ow, const HaloGeom& h,
                                 const ShellPlan& p, unsigned tiles,
                                 const Consts& c, cudaStream_t s) {
  using T = RingTile;
  auto kernel = mhd_shell_kernel<kReadW, kWriteW, TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(h.X, kBX), tiles);
  kernel<<<grid, dim3(kBX, T::kTY), T::kSmem, s>>>(f, w, sl, of, ow, h, p,
                                                   c);
  return cudaGetLastError();
}

// The shell kernel over plan p, w read when w.p[0] is set and written
// when ow.p[0] is; invalid for a plan shell_tiles refuses. The instances
// as for launch_ring (mhd_ring.cuh).
template <class TIn = float, class TOut = float>
cudaError_t launch_shell(const InP<TIn>& f, const InP<TIn>& w,
                         const SlabP<TIn>& sl, const OutP<TOut>& of,
                         const OutP<TOut>& ow, const HaloGeom& h,
                         const ShellPlan& p, const Consts& c,
                         cudaStream_t s) {
  const long long tiles = shell_tiles(p, h.Z, h.Y);
  if (tiles < 1 || tiles > 65535) return cudaErrorInvalidValue;
  const unsigned t = static_cast<unsigned>(tiles);
  const bool rw = w.p[0] != nullptr, ww = ow.p[0] != nullptr;
  if constexpr (std::is_same<TIn, TOut>::value) {
    if (rw && ww)
      return launch_shell_variant<true, true>(f, w, sl, of, ow, h, p, t, c,
                                              s);
    if (rw)
      return launch_shell_variant<true, false>(f, w, sl, of, ow, h, p, t, c,
                                               s);
    if (ww)
      return launch_shell_variant<false, true>(f, w, sl, of, ow, h, p, t, c,
                                               s);
    return launch_shell_variant<false, false>(f, w, sl, of, ow, h, p, t, c,
                                              s);
  } else if constexpr (std::is_same<TOut, float>::value) {
    if (rw || !ww) return cudaErrorInvalidValue;
    return launch_shell_variant<false, true>(f, w, sl, of, ow, h, p, t, c, s);
  } else {
    if (!rw || !ww) return cudaErrorInvalidValue;
    return launch_shell_variant<true, true>(f, w, sl, of, ow, h, p, t, c, s);
  }
}

// B13's launch A in storage type S, after the launcher's checks
template <class S>
cudaError_t overlap_a(const void* const* fields, const void* const* w,
                      void* const* dst, const Pieces& pc, void* const* out_f,
                      void* const* out_w, void* const* f1, void* const* w1,
                      const Interior* r, int n_regions, int Z, int Y, int X,
                      int pair, const float* consts, cudaStream_t s) {
  DstPtrs<S> dp;
  std::memcpy(&dp, dst, sizeof dp);
  const InP<S> fp = in_ptrs<S>(fields);
  send_rows_kernel<S><<<dim3(blocks(X, kCopyBX), kCopyRows, kPieces * kNF),
                        kCopyBX, 0, s>>>(fp, dp, pc, Y, X);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_regions == 0) return err;
  if (!pair) {
    Consts c;
    std::memcpy(&c, consts, sizeof c);
    return launch_ring(fp, in_ptrs<S>(w), SlabP<S>{}, out_ptrs<S>(out_f),
                       out_ptrs<S>(out_w), interior_geom(r[0], Z, Y, X), c,
                       s);
  }
  Consts c0, c1;
  pair_consts(consts, c0, c1);
  err = launch_ring(fp, InP<S>{}, SlabP<S>{}, out_ptrs(f1), out_ptrs(w1),
                    interior_geom(r[0], Z, Y, X), c0, s);
  if (err != cudaSuccess || n_regions == 1) return err;
  return launch_ring(in_ptrs(f1), in_ptrs(w1), SlabPtrs{},
                     out_ptrs<S>(out_f), out_ptrs<S>(out_w),
                     interior_geom(r[1], Z, Y, X), c1, s);
}

// B14's launch B in storage type S, after the launcher's checks: one
// substep (plan: a ShellPlan) or the pair (a PairPlan)
template <class S>
cudaError_t fixup_b(const void* const* fields, const void* const* w,
                    const void* const* slabs, void* const* f1,
                    void* const* w1, void* const* margin,
                    const void* const* slabs1, void* const* out_f,
                    void* const* out_w, const int* plan, const HaloGeom& g,
                    int pair, const float* consts, cudaStream_t s) {
  const InP<S> fp = in_ptrs<S>(fields);
  const SlabP<S> sp = slab_ptrs<S>(slabs);
  if (!pair) {
    ShellPlan p;
    std::memcpy(&p, plan, sizeof p);
    Consts c;
    std::memcpy(&c, consts, sizeof c);
    return launch_shell(fp, in_ptrs<S>(w), sp, out_ptrs<S>(out_f),
                        out_ptrs<S>(out_w), g, p, c, s);
  }
  PairPlan p;
  std::memcpy(&p, plan, sizeof p);
  Consts c0, c1;
  pair_consts(consts, c0, c1);
  // (1) substep 0 over the shell of depth R: f1, w1 now B11 s=0's over
  // the whole shard (launch A wrote z, y in [R, n - R))
  cudaError_t err = launch_shell(fp, InP<S>{}, sp, out_ptrs(f1),
                                 out_ptrs(w1), g, p.shell0, c0, s);
  if (err != cudaSuccess) return err;
  // (2) substep 0 over the R rows around the shard, into the R-row slabs
  err = launch_margin(fp, sp, out_ptrs(margin), g, p.margin, c0, s);
  if (err != cudaSuccess) return err;
  // (3) substep 1 over the pair's shell from f1, w1 and those slabs
  return launch_shell(in_ptrs(f1), in_ptrs(w1), slab_ptrs(slabs1),
                      out_ptrs<S>(out_f), out_ptrs<S>(out_w),
                      HaloGeom{g.Z, g.Y, g.X, R, R}, p.shell1, c1, s);
}

}  // namespace

extern "C" {

// B13, launch A. fields/w: 8 device pointers each (w NULL for w=None, and
// with the pair); dst: 64 receive-buffer pointers, piece-major (8 pieces
// x 8 fields); pieces: 8 x 7 host ints (nz, ny, sz0, sy0, dz0, dy0, dY);
// out_f/out_w: 8 each (out_w NULL for write_w=False); f1/w1: the pair's
// 8 float32 scratch fields each (NULL with one substep); regions:
// n_regions x 5 host ints (z0, nz, y0, ny, zrun), one region with one
// substep (none when the shard has no interior), one or two with the
// pair (substep 0 into f1, w1; substep 1 from them); consts: kNConsts
// host floats; is_bf16: the storage type of fields, w, the receive
// buffers and the outputs.
cudaError_t mhd_substep_overlap_launch(
    const void* const* fields, const void* const* w, void* const* dst,
    const int* pieces, void* const* out_f, void* const* out_w,
    void* const* f1, void* const* w1, const int* regions, int n_regions,
    int Z, int Y, int X, int pair, const float* consts, int n_consts,
    int is_bf16, void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) || n_regions < 0 ||
      n_regions > (pair ? kMaxInteriors : 1) ||
      (pair && (n_regions < 1 || w != nullptr || out_w == nullptr ||
                f1 == nullptr || w1 == nullptr)))
    return cudaErrorInvalidValue;
  Interior r[kMaxInteriors] = {};
  std::memcpy(r, regions, sizeof(Interior) * n_regions);
  // substep 0 (or the one substep) reads the shard alone; the pair's
  // substep 1 reads f1 only where substep 0 wrote it
  if (n_regions > 0 && !reads_inside(r[0], 0, Z, 0, Y))
    return cudaErrorInvalidValue;
  if (n_regions > 1 && !reads_inside(r[1], r[0].z0, r[0].z0 + r[0].nz,
                                     r[0].y0, r[0].y0 + r[0].ny))
    return cudaErrorInvalidValue;
  Pieces pc;
  static_assert(sizeof(Piece) == kPieceInts * sizeof(int), "Piece layout");
  std::memcpy(&pc, pieces, sizeof pc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? overlap_a<bf16>(fields, w, dst, pc, out_f, out_w, f1, w1,
                                   r, n_regions, Z, Y, X, pair, consts, s)
                 : overlap_a<float>(fields, w, dst, pc, out_f, out_w, f1,
                                    w1, r, n_regions, Z, Y, X, pair, consts,
                                    s);
}

// B14, launch B. fields/w: the pre-substep shard and w (w NULL for
// w=None, and with the pair); slabs: 32 landed-row pointers (zlo, zhi,
// ylo, yhi, each in field order; rz = ry rows); out_f/out_w: B13's
// outputs, completed in place (out_w NULL for write_w=False). One
// substep: plan holds the kShellPlanInts host ints of ShellPlan, e = R
// (n_plan = kShellPlanInts); f1, w1, margin and slabs1 are NULL. The
// pair: plan holds PairPlan's kPairPlanInts; f1/w1: the 8 float32 scratch
// fields each that the same shard's launch A wrote; margin: 8 float32
// buffers of n_margin floats; slabs1: 32, the R-row slabs that the margin
// plan writes, views of margin (ops/cuda_mhd.py margin_slabs). is_bf16:
// the storage type of fields, w, slabs and outputs.
cudaError_t mhd_substep_fixup_launch(
    const void* const* fields, const void* const* w, const void* const* slabs,
    void* const* f1, void* const* w1, void* const* margin,
    const void* const* slabs1, void* const* out_f, void* const* out_w,
    const int* plan, int n_plan, int n_margin, int Z, int Y, int X, int rz,
    int ry, int pair, const float* consts, int n_consts, int is_bf16,
    void* stream) {
  if (n_consts != kNConsts || !shape_ok(Z, Y, X) ||
      !halo_ok(Z, Y, X, rz, ry, pair ? 2 * R : R))
    return cudaErrorInvalidValue;
  if (!pair) {
    ShellPlan p;
    if (n_plan != kShellPlanInts) return cudaErrorInvalidValue;
    std::memcpy(&p, plan, sizeof p);
    if (p.e != R) return cudaErrorInvalidValue;  // B13: z, y in [R, n - R)
  } else {
    if (n_plan != kPairPlanInts || w != nullptr || out_w == nullptr ||
        f1 == nullptr || w1 == nullptr || margin == nullptr ||
        slabs1 == nullptr)
      return cudaErrorInvalidValue;
    PairPlan p;
    std::memcpy(&p, plan, sizeof p);
    if (p.shell0.e != R || !margin_ok(p.margin, Z, Y, X, n_margin))
      return cudaErrorInvalidValue;
  }
  const HaloGeom g{Z, Y, X, rz, ry};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fixup_b<bf16>(fields, w, slabs, f1, w1, margin, slabs1,
                                 out_f, out_w, plan, g, pair, consts, s)
                 : fixup_b<float>(fields, w, slabs, f1, w1, margin, slabs1,
                                  out_f, out_w, plan, g, pair, consts, s);
}

// How many blocks of B14's kernel one SM holds
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
