// 6th-order Laplacian kernel for Hopper (sm_90a), float32 and bfloat16.
//
// B8 laplace6_ring_kernel replaces stencil_tpu/ops/pallas_stencil.py:432
// laplace6_pallas: the sum over x, y and z of the 6th-order central
// second derivative (reference: astaroth/user_kernels.h:49-62
// second_derivative) on a radius-3 halo-padded (Zp, Yp, Xp) shard,
// writing the (Z, Y, X) interior. Bound to Python through a plain
// extern "C" launcher (ctypes; ops/cuda_stencil.py laplace6_cuda, beside
// its plain twin laplace6_plain, launched as laplace6_plan says).
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
//
// Design: a z-streaming shared-memory ring. A block of 256 threads owns
// a 64 x 32 (x, y) output tile and walks a run of `zrun` z planes of it
// (the run: ops/cuda_stencil.py laplace6_plan). Shared memory holds a
// ring of kDepth + 4 window planes: the tile with 4 columns (3 used) and
// 3 rows on each side, its rows rounded up to a multiple of the 8 warps,
// filled by cp.async kDepth = 2 planes ahead of the plane in use (on an
// H100 at 256^3 two beat one, three, five and six and tied four:
// PERF.md §6), so that each input point crosses device memory about
// once and the x and y neighbours are shared-memory loads, never global
// re-reads. On this card the number of cp.async instructions, not their
// bytes, sets the copy rate, so each row's first 64 columns are full
// warp-wide chunks and the 8 left over of 4 or 8 rows share one
// instruction, and the copies are 8 bytes where every padded row starts
// on 8 bytes and the low x pad is odd (Astaroth's layout: Xp = 262 rules
// out 16-byte rows), else 4 (kernel_times.py --model laplace6 --plans
// times both). Each thread computes four adjacent columns of two rows:
// its x window is two or three loads beside the centres, the y
// neighbours six rows of centres shared by its rows, and the z
// neighbours a register pencil of the 7 planes around each output row,
// fed one row of centres a plane from the ring and indexed modulo 7 in
// a loop unrolled 7 times, so the pencil never moves. One barrier a
// plane: pass i waits for plane i, asks for plane i + 2 into the slot of
// plane i - 4, and computes the output plane whose centre is plane
// i - 3. Odd z runs walk down, so that neighbouring runs read the planes
// they share at about the same time.
// Ragged x, y and z are masked; 16-byte stores where X is a multiple of 4.
//
// bfloat16 (the same kernel, T = bf16): the ring still holds float32
// cells, each the exact value of a bfloat16 cell, so the window indexing
// and the pencil are the float32 kernel's. A plane is fetched as pairs of
// bfloat16 cells into registers after the pass's barrier and written into
// its ring slot, widened, at the end of the pass (PlaneLoader<bf16>), so
// that the loads fly behind the pass's arithmetic. A thread's four
// outputs of a row are two bfloat16x2 lanes: every add and multiply is
// one of Hopper's packed bfloat16 instructions, rounded once, in the
// twin's order, with D2_C and w_i rounded once to bfloat16 as
// dt.type(...) rounds them and inv_ds^2 handed in rounded the same way:
// kernel and twin agree bitwise (csrc/bf16_math.cuh says why). A float32 add
// rounded to bfloat16 after every operation costs a conversion an
// operation, at a fraction of the float32 rate: 3x the float32 kernel's
// time on the first build. Bound: bytes, (Zp*Yp*Xp + Z*Y*X) * 2 B
// (0.0208 ms at 256^3 on 3.35 TB/s).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "bf16_math.cuh"

namespace {

// pallas_stencil.py _D2_C, _D2: each rounded once from double to float
constexpr float kC = static_cast<float>(-49.0 / 18.0);
constexpr float kW1 = static_cast<float>(3.0 / 2.0);
constexpr float kW2 = static_cast<float>(-3.0 / 20.0);
constexpr float kW3 = static_cast<float>(1.0 / 90.0);
// bfloat16: the same constants rounded once to bfloat16, as dt.type(...)
// rounds them: -2.71875 (0xC02E), 1.5 (0x3FC0), -0.150390625 (0xBE1A),
// 0.0111083984375 (0x3C36); weight2 and kC2 below hold their bits
constexpr int R = 3;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesX = 16;                     // threads across a tile row
constexpr int kTX = 4 * kLanesX;                // 64 tile columns
constexpr int kRowGroups = kThreads / kLanesX;  // 16 thread rows
constexpr int kPitch = kTX + 8;                 // window columns
constexpr int kPencil = 2 * R + 1;              // 7 planes
constexpr int kRows = 2;                        // output rows a thread
constexpr int kTY = kRowGroups * kRows;         // 32 tile rows
constexpr int kDepth = 2;                       // planes asked for ahead
constexpr int kSlots = kDepth + R + 1;          // ring planes
// the rows of a window plane in the ring: the tile's and R on each side,
// rounded up to a multiple of the warps, which copy one row each at a time
constexpr int kWinRows = (kTY + 2 * R + kWarps - 1) / kWarps * kWarps;
constexpr int kPlane = kPitch * kWinRows;
constexpr size_t kRingBytes = sizeof(float) * kSlots * kPlane;

inline unsigned blocks(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

struct Geom {
  int Z, Y, X;    // interior
  int Yp, Xp;     // row and plane strides of the padded field
  int lz, ly, lx; // low pads
};

struct Scale {
  float ix2, iy2, iz2;
};

__device__ __forceinline__ float weight(int d) {
  return d == 1 ? kW1 : (d == 2 ? kW2 : kW3);
}

// bfloat16: two lanes a register (lane 0 in the low half); pk, add2 and
// mul2 (csrc/bf16_math.cuh) pack two of the ring's widened cells and add
// and multiply them with Hopper's bfloat16x2 instructions, each lane
// rounded once: the twin's float32 operation rounded to bfloat16, as
// bf16_math.cuh argues.
// D2_C and w_i in both lanes
constexpr unsigned kC2 = 0xC02EC02Eu;
__device__ __forceinline__ unsigned weight2(int d) {
  return d == 1 ? 0x3FC03FC0u : (d == 2 ? 0xBE1ABE1Au : 0x3C363C36u);
}

__device__ __forceinline__ float part(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One cp.async of kChunk floats to the shared-memory address dst, only
// where `on` is set (a predicate inside the asm, so that the copies are
// straight-line code).
template <int kChunk>
__device__ __forceinline__ void copy_cell(unsigned dst, const float* src,
                                          int on) {
  asm volatile(
      "{\n .reg .pred p0;\n setp.ne.b32 p0, %2, 0;\n"
      " @p0 cp.async.ca.shared.global [%0], [%1], %3;\n}\n" ::"r"(dst),
      "l"(src), "r"(on), "n"(4 * kChunk));
}
// A row's full chunks: the 8-byte cell src[0..1], or the 4-byte ones
// src[0] and src[32] (to dst and dst + 128 bytes), each where its flag is
// set.
template <int kChunk>
__device__ __forceinline__ void copy_full(unsigned dst, const float* src,
                                          int on0, int on1) {
  if (kChunk == 2) {
    copy_cell<2>(dst, src, on0);
    return;
  }
  asm volatile(
      "{\n .reg .pred p0, p1;\n"
      " setp.ne.b32 p0, %2, 0;\n setp.ne.b32 p1, %3, 0;\n"
      " @p0 cp.async.ca.shared.global [%0], [%1], 4;\n"
      " @p1 cp.async.ca.shared.global [%0+128], [%1+128], 4;\n}\n" ::"r"(dst),
      "l"(src), "r"(on0), "r"(on1));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most kDepth - 1 groups are pending
__device__ __forceinline__ void cp_async_wait_ahead() {
  static_assert(kDepth == 2, "the wait_group immediate is kDepth - 1");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The four centre columns of a window row at p (16-byte aligned: the
// thread's window columns 0 .. 3 at kShift 0, -1 .. 2 at kShift 1).
template <int kShift>
__device__ __forceinline__ float4 centres(const float* p) {
  const float4 a = ld4(p);
  return kShift == 0 ? a : make_float4(a.y, a.z, a.w, p[4]);
}

// Where the window planes come from: the padded field at stream plane 0
// (base: its window column 0), and the window's first padded row and
// column. Window rows below the padded field copy its last row instead,
// and cells outside the padded row are left out: either only ever feeds
// outputs that are not stored.
template <typename T>
struct Window {
  const T* base;
  int yw, xw, Yp, Xp;
  __device__ __forceinline__ const T* row(int r) const {
    return base + static_cast<ptrdiff_t>(min(yw + r, Yp - 1)) * Xp;
  }
  // window columns c .. c + n - 1 lie in the padded row
  __device__ __forceinline__ bool inside(int c, int n) const {
    return xw + c >= 0 && xw + c + n <= Xp;
  }
};

// Fills ring slots with window planes, one plane a call of fetch(slot),
// in stream order: each plane is `step` elements past the last. land()
// at the end of the pass finishes what fetch began.
template <typename T, int kChunk>
struct PlaneLoader;

// float32: cp.async straight into the slot (land has nothing to do). On
// this card the number of cp.async instructions, not their bytes, sets
// the copy rate, so each row's first 64 columns are full warp-wide chunks
// and the 8 left over of 4 or 8 rows share one instruction.
template <int kChunk>
struct PlaneLoader<float, kChunk> {
  static constexpr int kCopyRows = kWinRows / kWarps;  // full rows a warp
  // a row's 72 smem columns: the full chunks of its first 64, and the 8
  // left over, whose cells (kLeftCells a row) of kLeftRows rows one
  // instruction copies; warp w copies leftover groups w, w + 8, ...
  static constexpr int kFull = 2 / kChunk;
  static constexpr int kLeftCells = 8 / kChunk;
  static constexpr int kLeftRows = 32 / kLeftCells;
  static constexpr int kLeftGroups = kWinRows / kLeftRows;
  static constexpr int kLeftPerWarp = (kLeftGroups + kWarps - 1) / kWarps;
  const float* rp[kCopyRows];  // full rows warp + 8 m, at column kChunk lane
  int full0, full1;
  unsigned dfull;
  const float* lp[kLeftPerWarp];  // leftover cells
  int left_on[kLeftPerWarp];
  unsigned dleft[kLeftPerWarp];
  ptrdiff_t step;

  __device__ __forceinline__ PlaneLoader(const Window<float>& w,
                                         unsigned ring_s, int tid,
                                         ptrdiff_t step_)
      : step(step_) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int m = 0; m < kCopyRows; ++m)
      rp[m] = w.row(warp + kWarps * m) + kChunk * lane;
    full0 = w.inside(kChunk * lane, kChunk);
    full1 = kFull > 1 && w.inside(kChunk * lane + 32, kChunk);
    dfull = ring_s + 4 * (warp * kPitch + kChunk * lane);
    const int lc = 64 + kChunk * (lane % kLeftCells);
#pragma unroll
    for (int u = 0; u < kLeftPerWarp; ++u) {
      const int q = warp + kWarps * u, r = q * kLeftRows + lane / kLeftCells;
      left_on[u] = q < kLeftGroups && w.inside(lc, kChunk);
      lp[u] = w.row(q < kLeftGroups ? r : 0) + lc;
      dleft[u] = ring_s + 4 * ((q < kLeftGroups ? r : 0) * kPitch + lc);
    }
  }
  __device__ __forceinline__ void fetch(int slot) {
    const unsigned d = 4 * slot * kPlane;
#pragma unroll
    for (int m = 0; m < kCopyRows; ++m) {
      copy_full<kChunk>(dfull + d + 4 * m * kWarps * kPitch, rp[m], full0,
                        full1);
      rp[m] += step;
    }
#pragma unroll
    for (int u = 0; u < kLeftPerWarp; ++u) {
      copy_cell<kChunk>(dleft[u] + d, lp[u], left_on[u]);
      lp[u] += step;
    }
  }
  __device__ __forceinline__ void land(float*) {}
};

// bfloat16: fetch() loads the thread's pairs of adjacent window cells
// into registers (two cells a register), land() writes them into the
// slot widened to float32. A plane's 72 x kWinRows cells are 36 pairs a
// row; pair p sits at smem floats 2p .. 2p + 1 of the plane (kPitch =
// 2 * 36), and thread t takes pairs t, t + 256, ... kChunk 2: a pair is
// one 4-byte load (window column 0 on an even padded column of a 4-byte
// aligned row, so that a pair lies in its row whole or not at all), else
// two 2-byte loads.
template <int kChunk>
struct PlaneLoader<bf16, kChunk> {
  static constexpr int kPairs = kPitch / 2 * kWinRows;
  static constexpr int kStage = (kPairs + kThreads - 1) / kThreads;
  const bf16* plane;    // the padded plane the next fetch reads
  int off[kStage];      // each pair's first cell in a plane
  unsigned on;          // bit 2m (2m + 1): pair m's first (second) cell
  unsigned staged[kStage];
  int tid, slot;        // slot: where land() writes, -1 for nothing
  ptrdiff_t step;

  __device__ __forceinline__ PlaneLoader(const Window<bf16>& w, unsigned,
                                         int tid_, ptrdiff_t step_)
      : plane(w.base), on(0), tid(tid_), slot(-1), step(step_) {
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      const int p = tid + kThreads * m;
      const int r = p < kPairs ? p / (kPitch / 2) : 0;
      const int c = 2 * (p % (kPitch / 2));
      off[m] = static_cast<int>(w.row(r) - w.base) + c;
      if (p < kPairs && w.inside(c, kChunk)) on |= 1u << (2 * m);
      if (p < kPairs && w.inside(c + 1, 1)) on |= 2u << (2 * m);
    }
  }
  __device__ __forceinline__ void fetch(int slot_) {
    const unsigned short* const q =
        reinterpret_cast<const unsigned short*>(plane);
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      if constexpr (kChunk == 2) {
        staged[m] = (on >> (2 * m)) & 1u
                        ? *reinterpret_cast<const unsigned*>(q + off[m])
                        : 0u;
      } else {
        const unsigned lo = (on >> (2 * m)) & 1u ? q[off[m]] : 0u;
        const unsigned hi = (on >> (2 * m)) & 2u ? q[off[m] + 1] : 0u;
        staged[m] = lo | (hi << 16);
      }
    }
    plane += step;
    slot = slot_;
  }
  __device__ __forceinline__ void land(float* ring) {
    if (slot < 0) return;
    float* const d = ring + slot * kPlane;
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      const int p = tid + kThreads * m;
      if (p < kPairs)
        *reinterpret_cast<float2*>(d + 2 * p) =
            make_float2(__uint_as_float(staged[m] << 16),
                        __uint_as_float(staged[m] & 0xffff0000u));
    }
    slot = -1;
  }
};

// four outputs of a row at p, of which only the first n < 4 may be
// stored where kVec is false
template <bool kVec>
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int n) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = v[e];
  }
}
// bfloat16: four outputs as two bfloat16x2 lanes; 8-byte stores where
// kVec
template <bool kVec>
__device__ __forceinline__ void store4b(bf16* p, const unsigned (&v)[2],
                                        int n) {
  if constexpr (kVec) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    unsigned short* const q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n)
        q[e] = static_cast<unsigned short>(v[e / 2] >> (16 * (e % 2)));
  }
}

// B8's ring kernel on cells of T (float or bf16). kChunk: cells a copy
// or load takes (2 where the padded rows are 8-byte aligned in float32,
// 4-byte aligned in bfloat16, and the low x pad odd, else 1).
template <typename T, int kChunk, bool kVecOut>
__global__ void __launch_bounds__(kThreads, 2)
laplace6_ring_kernel(const T* __restrict__ in, T* __restrict__ out, Geom g,
                     Scale s, int zrun) {
  extern __shared__ __align__(16) float ring[];
  // smem column of window column 0: 1 with 8-byte copies, so that each
  // lands on 8 bytes (the low x pad is odd); then the thread's centres
  // start one float past 16 bytes and take two loads a row
  constexpr int kShift = kChunk - 1;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int z0 = blockIdx.z * zrun, z1 = min(z0 + zrun, g.Z);
  // Odd z runs walk down: two neighbouring runs then reach the R planes
  // on each side of their border at about the same time, and the second
  // read of each is served by L2. Plane i of the stream is padded plane
  // zs + dz * i + lz; the output plane of pass i >= 6 is zs + dz * (i -
  // R). (hi + lo) is the same sum in either direction.
  const bool down = blockIdx.z & 1;
  const int dz = down ? -1 : 1;
  const int zs = down ? z1 - 1 + R : z0 - R;
  const ptrdiff_t pplane = static_cast<ptrdiff_t>(g.Yp) * g.Xp;
  const int xw = x0 + g.lx - 4 - kShift;  // padded column of smem column 0
  const int yw = y0 + g.ly - R;           // padded row of window row 0
  const Window<T> win{in + (zs + g.lz) * pplane + xw, yw, xw, g.Yp, g.Xp};
  PlaneLoader<T, kChunk> ld(
      win, static_cast<unsigned>(__cvta_generic_to_shared(ring)), tid,
      dz * pplane);

  // this thread's four columns and kRows rows: its first centre row's
  // 16-byte-aligned smem offset, and its first output
  const int tx = tid % kLanesX, ty = tid / kLanesX;
  const int ci = (R + kRows * ty) * kPitch + 4 + 4 * tx;
  const int ox = x0 + 4 * tx, oy = y0 + kRows * ty;
  const ptrdiff_t oplane = dz * static_cast<ptrdiff_t>(g.Y) * g.X;
  T* o = out + (zs + dz * R) * static_cast<ptrdiff_t>(g.Y) * g.X +
         static_cast<size_t>(oy) * g.X + ox;

  // bfloat16: inv_ds^2 (bfloat16-exact) in both lanes
  const unsigned sx2 = pk(s.ix2, s.ix2), sy2 = pk(s.iy2, s.iy2),
                 sz2 = pk(s.iz2, s.iz2);

  const int nload = z1 - z0 + 2 * R;  // planes z0 - R .. z1 + R - 1
  for (int i = 0; i < kDepth; ++i) {
    if (i < nload) {
      ld.fetch(i);
      ld.land(ring);
    }
    cp_async_commit();
  }
  // pass i waits for plane i (in ring slot `slot`), asks for plane i +
  // kDepth into the slot of plane i - 4 (read in pass i - 1, which the
  // barrier has closed; the bfloat16 loader writes it at the end of pass
  // i, when plane i - 4's slot is still read by no pass) and reads plane
  // i's centres into the pencil: pc[r][i % 7] is row r's four centre
  // columns at plane i
  float4 pc[kRows][kPencil];
  int slot = 0;
  auto advance = [&](int i) {
    cp_async_wait_ahead();  // plane i has landed (this thread's)
    __syncthreads();        // ... everyone's; pass i - 1 is done
    if (i + kDepth < nload) {
      const int ls = slot + kDepth;
      ld.fetch(ls < kSlots ? ls : ls - kSlots);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) {  // passes 0 .. 5 fill the pencil
    advance(k);
    const float* const pi = ring + slot * kPlane + ci;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      pc[r][k] = centres<kShift>(pi + r * kPitch);
    ld.land(ring);
    if (++slot == kSlots) slot = 0;
  }
  // pass i >= 6 computes the output plane of stream plane i - 3; in
  // pass i = 6 + 7 m + k plane i sits at pencil slot (k + 6) % 7, plane
  // i - 3 + d at (k + 3 + d) % 7: the loop is unrolled 7 times so that
  // every index is a constant and the pencil never moves
  for (int i0 = 2 * R; i0 < nload; i0 += kPencil) {
#pragma unroll
    for (int k = 0; k < kPencil; ++k) {
      if (i0 + k < nload) {
        advance(i0 + k);
        const float* const pi = ring + slot * kPlane + ci;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          pc[r][(k + 6) % kPencil] = centres<kShift>(pi + r * kPitch);
        const int ms = slot >= R ? slot - R : slot - R + kSlots;
        const float* const w = ring + ms * kPlane + ci;
        // rows -R .. kRows + R - 1 of the window at this thread's columns
        float4 yv[kRows + 2 * R];
#pragma unroll
        for (int j = 0; j < kRows + 2 * R; ++j)
          yv[j] = (j >= R && j < R + kRows)
                      ? pc[j - R][(k + 3) % kPencil]
                      : centres<kShift>(w + (j - R) * kPitch);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          // window columns -3 .. 6 around the thread's first centre
          const float* const wr = w + r * kPitch;
          const float4 c = yv[R + r];
          float xs[10];
          if (kShift == 0) {
            const float4 a = ld4(wr - 4), b = ld4(wr + 4);
            const float v[10] = {a.y, a.z, a.w, c.x, c.y,
                                 c.z, c.w, b.x, b.y, b.z};
#pragma unroll
            for (int q = 0; q < 10; ++q) xs[q] = v[q];
          } else {
            const float2 a = *reinterpret_cast<const float2*>(wr - 2);
            const float4 b = ld4(wr + 4);
            const float v[10] = {a.x, a.y, wr[0], c.x, c.y,
                                 c.z, c.w, b.y, b.z, b.w};
#pragma unroll
            for (int q = 0; q < 10; ++q) xs[q] = v[q];
          }
          if (oy + r >= g.Y || ox >= g.X) continue;
          T* const po = o + static_cast<size_t>(r) * g.X;
          if constexpr (std::is_same<T, bf16>::value) {
            // outputs (0, 1) and (2, 3) as two bfloat16x2 lanes
            unsigned res[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e0 = 2 * h, e1 = 2 * h + 1;
              const unsigned ctr = pk(xs[R + e0], xs[R + e1]);
              unsigned accx = mul2(kC2, ctr);
              unsigned accy = accx;
              unsigned accz = mul2(kC2, ctr);
#pragma unroll
              for (int d = 1; d <= R; ++d) {
                const unsigned wd = weight2(d);
                accx = add2(accx, mul2(wd, add2(pk(xs[R + e0 + d],
                                                   xs[R + e1 + d]),
                                                pk(xs[R + e0 - d],
                                                   xs[R + e1 - d]))));
                accy = add2(
                    accy,
                    mul2(wd, add2(pk(part(yv[R + r + d], e0),
                                     part(yv[R + r + d], e1)),
                                  pk(part(yv[R + r - d], e0),
                                     part(yv[R + r - d], e1)))));
                const float4 zh = pc[r][(k + 3 + d) % kPencil];
                const float4 zl = pc[r][(k + 3 - d) % kPencil];
                accz = add2(accz, mul2(wd, add2(pk(part(zh, e0),
                                                   part(zh, e1)),
                                                pk(part(zl, e0),
                                                   part(zl, e1)))));
              }
              res[h] = add2(add2(mul2(accx, sx2), mul2(accy, sy2)),
                            mul2(accz, sz2));
            }
            store4b<kVecOut>(po, res, g.X - ox);
          } else {
            float res[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ctr = xs[R + e];
              float accx = kC * ctr;
              float accy = accx;
              float accz = kC * ctr;
#pragma unroll
              for (int d = 1; d <= R; ++d) {
                const float wd = weight(d);
                accx = accx + wd * (xs[R + e + d] + xs[R + e - d]);
                accy = accy + wd * (part(yv[R + r + d], e) +
                                    part(yv[R + r - d], e));
                accz = accz + wd * (part(pc[r][(k + 3 + d) % kPencil], e) +
                                    part(pc[r][(k + 3 - d) % kPencil], e));
              }
              res[e] = accx * s.ix2 + accy * s.iy2 + accz * s.iz2;
            }
            store4<kVecOut>(po, res, g.X - ox);
          }
        }
        ld.land(ring);
        o += oplane;
        if (++slot == kSlots) slot = 0;
      }
    }
  }
  cp_async_wait_all();
}

// B8 on cells of T with kChunk-float copies; 16-byte stores (8-byte in
// bfloat16) where X is a multiple of 4 and the output aligned to them.
template <typename T, int kChunk>
cudaError_t launch(const T* in, T* out, const Geom& g, const Scale& s,
                   int zrun, cudaStream_t stream) {
  const bool vec_out = g.X % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  const auto kernel = vec_out ? laplace6_ring_kernel<T, kChunk, true>
                              : laplace6_ring_kernel<T, kChunk, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRingBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(g.X, kTX), blocks(g.Y, kTY), blocks(g.Z, zrun));
  kernel<<<grid, kThreads, kRingBytes, stream>>>(in, out, g, s, zrun);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B8 over the (Z, Y, X) interior of a (Zp, Yp, Xp) field with low pads
// (lz, ly, lx) >= 3, in z runs of `zrun` planes (ops/cuda_stencil.py
// laplace6_plan), on float32 cells or, where is_bf16, bfloat16 ones
// (ix2, iy2, iz2 then bfloat16-exact). Two cells a copy or load where
// every padded row starts on two cells (Xp even, the field aligned to
// two cells) and lx is odd, one otherwise.
cudaError_t laplace6_launch(const void* in, void* out, int Z, int Y, int X,
                            int Yp, int Xp, int lz, int ly, int lx,
                            float ix2, float iy2, float iz2, int zrun,
                            int is_bf16, void* stream) {
  if (Z < 1 || Y < 1 || X < 1 || lz < R || ly < R || lx < R || zrun < 1)
    return cudaErrorInvalidValue;
  const Geom g{Z, Y, X, Yp, Xp, lz, ly, lx};
  const Scale s{ix2, iy2, iz2};
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* bin = static_cast<const bf16*>(in);
    auto* bout = static_cast<bf16*>(out);
    if (Xp % 2 == 0 && reinterpret_cast<uintptr_t>(in) % 4 == 0 && lx % 2)
      return launch<bf16, 2>(bin, bout, g, s, zrun, st);
    return launch<bf16, 1>(bin, bout, g, s, zrun, st);
  }
  const auto* fin = static_cast<const float*>(in);
  auto* fout = static_cast<float*>(out);
  if (Xp % 2 == 0 && reinterpret_cast<uintptr_t>(in) % 8 == 0 && lx % 2)
    return launch<float, 2>(fin, fout, g, s, zrun, st);
  return launch<float, 1>(fin, fout, g, s, zrun, st);
}

// How many blocks of the kernel one SM holds, as the CUDA runtime counts
// them (the instance of Astaroth's layout: two cells a copy or load, odd
// low x pad, 16-byte stores in float32, 8-byte in bfloat16):
// ops/cuda_stencil.py laplace6_blocks_per_sm models it, and laplace6_plan
// plans with that.
cudaError_t laplace6_blocks_per_sm(int is_bf16, int* blocks_per_sm) {
  const auto kernel =
      is_bf16 ? reinterpret_cast<const void*>(
                    laplace6_ring_kernel<bf16, 2, true>)
              : reinterpret_cast<const void*>(
                    laplace6_ring_kernel<float, 2, true>);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRingBytes));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       kThreads, kRingBytes);
}

}  // extern "C"
