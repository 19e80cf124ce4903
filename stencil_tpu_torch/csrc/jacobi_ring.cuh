// The z-streaming N-step Jacobi kernel for Hopper (sm_90a), float32 or
// bfloat16 storage: one kernel body that csrc/jacobi7.cu launches as K2
// and csrc/jacobi_halo.cu as B6, and the device code both libraries
// share (the spheres, the floor modulo).
//
// N Jacobi steps per pass over device memory (temporal blocking), 1 <= N
// <= 8 a launch: each step averages the six face neighbours, in the order
// of the JAX kernels, ((zm+zp)+(ym+yp))+(xm+xp), then * 1/6
// (pallas_stencil.py:325-330, pallas_halo.py:404-410), with __fadd_rn /
// __fmul_rn in a library built -fmad=false; after every step the
// Dirichlet spheres are re-imposed at the GLOBAL coordinates wrapped
// modulo the global grid, since the recomputed ring cells may belong to
// a neighbouring shard.
//
// bfloat16 (T = bf16): the ring holds bfloat16 cells, so a window plane
// takes half the shared memory, and every add and the multiply by
// bf16(1/6) round to bfloat16 at once (csrc/bf16_math.cuh), as the JAX
// kernels do; intermediate levels are bfloat16 values, as JAX's are.
// The wrappers run 9 <= N <= 16 (bfloat16's sublane tile is 16) as two
// launches: the first walks N1 = ceil(N / 2) steps over the shard grown
// by N2 = N - N1 rows in z and y into a padded buffer in device memory
// (Box), the second the last N2 steps from that buffer (kPaddedRows).
// Every cell's value at a level depends only on its position, so the two
// launches compute what one launch of N steps would, bit for bit.
//
// Design. A block of 256 threads owns a 64 x TY (x, y) tile of outputs
// and walks a run of `zrun` z planes of it (TY, the prefetch depth and
// the run come from ops/cuda_stencil.py jacobi_ring_plan; TY = 32 at
// N <= 4). Its level-0 window is the tile with a margin of M = 4 *
// ceil(N / 4) columns and N rows on each side, so that every window row
// starts on 16 bytes when X is a multiple of 4. Shared memory holds
//   - a ring of depth + 3 input planes of the window, filled by cp.async
//     (16-byte copies when X % 4 == 0 and the rows are aligned, else
//     4-byte ones) `depth` planes ahead of the plane in use, so several
//     planes are always in flight, and
//   - for each intermediate level k = 1..N-1 a ring of 4 planes.
// Pass t waits for input plane p0 = z0 - N + t, passes ONE barrier, asks
// for plane p0 + depth, and then lets every level advance: level k
// computes its plane p0 - (2k - 1) from level k-1's planes p0 - 2k ..
// p0 - 2k + 2, all finished in earlier passes, over the tile grown by
// N - k cells in x and y (the ring that neighbouring blocks recompute
// too). Level N goes straight to device memory. Each lane owns two
// columns of the tile at every level (float2 loads and stores), each
// warp a run of rows whose y neighbours roll through registers
// (ring_rows); the few columns beyond the tile are one cell a lane. The
// spheres are tested only on planes and in blocks that reach them (a
// per-block vote on the window's columns and rows), from tables of the
// squared distances of its columns and rows to the centres.
//
// The launches differ only in where a window row comes from, chosen once
// a block while the row table is filled (RowSrc):
//   kWrappedRows  K2: the field itself, periodic: row wrap(y, Y) of plane
//                 wrap(p, Z);
//   kSlabRows     B6: the shard's row y for 0 <= y < Y, its z slabs for
//                 planes p < 0 (zlo) and p >= Z (zhi); the z-extended y
//                 slabs (ylo, yhi) for rows y < 0 and y >= Y at every
//                 plane: the sequential-sweep corner rule of
//                 pallas_halo.py:439-452.
//   kPaddedRows   the second launch of N > 8: row y of plane p of a
//                 buffer padded by rz in z and y (the first launch's
//                 output box).
// x wraps inside the row in all three. On a (1,1,1) mesh B6's slabs are
// the shard's own wrapped rows, so B6 there computes K2's values bit for
// bit.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bf16_math.cuh"

namespace {

// dt.type(1.0 / 6.0) in the JAX kernels: 1/6 in double, rounded once
// to float
constexpr float kSixth = static_cast<float>(1.0 / 6.0);

struct Spheres {
  int hx, hy, hz;  // hot centre
  int cx, cy, cz;  // cold centre
  int r2;          // radius squared
};

__device__ __forceinline__ float impose(float v, int gx, int gy, int gz,
                                        const Spheres& s) {
  int dx = gx - s.hx, dy = gy - s.hy, dz = gz - s.hz;
  if (dx * dx + dy * dy + dz * dz <= s.r2) v = 1.0f;
  dx = gx - s.cx;
  dy = gy - s.cy;
  dz = gz - s.cz;
  if (dx * dx + dy * dy + dz * dz <= s.r2) v = 0.0f;  // cold wins
  return v;
}

// floor modulo: a coordinate below 0 must wrap to the top, which C's %
// (truncating) does not do
__device__ __forceinline__ int wrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

inline unsigned blocks(int n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

constexpr int kRingThreads = 256;
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kTX = 64;        // tile columns: 32 lanes, 2 columns a lane
constexpr int kMaxSteps = 8;   // steps of one launch: float32's sublane tile
// The static tables below hold kMaxWY window rows and kMaxWX columns;
// ops/cuda_stencil.py counts their bytes (RING_STATIC_BYTES) from the
// same two numbers, and the card tests hold that to the build's.
constexpr int kMaxWY = 48;     // window rows the row and sphere tables hold
constexpr int kMaxWX = 80;     // window columns: kTX + 2 * ring_margin(8)

enum RowSource { kWrappedRows = 0, kSlabRows = 1, kPaddedRows = 2 };

// The slabs of a B6 shard (z-extended y slabs; see csrc/jacobi_halo.cu);
// with kPaddedRows only rz, the pad of the buffer, is read.
template <class T>
struct SlabSrc {
  const T* zlo;
  const T* zhi;
  const T* ylo;
  const T* yhi;
  int rz;  // rows of zlo/zhi, and the z offset of a y slab
  int e;   // columns of ylo/yhi
};

// The launch's output box, in the shard's coordinates: planes [oz, oz +
// nz) and rows [oy, oy + ny), every x; written to `out` as a dense (nz,
// ny, X) array. The shard itself is (0, 0, Z, Y).
struct Box {
  int oz, oy, nz, ny;
};

// The shard's global origin and the global grid, for the spheres (K2:
// origin 0 and the field's own shape).
struct Global {
  int oz, oy, ox;
  int gz, gy, gx;
};

// The launch's tile rows, prefetch depth and z run (jacobi_ring_plan).
struct RingPlan {
  int ty, depth, zrun;
};

// Where window row r comes from, set up once a block: base[j] is the row
// at plane pref = -1, 0, Z (for p < 0, 0 <= p < Z, p >= Z), and the row
// at plane p is base[j] + (p - pref) * stride; K2 uses base[1] alone, at
// plane wrap(p, Z). base[j] == nullptr: the row is never needed.
template <class T>
struct RowSrc {
  const T* base[3];
  int stride;
};

__host__ __device__ inline int ring_margin(int N) {
  return 4 * ((N + 3) / 4);
}

__host__ __device__ inline int ring_slots(int N, int depth) {
  return depth + 3 + 4 * (N - 1);
}

template <class T>
inline size_t ring_smem_bytes(int N, const RingPlan& p) {
  const size_t wx = kTX + 2 * ring_margin(N), wy = p.ty + 2 * N;
  return sizeof(T) * ring_slots(N, p.depth) * wx * wy;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(bf16* dst, const bf16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most depth - 1 groups are pending (the immediate must be
// a constant)
__device__ __forceinline__ void cp_async_wait_ahead(int depth) {
  switch (depth) {
    case 1: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ring cells of either storage type, as float32 (csrc/bf16_math.cuh has
// the bfloat16 ones)
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// the squared distances of a coordinate g to the hot (x) and cold (y)
// centres' coordinates h and c on one axis
__device__ __forceinline__ int2 sq2(int g, int h, int c) {
  return make_int2((g - h) * (g - h), (g - c) * (g - c));
}

// impose() from squared distances per axis: hot first, cold wins
__device__ __forceinline__ float impose2(float v, int2 dx, int2 dy, int2 dz,
                                         int r2) {
  if (dx.x + dy.x + dz.x <= r2) v = 1.0f;
  if (dx.y + dy.y + dz.y <= r2) v = 0.0f;
  return v;
}

// one Jacobi step of a cell: ((zm+zp)+(ym+yp))+(xm+xp), * 1/6; in
// bfloat16 every operation rounds to bfloat16
template <class T>
__device__ __forceinline__ float step7(float zm, float zp, float ym, float yp,
                                       float xm, float xp) {
  if constexpr (sizeof(T) == 2) {
    return mul_bf16(add_bf16(add_bf16(add_bf16(zm, zp), add_bf16(ym, yp)),
                             add_bf16(xm, xp)),
                    kSixthBf16);
  } else {
    return __fmul_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(zm, zp), __fadd_rn(ym, yp)),
                  __fadd_rn(xm, xp)),
        kSixth);
  }
}

// Rows [r0, r1) of one level at a thread's two columns, window cell i =
// r0 * P + first column: the level's planes lo, mid, hi below, at and
// above it; y neighbours roll through registers. kOut: the last level,
// to device memory at o (row stride X, rows below `rows_in` and the
// columns flagged in xin), else to dst in shared memory. kSpheres: impose
// them (dx per column, dy per window row in sy, dz per plane).
template <bool kOut, bool kSpheres, class T>
__device__ __forceinline__ void ring_rows(
    const T* lo, const T* mid, const T* hi, T* dst, T* o, int i, int r0,
    int r1, int P, int X, int rows_in, bool xin0, bool xin1, int2 dx0,
    int2 dx1, int2 dz, const int2* sy, int r2) {
  float2 up = ld2(mid + i - P), ctr = ld2(mid + i);
  for (int rr = r0; rr < r1; ++rr) {
    const float2 dn = ld2(mid + i + P);
    const float2 zm = ld2(lo + i), zp = ld2(hi + i);
    float v0 = step7<T>(zm.x, zp.x, up.x, dn.x, ld1(mid + i - 1), ctr.y);
    float v1 = step7<T>(zm.y, zp.y, up.y, dn.y, ctr.x, ld1(mid + i + 2));
    if (kSpheres) {
      const int2 dy = sy[rr];
      v0 = impose2(v0, dx0, dy, dz, r2);
      v1 = impose2(v1, dx1, dy, dz, r2);
    }
    if (!kOut) {
      st2(dst + i, v0, v1);
    } else if (rr < rows_in) {
      if (xin0) st1(o, v0);
      if (xin1) st1(o + 1, v1);
    }
    up = ctr;
    ctr = dn;
    i += P;
    if (kOut) o += X;
  }
}

template <int kSource, class T>
__global__ void __launch_bounds__(kRingThreads, 2)
jacobi_ring_kernel(const T* __restrict__ in, T* __restrict__ out,
                   SlabSrc<T> sl, int Z, int Y, int X, Box box, Global g,
                   Spheres s, int N, RingPlan pl, int vec) {
  // K2's box is always the field: spelled out, so that its offsets fold
  const Box bx = kSource == kWrappedRows ? Box{0, 0, Z, Y} : box;
  extern __shared__ __align__(16) float ring_raw[];
  T* const ring = reinterpret_cast<T*>(ring_raw);
  __shared__ RowSrc<T> rows[kMaxWY];
  __shared__ int2 sx[kMaxWX], sy[kMaxWY];  // squared distances to centres
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = ring_margin(N), TY = pl.ty;
  const int P = kTX + 2 * M, WY = TY + 2 * N;  // window pitch and rows
  const int plane = P * WY;
  const int S = pl.depth + 3;                  // input ring slots
  T* const lvl = ring + S * plane;             // levels 1..N-1, 4 slots each
  const int x0 = blockIdx.x * kTX, y0 = bx.oy + blockIdx.y * TY;
  const int z0 = bx.oz + blockIdx.z * pl.zrun;
  const int z1 = min(z0 + pl.zrun, bx.oz + bx.nz);
  const int xw = x0 - M, yw = y0 - N, zs = z0 - N;  // window origin
  const int yend = bx.oy + bx.ny;                   // the box's last row + 1
  const size_t yx = static_cast<size_t>(Y) * X;

  if (tid < WY) {
    const int y = yw + tid;
    RowSrc<T> r;
    r.base[0] = r.base[1] = r.base[2] = nullptr;
    r.stride = 0;
    // no output row of the tile reads a row N or more beyond its last
    if (y < min(y0 + TY, yend) + N) {
      if (kSource == kWrappedRows) {
        r.base[1] = in + static_cast<size_t>(wrap(y, Y)) * X;
        r.stride = Y * X;
      } else if (kSource == kPaddedRows) {
        const int YP = Y + 2 * sl.rz;  // rows of a plane of the buffer
        r.base[1] = in + (static_cast<size_t>(sl.rz) * YP + sl.rz + y) * X;
        r.stride = YP * X;
      } else if (y < 0 || y >= Y) {
        const T* slab = y < 0 ? sl.ylo : sl.yhi;
        const int col = y < 0 ? sl.e + y : y - Y;
        const int st = sl.e * X;
        const T* row0 =
            slab + (static_cast<size_t>(sl.rz) * sl.e + col) * X;  // z = 0
        r.base[0] = row0 - st;
        r.base[1] = row0;
        r.base[2] = row0 + static_cast<size_t>(Z) * st;
        r.stride = st;
      } else {
        const size_t row = static_cast<size_t>(y) * X;
        r.base[0] = sl.zlo + static_cast<size_t>(sl.rz - 1) * yx + row;
        r.base[1] = in + row;
        r.base[2] = sl.zhi + row;
        r.stride = Y * X;
      }
    }
    rows[tid] = r;
  }
  // the squared distances of the window's rows and columns to the
  // centres, and which spheres the window reaches in x and in y (the
  // votes are also the barrier after the tables)
  int2 fx = make_int2(s.r2 + 1, s.r2 + 1), fy = fx;
  if (tid < WY) sy[tid] = fy = sq2(wrap(g.oy + yw + tid, g.gy), s.hy, s.cy);
  if (tid < P)
    sx[tid] = fx = sq2(wrap(g.ox + wrap(xw + tid, X), g.gx), s.hx, s.cx);
  const bool hot_xy = __syncthreads_or(fx.x <= s.r2) &&
                      __syncthreads_or(fy.x <= s.r2);
  const bool cold_xy = __syncthreads_or(fx.y <= s.r2) &&
                       __syncthreads_or(fy.y <= s.r2);

  // plane p of the window into input slot `slot_index`, one row a warp:
  // 16-byte copies (four float32 or, 8 bytes, four bfloat16 cells), the
  // chunk 4 * lane, or single cells, the columns lane + 32 i, x wrapped
  // (4-byte cp.async for float32, a load and a store for bfloat16: the
  // store lands before the barrier of the pass that reads it)
  int xs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xs[i] = wrap(xw + (vec ? 4 * lane : lane + 32 * i), X);
  auto load_plane = [&](int p, int slot_index) {
    T* slot = ring + slot_index * plane;
    int j = 1, pp = p;
    if (kSource == kWrappedRows) {
      pp = wrap(p, Z);
    } else if (kSource == kSlabRows) {
      j = p < 0 ? 0 : (p < Z ? 1 : 2);
      pp = p - (j == 0 ? -1 : (j == 1 ? 0 : Z));
    }
    for (int r = warp; r < WY; r += kRingWarps) {
      const T* b = rows[r].base[j];
      if (b == nullptr) continue;
      const T* row = b + static_cast<ptrdiff_t>(pp) * rows[r].stride;
      T* d = slot + r * P;
      if (vec) {
        if (4 * lane < P) {
          if constexpr (sizeof(T) == 2)
            cp_async8(d + 4 * lane, row + xs[0]);
          else
            cp_async16(d + 4 * lane, row + xs[0]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (lane + 32 * i < P) {
            if constexpr (sizeof(T) == 2)
              d[lane + 32 * i] = row[xs[i]];
            else
              cp_async4(d + lane + 32 * i, row + xs[i]);
          }
      }
    }
  };

  // Level k's cells: the tile grown by m = N - k, window rows [k, k + h)
  // with h = TY + 2m. The tile's 64 columns go two a lane, and its rows
  // to the 8 warps in runs of consecutive rows (ring_rows), so a thread's
  // columns (and their x, for the spheres) are the same at every level
  // and pass; each warp also takes the m columns on either side of its
  // rows, one cell a lane.
  const int cb = M + 2 * lane;  // this lane's first window column
  const int2 dx0 = sx[cb], dx1 = sx[cb + 1];
  const bool xin0 = xw + cb < X, xin1 = xw + cb + 1 < X;

  const int nload = z1 - z0 + 2 * N;  // input planes zs .. zs + nload - 1
  for (int i = 0; i < pl.depth; ++i) {
    if (i < nload) load_plane(zs + i, i);
    cp_async_commit();
  }
  const int T_ = z1 - z0 + 3 * N - 1;
  int slot = 0;                      // the input slot of plane p0
  int gz0 = wrap(g.oz + zs, g.gz);   // the global z of plane p0
  for (int t = 0; t < T_; ++t) {
    const int p0 = zs + t;
    cp_async_wait_ahead(pl.depth);  // plane p0 has landed (this thread's)
    __syncthreads();                // ... everyone's, and pass t-1 is done
    if (t + pl.depth < nload) {
      const int ls = slot + pl.depth;
      load_plane(p0 + pl.depth, ls < S ? ls : ls - S);
    }
    cp_async_commit();
#pragma unroll 1
    for (int k = 1; k <= N; ++k) {
      const int q = p0 - (2 * k - 1);  // the plane level k computes
      if (q < z0 - N + k || q >= z1 + N - k) continue;
      const T *lo, *mid, *hi;
      if (k == 1) {  // input planes p0 - 2, p0 - 1, p0
        lo = ring + (slot >= 2 ? slot - 2 : slot - 2 + S) * plane;
        mid = ring + (slot >= 1 ? slot - 1 : slot - 1 + S) * plane;
        hi = ring + slot * plane;
      } else {       // level k-1's planes q - 1, q, q + 1
        const T* b = lvl + (k - 2) * 4 * plane;
        lo = b + ((t - 2 * k) & 3) * plane;
        mid = b + ((t - 2 * k + 1) & 3) * plane;
        hi = b + ((t - 2 * k + 2) & 3) * plane;
      }
      int gz = gz0 - (2 * k - 1);
      while (gz < 0) gz += g.gz;
      const int2 dz = sq2(gz, s.hz, s.cz);
      const bool spheres = (hot_xy && dz.x <= s.r2) || (cold_xy && dz.y <= s.r2);
      const int m = N - k, h = TY + 2 * m;
      const int r0 = k + h * warp / kRingWarps;
      const int r1 = k + h * (warp + 1) / kRingWarps;
      const int i = r0 * P + cb;
      if (k < N) {
        T* const dst = lvl + (k - 1) * 4 * plane +
                       ((t - 2 * k + 1) & 3) * plane;
        if (spheres)
          ring_rows<false, true>(lo, mid, hi, dst, static_cast<T*>(nullptr),
                                 i, r0, r1, P, X, 0, xin0, xin1, dx0, dx1,
                                 dz, sy, s.r2);
        else
          ring_rows<false, false>(lo, mid, hi, dst, static_cast<T*>(nullptr),
                                  i, r0, r1, P, X, 0, xin0, xin1, dx0, dx1,
                                  dz, sy, s.r2);
        // the m columns on either side of this warp's rows: lane (side,
        // row) = (lane / 16, lane % 16), one column of each side a round
        const int rr = r0 + (lane & 15);
        if (rr < r1) {
          for (int e = 0; e < m; ++e) {
            const int c = lane < 16 ? M - m + e : M + kTX + e;
            const int j = rr * P + c;
            float v = step7<T>(ld1(lo + j), ld1(hi + j), ld1(mid + j - P),
                               ld1(mid + j + P), ld1(mid + j - 1),
                               ld1(mid + j + 1));
            if (spheres) v = impose2(v, sx[c], sy[rr], dz, s.r2);
            st1(dst + j, v);
          }
        }
      } else {
        T* const o = out +
                     static_cast<size_t>(q - bx.oz) * bx.ny * X +
                     static_cast<size_t>(yw + r0 - bx.oy) * X + (xw + cb);
        const int rows_in = yend - yw;  // window rows inside the box
        if (spheres)
          ring_rows<true, true>(lo, mid, hi, static_cast<T*>(nullptr), o, i,
                                r0, r1, P, X, rows_in, xin0, xin1, dx0, dx1,
                                dz, sy, s.r2);
        else
          ring_rows<true, false>(lo, mid, hi, static_cast<T*>(nullptr), o, i,
                                 r0, r1, P, X, rows_in, xin0, xin1, dx0, dx1,
                                 dz, sy, s.r2);
      }
    }
    if (++slot == S) slot = 0;
    if (++gz0 == g.gz) gz0 = 0;
  }
  cp_async_wait_all();
}

// The ring kernel with row source kSource over the output box `bx` of a
// (Z, Y, X) field or shard; invalid for a plan that does not fit. Copies
// of 16 bytes (float32) or 8 bytes (bfloat16) where X % 4 == 0 and every
// source is aligned to them, single cells otherwise.
template <int kSource, class T>
cudaError_t launch_jacobi_ring(const T* in, T* out, const SlabSrc<T>& sl,
                               int Z, int Y, int X, const Box& bx,
                               const Global& g, const Spheres& s, int N,
                               const RingPlan& pl, cudaStream_t stream) {
  if (N < 1 || N > kMaxSteps || Z < 1 || Y < 1 || X < 1 || pl.ty < 1 ||
      pl.ty + 2 * N > kMaxWY || pl.depth < 1 || pl.depth > 4 ||
      pl.zrun < 1 || bx.nz < 1 || bx.ny < 1)
    return cudaErrorInvalidValue;
  const auto aligned = [](const T* p) {
    return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  };
  const int vec = X % 4 == 0 && aligned(in) &&
                  (kSource != kSlabRows ||
                   (aligned(sl.zlo) && aligned(sl.zhi) && aligned(sl.ylo) &&
                    aligned(sl.yhi)));
  const size_t smem = ring_smem_bytes<T>(N, pl);
  auto kernel = jacobi_ring_kernel<kSource, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(X, kTX), blocks(bx.ny, pl.ty),
                  blocks(bx.nz, pl.zrun));
  kernel<<<grid, kRingThreads, smem, stream>>>(in, out, sl, Z, Y, X, bx, g,
                                               s, N, pl, vec);
  return cudaGetLastError();
}

// Blocks of the ring kernel (row source kSource, storage T) one SM holds
// at a tile and depth.
template <int kSource, class T>
cudaError_t ring_blocks_per_sm(int N, int ty, int depth,
                               int* blocks_per_sm) {
  const size_t smem = ring_smem_bytes<T>(N, RingPlan{ty, depth, 1});
  auto kernel = jacobi_ring_kernel<kSource, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kRingThreads, smem);
}

}  // namespace
