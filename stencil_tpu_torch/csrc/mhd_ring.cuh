// The streaming MHD RK3 substep for Hopper (sm_90a), float32 or
// bfloat16 storage, float32 arithmetic: one kernel body that csrc/mhd.cu
// launches as B9 and B11, twice each as the substep pairs B10 and B12,
// and over B12's margin (its z strips
// walking z, its y strips walking y), and csrc/mhd_overlap.cu as B13's
// interior (walking z) and as B14's shell (its z strips walking z, its
// y strips walking y).
//
// One RK3 substep s over a region of a (Z, Y, X) field or shard (or, for
// B12's margin, the rows just outside a shard): the points z in [z0, z0 +
// nz), y in [y0, y0 + ny), every x (x wrapped):
//   wq = dt * rates;  wq = alpha * w + wq  (only when w is read);
//   w_out = wq (only when written);  f_out = value + beta * wq.
// kReadW=false is w=None (alpha_0 == 0: substep 0 never reads w);
// kWriteW=false is write_w=False (nothing reads substep 2's w).
//
// Design (B11's, generalised to a region, a row source and a streaming
// axis): a block owns a 32 x 16 tile of the region, 32 x columns by 16
// rows of the tile's row axis, and walks a run of slices along the
// streaming axis. The z instance (kStreamZ: tile rows are y, slices are
// z planes) computes B9, B11, B13's interior and B14's z strips; the y
// instance (kStreamY: tile rows are z, slices are y) B14's y strips,
// which are R rows deep in y, so that a tile's 16 rows lie along their
// broad z side and every warp computes. Shared memory holds, per field,
// a ring of 8 slices of the tile and its radius-3 margin (22 x 38
// floats each): 7 for the point's neighbourhood and one that cp.async
// fills with slice s + 4 while slice s is computed. Each margin row is
// copied by one warp, coalesced, x wrapped, from a table of the block's
// rows set up once (RowSrc), so every tap of the ~300 a point is a
// shared-memory load with an immediate offset from one of 7 per-thread
// slice registers. The arithmetic is field_data and mhd_rates
// (mhd_common.cuh), unchanged, through a shared-memory accessor (RingAt,
// which swaps dy and dz in the y instance). A 32 x 16 tile is 512
// threads, 16 warps and 214 KB a block, one block an SM, at most 128
// registers a thread; 32 x 8 and 32 x 4 tiles hold 8 warps an SM and ran
// slower on an H100 (PERF.md). ops/cuda_mhd.py ring_zrun picks the z run
// of a whole region; B14's strips are walked whole.
//
// The launches differ only in where a margin row comes from, a choice
// made once a block, while the table is filled (RingGeom::source):
//   kHaloRows     B11, B14: the shard, a z slab or a z-extended y slab,
//                 as halo_row_of chooses (the slab layout of
//                 mhd_common.cuh). Every source steps by a whole plane
//                 from one z to the next (Y X in the shard and the z
//                 slabs, ry X in the y slabs) and by X from one y to the
//                 next, so a row's source at every slice is its base at
//                 slice -1, 0 or N (N = Z or Y) plus a stride;
//   kWrappedRows  B9: the field itself, periodic: row wrap(y, Y) at plane
//                 wrap(p, Z) (Z, Y >= 8 > R, so one wrap is enough);
//                 B13's interior takes the same rule on a region whose
//                 radius-R neighbourhood lies in the shard, so no row it
//                 reads wraps and it reads the shard alone (z instance).
// The values are therefore B11's bit for bit in every launch: on a
// (1,1,1) mesh B11's slabs are the shard's own wrapped rows, and B13's
// interior and B14's strips read, tap for tap, the rows B11 reads at
// the same points; B12's margin, points up to R outside the shard,
// reads its rows from slabs of 2R rows, the rows the neighbour's own
// B11 reads at those points. Where a point's values go is the launch's
// output map (OutMap): the shard's layout, or a slab's.
//
// Storage (TIn: the fields, w and slabs a launch reads; TOut: the f and
// w it writes), float or bf16. The ring is float32 in every instance
// (same 214 KB, same layout, same arithmetic), so a bf16 launch computes
// exactly what the float32 instance computes on the widened inputs, and
// rounds each output once (store). cp.async copies 4, 8 or 16 bytes, not
// a 2-byte cell, so a bf16 slice is staged through registers instead:
// every warp issues the global loads of its rows of slice s + 4 before
// slice s is computed (a register a cell, none read before the
// compute), and widens and stores them into the ring after it. The substep pair keeps f1 and w1 in
// float32 (the JAX pair kernels never round them): its substep 0 is a
// bf16 -> float launch, its substep 1 float -> bf16.

#pragma once

#include "mhd_common.cuh"

namespace {

constexpr int kRing = 8;  // ring slots per field: 2R + 1 slices + 1 loading

struct RingTile {
  static constexpr int kTY = 16;               // the tile's rows
  static constexpr int kPX = kBX + 2 * R;      // 38 floats a margin row
  static constexpr int kPY = kTY + 2 * R;      // margin rows a slice
  static constexpr int kPlane = kPX * kPY;     // one field's slice
  static constexpr int kSlot = kNF * kPlane;   // one slice of 8 fields
  static constexpr int kRows = kNF * kPY;      // margin rows of a slot
  static constexpr int kThreads = kBX * kTY;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowsPerWarp = kRows / kWarps;
  static constexpr size_t kSmem = sizeof(float) * kRing * kSlot;
  static_assert(kRows % kWarps == 0, "every warp copies as many rows");
};

enum RowSource { kHaloRows = 0, kWrappedRows = 1 };
enum RingAxis { kStreamZ = 0, kStreamY = 1 };  // the axis a block walks

// One launch: the field or shard (h; its slabs' rz, ry for kHaloRows),
// the region it computes, the z run a block walks and the row source
// (the z instance's launches; B14's shell plans its own, mhd_overlap.cu).
struct RingGeom {
  HaloGeom h;
  int z0, nz, y0, ny;
  int zrun;
  int source;  // RowSource
};

// Where point (z, y, x) is written (and w read): off + z zs + y X + x.
// The shard: off = 0, zs = Y X; a z slab of R rows from z0: off = -z0 Y
// X, zs = Y X; a z-extended y slab: zs = R X (mhd.cu MarginPlan).
struct OutMap {
  int off, zs;
};

// Where margin row (q, u) of slice p comes from, set up once a block (u
// the tile's row coordinate: y in the z instance, z in the y instance):
// base[k] is the row at slice pref = -1, 0, N (for p < 0, 0 <= p < N,
// p >= N; N = Z or Y), and the row at slice p is then base[k] + (p -
// pref) * stride; dst is the row's offset in a ring slot (-1: the row
// lies R or more beyond the region's last row, and only masked points
// would read it).
template <class T>
struct RowSrc {
  const T* base[3];
  int stride;
  int dst;
};

// a field's ring around one point: o[k] is the point's offset in the
// slot of slice s + k - R, p the field's first float in a slot; the
// slices step along z (kStreamZ) or y (kStreamY), the tile's rows along
// the other
template <int PX, int kAxis>
struct RingAt {
  const float* p;
  const int* o;
  __device__ __forceinline__ float operator()(int dx, int dy, int dz) const {
    return kAxis == kStreamZ ? p[o[dz + R] + dy * PX + dx]
                             : p[o[dy + R] + dz * PX + dx];
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

// One block's walk: the tile of 32 x columns from x0 and 16 rows from u0
// (rows at or past u1, the region's end, are masked), slices s0 to s1 of
// the streaming axis kAxis (u and the slices may lie up to R outside the
// shard when the slabs hold 2R rows), margin rows from source (the y
// instance takes kHaloRows only), outputs (and w) at om. ring: the
// kernel's dynamic shared memory, rows its RowSrc table.
template <int kAxis, bool kReadW, bool kWriteW, class TIn, class TOut>
__device__ __forceinline__ void ring_run(
    const InP<TIn>& f, const InP<TIn>& w, const SlabP<TIn>& sl,
    const OutP<TOut>& of, const OutP<TOut>& ow, const HaloGeom& h,
    const OutMap& om, int source, int x0, int u0, int u1, int s0, int s1,
    const Consts& c, float* ring, RowSrc<TIn>* rows) {
  using T = RingTile;
  const int Z = h.Z, Y = h.Y, X = h.X;
  const int N = kAxis == kStreamZ ? Z : Y;  // slices of the streaming axis
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int k = warp * kBX + lane; k < T::kRows; k += T::kThreads) {
    const int qk = k / T::kPY, ru = k - qk * T::kPY;
    const int u = u0 - R + ru;
    RowSrc<TIn> r;
    // field qk's pointers, each a kernel parameter read at a constant
    // index (a run-time index would copy the structs to local memory)
#pragma unroll
    for (int q = 0; q < kNF; ++q) {
      if (q != qk) continue;
      if (kAxis == kStreamZ && source == kWrappedRows) {
        const TIn* row = f.p[q] + wrap(u, Y) * X;
        r.base[0] = row + (Z - 1) * Y * X;  // plane Z - 1 at p = -1
        r.base[1] = row;                    // plane 0 at p = 0
        r.base[2] = row;                    // plane 0 at p = Z
      } else {
        const int pref[3] = {-1, 0, N};
#pragma unroll
        for (int j = 0; j < 3; ++j)
          r.base[j] = kAxis == kStreamZ
                          ? halo_row_of(f.p[q], sl.zlo[q], sl.zhi[q],
                                        sl.ylo[q], sl.yhi[q], h, u, pref[j])
                          : halo_row_of(f.p[q], sl.zlo[q], sl.zhi[q],
                                        sl.ylo[q], sl.yhi[q], h, pref[j], u);
      }
    }
    if (kAxis == kStreamZ)
      r.stride = (source == kWrappedRows || (u >= 0 && u < Y) ? Y : h.ry) * X;
    else
      r.stride = X;
    r.dst = u < u1 + R ? qk * T::kPlane + ru * T::kPX : -1;
    rows[k] = r;
  }
  __syncthreads();
  const int xa = wrap(x0 - R + lane, X);             // margin column lane
  const int xb = wrap(x0 - R + kBX + lane, X);       // column 32 + lane

  // slice p of every field into its ring slot, one margin row a warp
  constexpr bool kAsync = std::is_same<TIn, float>::value;
  auto load_slice = [&](int p) {
    if constexpr (kAsync) {
      float* slot = ring + ((p + kRing) % kRing) * T::kSlot;
      const int j = p < 0 ? 0 : (p < N ? 1 : 2);
      const int dp = p - (j == 0 ? -1 : (j == 1 ? 0 : N));
#pragma unroll
      for (int i = 0; i < T::kRowsPerWarp; ++i) {
        const RowSrc<TIn>& r = rows[warp + T::kWarps * i];
        if (r.dst < 0) continue;
        const TIn* row = r.base[j] + dp * r.stride;
        float* d = slot + r.dst;
        cp_async4(d + lane, row + xa);
        if (lane < 2 * R) cp_async4(d + kBX + lane, row + xb);
      }
    }
  };
  // bf16: slice p's cells of this lane, one register each, read only
  // after the slice's compute, so that the loads' latency hides behind
  // it: column lane of each of the warp's rows (sa), and the rows' last
  // 2R columns spread over the warp's lanes, cell e = lane + 32 t of the
  // warp's kRowsPerWarp x 2R (sb; e / 2R the row, e % 2R the column)
  constexpr int kTail = T::kRowsPerWarp * 2 * R;
  constexpr int kB = (kTail + 31) / 32;
  unsigned short sa[T::kRowsPerWarp], sb[kB];
  int xt[kB];  // the column of each sb cell, wrapped
#pragma unroll
  for (int t = 0; t < kB; ++t)
    xt[t] = wrap(x0 - R + kBX + (lane + 32 * t) % (2 * R), X);
  auto fetch_slice = [&](int p) {
    const int j = p < 0 ? 0 : (p < N ? 1 : 2);
    const int dp = p - (j == 0 ? -1 : (j == 1 ? 0 : N));
#pragma unroll
    for (int i = 0; i < T::kRowsPerWarp; ++i) {
      const RowSrc<TIn>& r = rows[warp + T::kWarps * i];
      if (r.dst < 0) continue;
      sa[i] = __ldg(reinterpret_cast<const unsigned short*>(
                        r.base[j] + dp * r.stride) + xa);
    }
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      const int e = lane + 32 * t;
      if (e >= kTail) continue;
      const RowSrc<TIn>& r = rows[warp + T::kWarps * (e / (2 * R))];
      if (r.dst < 0) continue;
      sb[t] = __ldg(reinterpret_cast<const unsigned short*>(
                        r.base[j] + dp * r.stride) + xt[t]);
    }
  };
  auto put_slice = [&](int p) {
    float* slot = ring + ((p + kRing) % kRing) * T::kSlot;
#pragma unroll
    for (int i = 0; i < T::kRowsPerWarp; ++i) {
      const RowSrc<TIn>& r = rows[warp + T::kWarps * i];
      if (r.dst >= 0) slot[r.dst + lane] = widen(sa[i]);
    }
#pragma unroll
    for (int t = 0; t < kB; ++t) {
      const int e = lane + 32 * t;
      if (e >= kTail) continue;
      const RowSrc<TIn>& r = rows[warp + T::kWarps * (e / (2 * R))];
      if (r.dst >= 0) slot[r.dst + kBX + e % (2 * R)] = widen(sb[t]);
    }
  };
  for (int p = s0 - R; p <= s0 + R; ++p) {
    if constexpr (kAsync) {
      load_slice(p);
    } else {
      fetch_slice(p);
      put_slice(p);
    }
  }
  if constexpr (kAsync) {
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  const int x = x0 + lane, u = u0 + warp;
  const bool live = x < X && u < u1;
  const int here = (warp + R) * T::kPX + (lane + R);
  for (int s = s0; s < s1; ++s) {
    if constexpr (kAsync) {
      if (s + 1 < s1) load_slice(s + 1 + R);
      cp_async_commit();
    } else {
      if (s + 1 < s1) fetch_slice(s + 1 + R);
    }
    if (live) {
      int o[2 * R + 1];
#pragma unroll
      for (int k = 0; k <= 2 * R; ++k)
        o[k] = ((s + k - R + kRing) % kRing) * T::kSlot + here;
      Fd F[kNF];
      field_data(
          [&](int q) {
            return RingAt<T::kPX, kAxis>{ring + q * T::kPlane, o};
          },
          c, F);
      float r[kNF];
      mhd_rates(F, c, r);
      const int og =
          om.off + x +
          (kAxis == kStreamZ ? s * om.zs + u * X : u * om.zs + s * X);
#pragma unroll
      for (int q = 0; q < kNF; ++q) {
        float wq = c.dt * r[q];
        if (kReadW) wq = c.alpha * load(w.p[q] + og) + wq;
        if (kWriteW) store(ow.p[q] + og, wq);
        store(of.p[q] + og, F[q].v + c.beta * wq);
      }
    }
    if constexpr (kAsync) {
      cp_async_wait_all();
    } else {
      // slot (s + 4) % 8 is slice s - 4's, which no warp reads for s
      if (s + 1 < s1) put_slice(s + 1 + R);
    }
    __syncthreads();
  }
}

// The z instance over a RingGeom region: block (bx, by, bz) computes the
// tile (bx, by) of the region's (x, y) over z run bz.
template <bool kReadW, bool kWriteW, class TIn = float, class TOut = float>
__global__ void __launch_bounds__(RingTile::kThreads, 1)
mhd_substep_ring_kernel(InP<TIn> f, InP<TIn> w, SlabP<TIn> sl,
                        OutP<TOut> of, OutP<TOut> ow, RingGeom g,
                        Consts c) {
  extern __shared__ float ring[];  // [kRing][kNF][kPY][kPX]
  __shared__ RowSrc<TIn> rows[RingTile::kRows];  // row k = q * kPY + ru
  const int z0 = g.z0 + blockIdx.z * g.zrun;
  ring_run<kStreamZ, kReadW, kWriteW>(
      f, w, sl, of, ow, g.h, OutMap{0, g.h.Y * g.h.X}, g.source,
      blockIdx.x * kBX, g.y0 + blockIdx.y * RingTile::kTY, g.y0 + g.ny, z0,
      min(z0 + g.zrun, g.z0 + g.nz), c, ring, rows);
}

template <bool kReadW, bool kWriteW, class TIn, class TOut>
cudaError_t launch_ring_variant(const InP<TIn>& f, const InP<TIn>& w,
                                const SlabP<TIn>& sl, const OutP<TOut>& of,
                                const OutP<TOut>& ow, const RingGeom& g,
                                const Consts& c, cudaStream_t s) {
  using T = RingTile;
  auto kernel = mhd_substep_ring_kernel<kReadW, kWriteW, TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks(g.h.X, kBX), blocks(g.ny, T::kTY),
                  blocks(g.nz, g.zrun));
  kernel<<<grid, dim3(kBX, T::kTY), T::kSmem, s>>>(f, w, sl, of, ow, g, c);
  return cudaGetLastError();
}

// The ring kernel over region g, w read when w.p[0] is set and written
// when ow.p[0] is; invalid for an empty region or run. One storage type
// builds all four w variants; the pair's mixed instances build only
// theirs: bf16 -> float substep 0 (no w read, w written) and float ->
// bf16 substep 1 (w read and written).
template <class TIn = float, class TOut = float>
cudaError_t launch_ring(const InP<TIn>& f, const InP<TIn>& w,
                        const SlabP<TIn>& sl, const OutP<TOut>& of,
                        const OutP<TOut>& ow, const RingGeom& g,
                        const Consts& c, cudaStream_t s) {
  if (g.zrun < 1 || g.nz < 1 || g.ny < 1 || g.z0 < 0 || g.y0 < 0 ||
      g.z0 + g.nz > g.h.Z || g.y0 + g.ny > g.h.Y)
    return cudaErrorInvalidValue;
  const bool rw = w.p[0] != nullptr, ww = ow.p[0] != nullptr;
  if constexpr (std::is_same<TIn, TOut>::value) {
    if (rw && ww)
      return launch_ring_variant<true, true>(f, w, sl, of, ow, g, c, s);
    if (rw) return launch_ring_variant<true, false>(f, w, sl, of, ow, g, c, s);
    if (ww) return launch_ring_variant<false, true>(f, w, sl, of, ow, g, c, s);
    return launch_ring_variant<false, false>(f, w, sl, of, ow, g, c, s);
  } else if constexpr (std::is_same<TOut, float>::value) {
    if (rw || !ww) return cudaErrorInvalidValue;
    return launch_ring_variant<false, true>(f, w, sl, of, ow, g, c, s);
  } else {
    if (!rw || !ww) return cudaErrorInvalidValue;
    return launch_ring_variant<true, true>(f, w, sl, of, ow, g, c, s);
  }
}

}  // namespace
