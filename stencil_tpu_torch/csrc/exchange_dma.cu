// The remote-write halo exchange for Hopper (sm_90a): B4.
//
// Replaces stencil_tpu/parallel/pallas_exchange.py:57
// _exchange_axis_pallas (driven by exchange_shard_pallas, :121). One
// axis sweep of a mesh: every shard stores its two boundary slabs
// straight into its periodic neighbours' halos, through the neighbours'
// device pointers. Where a neighbour lies on another card these are
// plain global stores over NVLink once peer access is on
// (peer_access_enable below); where it shares the card they are stores
// into another tensor of the same memory; on a one-shard axis the
// neighbour is the shard itself. The TPU kernel's neighbour barrier
// (:75-78, "your halo may be written") becomes an ordering the wrapper
// sets up with CUDA events between one side stream per card
// (stencil_tpu_torch/ops/cuda_exchange.py): a sweep starts after every
// previous reader of the halos it writes, and every card's sweep a
// lands before any card's sweep a+1 starts.
//
// Semantics, along the swept axis of a padded shard of alloc = r_lo +
// interior + r_hi cells, each slab spanning the whole padded cross
// section of the other two axes (so edges and corners ride along from
// sweep to sweep):
//   right neighbour's lo halo [0, r_lo)
//       <- my [interior, r_lo + interior)
//   left neighbour's hi halo [r_lo + interior, alloc)
//       <- my [r_lo, r_lo + r_hi)
// With two shards on the axis, left and right are the same shard; its
// two halos are distinct. Within one sweep every source is interior
// along the swept axis and every destination halo, so no launch reads
// what it writes, and every (quantity, shard) of a card may share one
// grid.
//
// A padded (Z, Y, X) shard swept along one of its dimensions is `runs`
// (the product of the dimensions before it) contiguous runs of
// r * inner elements, `stride` = alloc * inner elements apart (inner =
// the product of the dimensions after it). The wrapper counts those in
// the widest unit of 1, 2, 4, 8 or 16 bytes that every pointer, offset
// and run of the launch divides, so any dtype is copied exactly, bit
// for bit.
//
// Bound on this card: bytes (the slabs read once and written once), and
// in practice launch latency: a z sweep of four 512 x 256 x 256 quarter
// shards reads and writes 4 MiB (1.3 us each way at 3.35 TB/s). The
// first version launched once per shard and quantity from Python, and
// its time was the host's (PERF.md, Findings).
// Design: ONE launch per card and sweep. The wrapper builds, once per
// set of buffers, a launch table in device memory: one Entry per
// (quantity, shard) held on the card, each with its source and
// neighbour pointers and its slab geometry. blockIdx.z picks the
// entry, blockIdx.y the slab (lo or hi), and the blocks along x copy
// that slab grid-stride, consecutive lanes on consecutive units of a
// run (coalesced; an x sweep's runs are r elements, one per (z, y) row,
// and stay short). Nothing is staged through the host and no copy
// engine is used.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// One (quantity, shard) of a sweep, in units; ops/cuda_exchange.py
// ENTRY_FIELDS lays the int64 rows of the table out in this order.
struct Entry {
  const void* src;
  void* dst_lo;           // the right neighbour: its lo halo is written
  void* dst_hi;           // the left neighbour: its hi halo is written
  long long lo_src_off;   // first unit of run 0, lo slab, in the source
  long long lo_dst_off;   // ... in the destination
  long long lo_run;       // units per run (0: no lo slab)
  long long hi_src_off;
  long long hi_dst_off;
  long long hi_run;
  long long stride;       // units between runs
  long long runs;
};
static_assert(sizeof(Entry) == 11 * sizeof(long long), "Entry layout");

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;

// Offsets fit 32 bits: the wrapper refuses shards of 2^31 units or more.
template <typename T>
__global__ void __launch_bounds__(kThreads)
exchange_table_kernel(const Entry* __restrict__ table) {
  const Entry& e = table[blockIdx.z];
  const bool hi = blockIdx.y != 0;
  const unsigned run = static_cast<unsigned>(hi ? e.hi_run : e.lo_run);
  if (run == 0) return;
  const unsigned total = static_cast<unsigned>(e.runs) * run;
  const unsigned stride = static_cast<unsigned>(e.stride);
  const T* __restrict__ src = static_cast<const T*>(e.src) +
                              (hi ? e.hi_src_off : e.lo_src_off);
  T* __restrict__ dst = static_cast<T*>(hi ? e.dst_hi : e.dst_lo) +
                        (hi ? e.hi_dst_off : e.lo_dst_off);
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += step) {
    const unsigned k = t / run;
    const unsigned o = k * stride + (t - k * run);
    dst[o] = src[o];
  }
}

template <typename T>
cudaError_t launch(const Entry* table, int n, long long most,
                   cudaStream_t stream) {
  unsigned nb = static_cast<unsigned>((most + kThreads - 1) / kThreads);
  unsigned cap = kMaxBlocks / (2u * static_cast<unsigned>(n));
  if (cap < 1) cap = 1;
  if (nb > cap) nb = cap;
  exchange_table_kernel<T><<<dim3(nb, 2, static_cast<unsigned>(n)),
                             kThreads, 0, stream>>>(table);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One sweep of every (quantity, shard) held on card `device`: `table`
// holds `n` Entry rows in that card's memory, `most` is the largest
// slab of any entry in units (runs * run), all in units of `unit`
// bytes. Launches on `stream` (a stream of `device`) with `device`
// current, then restores the caller's device.
cudaError_t exchange_table_launch(const void* table, int n, long long most,
                                  int unit, int device, void* stream) {
  if (n <= 0 || n > 65535 || most <= 0 || most >= (1LL << 31))
    return cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  const Entry* t = static_cast<const Entry*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 1: err = launch<uint8_t>(t, n, most, s); break;
    case 2: err = launch<uint16_t>(t, n, most, s); break;
    case 4: err = launch<uint32_t>(t, n, most, s); break;
    case 8: err = launch<uint2>(t, n, most, s); break;
    case 16: err = launch<uint4>(t, n, most, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

// Let kernels running on card `dev` store into memory of card `peer`.
// Returns 0 when that is on (also when PyTorch or an earlier call had
// turned it on already: cudaErrorPeerAccessAlreadyEnabled is accepted
// and cleared), -1 when the hardware cannot reach the peer at all, else
// the CUDA error. The current device is restored.
int peer_access_enable(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return -1;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

}  // extern "C"
