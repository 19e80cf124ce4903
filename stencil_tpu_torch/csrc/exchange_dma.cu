// The remote-write halo exchange for Hopper (sm_90a): B4.
//
// Replaces stencil_tpu/parallel/pallas_exchange.py:57
// _exchange_axis_pallas (driven by exchange_shard_pallas, :121). One
// axis sweep of one shard of a mesh: the kernel stores the shard's two
// boundary slabs straight into its periodic neighbours' halos, through
// the neighbours' device pointers. Where a neighbour lies on another
// card these are plain global stores over NVLink once peer access is on
// (peer_access_enable below); where it shares the card they are stores
// into another tensor of the same memory. The TPU kernel's neighbour
// barrier (:75-78, "your halo may be written") becomes an ordering the
// wrapper sets up with CUDA events between the shards' streams
// (stencil_tpu_torch/parallel/cuda_exchange.py): a shard's sweep starts
// after every previous reader of the halos it writes, and every shard's
// sweep a lands before any sweep a+1 starts.
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
// two halos are distinct.
//
// A padded (Z, Y, X) shard swept along one of its dimensions is `runs`
// (the product of the dimensions before it) contiguous runs of
// r * inner elements, `stride` = alloc * inner elements apart (inner =
// the product of the dimensions after it). The wrapper (ops/
// cuda_exchange.py) counts those in the widest unit of 1, 2, 4, 8 or 16
// bytes that every offset and run divides, so any dtype is copied
// exactly, bit for bit.
//
// Bound on this card: bytes (the slabs read once and written once), and
// in practice launch latency: a sweep of a 512 x 256 x 256 quarter shard
// moves 2 x 0.5 MiB; the x sweep writes runs of r elements, one per
// (z, y) row.
// Design: one thread per unit, grid-stride over the two slabs
// (blockIdx.y picks the slab). A simple copy that is right; nothing is
// staged through the host and no copy engine is used.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Slab {
  const void* src;
  void* dst;
  long long src_off;  // first unit of run 0 in the source
  long long dst_off;  // first unit of run 0 in the destination
  long long run;      // units per run (0: no slab)
};

template <typename T>
__global__ void exchange_axis_kernel(Slab lo, Slab hi, long long stride,
                                     long long runs) {
  const Slab s = blockIdx.y == 0 ? lo : hi;
  const long long total = runs * s.run;
  const T* __restrict__ src = static_cast<const T*>(s.src) + s.src_off;
  T* __restrict__ dst = static_cast<T*>(s.dst) + s.dst_off;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += step) {
    const long long k = t / s.run;
    const long long o = k * stride + (t - k * s.run);
    dst[o] = src[o];
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

template <typename T>
cudaError_t launch(const Slab& lo, const Slab& hi, long long stride,
                   long long runs, cudaStream_t stream) {
  const long long most = runs * (lo.run > hi.run ? lo.run : hi.run);
  if (most == 0) return cudaSuccess;
  long long nb = (most + kThreads - 1) / kThreads;
  if (nb > kMaxBlocks) nb = kMaxBlocks;
  exchange_axis_kernel<T><<<dim3(static_cast<unsigned>(nb), 2), kThreads,
                            0, stream>>>(lo, hi, stride, runs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One axis sweep of one shard: `src` is the shard, `dst_lo` the right
// neighbour (its lo halo is written), `dst_hi` the left one (its hi
// halo). Offsets, runs and the stride are in units of `unit` bytes.
cudaError_t exchange_axis_launch(const void* src, void* dst_lo,
                                 void* dst_hi, long long lo_src_off,
                                 long long lo_dst_off, long long lo_run,
                                 long long hi_src_off, long long hi_dst_off,
                                 long long hi_run, long long stride,
                                 long long runs, int unit, void* stream) {
  const Slab lo{src, dst_lo, lo_src_off, lo_dst_off, lo_run};
  const Slab hi{src, dst_hi, hi_src_off, hi_dst_off, hi_run};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 1: return launch<uint8_t>(lo, hi, stride, runs, s);
    case 2: return launch<uint16_t>(lo, hi, stride, runs, s);
    case 4: return launch<uint32_t>(lo, hi, stride, runs, s);
    case 8: return launch<uint2>(lo, hi, stride, runs, s);
    case 16: return launch<uint4>(lo, hi, stride, runs, s);
    default: return cudaErrorInvalidValue;
  }
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
