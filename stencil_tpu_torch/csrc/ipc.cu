// CUDA IPC buffer sharing and device-side flags between processes.
//
// Replaces no TPU kernel: it is the CUDA form of what JAX's
// make_async_remote_copy gets from the ICI, the means by which the
// remote-write kernels (B4 in exchange_dma.cu, B7 in jacobi_overlap.cu,
// B13 in mhd_overlap.cu) store into a neighbour's buffers when another
// process owns them, and by which those stores are ordered across
// processes. It launches no kernel of its own.
//
// * Buffer sharing: ipc_export names the cudaMalloc block that holds a
//   pointer (cudaIpcGetMemHandle of the block's base, which
//   cuMemGetAddressRange finds) and its offset in the block; ipc_open
//   maps a block another process exported into this process's current
//   device (cudaIpcOpenMemHandle, peer access enabled lazily where the
//   block lies on another card), ipc_close unmaps it.
// * Flags: flag_write and flag_wait are the driver's stream memory
//   operations on a 32-bit counter: cuStreamWriteValue32 in its default
//   form, which fences the stream's earlier stores (the writer kernel's
//   stores into the peer's buffers) before the counter is written, and
//   cuStreamWaitValue32 with CU_STREAM_WAIT_VALUE_GEQ, which holds the
//   stream's later work until the counter reaches the value. The
//   counters only grow, so a wait is never satisfied by an earlier
//   step's signal. A wait holds no SM: it sits in the stream's front
//   end.
//
// The driver functions are reached through the runtime's entry-point
// query, so the library links against nothing beyond the runtime.
// Bound on this card: neither bytes nor operations; what these calls
// cost is a few microseconds of launch latency each.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

typedef CUresult (*WriteFn)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
typedef CUresult (*WaitFn)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
typedef CUresult (*RangeFn)(CUdeviceptr*, size_t*, CUdeviceptr);
typedef CUresult (*AttrFn)(int*, CUdevice_attribute, CUdevice);

void* entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &fn, 12000,
                                                     cudaEnableDefault,
                                                     &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault,
                                            &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return fn;
}

// A driver error is returned as its negative, so that the wrapper can
// tell it from a runtime error; -1000000 means the entry point was not
// found.
constexpr int kNoEntry = -1000000;

int drv(CUresult r) { return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r); }

}  // namespace

extern "C" {

// The stream memory operations' device attributes of card `device`:
// 32-bit operations (attribute 92) and 64-bit ones (93).
int stream_mem_ops(int device, int* ops32, int* ops64) {
  static AttrFn fn = reinterpret_cast<AttrFn>(entry("cuDeviceGetAttribute"));
  if (!fn) return kNoEntry;
  int r = drv(fn(ops32, static_cast<CUdevice_attribute>(92), device));
  if (r) return r;
  return drv(fn(ops64, static_cast<CUdevice_attribute>(93), device));
}

// The IPC handle (64 bytes into `handle`) of the cudaMalloc block that
// holds `ptr`, on the current device, and ptr's offset in that block.
int ipc_export(const void* ptr, void* handle, long long* offset) {
  static RangeFn fn =
      reinterpret_cast<RangeFn>(entry("cuMemGetAddressRange"));
  if (!fn) return kNoEntry;
  CUdeviceptr base = 0;
  size_t size = 0;
  int r = drv(fn(&base, &size, reinterpret_cast<CUdeviceptr>(ptr)));
  if (r) return r;
  cudaIpcMemHandle_t h;
  cudaError_t err = cudaIpcGetMemHandle(&h, reinterpret_cast<void*>(base));
  if (err != cudaSuccess) return static_cast<int>(err);
  std::memcpy(handle, &h, sizeof h);
  *offset = static_cast<long long>(reinterpret_cast<CUdeviceptr>(ptr) - base);
  return 0;
}

// Map the block another process exported as `handle` into the current
// device; its base lands in *ptr.
int ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Write `value` into the counter at device address `addr` once the
// stream's earlier work is done and its stores are fenced.
int flag_write(void* stream, unsigned long long addr, unsigned int value) {
  static WriteFn fn = reinterpret_cast<WriteFn>(entry("cuStreamWriteValue32"));
  if (!fn) return kNoEntry;
  return drv(fn(static_cast<CUstream>(stream), addr, value,
                CU_STREAM_WRITE_VALUE_DEFAULT));
}

// Hold the stream's later work until the counter at `addr` (this
// card's memory) is at least `value`.
int flag_wait(void* stream, unsigned long long addr, unsigned int value) {
  static WaitFn fn = reinterpret_cast<WaitFn>(entry("cuStreamWaitValue32"));
  if (!fn) return kNoEntry;
  return drv(fn(static_cast<CUstream>(stream), addr, value,
                CU_STREAM_WAIT_VALUE_GEQ));
}

}  // extern "C"
