// MoE capacity-buffer gather for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_dispatch/kernel.py
// (_kernel / moe_gather_fwd): buf[e, c, :] = x[slot_token[e*C + c], :],
// or zeros where the slot is empty (token < 0 or >= T).
//
// The TPU kernel keeps the whole [T, d] token block in VMEM and walks
// one expert's C slots per grid step with the indices in SMEM (scalar
// prefetch).  Here nothing is staged: one warp owns one destination row,
// reads its slot's token id itself, and copies the row with 16-byte
// loads and stores, neighbouring lanes on neighbouring addresses (an
// empty slot stores zeros and reads nothing).  The copy is a bit copy of
// 16-byte words, so it is exact for any dtype.
//
// What bounds it on this card: bytes.  It moves each filled row twice
// (read, write) and each empty row once (write) with no arithmetic; at
// the MoE path's sizes (E*C = 512..1024 rows of 4 KB in bf16, 2-4 MB)
// the byte bound is about a microsecond, under the launch latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // destination rows per block

__global__ void __launch_bounds__(kWarps * 32)
moe_gather_kernel(const uint4* __restrict__ x,
                  const int* __restrict__ slot_token,
                  uint4* __restrict__ out, int T, int rows, int nv) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int tok = __ldg(slot_token + row);
  uint4* dst = out + (size_t)row * nv;
  if (tok < 0 || tok >= T) {
    for (int i = lane; i < nv; i += 32) dst[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = x + (size_t)tok * nv;
  for (int i = lane; i < nv; i += 32) dst[i] = __ldg(src + i);
}

}  // namespace

// x: [T, nv] and out: [rows, nv] 16-byte words, contiguous and 16-byte
// aligned (the wrapper checks that a row of d elements is a whole number
// of 16-byte words); slot_token: [rows] int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int moe_gather_fwd(const void* x, const void* slot_token,
                              void* out, int T, int rows, int nv,
                              void* stream) {
  if (rows <= 0 || nv <= 0) return cudaSuccess;
  const int blocks = (rows + kWarps - 1) / kWarps;
  moe_gather_kernel<<<blocks, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(slot_token),
      static_cast<uint4*>(out), T, rows, nv);
  return cudaGetLastError();
}
