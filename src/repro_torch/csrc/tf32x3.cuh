// fp32 products on Hopper's tensor cores in 3xTF32, shared by the SSD
// kernels (ssm_scan.cu, ssm_scan_bwd.cu; their cp.async copies are
// hopper.cuh's, included here): the split of an fp32 value into tf32
// hi and lo, K-major operand planes in the 128-byte swizzle, and wgmma
// m64n64k8 tf32 with A from registers.  sm_90a only.  Each including
// source is its own library, so everything here has internal linkage.
//
// A plane holds an operand K-major: 64 rows (the wgmma's N), K split
// into boxes of 32 tf32 (128 bytes a row, 8 KB a box), 16-byte chunks
// swizzled by row.  A product d += a . b is taken as lo*hi' + hi*lo' +
// hi*hi' (about fp32 accuracy; one TF32 pass errs by ~1e-2).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // cp.async

namespace {

constexpr int kBox = 64 * 128;  // 64 rows x 128 bytes (32 tf32 of K)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to tf32, to nearest with ties away (cvt.rna for finite x)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x (finite) ~ hi + lo, both tf32: x - hi is exact, lo is it rounded
// (within 2^-22 of x)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a
// 128-byte-swizzled box
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major operand:
// rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// pins registers at this point of the program, so the compiler neither
// moves their reads or writes across a wgmma fence or wait nor reuses
// an A fragment's registers while a wgmma may still read them
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC32(i) ACC16(i), ACC16(i + 16)
#define REGS32                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"

// d[64 x 64] (+)= A[64 x 8] * B[8 x 64] in tf32, A from registers (each
// warp its 16 rows), B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a . b in 3xTF32 (small terms first); b's planes at b_hi, b_lo
__device__ __forceinline__ void wgmma3(float (&d)[32],
                                       const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint32_t b_hi,
                                       uint32_t b_lo, int accumulate) {
  wgmma_tf32(d, al, sw128_desc(b_hi), accumulate);
  wgmma_tf32(d, ah, sw128_desc(b_lo), 1);
  wgmma_tf32(d, ah, sw128_desc(b_hi), 1);
}

// K offset in bytes of k-step kk (8 tf32) in a plane of 128-byte boxes
__device__ __forceinline__ uint32_t kstep(int kk) {
  return (kk >> 2) * kBox + (kk & 3) * 32;
}

// orders this thread's generic-proxy writes to shared memory before the
// async proxy (wgmma) reads them
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The products go in batches of 4 k-steps (12 wgmmas); each batch's A
// fragments are split into one of two register sets while the batch
// before runs on the tensor cores.  After issuing batch b: wait until
// batch b - 1 is done (its set is free again).  Every batch is issued,
// with no branch between its wgmmas (ptxas serialises wgmmas that a
// branch separates): k-steps past the data multiply zeros (zero A
// fragments, zero-padded planes).
#define BATCH_ISSUED(b, ah, al)  \
  do {                           \
    wgmma_commit();              \
    wgmma_wait<1>();             \
    pin(ah[((b) + 1) & 1]);      \
    pin(al[((b) + 1) & 1]);      \
  } while (0)
#define BATCH_DRAIN(ah, al) \
  do {                        \
    wgmma_wait<0>();          \
    pin(ah[0]);               \
    pin(al[0]);               \
    pin(ah[1]);               \
    pin(al[1]);               \
  } while (0)

}  // namespace
