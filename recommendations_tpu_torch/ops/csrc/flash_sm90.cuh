// Building blocks of the tensor-core flash kernels, shared by flash_fwd.cu
// and flash_bwd.cu: ldmatrix fragment loads, 16-byte cp.async staging, the
// ex2 special-function exponential and bf16 packing.
//
// Fragment layouts are those of mma.sync m16n8k16 (g = lane / 4, c = lane % 4):
// a B fragment holds B[2c..2c+1][g] and B[2c+8..2c+9][g]. For a tile stored
// row-major in shared memory with n (keys or heads) as the row:
// - ldsm_x4 over rows n0..n0+15, columns d0..d0+15 gives the B fragments of
//   a product that contracts over the columns (S = Q.K^T reads K so): r[0], r[1]
//   for rows n0..n0+7, r[2], r[3] for rows n0+8..n0+15;
// - ldsm_x4_t over the same tile gives the B fragments of a product that
//   contracts over the rows (O = P.V reads V so): r[0], r[1] for columns
//   d0..d0+7, r[2], r[3] for columns d0+8..d0+15.
// ldsm_row / ldsm_row_t give the row and column (in elements) that this lane
// addresses for the two.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// row offset (0..15) and column offset (0 or 8) this lane addresses
__device__ __forceinline__ int ldsm_row(int lane) { return ((lane >> 4) << 3) + (lane & 7); }
__device__ __forceinline__ int ldsm_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int ldsm_row_t(int lane) { return (((lane >> 3) & 1) << 3) + (lane & 7); }
__device__ __forceinline__ int ldsm_col_t(int lane) { return (lane >> 4) << 3; }

// 16 bytes from global to shared memory, asynchronously; zeros when !in (src
// is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x on the special-function unit (ex2.approx: 2 ulp; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two bf16 halves of a packed pair, as float
__device__ __forceinline__ float bf_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// two floats as a packed bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
