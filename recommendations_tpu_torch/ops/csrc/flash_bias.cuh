// The relative-position bias as the flash kernels read it, shared by
// flash_fwd.cu and flash_bwd.cu so that both hold one layout.
//
// The table is (n_table, H) float32; the pair (query row i, key j) of head h
// reads table[i - j + nk, h], rounded to bf16 (the TPU kernel's bf16 expansion
// of the table, for any operand type). The tensor-core kernels stage, per key
// tile, the run of each head that their rows need, reversed, with a padded
// stride.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace {

// The position bias of a call: the (n_table, H) float32 table and nk, or none.
struct Bias {
  const float* table;
  int n_table, nk;
};

// table[l, h] rounded to bf16
__device__ __forceinline__ float bias_at(const float* __restrict__ table, int l, int n_head, int h) {
  return __bfloat162float(__float2bfloat16_rn(table[(size_t)l * n_head + h]));
}

// bias staging row length: the largest run a head needs, padded so that the
// 8 heads of a fragment read 8 different bank groups
__host__ __device__ __forceinline__ int bias_ustride(int rows, int tile) {
  return ((rows + tile - 1 + 63) & ~63) + 8;
}

// Stages the bias of rows [row0, row0 + rows) against keys [t0, t1): head h's
// entry for (row, key j) lands at bs[h * ustride + (row - row0) + (t1 - 1 - j)],
// rounded to bf16; indices outside the table (masked pairs only) read 0.
__device__ __forceinline__ void stage_bias(__nv_bfloat16* bs, int ustride,
                                           const float* __restrict__ table, int n_table,
                                           int n_head, int nk, int row0, int rows, int t0,
                                           int t1) {
  const int n_u = rows + (t1 - t0) - 1, l0 = row0 - (t1 - 1) + nk;
  for (int i = threadIdx.x; i < n_u * n_head; i += blockDim.x) {
    const int u = i / n_head, h = i - u * n_head, l = l0 + u;
    const float x = (l >= 0 && l < n_table) ? table[(size_t)l * n_head + h] : 0.f;
    bs[h * ustride + u] = __float2bfloat16_rn(x);
  }
}

}  // namespace
