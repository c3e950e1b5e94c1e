// The relative-position bias as the flash kernels read it, shared by
// flash_fwd.cu and flash_bwd.cu so that both hold one layout.
//
// The table is (n_table, H) float32; the pair (query row i, key j) of head h
// reads table[i - j + nk, h], rounded to bf16 (the TPU kernel's bf16 expansion
// of the table, for any operand type). The tensor-core kernels stage, per key
// tile, the run of each head that their rows need, reversed, with a padded
// stride; the one-pass tensor-core kernels (mqa_tc_bias_fwd_kernel,
// mqa_tc_bias_dq_kernel) stage it in the layout of BiasTile below.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_sm90.cuh"

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

// ---- the bias of the one-pass tensor-core kernels ----
//
// The bias of a block's R rows against a KT-key tile [t0, t0 + KT) lies on
// R + KT - 1 diagonals: with z = (row0 + R - 1 - i) + (j - t0), every pair
// reads table row lz - z, lz = row0 + R - 1 - t0 + nk. The rows it needs,
// R + KT + 2 of the (L, H) f32 table, are one contiguous run: it is copied by
// cp.async with the K/V tile (rows outside the table read as zeros: masked
// pairs only), and once landed each head's run is written as bf16 in z
// order, in two copies, copy p holding z at position z + p. A lane's two
// neighbouring keys j, j + 1 (j even) of row i sit at z, z + 1 with z of the
// row's parity: in copy p = z & 1 they are one aligned 32-bit word, and the
// words of the lane's two heads g and g + 8 sit side by side (a copy is
// [head pair][word] of 64 bits), so one 64-bit load gives both. A head's run
// is padded to HS = 8 (mod 16) entries, so the 8 head pairs x 4 key pairs of
// a fragment's load fall on different banks in each half-warp; the f32 run
// is padded to H + 4 floats a row, so the conversion reads without bank
// conflicts too.
//
// One barrier a tile: the copies of tile t + 2 are issued at the top of tile
// t (TC_BIAS_KV_BUFS K/V buffers, two f32 runs, two bf16 copies), after the
// barrier that follows the wait for tile t + 1's; then tile t + 1's bias is
// converted and tile t computed.

// the bias layout of a block of `rows` query rows and n_head heads
template <int KT> struct BiasTile {
  int hs;     // bf16 entries of a head's copy: >= rows + KT, = 8 (mod 16)
  int words;  // 32-bit words of a copy that the conversion writes
  int nr;     // table rows staged a tile
  int rs;     // floats a staged table row: n_head + 4
  __host__ __device__ BiasTile(int rows, int n_head)
      : hs((rows + KT + 7) / 16 * 16 + 8), words((rows + KT + 1) / 2), nr(2 * words + 1), rs(n_head + 4) {}
};

constexpr int TC_BIAS_KV_BUFS = 3;  // K/V tiles in flight or in use

// shared memory of a bias kernel: the K/V tiles, two tiles' two bf16 copies,
// two f32 runs
template <int HD, int KT> size_t tc_bias_smem(int rows, int n_head) {
  const BiasTile<KT> bt(rows, n_head);
  return (size_t)TC_BIAS_KV_BUFS * 2 * KT * (HD + 8) * sizeof(__nv_bfloat16) +
         (size_t)2 * 2 * n_head * bt.hs * sizeof(__nv_bfloat16) + (size_t)2 * bt.nr * bt.rs * sizeof(float);
}

// K and V of key tile `tile` into buffer tile % TC_BIAS_KV_BUFS of ks, vs
// (rows of HD + 8), as cp.async copies; keys past the end are zeros
template <int HD, int KT>
__device__ __forceinline__ void tc_bias_stage_kv(__nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* kb,
                                                 const __nv_bfloat16* vb, int tile, int seq_len) {
  constexpr int KS = HD + 8;
  const int t0 = tile * KT;
  __nv_bfloat16* kd = ks + (tile % TC_BIAS_KV_BUFS) * KT * KS;
  __nv_bfloat16* vd = vs + (tile % TC_BIAS_KV_BUFS) * KT * KS;
  for (int i = threadIdx.x; i < KT * (HD / 8); i += blockDim.x) {
    const int j = i / (HD / 8), d = (i % (HD / 8)) * 8;
    const bool in = t0 + j < seq_len;
    const size_t src = (size_t)(in ? t0 + j : 0) * HD + d;
    cp_async16(kd + j * KS + d, kb + src, in);
    cp_async16(vd + j * KS + d, vb + src, in);
  }
}

// the table rows that the tile at key t0 reads into the f32 run rd, as
// cp.async copies: staged row r holds table row l_a + r, l_a = lz - 2 words
// + 1 (zrow = row0 + R - 1); the loop steps with a carry instead of dividing
template <int KT>
__device__ __forceinline__ void tc_bias_stage_rows(float* rd, const BiasTile<KT>& bt,
                                                   const float* __restrict__ table, int n_table, int n_head,
                                                   int nk, int zrow, int t0) {
  const int l_a = zrow - t0 + nk - 2 * bt.words + 1;
  const int chunks = n_head / 4, dr = blockDim.x / chunks, dch = blockDim.x - dr * chunks;
  for (int r = threadIdx.x / chunks, ch = threadIdx.x - r * chunks; r < bt.nr;) {
    const int l = l_a + r;
    const bool in = l >= 0 && l < n_table;
    cp_async16(rd + r * bt.rs + 4 * ch, table + (size_t)(in ? l : 0) * n_head + 4 * ch, in);
    r += dr, ch += dch;
    if (ch >= chunks) ch -= chunks, ++r;
  }
}

// tile `tile`'s staged f32 run (run tile & 1 of raw) as its two bf16 copies
// (at bw + (tile & 1) 2 copy_pairs; [2 copies][n_head / 2 head pairs][hs / 2
// words]: pair (16 G + g, 16 G + g + 8) is pair 8 G + g): copy p word w
// holds z = 2w - p and 2w + 1 - p (staged row 2 words - 1 - z); a warp takes
// 8 head pairs x 4 words at a time. The arguments are references, as a
// lambda captures them: taken by value, they give the forward other SASS.
template <int KT>
__device__ __forceinline__ void tc_bias_convert(uint2* const& bw, float* const& raw, const BiasTile<KT>& bt,
                                                const int& copy_pairs, const int& groups, const int& warp,
                                                const int& lane, int tile) {
  const float* rd = raw + (tile & 1) * bt.nr * bt.rs;
  uint2* dst = bw + (tile & 1) * 2 * copy_pairs;
  const int nwb = (bt.words + 3) / 4, warps = blockDim.x >> 5;
  const int dwb = warps / groups, dgb = warps - dwb * groups;
  for (int wb = warp / groups, gb = warp - wb * groups; wb < nwb;) {
    const int w = (lane >> 3) + 4 * wb;
    if (w < bt.words) {
      const float* src = rd + (2 * bt.words - 2 * w) * bt.rs + 16 * gb + (lane & 7);  // z = 2w - 1, head g
      const float zm = src[0], z0 = src[-bt.rs], zp = src[-2 * bt.rs];
      const float ym = src[8], y0 = src[8 - bt.rs], yp = src[8 - 2 * bt.rs];  // head g + 8
      const int at = (8 * gb + (lane & 7)) * (bt.hs / 2) + w;
      dst[at] = make_uint2(pack_bf16(z0, zp), pack_bf16(y0, yp));
      dst[copy_pairs + at] = make_uint2(pack_bf16(zm, z0), pack_bf16(ym, y0));
    }
    wb += dwb, gb += dgb;
    if (gb >= groups) gb -= groups, ++wb;
  }
}

}  // namespace
