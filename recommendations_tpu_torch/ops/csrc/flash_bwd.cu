// Flash-attention backward over folded heads, for Hopper (sm_90a).
//
// Replaces the TPU kernels of recommendations_tpu/ops/fused_attention.py that
// _fused_vjp_bwd launches without a position bias: _bwd_fused_kernel (one
// program per batch row, T <= 384), _dq_kernel/_dkv_kernel (384 < T <= 512)
// and _dq_kernel_grid/_dkv_kernel_grid (T > 512). One pair of kernels here
// serves every sequence length up to the forward's.
//
// Layout, as at the JAX call site: q, dO and dq are (B, T, H*hd); k, v, dk and
// dv are (B, T, hd) for multi-query attention or (B, T, H*hd) for multi-head
// attention; lse (the forward's logsumexp) and D = rowsum(dO * O) are
// (B, T, H) float32. D is computed by the caller, as the JAX package computes
// it outside its kernel.
//
// Arithmetic, as _bwd_fused_kernel: qs = round(q * scale); s = qs.k in f32;
// p = exp(s - lse) on live (row, key) pairs and 0 elsewhere; dp = dO.v;
// ds = p * (dp - D); dq = round(ds).k * scale; dv = round(p)^T.dO;
// dk = round(ds)^T.q * scale. "round" is the operand type (bf16 or f32); every
// product accumulates in f32, and for multi-query attention dK and dV are
// summed over the heads in f32 before the one rounding to the output type.
//
// Bound on an H100 SXM (MQA 32x16, bf16, causal, one call): at the LTHM-base
// training shape (B=64, T=257) it moves 56.8 MB (q, dO, dq at 16.8 MB each;
// k, v, dk, dv; lse and D), 17 us at 3.35 TB/s, and does five products over
// the live pairs, 10.9 GFLOP or 11 us at the 989 TFLOP/s tensor-core peak:
// bound by bytes. At B=16, T=1025 the products take 43.6 us (operations).
// The exponentials bind harder: p is recomputed in both kernels, two per
// live (row, head, key), 538 M at T=1025, 129 us at 16 a clock per SM.
//
// Design: two kernels, FA2-style, so that no output is written by two blocks
// and no float atomics are used (two runs give the same bits):
// - a dK/dV kernel over (key block, batch row) items, which walks every
//   causally live query row and every head of it and accumulates its keys'
//   dK and dV;
// - a dQ kernel over (batch row, query rows), which walks the live keys.
// Both recompute s and p from lse. Three specializations of each, chosen
// from the inputs:
// - mqa_tc_dkv_kernel / mqa_tc_dq_kernel (bf16, MQA, 16 to 128 heads in
//   groups of 16, hd in {16, 32, 64}, no bias: the training path of LTHM).
//   At MQA the 16 heads of one query row share K, V and the causal extent.
//   In the dQ kernel they are the 16 rows of an mma.sync m16n8k16 tile, a
//   warp owns 32 / hd such rows, and K and V tiles arrive by cp.async, two
//   in flight; ldmatrix reads K both ways (as B of S = qs.K^T and,
//   transposed, as B of dq += round(dS).K), so no transposed copy is staged.
//   In the dK/dV kernel a warp owns 16 keys and the roles turn over:
//   S^T = K.qs^T and dP^T = V.dO^T take the warp's K and V as A operands held
//   in registers, and dV += round(P^T).dO, dK += round(dS^T).q contract over
//   the 16 heads of a row, their B operands read by ldmatrix.trans. Query
//   rows (q, dO, lse, D) arrive in stages of up to 32 rows by cp.async, two
//   stages in flight, in more than 48 KB of shared memory (q and dO
//   swizzled so the 8 heads an ldmatrix reads lie in 8 bank groups); qs =
//   round(q * scale) is formed from the fragment. A block of 16 warps owns 64
//   keys (4 tiles x 4 warps that split the rows, summed in a fixed order at
//   the end), so each staged row serves 64 keys: at 32 keys the copy from L2
//   would outrun the exponentials. The grid is persistent, one block per SM,
//   and deals the items heaviest first in a serpentine (see the kernel), so
//   the SMs' rows add up to about the same. Both kernels take exp as exp2 on
//   the special-function unit and mask only the diagonal and ragged tiles,
//   and add each stage's (tile's) tensor-core sums into the f32 totals
//   apart, so that rounding does not build up over long rows.
// - mqa_mma_dkv_kernel / mqa_mma_dq_kernel (the position-bias case, entries
//   flash_bias_dq and flash_bias_dkv): a warp owns 16 keys (dK/dV, 2 key
//   tiles x 4 row parts, rows staged 8 at a time) or 16 heads of one row
//   (dQ); key blocks i and n - 1 - i paired under the causal mask.
// - FMA (float32, MHA, other head counts and dims): one thread per (query
//   row, head) for dQ and per (key, kv head) for dK/dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bias.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int SMEM_BUDGET = 48 * 1024;  // dynamic shared memory per block
constexpr int THREADS = 256;            // target threads per FMA block
constexpr int KV_TILE = 512;            // largest K/V staging tile of the dQ kernel
constexpr int DKV_KEY_TILES = 2;        // 16-key tiles per dK/dV block
constexpr int DKV_ROW_SPLIT = 4;        // warps that split a key tile's query rows
constexpr int DKV_MAX_ROWS = 16;        // query rows staged at a time

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T: the TPU kernel's astype to the operand type.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// HD elements from a 16-byte aligned address, as float.
template <typename T, int HD>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[HD]) {
  constexpr int PER = 16 / sizeof(T);
  static_assert(HD % PER == 0, "a head must be a whole number of 16-byte words");
#pragma unroll
  for (int i = 0; i < HD / PER; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < PER; ++j) out[i * PER + j] = to_f(e[j]);
  }
}

// HD floats rounded to T, stored to a 16-byte aligned address.
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&x)[HD], float mul) {
  alignas(16) T out[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) out[d] = from_f<T>(x[d] * mul);
#pragma unroll
  for (int i = 0; i < HD * (int)sizeof(T) / 16; ++i)
    reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(out)[i];
}

// ---- FMA kernels: any type, MQA or MHA ---------------------------------------

// One thread per (query row, head): dq = round(ds).k * scale over the live keys.
template <typename T, int HD, bool BIAS>
__global__ void fma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dcol,
                              T* __restrict__ dq, int seq_len, int n_head, int kvh,
                              int rows_per_block, int causal, float scale,
                              const float* __restrict__ table, int nk) {
  const int b = blockIdx.y;
  const int r_local = threadIdx.x / n_head;
  const int h = threadIdx.x - r_local * n_head;
  const int row = blockIdx.x * rows_per_block + r_local;
  if (r_local >= rows_per_block || row >= seq_len) return;
  const int width = kvh * HD;
  const size_t q_off = ((size_t)b * seq_len + row) * (size_t)n_head * HD + (size_t)h * HD;
  const size_t r_off = ((size_t)b * seq_len + row) * n_head + h;
  const T* kb = k + (size_t)b * seq_len * width + (kvh == 1 ? 0 : h) * HD;
  const T* vb = v + (size_t)b * seq_len * width + (kvh == 1 ? 0 : h) * HD;

  float qs[HD], dov[HD], acc[HD];
  load_row<T, HD>(q + q_off, qs);
  load_row<T, HD>(dout + q_off, dov);
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    if constexpr (!BIAS) qs[d] = round_to<T>(qs[d] * scale);
    acc[d] = 0.f;
  }
  const float l = lse[r_off], dd = dcol[r_off];
  const int n_keys = causal ? row + 1 : seq_len;
  for (int j = 0; j < n_keys; ++j) {
    float kf[HD], vf[HD];
    load_row<T, HD>(kb + (size_t)j * width, kf);
    load_row<T, HD>(vb + (size_t)j * width, vf);
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      s = fmaf(qs[d], kf[d], s);
      dp = fmaf(dov[d], vf[d], dp);
    }
    if constexpr (BIAS) s = s * scale + bias_at(table, row - j + nk, n_head, h);
    const float ds = round_to<T>(expf(s - l) * (dp - dd));
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, kf[d], acc[d]);
  }
  store_row<T, HD>(dq + q_off, acc, scale);
}

// One thread per (key, kv head): dk and dv over the live query rows and every
// head that reads this kv head (all H at MQA, one at MHA).
template <typename T, int HD, bool BIAS>
__global__ void fma_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dcol,
                               T* __restrict__ dk, T* __restrict__ dv, int seq_len, int n_head,
                               int kvh, int keys_per_block, int causal, float scale,
                               const float* __restrict__ table, int nk) {
  const int b = blockIdx.y;
  const int j_local = threadIdx.x / kvh;
  const int kh = threadIdx.x - j_local * kvh;
  const int key0 = blockIdx.x * keys_per_block;
  const int key = key0 + j_local;
  if (j_local >= keys_per_block || key >= seq_len) return;
  const int width = kvh * HD;
  const size_t kv_off = ((size_t)b * seq_len + key) * width + (size_t)kh * HD;
  float kf[HD], vf[HD], dka[HD], dva[HD];
  load_row<T, HD>(k + kv_off, kf);
  load_row<T, HD>(v + kv_off, vf);
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;
  const int h_lo = kvh == 1 ? 0 : kh, h_hi = kvh == 1 ? n_head : kh + 1;
  // the loop starts at the block's first key so that a warp's lanes walk the
  // same rows (and read the same q and dO); rows before a lane's key are skipped
  for (int i = causal ? key0 : 0; i < seq_len; ++i) {
    if (causal && i < key) continue;
    for (int h = h_lo; h < h_hi; ++h) {
      const size_t q_off = ((size_t)b * seq_len + i) * (size_t)n_head * HD + (size_t)h * HD;
      const size_t r_off = ((size_t)b * seq_len + i) * n_head + h;
      float qv[HD], dov[HD];
      load_row<T, HD>(q + q_off, qv);
      load_row<T, HD>(dout + q_off, dov);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(BIAS ? qv[d] : round_to<T>(qv[d] * scale), kf[d], s);
        dp = fmaf(dov[d], vf[d], dp);
      }
      if constexpr (BIAS) s = s * scale + bias_at(table, i - key + nk, n_head, h);
      const float p = expf(s - lse[r_off]);
      const float ds = round_to<T>(p * (dp - dcol[r_off]));
      const float pr = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dva[d] = fmaf(pr, dov[d], dva[d]);
        dka[d] = fmaf(ds, qv[d], dka[d]);
      }
    }
  }
  store_row<T, HD>(dk + kv_off, dka, scale);
  store_row<T, HD>(dv + kv_off, dva, 1.f);
}

// The table gradient without tensor cores: one thread per table entry (l, h),
// which walks every batch row and every live pair on its diagonal
// d = q - k = l - nk and sums the unrounded ds = p * (dp - D) in f32. It owns
// its output, so two runs give the same bits.
template <typename T, int HD>
__global__ void fma_dtable_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ dcol,
                                  const float* __restrict__ table, float* __restrict__ dtable,
                                  int batch, int seq_len, int n_head, int kvh, int n_table, int nk,
                                  int causal, float scale) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_table * n_head) return;
  const int l = idx / n_head, h = idx - l * n_head, diag = l - nk;
  float acc = 0.f;
  if (!(causal && diag < 0)) {
    const float bias = bias_at(table, l, n_head, h);
    const int width = kvh * HD, kcol = (kvh == 1 ? 0 : h) * HD;
    const int i0 = max(0, diag), i1 = min(seq_len, seq_len + diag);
    for (int b = 0; b < batch; ++b) {
      for (int i = i0; i < i1; ++i) {
        const size_t q_off = ((size_t)b * seq_len + i) * (size_t)n_head * HD + (size_t)h * HD;
        const size_t kv_off = ((size_t)b * seq_len + (i - diag)) * width + kcol;
        const size_t r_off = ((size_t)b * seq_len + i) * n_head + h;
        float qv[HD], dov[HD], kf[HD], vf[HD];
        load_row<T, HD>(q + q_off, qv);
        load_row<T, HD>(dout + q_off, dov);
        load_row<T, HD>(k + kv_off, kf);
        load_row<T, HD>(v + kv_off, vf);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          s = fmaf(qv[d], kf[d], s);
          dp = fmaf(dov[d], vf[d], dp);
        }
        acc += expf(s * scale + bias - lse[r_off]) * (dp - dcol[r_off]);
      }
    }
  }
  dtable[idx] = acc;
}

template <typename T, int HD, bool BIAS>
int launch_fma_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* dcol, void* dk, void* dv, int batch, int seq_len, int n_head,
                   int kvh, int causal, Bias bias, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int keys = kvh >= THREADS ? 1 : THREADS / kvh;
  fma_dkv_kernel<T, HD, BIAS><<<dim3((seq_len + keys - 1) / keys, batch), keys * kvh, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<T*>(dk), static_cast<T*>(dv), seq_len,
      n_head, kvh, keys, causal, scale, bias.table, bias.nk);
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool BIAS>
int launch_fma_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dcol, void* dq, int batch, int seq_len, int n_head, int kvh,
                  int causal, Bias bias, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int rows = n_head >= THREADS ? 1 : THREADS / n_head;
  fma_dq_kernel<T, HD, BIAS><<<dim3((seq_len + rows - 1) / rows, batch), rows * n_head, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<T*>(dq), seq_len, n_head, kvh, rows, causal,
      scale, bias.table, bias.nk);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_fma_dtable(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dcol, void* dtable, int batch, int seq_len,
                      int n_head, int kvh, int causal, Bias bias, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int n = bias.n_table * n_head;
  fma_dtable_kernel<T, HD><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), bias.table, static_cast<float*>(dtable), batch, seq_len,
      n_head, kvh, bias.n_table, bias.nk, causal, scale);
  return (int)cudaGetLastError();
}

// ---- tensor-core specialization: bf16, MQA, heads a multiple of 16 ------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a.b for a 16x16 bf16 A (row-major) and a 16x8 bf16 B (column-major).
// Fragments (g = lane / 4, c = lane % 4): a[0] = A[g][2c..2c+1],
// a[1] = A[g+8][2c..], a[2] = A[g][2c+8..], a[3] = A[g+8][2c+8..];
// b0 = B[2c..2c+1][g], b1 = B[2c+8..2c+9][g]; d[0..1] = D[g][2c..2c+1],
// d[2..3] = D[g+8][2c..2c+1].
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 heads x 8 keys: the A operand (16 heads x HD) against keys n0..n0+7 of a
// row-major staged tile.
template <int HD>
__device__ __forceinline__ void head_key_tile(float (&s)[4], const uint32_t (&a)[HD / 16][4],
                                              const bf16* rows, int n0, int g, int c) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const bf16* r = rows + (size_t)(n0 + g) * HD + 2 * c;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) mma_16816(s, a[kk], ld32(r + kk * 16), ld32(r + kk * 16 + 8));
}

// A fragment of 16 rows x HD from a row-major matrix whose row m is at
// base + m * stride; rows at or past n_rows are zeros. mul scales in f32 before
// the rounding to bf16 (1 keeps the values as they are).
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const bf16* base, size_t stride,
                                       int n_rows, int g, int c, float mul) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = g + (r & 1) * 8;
      const int d = kk * 16 + 2 * c + (r >> 1) * 8;
      uint32_t x = 0u;
      if (m < n_rows) {
        const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(base + m * stride + d);
        x = mul == 1.f ? *reinterpret_cast<const uint32_t*>(&pair)
                       : pack_bf16(__bfloat162float(pair.x) * mul, __bfloat162float(pair.y) * mul);
      }
      a[kk][r] = x;
    }
  }
}

// dQ: a warp owns 16 heads of one query row and walks the row's live keys.
// With the bias (the grid kernel's arithmetic), q enters unscaled, the product
// is scaled in f32 and the staged bias added.
template <int HD, bool BIAS>
__global__ void mqa_mma_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ dcol,
                                  bf16* __restrict__ dq, int seq_len, int n_head,
                                  int rows_per_block, int tile_rows, int causal, float scale,
                                  const float* __restrict__ table, int n_table, int nk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = tile_rows + 8;           // padded K^T rows
  bf16* ks = reinterpret_cast<bf16*>(smem);    // [tile_rows][HD]
  bf16* vs = ks + (size_t)tile_rows * HD;      // [tile_rows][HD]
  bf16* kt = vs + (size_t)tile_rows * HD;      // [HD][kstride]
  const int ustride = bias_ustride(rows_per_block, tile_rows);
  bf16* bs = kt + (size_t)HD * kstride;        // [n_head][ustride] (BIAS)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int groups = n_head >> 4;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int row = row0 + warp / groups;
  const int h0 = (warp % groups) * 16;
  const bool active = row < seq_len;

  const int last_row = min(row0 + rows_per_block, seq_len) - 1;
  const int block_keys = causal ? last_row + 1 : seq_len;         // block-uniform
  const int my_keys = active ? (causal ? row + 1 : seq_len) : 0;  // warp-uniform

  const size_t q_row = ((size_t)b * seq_len + row) * (size_t)n_head * HD + (size_t)h0 * HD;
  const bf16* kb = k + (size_t)b * seq_len * HD;
  const bf16* vb = v + (size_t)b * seq_len * HD;

  // A operands: heads h0+g and h0+g+8 of this row; q scaled in f32 and rounded
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_a<HD>(qa, q + q_row, HD, active ? 16 : 0, g, c, BIAS ? 1.f : scale);
  load_a<HD>(da, dout + q_row, HD, active ? 16 : 0, g, c, 1.f);
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
  if (active) {
    const size_t r_off = ((size_t)b * seq_len + row) * n_head + h0 + g;
    lse_r[0] = lse[r_off], lse_r[1] = lse[r_off + 8];
    d_r[0] = dcol[r_off], d_r[1] = dcol[r_off + 8];
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const bf16 zero = __float2bfloat16(0.f);
  for (int t0 = 0; t0 < block_keys; t0 += tile_rows) {
    const int t1 = min(t0 + tile_rows, block_keys);
    const int n = t1 - t0, n16 = (n + 15) & ~15;
    __syncthreads();
    for (int i = threadIdx.x; i < n16 * HD; i += blockDim.x) {
      const int j = i / HD, d = i - j * HD;
      const bool in = j < n;
      const bf16 kv = in ? kb[(size_t)t0 * HD + i] : zero;
      ks[i] = kv;
      kt[d * kstride + j] = kv;
      vs[i] = in ? vb[(size_t)t0 * HD + i] : zero;
    }
    if constexpr (BIAS)
      stage_bias(bs, ustride, table, n_table, n_head, nk, row0, rows_per_block, t0, t1);
    __syncthreads();
    const int j1 = min(t1, my_keys);
    for (int j0 = t0; j0 < j1; j0 += 16) {
      float s0[4], s1[4], dp0[4], dp1[4];
      head_key_tile<HD>(s0, qa, ks, j0 - t0, g, c);
      head_key_tile<HD>(s1, qa, ks, j0 - t0 + 8, g, c);
      if constexpr (BIAS) {
        // fragment row r is head h0 + g + 8r; s0[e] is key j0 + 2c + (e & 1), s1 8 keys on
        const int u = (row - row0) + (t1 - 1 - j0 - 2 * c);
        const bf16* b0 = bs + (size_t)(h0 + g) * ustride + u;
        const bf16* b1 = b0 + (size_t)8 * ustride;
        s0[0] = s0[0] * scale + __bfloat162float(b0[0]);
        s0[1] = s0[1] * scale + __bfloat162float(b0[-1]);
        s0[2] = s0[2] * scale + __bfloat162float(b1[0]);
        s0[3] = s0[3] * scale + __bfloat162float(b1[-1]);
        s1[0] = s1[0] * scale + __bfloat162float(b0[-8]);
        s1[1] = s1[1] * scale + __bfloat162float(b0[-9]);
        s1[2] = s1[2] * scale + __bfloat162float(b1[-8]);
        s1[3] = s1[3] * scale + __bfloat162float(b1[-9]);
      }
      head_key_tile<HD>(dp0, da, vs, j0 - t0, g, c);
      head_key_tile<HD>(dp1, da, vs, j0 - t0 + 8, g, c);
      const int j = j0 + 2 * c;
      float ds0[4], ds1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int je = j + (e & 1), r = e >> 1;
        const float p0 = je < my_keys ? expf(s0[e] - lse_r[r]) : 0.f;
        const float p1 = je + 8 < my_keys ? expf(s1[e] - lse_r[r]) : 0.f;
        ds0[e] = p0 * (dp0[e] - d_r[r]);
        ds1[e] = p1 * (dp1[e] - d_r[r]);
      }
      // the dS accumulators are the dq product's A fragment; dS rounds to bf16
      const uint32_t dsa[4] = {pack_bf16(ds0[0], ds0[1]), pack_bf16(ds0[2], ds0[3]),
                               pack_bf16(ds1[0], ds1[1]), pack_bf16(ds1[2], ds1[3])};
      const bf16* kr = kt + (size_t)g * kstride + (j0 - t0) + 2 * c;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        mma_16816(acc[nt], dsa, ld32(kr + nt * 8 * kstride), ld32(kr + nt * 8 * kstride + 8));
    }
  }

  if (active) {
    bf16* orow = dq + q_row;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int d = nt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(orow + (size_t)g * HD + d) =
          pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
      *reinterpret_cast<uint32_t*>(orow + (size_t)(g + 8) * HD + d) =
          pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
}

// Shared memory of the dK/dV kernel, in bytes: the staged rows (q, round(q *
// scale) but with the bias, dO, lse, D), at least the final reduction's
// buffer; with the bias also the bias of a stage and the per-warp table
// gradient sums.
struct DkvSmem {
  size_t stage, bias, dbw, total;
};
__host__ __device__ __forceinline__ int dkv_bias_stride(int n_head) { return n_head + 2; }
__host__ __device__ __forceinline__ int dkv_dbw_stride(int n_head) { return n_head + 4; }
__host__ __device__ __forceinline__ DkvSmem dkv_smem(int rows, int n_head, int hd, bool bias) {
  DkvSmem m;
  const size_t row_bytes = (size_t)(bias ? 2 : 3) * n_head * hd * sizeof(bf16) + (size_t)2 * n_head * 4;
  const size_t red_bytes = (size_t)2 * DKV_KEY_TILES * 16 * hd * sizeof(float);
  m.stage = rows * row_bytes > red_bytes ? rows * row_bytes : red_bytes;
  m.bias = bias ? (size_t)(rows + 16 * DKV_KEY_TILES - 1) * dkv_bias_stride(n_head) * sizeof(bf16) : 0;
  m.dbw = bias ? (size_t)DKV_KEY_TILES * DKV_ROW_SPLIT * (rows + 15) * dkv_dbw_stride(n_head) * 4 : 0;
  m.total = m.stage + m.bias + m.dbw;
  return m;
}

// dK/dV: a warp owns 16 keys and a quarter of the block's query rows; the block
// stages its rows' q (qs), dO, lse and D in shared memory.
//
// With the bias (BIAS), the logits take the grid kernel's arithmetic and the
// block also sums the table gradient: ds (unrounded, f32) of the pair (row i,
// key j, head h) belongs to table row i - j + nk. A block walks
// batch_per_block batch rows, and for each the rows of its keys in stages of
// R; per stage each warp adds its ds into its own buffer by diagonal (a
// warp's lanes hold distinct (diagonal, head) pairs for a row, and a
// __syncwarp orders its rows), then the block adds the warps' buffers in a
// fixed order into its own (n_table, H) slice of dtable_part. No two blocks
// write one slice and nothing is added atomically, so two runs give the same
// bits; the caller sums the slices. Under the causal mask a block also takes
// two key blocks, i and n - 1 - i (paired), so that every block walks about
// the same number of rows: unpaired, the first key block walks all T rows
// and the last one 32.
template <int HD, bool BIAS>
__global__ void mqa_mma_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ dcol,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, int batch,
                                   int batch_per_block, int paired, int seq_len, int n_head,
                                   int rows_per_stage, int causal, float scale,
                                   const float* __restrict__ table, int n_table, int nk,
                                   float* __restrict__ dtable_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KEYS = 16 * DKV_KEY_TILES;  // keys of a block
  const int width = n_head * HD;
  const int R = rows_per_stage;
  const DkvSmem lay = dkv_smem(R, n_head, HD, BIAS);
  bf16* q_s = reinterpret_cast<bf16*>(smem);                       // [R][width] q
  bf16* qs_s = BIAS ? q_s : q_s + (size_t)R * width;               // [R][width] round(q*scale)
  bf16* do_s = qs_s + (size_t)R * width;                           // [R][width] dO
  float* lse_s = reinterpret_cast<float*>(do_s + (size_t)R * width);  // [R][H]
  float* d_s = lse_s + (size_t)R * n_head;                            // [R][H]
  const int bstride = dkv_bias_stride(n_head), wstride = dkv_dbw_stride(n_head);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + lay.stage);            // [R + KEYS - 1][bstride]
  float* dbw_all = reinterpret_cast<float*>(smem + lay.stage + lay.bias);  // [warps][R + 15][wstride]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int tile = warp % DKV_KEY_TILES, part = warp / DKV_KEY_TILES;
  const int n_kb = (seq_len + KEYS - 1) / KEYS;  // key blocks
  const int dbw_size = (R + 15) * wstride;
  float* dbw = dbw_all + (size_t)warp * dbw_size;
  float* part_out = nullptr;
  if constexpr (BIAS) {
    part_out = dtable_part + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * n_table * n_head;
    for (int i = threadIdx.x; i < DKV_KEY_TILES * DKV_ROW_SPLIT * dbw_size; i += blockDim.x)
      dbw_all[i] = 0.f;
  }
  const int b_lo = blockIdx.y * batch_per_block, b_hi = min(batch, b_lo + batch_per_block);
  const int kb_second = paired ? n_kb - 1 - (int)blockIdx.x : (int)blockIdx.x;

  for (int kbi = blockIdx.x;; kbi = kb_second) {
    const int k0 = kbi * KEYS;      // the key block's first key
    const int kw0 = k0 + 16 * tile;  // warp's first key
    for (int b = b_lo; b < b_hi; ++b) {
      // A operands: keys kw0+g and kw0+g+8 of K and V, held for the whole walk
      uint32_t ka[HD / 16][4], va[HD / 16][4];
      const size_t kv_base = ((size_t)b * seq_len + kw0) * HD;
      load_a<HD>(ka, k + kv_base, HD, seq_len - kw0, g, c, 1.f);
      load_a<HD>(va, v + kv_base, HD, seq_len - kw0, g, c, 1.f);

      float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

      const size_t qbase = (size_t)b * seq_len * width;
      const size_t rbase = (size_t)b * seq_len * n_head;
      for (int r0 = causal ? k0 : 0; r0 < seq_len; r0 += R) {
        const int nr = min(R, seq_len - r0);
        __syncthreads();
        const __nv_bfloat162* qsrc = reinterpret_cast<const __nv_bfloat162*>(q + qbase + (size_t)r0 * width);
        const __nv_bfloat162* dsrc = reinterpret_cast<const __nv_bfloat162*>(dout + qbase + (size_t)r0 * width);
        for (int i = threadIdx.x; i < nr * width / 2; i += blockDim.x) {
          const __nv_bfloat162 qp = qsrc[i];
          reinterpret_cast<__nv_bfloat162*>(q_s)[i] = qp;
          if constexpr (!BIAS)
            reinterpret_cast<uint32_t*>(qs_s)[i] =
                pack_bf16(__bfloat162float(qp.x) * scale, __bfloat162float(qp.y) * scale);
          reinterpret_cast<__nv_bfloat162*>(do_s)[i] = dsrc[i];
        }
        for (int i = threadIdx.x; i < nr * n_head; i += blockDim.x) {
          lse_s[i] = lse[rbase + (size_t)r0 * n_head + i];
          d_s[i] = dcol[rbase + (size_t)r0 * n_head + i];
        }
        // the bias of this stage: (row i, key j) at u = (i - r0) - (j - k0) + KEYS - 1,
        // table row l = nk + r0 - k0 - (KEYS - 1) + u
        const int l0 = nk + r0 - k0 - (KEYS - 1);
        if constexpr (BIAS) {
          for (int i = threadIdx.x; i < (nr + KEYS - 1) * n_head; i += blockDim.x) {
            const int u = i / n_head, h = i - u * n_head, l = l0 + u;
            const float x = (l >= 0 && l < n_table) ? table[(size_t)l * n_head + h] : 0.f;
            bias_s[u * bstride + h] = __float2bfloat16_rn(x);
          }
        }
        __syncthreads();

        for (int i = r0 + part; i < r0 + nr; i += DKV_ROW_SPLIT) {
          if (causal && i < kw0) continue;  // warp-uniform: every key of the warp is after row i
          const int r = i - r0;
          const bf16* qrow = qs_s + (size_t)r * width;
          const bf16* qraw = q_s + (size_t)r * width;
          const bf16* drow = do_s + (size_t)r * width;
          const float* lrow = lse_s + (size_t)r * n_head;
          const float* dd = d_s + (size_t)r * n_head;
          for (int h0 = 0; h0 < n_head; h0 += 16) {
            // S^T and dP^T: 16 keys x 8 heads, two tiles for the 16 heads
            float st[2][4], dpt[2][4];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
              dpt[t][0] = dpt[t][1] = dpt[t][2] = dpt[t][3] = 0.f;
              const bf16* qh = qrow + (size_t)(h0 + 8 * t + g) * HD + 2 * c;
              const bf16* dh = drow + (size_t)(h0 + 8 * t + g) * HD + 2 * c;
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk) {
                mma_16816(st[t], ka[kk], ld32(qh + kk * 16), ld32(qh + kk * 16 + 8));
                mma_16816(dpt[t], va[kk], ld32(dh + kk * 16), ld32(dh + kk * 16 + 8));
              }
            }
            float p[2][4], ds[2][4];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int kl = g + (e >> 1) * 8;  // key kw0 + kl
                const int key = kw0 + kl;
                const int hh = h0 + 8 * t + 2 * c + (e & 1);
                const bool live = key < seq_len && (!causal || key <= i);
                float sv = st[t][e];
                if constexpr (BIAS)
                  sv = sv * scale + __bfloat162float(bias_s[(r - 16 * tile - kl + KEYS - 1) * bstride + hh]);
                const float pv = live ? expf(sv - lrow[hh]) : 0.f;
                p[t][e] = pv;
                ds[t][e] = pv * (dpt[t][e] - dd[hh]);
                if constexpr (BIAS) dbw[(r - kl + 15) * wstride + hh] += ds[t][e];
              }
            }
            // P^T and dS^T (16 keys x 16 heads) rounded to bf16 are A fragments
            const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                    pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
            const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                     pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
            // B operands: dO and q of the 16 heads (k = head, n = dim)
            const bf16* dcolp = drow + (size_t)(h0 + 2 * c) * HD + g;
            const bf16* qcolp = qraw + (size_t)(h0 + 2 * c) * HD + g;
#pragma unroll
            for (int nt = 0; nt < HD / 8; ++nt) {
              const bf16* dp_ = dcolp + nt * 8;
              const bf16* qp_ = qcolp + nt * 8;
              mma_16816(dva[nt], pa, pack_raw(dp_[0], dp_[HD]), pack_raw(dp_[8 * HD], dp_[9 * HD]));
              mma_16816(dka[nt], dsa, pack_raw(qp_[0], qp_[HD]), pack_raw(qp_[8 * HD], qp_[9 * HD]));
            }
          }
          if constexpr (BIAS) __syncwarp();  // the next row's lanes may add where this row's did
        }

        if constexpr (BIAS) {
          // the warps' sums of this stage, in a fixed order, into the block's slice
          __syncthreads();
          for (int i = threadIdx.x; i < (nr + KEYS - 1) * n_head; i += blockDim.x) {
            const int u = i / n_head, h = i - u * n_head;
            float sum = 0.f;
            for (int w = 0; w < DKV_KEY_TILES * DKV_ROW_SPLIT; ++w) {
              const int sw = u + 16 * (w % DKV_KEY_TILES) - (KEYS - 16);  // the warp's own index
              if (sw < 0 || sw >= R + 15) continue;
              float* cell = dbw_all + (size_t)w * dbw_size + sw * wstride + h;
              sum += *cell;
              *cell = 0.f;
            }
            const int l = l0 + u;
            if (l >= 0 && l < n_table) part_out[(size_t)l * n_head + h] += sum;
          }
        }
      }

      // the row parts of each key tile add up in a fixed order: part 0 takes the
      // others' sums one at a time through shared memory
      float* red = reinterpret_cast<float*>(smem);  // [2][DKV_KEY_TILES][16][HD]
      float* red_k = red + (size_t)tile * 16 * HD;
      float* red_v = red + (size_t)(DKV_KEY_TILES + tile) * 16 * HD;
      for (int src = 1; src < DKV_ROW_SPLIT; ++src) {
        __syncthreads();
        if (part == src) {
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt) {
            const int d = nt * 8 + 2 * c;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int at = (g + (e >> 1) * 8) * HD + d + (e & 1);
              red_k[at] = dka[nt][e];
              red_v[at] = dva[nt][e];
            }
          }
        }
        __syncthreads();
        if (part == 0) {
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt) {
            const int d = nt * 8 + 2 * c;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int at = (g + (e >> 1) * 8) * HD + d + (e & 1);
              dka[nt][e] += red_k[at];
              dva[nt][e] += red_v[at];
            }
          }
        }
      }
      if (part == 0) {
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const int d = nt * 8 + 2 * c;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int key = kw0 + g + half * 8;
            if (key >= seq_len) continue;
            const size_t at = ((size_t)b * seq_len + key) * HD + d;
            *reinterpret_cast<uint32_t*>(dk + at) =
                pack_bf16(dka[nt][2 * half] * scale, dka[nt][2 * half + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dva[nt][2 * half], dva[nt][2 * half + 1]);
          }
        }
      }
    }
    if (kbi == kb_second) break;
  }
}

// rows staged at a time by the dK/dV kernel, or 0 when fewer than its row
// split fit the budget
__host__ int dkv_rows_per_stage(int n_head, int head_dim, bool bias) {
  for (int rows = DKV_MAX_ROWS; rows >= DKV_ROW_SPLIT; --rows)
    if (dkv_smem(rows, n_head, head_dim, bias).total <= (size_t)SMEM_BUDGET) return rows;
  return 0;
}

// the tensor-core kernels take bf16, MQA, 16-head groups and hd in {16, 32, 64}
bool mma_ok(int kvh, int n_head, int head_dim, int is_bf16, bool bias) {
  return is_bf16 && kvh == 1 && n_head % 16 == 0 && n_head <= 512 &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64) &&
         dkv_rows_per_stage(n_head, head_dim, bias) >= DKV_ROW_SPLIT;
}

// The bias dK/dV grid: x over key blocks (pairs of them under the causal
// mask), y over groups of batch rows, the group as small as lets every block
// be resident at once (the occupancy the card reports), so that the blocks,
// of about equal work, fill one wave. The table-gradient slices are x * y.
struct DkvGrid {
  int x, y, batch_per_block, paired;
};

DkvGrid dkv_grid(int batch, int seq_len, int causal, int resident_blocks) {
  const int n_kb = (seq_len + 16 * DKV_KEY_TILES - 1) / (16 * DKV_KEY_TILES);
  DkvGrid g{causal ? (n_kb + 1) / 2 : n_kb, 0, 1, causal ? 1 : 0};
  const int slots = resident_blocks > 0 ? resident_blocks : 1;
  g.batch_per_block = (g.x * batch + slots - 1) / slots;
  if (g.batch_per_block < 1) g.batch_per_block = 1;
  g.y = (batch + g.batch_per_block - 1) / g.batch_per_block;
  return g;
}

constexpr int DKV_THREADS = 32 * DKV_KEY_TILES * DKV_ROW_SPLIT;

// blocks of the dK/dV kernel the card holds at once (SMs x blocks per SM)
template <int HD, bool BIAS>
int dkv_resident_blocks(int n_head) {
  const size_t smem = dkv_smem(dkv_rows_per_stage(n_head, HD, BIAS), n_head, HD, BIAS).total;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mqa_mma_dkv_kernel<HD, BIAS>, DKV_THREADS, smem);
  return sms * per_sm;
}

template <int HD, bool BIAS>
DkvGrid dkv_grid_of(int batch, int seq_len, int n_head, int causal) {
  return dkv_grid(batch, seq_len, causal, dkv_resident_blocks<HD, BIAS>(n_head));
}

template <int HD, bool BIAS>
int launch_mma_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* dcol, void* dk, void* dv, void* dtable_part, int batch,
                   int seq_len, int n_head, int causal, Bias bias, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int rows = dkv_rows_per_stage(n_head, HD, BIAS);
  const size_t smem = dkv_smem(rows, n_head, HD, BIAS).total;
  const DkvGrid g = dkv_grid_of<HD, BIAS>(batch, seq_len, n_head, causal);
  mqa_mma_dkv_kernel<HD, BIAS><<<dim3(g.x, g.y), DKV_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch,
      g.batch_per_block, g.paired, seq_len, n_head, rows, causal, scale, bias.table, bias.n_table,
      bias.nk, static_cast<float*>(dtable_part));
  return (int)cudaGetLastError();
}

template <int HD, bool BIAS>
int launch_mma_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dcol, void* dq, int batch, int seq_len, int n_head, int causal,
                  Bias bias, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int groups = n_head / 16;
  int qrows = 16 / groups;  // up to 16 warps per block
  if (qrows < 1) qrows = 1;
  auto smem_of = [&](int t) {
    return (size_t)2 * HD * (3 * t + 8) +
           (BIAS ? (size_t)2 * n_head * bias_ustride(qrows, t) : 0);
  };
  int tile = KV_TILE;
  while (tile > 16 && smem_of(tile) > (size_t)SMEM_BUDGET) tile >>= 1;
  if (smem_of(tile) > (size_t)SMEM_BUDGET) return -1;
  int need = 16;
  while (need < seq_len) need <<= 1;
  if (tile > need) tile = need;
  mqa_mma_dq_kernel<HD, BIAS><<<dim3((seq_len + qrows - 1) / qrows, batch), qrows * groups * 32,
                                smem_of(tile), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<bf16*>(dq), seq_len, n_head, qrows, tile,
      causal, scale, bias.table, bias.n_table, bias.nk);
  return (int)cudaGetLastError();
}

// ---- the no-bias tensor-core backward: async staging, balanced grids ---------

constexpr int TC_WARPS = 8;      // warps per dQ block
constexpr int TC_KEY_TILE = 64;  // keys per staged K/V tile of the dQ kernel (two in flight)
constexpr int TDKV_KEY_TILES = 4;         // 16-key tiles per dK/dV block
constexpr int TDKV_ROW_SPLIT = 4;         // warps that split a key tile's query rows
constexpr int TDKV_MAX_ROWS = 32;         // query rows per stage (two stages in flight)
constexpr int TDKV_SMEM = 200 * 1024;     // budget: one dK/dV block per SM
constexpr int TDKV_THREADS = 32 * TDKV_KEY_TILES * TDKV_ROW_SPLIT;

// A dQ warp owns 32 / HD query rows (at least one) of one 16-head group.
template <int HD> __host__ __device__ constexpr int tc_dq_rows_per_warp() { return HD >= 32 ? 1 : 32 / HD; }

// dQ: as the forward, a warp walks the live keys of its rows; K and V tiles
// arrive by cp.async behind the work on the tile before, and ldmatrix reads K
// both ways (as B of S = qs.K^T, and transposed as B of dq += dS.K), so no
// transposed copy is staged.
template <int HD, bool BIAS>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
    mqa_tc_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dcol,
                     bf16* __restrict__ dq, int batch, int seq_len, int n_head, int rows_per_block,
                     int n_qb, int causal, float scale) {
  static_assert(!BIAS, "the position bias takes mqa_mma_dq_kernel");
  constexpr int RPW = tc_dq_rows_per_warp<HD>();
  constexpr int KT = TC_KEY_TILE;
  constexpr int KS = HD + 8;  // padded row: the 8 rows of an ldmatrix hit 8 bank groups
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][KT][KS]
  bf16* vs = ks + 2 * KT * KS;               // [2][KT][KS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int groups = n_head >> 4;
  const int qb = causal ? n_qb - 1 - (int)blockIdx.x / batch : (int)blockIdx.x / batch;  // heavy first
  const int b = blockIdx.x % batch;
  const int row0 = qb * rows_per_block;
  const int wrow = row0 + (warp / groups) * RPW;
  const int h0 = (warp % groups) * 16;
  const int block_keys = causal ? min(row0 + rows_per_block, seq_len) : seq_len;
  const int warp_keys = wrow >= seq_len ? 0 : causal ? min(wrow + RPW, seq_len) : seq_len;
  const int n_tiles = (block_keys + KT - 1) / KT;
  const bf16* kb = k + (size_t)b * seq_len * HD;
  const bf16* vb = v + (size_t)b * seq_len * HD;

  auto stage = [&](int tile) {
    const int t0 = tile * KT;
    bf16* kd = ks + (tile & 1) * KT * KS;
    bf16* vd = vs + (tile & 1) * KT * KS;
    for (int i = threadIdx.x; i < KT * (HD / 8); i += blockDim.x) {
      const int j = i / (HD / 8), d = (i % (HD / 8)) * 8;
      const bool in = t0 + j < seq_len;  // keys past the end are zeros
      const size_t src = (size_t)(in ? t0 + j : 0) * HD + d;
      cp_async16(kd + j * KS + d, kb + src, in);
      cp_async16(vd + j * KS + d, vb + src, in);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) stage(0);

  // A operands: qs = round(q * scale) and dO of each row's 16 heads
  uint32_t qa[RPW][HD / 16][4], da[RPW][HD / 16][4];
  float lr[RPW][2], dd[RPW][2], acc[RPW][HD / 8][4];
#pragma unroll
  for (int rt = 0; rt < RPW; ++rt) {
    const int row = wrow + rt;
    const size_t q_row = ((size_t)b * seq_len + row) * n_head * HD + (size_t)h0 * HD;
    const bool active = row < seq_len;
    load_a<HD>(qa[rt], q + q_row, HD, active ? 16 : 0, g, c, scale);
    load_a<HD>(da[rt], dout + q_row, HD, active ? 16 : 0, g, c, 1.f);
    lr[rt][0] = lr[rt][1] = dd[rt][0] = dd[rt][1] = 0.f;
    if (active) {
      const size_t r_off = ((size_t)b * seq_len + row) * n_head + h0 + g;
      lr[rt][0] = lse[r_off], lr[rt][1] = lse[r_off + 8];
      dd[rt][0] = dcol[r_off], dd[rt][1] = dcol[r_off + 8];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) acc[rt][nt][0] = acc[rt][nt][1] = acc[rt][nt][2] = acc[rt][nt][3] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    // this tile's sums, added to the rows' in f32 after it (as the dK/dV stages)
    float tacc[RPW][HD / 8][4];
#pragma unroll
    for (int rt = 0; rt < RPW; ++rt)
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) tacc[rt][nt][0] = tacc[rt][nt][1] = tacc[rt][nt][2] = tacc[rt][nt][3] = 0.f;
    if (tile + 1 < n_tiles) stage(tile + 1);  // overlaps this tile's work
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int t0 = tile * KT;
    const bf16* kt = ks + (tile & 1) * KT * KS;
    const bf16* vt = vs + (tile & 1) * KT * KS;
    const int j_end = min(t0 + KT, warp_keys);
    for (int j0 = t0; j0 < j_end; j0 += 16) {
      // keys j0..j0+15: K and V as B of S and dP, K transposed as B of dq
      uint32_t kf[HD / 16][4], vf[HD / 16][4], ktf[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int at = (j0 - t0 + ldsm_row(lane)) * KS + kk * 16 + ldsm_col(lane);
        ldsm_x4(kf[kk], kt + at);
        ldsm_x4(vf[kk], vt + at);
        ldsm_x4_t(ktf[kk], kt + (j0 - t0 + ldsm_row_t(lane)) * KS + kk * 16 + ldsm_col_t(lane));
      }
#pragma unroll
      for (int rt = 0; rt < RPW; ++rt) {
        const int row = wrow + rt;
        if (row >= seq_len || (causal && j0 > row)) continue;  // warp-uniform
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            mma_16816(s[nt], qa[rt][kk], kf[kk][2 * nt], kf[kk][2 * nt + 1]);
            mma_16816(dp[nt], da[rt][kk], vf[kk][2 * nt], vf[kk][2 * nt + 1]);
          }
        }
        const bool edge = (causal && j0 + 15 > row) || j0 + 16 > seq_len;  // the mask's tiles
        float ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = j0 + nt * 8 + 2 * c + (e & 1);
            float p = ex2(fmaf(s[nt][e], LOG2E, -lr[rt][r] * LOG2E));
            if (edge && (key >= seq_len || (causal && key > row))) p = 0.f;
            ds[nt][e] = p * (dp[nt][e] - dd[rt][r]);
          }
        // the dS accumulators are the dq product's A fragment; dS rounds to bf16
        const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                 pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          mma_16816(tacc[rt][2 * kk], dsa, ktf[kk][0], ktf[kk][1]);
          mma_16816(tacc[rt][2 * kk + 1], dsa, ktf[kk][2], ktf[kk][3]);
        }
      }
    }
#pragma unroll
    for (int rt = 0; rt < RPW; ++rt)
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rt][nt][e] += tacc[rt][nt][e];
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

#pragma unroll
  for (int rt = 0; rt < RPW; ++rt) {
    const int row = wrow + rt;
    if (row >= seq_len) continue;
    bf16* orow = dq + ((size_t)b * seq_len + row) * n_head * HD + (size_t)h0 * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int d = nt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(orow + (size_t)g * HD + d) =
          pack_bf16(acc[rt][nt][0] * scale, acc[rt][nt][1] * scale);
      *reinterpret_cast<uint32_t*>(orow + (size_t)(g + 8) * HD + d) =
          pack_bf16(acc[rt][nt][2] * scale, acc[rt][nt][3] * scale);
    }
  }
}

// Shared memory of a dK/dV stage of `rows` query rows: q and dO (swizzled),
// lse and D; and of the whole block: two stages and the final reduction's buffer.
__host__ __device__ __forceinline__ size_t tdkv_stage_bytes(int rows, int n_head, int hd) {
  return (size_t)rows * n_head * (2 * hd * sizeof(bf16) + 2 * sizeof(float));
}
__host__ __device__ __forceinline__ size_t tdkv_smem(int rows, int n_head, int hd) {
  return 2 * tdkv_stage_bytes(rows, n_head, hd) + (size_t)2 * TDKV_KEY_TILES * 16 * hd * sizeof(float);
}

// rows per stage of the dK/dV kernel, or 0 when fewer than its row split fit
int tdkv_rows(int n_head, int head_dim) {
  for (int rows = TDKV_MAX_ROWS; rows >= TDKV_ROW_SPLIT; --rows)
    if (tdkv_smem(rows, n_head, head_dim) <= (size_t)TDKV_SMEM) return rows;
  return 0;
}

// Element offset, in a staged row, of the 16-byte word w of head h: the word
// index is XORed with bits of h so that the 8 heads one ldmatrix reads (at
// one word) lie in 8 different bank groups.
template <int HD>
__device__ __forceinline__ int swz(int h, int w) {
  constexpr int NW = HD / 8;  // words a head
  return h * HD + ((w ^ ((h * NW / 8) % NW)) << 3);
}

// 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// dK/dV: a warp owns 16 keys (K and V as A operands in registers) and a
// quarter of each stage's query rows. Stages of R rows (q, dO, lse, D) arrive
// by cp.async, two in flight, so the copy of the next overlaps the products
// on this one; ldmatrix gives q and dO both ways (as B of S^T = K.qs^T and
// dP^T = V.dO^T, and transposed as B of dV += P^T.dO and dK += dS^T.q), and
// qs = round(q * scale) is formed from the fragment.
//
// Balance: the grid is persistent, one block per resident slot (one per SM:
// a block's registers fill more than half of one), and the work items
// (key block, batch row) are ordered heaviest first (under the causal mask
// key block i walks T - 64 i rows) and dealt out in a serpentine: item r of
// round k goes to block r - kG in even rounds and G - 1 - (r - kG) in odd
// ones. Each block then holds a heavy and a light item in turn, so that the
// blocks' rows add up to about the same. Each item's dK and dV are written by
// its one block, in a fixed order of sums.
template <int HD, bool BIAS>
__global__ void __launch_bounds__(TDKV_THREADS, 1)
    mqa_tc_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dcol,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int batch, int seq_len,
                      int n_head, int rows_per_stage, int causal, float scale) {
  static_assert(!BIAS, "the position bias takes mqa_mma_dkv_kernel");
  constexpr int KEYS = 16 * TDKV_KEY_TILES;  // keys of a key block
  const int width = n_head * HD;
  const int R = rows_per_stage;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t sb = tdkv_stage_bytes(R, n_head, HD);
  float* red = reinterpret_cast<float*>(smem + 2 * sb);  // [2][KEY_TILES][16][HD]
  auto q_of = [&](int buf) { return reinterpret_cast<bf16*>(smem + buf * sb); };  // [R][width]
  auto do_of = [&](int buf) { return q_of(buf) + (size_t)R * width; };              // [R][width]
  auto lse_of = [&](int buf) { return reinterpret_cast<float*>(do_of(buf) + (size_t)R * width); };  // [R][H]
  auto d_of = [&](int buf) { return lse_of(buf) + (size_t)R * n_head; };                            // [R][H]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int tile = warp % TDKV_KEY_TILES, part = warp / TDKV_KEY_TILES;
  const int n_items = (seq_len + KEYS - 1) / KEYS * batch;

  for (int round = 0;; ++round) {
    const int item = round * gridDim.x + ((round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (item >= n_items) break;
    const int kbi = item / batch, b = item % batch;
    const int k0 = kbi * KEYS;       // the key block's first key
    const int kw0 = k0 + 16 * tile;  // the warp's first key
    {
      const size_t qbase = (size_t)b * seq_len * width;
      const size_t rbase = (size_t)b * seq_len * n_head;
      const int r_begin = causal ? k0 : 0;
      const int n_stages = (seq_len - r_begin + R - 1) / R;
      auto stage = [&](int st) {
        const int r0 = r_begin + st * R, nr = min(R, seq_len - r0), buf = st & 1;
        bf16* qd = q_of(buf);
        bf16* dd = do_of(buf);
        const bf16* qsrc = q + qbase + (size_t)r0 * width;
        const bf16* dsrc = dout + qbase + (size_t)r0 * width;
        const int words = width / 8;  // 16-byte words a row
        for (int i = threadIdx.x; i < nr * words; i += blockDim.x) {
          const int r = i / words, w = i - r * words, h = w / (HD / 8);
          const int at = r * width + swz<HD>(h, w - h * (HD / 8));
          cp_async16(qd + at, qsrc + (size_t)i * 8, true);
          cp_async16(dd + at, dsrc + (size_t)i * 8, true);
        }
        float* ld = lse_of(buf);
        float* dl = d_of(buf);
        for (int i = threadIdx.x; i < nr * n_head; i += blockDim.x) {
          cp_async4(ld + i, lse + rbase + (size_t)r0 * n_head + i);
          cp_async4(dl + i, dcol + rbase + (size_t)r0 * n_head + i);
        }
        cp_async_commit();
      };
      stage(0);

      // A operands: keys kw0+g and kw0+g+8 of K and V, held for the whole walk
      uint32_t ka[HD / 16][4], va[HD / 16][4];
      const size_t kv_base = ((size_t)b * seq_len + kw0) * HD;
      load_a<HD>(ka, k + kv_base, HD, seq_len - kw0, g, c, 1.f);
      load_a<HD>(va, v + kv_base, HD, seq_len - kw0, g, c, 1.f);
      float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

      for (int st = 0; st < n_stages; ++st) {
        // this stage's sums, added to the item's in f32 after it: a sum of a few
        // tensor-core accumulations at a time, so rounding does not build up
        float sdk[HD / 8][4], sdv[HD / 8][4];
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sdk[nt][e] = sdv[nt][e] = 0.f;
        if (st + 1 < n_stages) stage(st + 1);  // overlaps this stage's work
        else cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int r0 = r_begin + st * R, nr = min(R, seq_len - r0), buf = st & 1;
        for (int r = part; r < nr; r += TDKV_ROW_SPLIT) {
          const int i = r0 + r;
          if (causal && i < kw0) continue;  // warp-uniform: every key of the warp is after row i
          const bool edge = (causal && i < kw0 + 15) || kw0 + 16 > seq_len;  // the mask's rows
          const bf16* qrow = q_of(buf) + (size_t)r * width;
          const bf16* drow = do_of(buf) + (size_t)r * width;
          const float* lrow = lse_of(buf) + (size_t)r * n_head;
          const float* drw = d_of(buf) + (size_t)r * n_head;
          for (int h0 = 0; h0 < n_head; h0 += 16) {
            // B fragments of the 16 heads: qs and dO with k = dim, q and dO with k = head
            uint32_t qf[HD / 16][4], df[HD / 16][4], qt[HD / 16][4], dt[HD / 16][4];
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              const int at = swz<HD>(h0 + ldsm_row(lane), 2 * kk + (ldsm_col(lane) >> 3));
              const int at_t = swz<HD>(h0 + ldsm_row_t(lane), 2 * kk + (ldsm_col_t(lane) >> 3));
              ldsm_x4(qf[kk], qrow + at);
              ldsm_x4(df[kk], drow + at);
              ldsm_x4_t(qt[kk], qrow + at_t);
              ldsm_x4_t(dt[kk], drow + at_t);
#pragma unroll
              for (int j = 0; j < 4; ++j)  // qs = round(q * scale)
                qf[kk][j] = pack_bf16(bf_lo(qf[kk][j]) * scale, bf_hi(qf[kk][j]) * scale);
            }
            // S^T and dP^T: 16 keys x 8 heads, two tiles for the 16 heads
            float st_[2][4], dpt[2][4];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              st_[t][0] = st_[t][1] = st_[t][2] = st_[t][3] = 0.f;
              dpt[t][0] = dpt[t][1] = dpt[t][2] = dpt[t][3] = 0.f;
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk) {
                mma_16816(st_[t], ka[kk], qf[kk][2 * t], qf[kk][2 * t + 1]);
                mma_16816(dpt[t], va[kk], df[kk][2 * t], df[kk][2 * t + 1]);
              }
            }
            float p[2][4], ds[2][4];
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const int hh = h0 + 8 * t + 2 * c;  // this lane's heads hh, hh + 1
              const float2 l2 = *reinterpret_cast<const float2*>(lrow + hh);
              const float2 d2 = *reinterpret_cast<const float2*>(drw + hh);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float lv = (e & 1) ? l2.y : l2.x, dv_ = (e & 1) ? d2.y : d2.x;
                const int key = kw0 + g + (e >> 1) * 8;
                float pv = ex2(fmaf(st_[t][e], LOG2E, -lv * LOG2E));
                if (edge && (key >= seq_len || (causal && key > i))) pv = 0.f;
                p[t][e] = pv;
                ds[t][e] = pv * (dpt[t][e] - dv_);
              }
            }
            // P^T and dS^T (16 keys x 16 heads) rounded to bf16 are A fragments
            const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                    pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
            const uint32_t dsa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                     pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              mma_16816(sdv[2 * kk], pa, dt[kk][0], dt[kk][1]);
              mma_16816(sdv[2 * kk + 1], pa, dt[kk][2], dt[kk][3]);
              mma_16816(sdk[2 * kk], dsa, qt[kk][0], qt[kk][1]);
              mma_16816(sdk[2 * kk + 1], dsa, qt[kk][2], qt[kk][3]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dka[nt][e] += sdk[nt][e], dva[nt][e] += sdv[nt][e];
        __syncthreads();  // the next iteration's copy overwrites this buffer
      }

      // the row parts of each key tile add up in a fixed order: part 0 takes the
      // others' sums one at a time through shared memory
      float* red_k = red + (size_t)tile * 16 * HD;
      float* red_v = red + (size_t)(TDKV_KEY_TILES + tile) * 16 * HD;
      for (int src = 1; src < TDKV_ROW_SPLIT; ++src) {
        if (part == src) {
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int at = (g + (e >> 1) * 8) * HD + nt * 8 + 2 * c + (e & 1);
              red_k[at] = dka[nt][e];
              red_v[at] = dva[nt][e];
            }
        }
        __syncthreads();
        if (part == 0) {
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int at = (g + (e >> 1) * 8) * HD + nt * 8 + 2 * c + (e & 1);
              dka[nt][e] += red_k[at];
              dva[nt][e] += red_v[at];
            }
        }
        __syncthreads();
      }
      if (part == 0) {
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const int d = nt * 8 + 2 * c;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int key = kw0 + g + half * 8;
            if (key >= seq_len) continue;
            const size_t at = ((size_t)b * seq_len + key) * HD + d;
            *reinterpret_cast<uint32_t*>(dk + at) =
                pack_bf16(dka[nt][2 * half] * scale, dka[nt][2 * half + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dva[nt][2 * half], dva[nt][2 * half + 1]);
          }
        }
      }
    }
  }
}

// the tensor-core backward takes bf16, MQA, 1 to TC_WARPS groups of 16 heads,
// hd in {16, 32, 64}, and at least TDKV_ROW_SPLIT rows a dK/dV stage
bool tc_bwd_ok(int kvh, int n_head, int head_dim, int is_bf16) {
  return is_bf16 && kvh == 1 && n_head % 16 == 0 && n_head / 16 <= TC_WARPS &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64) &&
         tdkv_rows(n_head, head_dim) >= TDKV_ROW_SPLIT;
}

template <int HD>
int launch_tc_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* dcol, void* dq, int batch, int seq_len, int n_head, int causal,
                 cudaStream_t stream) {
  const int groups = n_head / 16;
  const int slices = TC_WARPS / groups;  // row slices of a block
  const int rows = slices * tc_dq_rows_per_warp<HD>();
  const int n_qb = (seq_len + rows - 1) / rows;
  if ((long long)n_qb * batch > 0x7fffffffLL) return -1;
  const size_t smem = (size_t)2 * 2 * TC_KEY_TILE * (HD + 8) * sizeof(bf16);
  const float scale = (float)(1.0 / sqrt((double)HD));
  mqa_tc_dq_kernel<HD, false><<<n_qb * batch, slices * groups * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<bf16*>(dq), batch, seq_len, n_head, rows, n_qb,
      causal, scale);
  return (int)cudaGetLastError();
}

// the dK/dV kernel's shared memory for this shape, opted in above 48 KB, and
// the blocks the card holds at once (SMs x blocks per SM)
template <int HD>
int tdkv_prepare(int n_head, size_t* smem, int* resident) {
  *smem = tdkv_smem(tdkv_rows(n_head, HD), n_head, HD);
  int rc = (int)cudaFuncSetAttribute(mqa_tc_dkv_kernel<HD, false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (rc) return rc;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mqa_tc_dkv_kernel<HD, false>,
                                                          TDKV_THREADS, *smem);
  *resident = sms * per_sm;
  return rc;
}

template <int HD>
int launch_tc_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dcol, void* dk, void* dv, int batch, int seq_len, int n_head,
                  int causal, cudaStream_t stream) {
  size_t smem = 0;
  int resident = 0;
  const int rc = tdkv_prepare<HD>(n_head, &smem, &resident);
  if (rc) return rc;
  const int items = (seq_len + 16 * TDKV_KEY_TILES - 1) / (16 * TDKV_KEY_TILES) * batch;
  const float scale = (float)(1.0 / sqrt((double)HD));
  mqa_tc_dkv_kernel<HD, false><<<min(items, resident), TDKV_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch,
      seq_len, n_head, tdkv_rows(n_head, HD), causal, scale);
  return (int)cudaGetLastError();
}

// One backward half for the call's types: which = 0 dK/dV (and, with the bias,
// the table gradient into dtable_part), 1 dQ.
template <bool BIAS>
int backward(int which, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* dcol, void* dq, void* dk, void* dv, void* dtable_part,
             int batch, int seq_len, int n_head, int kvh, int head_dim, int causal, int is_bf16,
             Bias bias, cudaStream_t s) {
  if (n_head < 1 || n_head > 1024 || batch < 1 || seq_len < 1 || batch > 65535) return -1;
  if constexpr (!BIAS) {
    if (tc_bwd_ok(kvh, n_head, head_dim, is_bf16)) {
#define TC_CASE(HD)                                                                               \
  case HD:                                                                                        \
    return which == 0 ? launch_tc_dkv<HD>(q, k, v, dout, lse, dcol, dk, dv, batch, seq_len,       \
                                          n_head, causal, s)                                      \
                      : launch_tc_dq<HD>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head,    \
                                         causal, s);
      switch (head_dim) {
        TC_CASE(16)
        TC_CASE(32)
        TC_CASE(64)
        default: return -1;
      }
#undef TC_CASE
    }
  } else if (mma_ok(kvh, n_head, head_dim, is_bf16, BIAS)) {
#define MMA_CASE(HD)                                                                              \
  case HD:                                                                                        \
    return which == 0 ? launch_mma_dkv<HD, BIAS>(q, k, v, dout, lse, dcol, dk, dv, dtable_part,   \
                                                 batch, seq_len, n_head, causal, bias, s)         \
                      : launch_mma_dq<HD, BIAS>(q, k, v, dout, lse, dcol, dq, batch, seq_len,     \
                                                n_head, causal, bias, s);
    switch (head_dim) {
      MMA_CASE(16)
      MMA_CASE(32)
      MMA_CASE(64)
      default: return -1;
    }
#undef MMA_CASE
  }
#define FMA_CASE(T, HD)                                                                           \
  case HD: {                                                                                      \
    if (which == 1)                                                                               \
      return launch_fma_dq<T, HD, BIAS>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head,     \
                                        kvh, causal, bias, s);                                    \
    int rc = launch_fma_dkv<T, HD, BIAS>(q, k, v, dout, lse, dcol, dk, dv, batch, seq_len,        \
                                         n_head, kvh, causal, bias, s);                           \
    if (rc || !BIAS) return rc;                                                                   \
    return launch_fma_dtable<T, HD>(q, k, v, dout, lse, dcol, dtable_part, batch, seq_len,        \
                                    n_head, kvh, causal, bias, s);                                \
  }
  if (is_bf16) {
    switch (head_dim) {
      FMA_CASE(bf16, 8)
      FMA_CASE(bf16, 16)
      FMA_CASE(bf16, 32)
      FMA_CASE(bf16, 64)
      default: return -1;
    }
  }
  switch (head_dim) {
    FMA_CASE(float, 8)
    FMA_CASE(float, 16)
    FMA_CASE(float, 32)
    FMA_CASE(float, 64)
    default: return -1;
  }
#undef FMA_CASE
}

}  // namespace

// Returns 0 on success, cudaGetLastError() after a refused launch, or -1 for
// a shape the kernels do not take (head_dim, n_head > 1024, batch > 65535).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dcol, void* dq, void* dk, void* dv,
                         int batch, int seq_len, int n_head, int kvh, int head_dim, int causal,
                         int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias none{nullptr, 0, 0};
  int rc = backward<false>(0, q, k, v, dout, lse, dcol, dq, dk, dv, nullptr, batch, seq_len,
                           n_head, kvh, head_dim, causal, is_bf16, none, s);
  if (rc) return rc;
  return backward<false>(1, q, k, v, dout, lse, dcol, dq, dk, dv, nullptr, batch, seq_len, n_head,
                         kvh, head_dim, causal, is_bf16, none, s);
}

// The backward with the relative-position bias table (n_table, n_head) float32,
// in two entries, one per kernel: dq, and dk, dv with the table gradient. The
// caller checks the table covers every live pair (as for flash_bias_fwd).
extern "C" int flash_bias_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dcol, const void* table, void* dq,
                             int batch, int seq_len, int n_head, int kvh, int head_dim,
                             int n_table, int nk, int causal, int is_bf16, void* stream) {
  if (n_table < 1 || nk < 0) return -1;
  return backward<true>(1, q, k, v, dout, lse, dcol, dq, nullptr, nullptr, nullptr, batch,
                        seq_len, n_head, kvh, head_dim, causal, is_bf16,
                        Bias{static_cast<const float*>(table), n_table, nk},
                        static_cast<cudaStream_t>(stream));
}

// dtable_part: flash_bias_dkv_slices(...) zeroed (n_table, n_head) float32
// slices, each written by one block; their sum is the table gradient.
extern "C" int flash_bias_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* dcol, const void* table, void* dk,
                              void* dv, void* dtable_part, int batch, int seq_len, int n_head,
                              int kvh, int head_dim, int n_table, int nk, int causal,
                              int is_bf16, void* stream) {
  if (n_table < 1 || nk < 0) return -1;
  return backward<true>(0, q, k, v, dout, lse, dcol, nullptr, dk, dv, dtable_part, batch,
                        seq_len, n_head, kvh, head_dim, causal, is_bf16,
                        Bias{static_cast<const float*>(table), n_table, nk},
                        static_cast<cudaStream_t>(stream));
}

namespace {

// the grid flash_bias_dkv launches for this shape on the current device (one
// block and one slice when the FMA kernels take the call)
DkvGrid bias_dkv_grid(int batch, int seq_len, int n_head, int kvh, int head_dim, int causal,
                      int is_bf16) {
  if (!mma_ok(kvh, n_head, head_dim, is_bf16, true)) return DkvGrid{1, 1, 1, 0};
  switch (head_dim) {
    case 16: return dkv_grid_of<16, true>(batch, seq_len, n_head, causal);
    case 32: return dkv_grid_of<32, true>(batch, seq_len, n_head, causal);
    case 64: return dkv_grid_of<64, true>(batch, seq_len, n_head, causal);
    default: return DkvGrid{-1, 1, 1, 0};
  }
}

}  // namespace

// The number of table-gradient slices flash_bias_dkv writes for this shape on
// the current device.
extern "C" int flash_bias_dkv_slices(int batch, int seq_len, int n_head, int kvh, int head_dim,
                                     int causal, int is_bf16) {
  const DkvGrid g = bias_dkv_grid(batch, seq_len, n_head, kvh, head_dim, causal, is_bf16);
  return g.x * g.y;
}

// The batch rows one block of flash_bias_dkv walks for this shape on the
// current device.
extern "C" int flash_bias_dkv_batch_per_block(int batch, int seq_len, int n_head, int kvh,
                                              int head_dim, int causal, int is_bf16) {
  return bias_dkv_grid(batch, seq_len, n_head, kvh, head_dim, causal, is_bf16).batch_per_block;
}

// The (key block, batch row) items one block of the no-bias dK/dV kernel
// walks for this shape on the current device (at most), or 0 where the FMA
// kernels take the call.
extern "C" int flash_dkv_items_per_block(int batch, int seq_len, int n_head, int kvh,
                                         int head_dim, int is_bf16) {
  if (!tc_bwd_ok(kvh, n_head, head_dim, is_bf16)) return 0;
  size_t smem = 0;
  int resident = 0, rc = 0;
  switch (head_dim) {
    case 16: rc = tdkv_prepare<16>(n_head, &smem, &resident); break;
    case 32: rc = tdkv_prepare<32>(n_head, &smem, &resident); break;
    default: rc = tdkv_prepare<64>(n_head, &smem, &resident); break;
  }
  if (rc || resident < 1) return -1;
  const int items = (seq_len + 16 * TDKV_KEY_TILES - 1) / (16 * TDKV_KEY_TILES) * batch;
  const int grid = items < resident ? items : resident;
  return (items + grid - 1) / grid;
}
