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
// - the position-bias case (entries flash_bias_dkv and flash_bias_dq):
//   dK/dV is mqa_tc_bias_dkv_kernel, the no-bias kernel's design with the
//   bias (H = 16 or 32; other head counts take the FMA kernels; the bias run
//   of each stage staged once, the table gradient carried along its
//   diagonals in registers, see the kernel); dQ is mqa_tc_bias_dq_kernel,
//   the no-bias dQ kernel's design with the bias run of each 64-key tile
//   staged as flash_bias_fwd stages it (up to TC_WARPS groups of 16 heads),
//   and above that mqa_mma_dq_kernel, where a warp owns 16 heads of one row.
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

// dQ with the bias for more than TC_WARPS groups of 16 heads (up to 512): a
// warp owns 16 heads of one query row and walks the row's live keys. With the
// bias (the grid kernel's arithmetic), q enters unscaled, the product is
// scaled in f32 and the staged bias added.
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
constexpr int TDKV_BIAS_SMEM = 227 * 1024;  // with the bias: the block's table-gradient exits too
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
  static_assert(!BIAS, "the position bias takes mqa_tc_bias_dq_kernel");
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

// ---- the bias tensor-core dQ: the no-bias design, the bias staged per tile ----
//
// mqa_tc_dq_kernel's design (a warp owns 32 / HD rows of a 16-head group;
// 64-key K/V tiles by cp.async; ldmatrix reads K both ways; the dS
// accumulators, rounded to bf16, are the A fragment of dq += dS.K; ex2 with
// the mask on diagonal and ragged tiles only; each tile's sums added into the
// f32 totals apart; heavy first), with the grid kernel's logits: s =
// (q.k) * scale + bias, q the unscaled bf16 operand, the bias
// bf16(table[i - j + nk, h]); p = exp(s - lse) as ex2(s log2e - lse log2e).
//
// The bias is staged as mqa_tc_bias_fwd_kernel (flash_fwd.cu) stages it, by
// the same functions, in the layout of BiasTile (flash_bias.cuh): the R + 66
// table rows a 64-key tile reads, one contiguous f32 run, arrive by cp.async
// beside K/V two tiles ahead, and once a tile each head's run is written as
// bf16 in two copies shifted by one (a row reads the copy of its parity), a
// lane's two heads g and g + 8 interleaved, so that one aligned 64-bit load
// gives a lane its 4 bias values. One barrier a tile. The two rows of a warp
// at hd = 16 (tc_dq_rows_per_warp) are of two parities: the first reads copy
// pe, the second copy 1 - pe.
//
// Bound at the production shape (B=64, T=1025, MQA 32x16, bf16, causal): the
// three products (s, dp, dq) over the live pairs take 0.10 ms at the
// tensor-core peak; one exponential per live (row, head, key), 1.08 G, takes
// 0.26 ms at 16 a clock per SM. As in the forward, the per-logit work around
// the products sets the pace.

template <int HD>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
    mqa_tc_bias_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dcol,
                          bf16* __restrict__ dq, const float* __restrict__ table, int batch, int seq_len,
                          int n_head, int rows_per_block, int n_qb, int causal, float scale, int n_table,
                          int nk) {
  constexpr int RPW = tc_dq_rows_per_warp<HD>();
  constexpr int KT = TC_KEY_TILE;
  constexpr int KS = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [3][KT][KS]
  bf16* vs = ks + TC_BIAS_KV_BUFS * KT * KS;  // [3][KT][KS]
  const BiasTile<KT> bt(rows_per_block, n_head);
  // [2 tiles][2 copies][n_head / 2 head pairs][hs / 2 words]: pair (16 G + g, 16 G + g + 8) is pair 8 G + g
  uint2* bw = reinterpret_cast<uint2*>(vs + TC_BIAS_KV_BUFS * KT * KS);
  const int copy_pairs = n_head / 2 * (bt.hs / 2);
  float* raw = reinterpret_cast<float*>(bw + 4 * copy_pairs);  // [2 tiles][nr][rs]

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
  const int zrow = row0 + rows_per_block - 1;  // z = (zrow - i) + (j - t0)

  // K and V of a tile, and the table rows its bias reads, in one cp.async group
  auto stage = [&](int tile) {
    const int t0 = tile * KT;
    tc_bias_stage_kv<HD, KT>(ks, vs, kb, vb, tile, seq_len);
    tc_bias_stage_rows(raw + (tile & 1) * bt.nr * bt.rs, bt, table, n_table, n_head, nk, zrow, t0);
    cp_async_commit();
  };
  auto convert = [&](int tile) { tc_bias_convert(bw, raw, bt, copy_pairs, groups, warp, lane, tile); };

  if (n_tiles > 0) stage(0);
  if (n_tiles > 1) stage(1);

  // A operands (while the first copies land): q of each row's 16 heads,
  // unscaled (the product is scaled after), and dO; -lse log2e and D
  uint32_t qa[RPW][HD / 16][4], da[RPW][HD / 16][4];
  float nl[RPW][2], dd[RPW][2], acc[RPW][HD / 8][4];
#pragma unroll
  for (int rt = 0; rt < RPW; ++rt) {
    const int row = wrow + rt;
    const size_t q_row = ((size_t)b * seq_len + row) * n_head * HD + (size_t)h0 * HD;
    const bool active = row < seq_len;
    load_a<HD>(qa[rt], q + q_row, HD, active ? 16 : 0, g, c, 1.f);
    load_a<HD>(da[rt], dout + q_row, HD, active ? 16 : 0, g, c, 1.f);
    nl[rt][0] = nl[rt][1] = dd[rt][0] = dd[rt][1] = 0.f;
    if (active) {
      const size_t r_off = ((size_t)b * seq_len + row) * n_head + h0 + g;
      nl[rt][0] = -lse[r_off] * LOG2E, nl[rt][1] = -lse[r_off + 8] * LOG2E;
      dd[rt][0] = dcol[r_off], dd[rt][1] = dcol[r_off + 8];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) acc[rt][nt][0] = acc[rt][nt][1] = acc[rt][nt][2] = acc[rt][nt][3] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (n_tiles > 0) convert(0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();  // tile + 1's copies, issued a tile ago
    __syncthreads();     // ... have landed for every thread; tile's bias is converted; tile - 1 is done
    if (tile + 2 < n_tiles) stage(tile + 2);
    if (tile + 1 < n_tiles) convert(tile + 1);
    // this tile's sums, added to the rows' in f32 after it
    float tacc[RPW][HD / 8][4];
#pragma unroll
    for (int rt = 0; rt < RPW; ++rt)
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) tacc[rt][nt][0] = tacc[rt][nt][1] = tacc[rt][nt][2] = tacc[rt][nt][3] = 0.f;
    const int t0 = tile * KT;
    const bf16* kt = ks + (tile % TC_BIAS_KV_BUFS) * KT * KS;
    const bf16* vt = vs + (tile % TC_BIAS_KV_BUFS) * KT * KS;
    const uint2* bt_w = bw + (tile & 1) * 2 * copy_pairs + (h0 / 2 + g) * (bt.hs / 2) + c;
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
      // the bias words of row wrow + rt: z = zw - rt at key j0, in copy p =
      // z & 1 at word (z + p) / 2 (as the forward)
      const int zw = zrow - wrow + j0 - t0, pe = zw & 1;
      const uint2* bpe = bt_w + pe * copy_pairs + (zw + pe) / 2;
      const uint2* bpo = bt_w + (1 - pe) * copy_pairs + (zw - pe) / 2;
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
        // s = (q.k) * scale + bias: keys j0 + 8 nt + 2c and + 1 of heads g
        // (.x) and g + 8 (.y), one 64-bit load
        const uint2* bp = (rt & 1) ? bpo - (rt - 1) / 2 : bpe - rt / 2;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint2 bb = bp[4 * nt];
          s[nt][0] = fmaf(s[nt][0], scale, bf_lo(bb.x));
          s[nt][1] = fmaf(s[nt][1], scale, bf_hi(bb.x));
          s[nt][2] = fmaf(s[nt][2], scale, bf_lo(bb.y));
          s[nt][3] = fmaf(s[nt][3], scale, bf_hi(bb.y));
        }
        const bool edge = (causal && j0 + 15 > row) || j0 + 16 > seq_len;  // the mask's tiles
        float ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = j0 + nt * 8 + 2 * c + (e & 1);
            float p = ex2(fmaf(s[nt][e], LOG2E, nl[rt][r]));
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
// lse and D.
__host__ __device__ __forceinline__ size_t tdkv_stage_bytes(int rows, int n_head, int hd) {
  return (size_t)rows * n_head * (2 * hd * sizeof(bf16) + 2 * sizeof(float));
}
// With the position bias: 32-bit words a staged bias row (u) takes, bf16
// pairs of heads padded so that the 8 rows one fragment reads lie in 8 bank
// groups; and the bytes of one stage's bias run (rows + 63 diagonals).
__host__ __device__ __forceinline__ int tdkv_bias_words(int n_head) { return n_head / 2 + 4; }
__host__ __device__ __forceinline__ size_t tdkv_bias_bytes(int rows, int n_head) {
  return (size_t)(rows + 16 * TDKV_KEY_TILES - 1) * tdkv_bias_words(n_head) * 4;
}
// With the bias, the diagonals a stage's exits reach: R + 51 (see the kernel).
__host__ __device__ __forceinline__ int tdkv_diagonals(int rows) { return rows + 3 * 16 + TDKV_ROW_SPLIT - 1; }
// The whole block: two stages, with the bias two bias runs, then the final
// reduction's buffer, which with the bias shares its room with the warps'
// per-stage table-gradient exits (R rows x H f32 a warp); with the bias also
// the window of the diagonals in progress and two stages' prefetched slice
// rows (R x H f32 each).
__host__ __device__ __forceinline__ size_t tdkv_smem(int rows, int n_head, int hd, bool bias) {
  const size_t red = (size_t)2 * TDKV_KEY_TILES * 16 * hd * sizeof(float);
  const size_t ex = bias ? (size_t)TDKV_KEY_TILES * TDKV_ROW_SPLIT * rows * n_head * sizeof(float) : 0;
  const size_t window = bias ? (size_t)(tdkv_diagonals(rows) + 2 * rows) * n_head * sizeof(float) : 0;
  return 2 * tdkv_stage_bytes(rows, n_head, hd) + (bias ? 2 * tdkv_bias_bytes(rows, n_head) : 0) +
         (ex > red ? ex : red) + window;
}

// rows per stage of the dK/dV kernel, or 0 when fewer than its row split fit;
// with the bias a multiple of the row split (each warp's rows then step by
// the split from one stage to the next) in the larger budget
int tdkv_rows(int n_head, int head_dim, bool bias) {
  for (int rows = TDKV_MAX_ROWS; rows >= TDKV_ROW_SPLIT; --rows) {
    if (bias && rows % TDKV_ROW_SPLIT) continue;
    if (tdkv_smem(rows, n_head, head_dim, bias) <= (size_t)(bias ? TDKV_BIAS_SMEM : TDKV_SMEM)) return rows;
  }
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
template <int HD>
__global__ void __launch_bounds__(TDKV_THREADS, 1)
    mqa_tc_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dcol,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int batch, int seq_len,
                      int n_head, int rows_per_stage, int causal, float scale) {
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

// dK/dV with the position bias (NG groups of 16 heads, H = 16 NG; entry
// flash_bias_dkv): the block, grid, staging and sums of the kernel above, and
// the logits of the grid kernel's arithmetic: q unrounded, s = (q.k) * scale
// + bf16(table[i - j + nk, h]); the bias run of a stage's R + 63 diagonals is
// staged once, as bf16 pairs of heads, beside the stage. The block also sums
// the table gradient, the unrounded ds of each (row i, key j, head h) into
// table row i - j + nk, without atomics and without a shared
// read-modify-write per element: a warp carries the sums of the diagonals
// that cross its 16 keys in registers (the ds fragment's own layout) and,
// after each of its rows, hands them on by one shuffle to the lanes of the
// keys 4 further on (its next row is 4 rows on, so a diagonal moves 4 keys).
// The sums of the 4 diagonals that leave its last keys are stored once to
// the warp's exit buffer; at the end of a stage the block adds the 16 warps'
// exits, in a fixed order, into its own (n_table, H) slice of dtable_part (a
// read-modify-write of one cell by one thread). One drain stage without rows
// after an item's last stage empties the registers. So two runs give the
// same bits; the caller sums the slices, one per block of the grid. The
// window of the table rows in progress (R + 51 of them) stays in shared
// memory across stages; a row leaves it once, when complete, added to the
// slice's old value, prefetched a stage ahead. Bound at the production shape
// (B=64, T=1025, MQA 32x16): its four products over the live pairs take
// 0.14 ms at the tensor-core peak (operations), its 1.08e9 exponentials 0.26
// ms at 16 a clock per SM; the instruction stream around each exponential
// (and the table gradient's shuffles and exits) binds it. The no-bias kernel
// stays a kernel of its own: built from one template, it lost 3% at the same
// arithmetic.
template <int HD, int NG>
__global__ void __launch_bounds__(TDKV_THREADS, 1)
    mqa_tc_bias_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dcol,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int batch, int seq_len,
                           int n_head, int rows_per_stage, int causal, float scale,
                           const float* __restrict__ table, int n_table, int nk,
                           float* __restrict__ dtable_part) {
  // the table gradient (tools/probe_flash.py times a build with it cut out)
  constexpr bool DTABLE = true;
  constexpr int KEYS = 16 * TDKV_KEY_TILES;  // keys of a key block
  constexpr int H = 16 * NG;
  const int width = n_head * HD;
  const int R = rows_per_stage;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t sb = tdkv_stage_bytes(R, n_head, HD);
  const size_t bb = tdkv_bias_bytes(R, n_head);
  auto q_of = [&](int buf) { return reinterpret_cast<bf16*>(smem + buf * sb); };  // [R][width]
  auto do_of = [&](int buf) { return q_of(buf) + (size_t)R * width; };              // [R][width]
  auto lse_of = [&](int buf) { return reinterpret_cast<float*>(do_of(buf) + (size_t)R * width); };  // [R][H]
  auto d_of = [&](int buf) { return lse_of(buf) + (size_t)R * n_head; };                            // [R][H]
  // [R + KEYS - 1][bias words]: bf16 pairs of heads of diagonal u = (i - r0) - (j - k0) + KEYS - 1
  auto bias_of = [&](int buf) { return reinterpret_cast<uint32_t*>(smem + 2 * sb + buf * bb); };
  float* red = reinterpret_cast<float*>(smem + 2 * sb + 2 * bb);  // [2][KEY_TILES][16][HD]
  float* ex_all = red;                                             // [warps][R][H]
  const int n_diag = tdkv_diagonals(R);
  // the window [n_diag][H] of the table rows in progress (row l at l %
  // n_diag), then two stages' prefetched slice rows [2][R][H]
  float* win = ex_all + (size_t)TDKV_KEY_TILES * TDKV_ROW_SPLIT * R * n_head;
  float* pf = win + (size_t)n_diag * n_head;
  const int bw = tdkv_bias_words(n_head);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int tile = warp % TDKV_KEY_TILES, part = warp / TDKV_KEY_TILES;
  const int n_items = (seq_len + KEYS - 1) / KEYS * batch;
  float* ex = ex_all + (size_t)warp * R * n_head;
  float* slice = dtable_part + (size_t)blockIdx.x * n_table * n_head;
  for (int i = threadIdx.x; i < n_diag * n_head; i += blockDim.x) win[i] = 0.f;
  // (the first stage's __syncthreads orders these before any use)

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
      // the bias run of stage st (table rows l0 .. l0 + R + KEYS - 2, rounded
      // to bf16; rows outside the table, masked pairs only, read 0), loaded
      // into registers before a stage's work and stored after it, so that the
      // loads' latency hides behind the products
      constexpr int NB = (TDKV_MAX_ROWS + KEYS - 1) * 8 * NG / TDKV_THREADS + 1;
      float2 bias_next[NB];
      auto bias_load = [&](int st) {
        const int l0 = nk + r_begin + st * R - k0 - (KEYS - 1), pairs = n_head / 2;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int i = threadIdx.x + j * TDKV_THREADS, u = i / pairs, l = l0 + u;
          bias_next[j] = make_float2(0.f, 0.f);
          if (u < R + KEYS - 1 && l >= 0 && l < n_table)
            bias_next[j] = *reinterpret_cast<const float2*>(table + (size_t)l * n_head + 2 * (i - u * pairs));
        }
      };
      auto bias_store = [&](int st) {
        uint32_t* bs = bias_of(st & 1);
        const int pairs = n_head / 2;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int i = threadIdx.x + j * TDKV_THREADS, u = i / pairs;
          if (u < R + KEYS - 1) bs[u * bw + i - u * pairs] = pack_bf16(bias_next[j].x, bias_next[j].y);
        }
      };
      // the slice rows that stage st completes (table rows nk + r0 - k0 - 63 +
      // u, u < R), prefetched a stage ahead into buffer st & 1: no stage before
      // st of this item writes them
      auto pf_load = [&](int st) {
        const int l0 = nk + r_begin + st * R - k0 - (KEYS - 1);
        float* dst = pf + (size_t)(st & 1) * R * n_head;
        for (int i = 4 * threadIdx.x; i < R * n_head; i += 4 * blockDim.x) {  // 16 bytes a copy
          const int l = l0 + i / n_head;
          const bool in = l >= 0 && l < n_table;
          cp_async16(dst + i, slice + (in ? (size_t)l * n_head + i % n_head : 0), in);
        }
      };
      stage(0);
      bias_load(0);
      bias_store(0);
      pf_load(0);
      cp_async_commit();

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
      // the sums of the diagonals crossing this lane's keys and heads, in the
      // ds fragment's layout (key kw0 + g + 8 (e >> 1), head 16 hg + 8 t + 2 c + (e & 1))
      float dg[NG][2][4];
#pragma unroll
      for (int hg = 0; hg < NG; ++hg)
#pragma unroll
        for (int t = 0; t < 2; ++t) dg[hg][t][0] = dg[hg][t][1] = dg[hg][t][2] = dg[hg][t][3] = 0.f;

      // the item's stages, and one drain stage without rows
      for (int st = 0; st < n_stages + 1; ++st) {
        const bool real = st < n_stages;
        // this stage's sums, added to the item's in f32 after it: a sum of a few
        // tensor-core accumulations at a time, so rounding does not build up
        float sdk[HD / 8][4], sdv[HD / 8][4];
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sdk[nt][e] = sdv[nt][e] = 0.f;
        if (real) {
          if (st + 1 < n_stages) {
            stage(st + 1);  // overlaps this stage's work
            bias_load(st + 1);
          } else {
            cp_async_commit();
          }
          if (st + 1 < n_stages) pf_load(st + 1);
          cp_async_commit();
          cp_async_wait<2>();  // this stage and its prefetched slice rows
        }
        __syncthreads();
        const int r0 = r_begin + st * R, nr = real ? min(R, seq_len - r0) : 0, buf = st & 1;
        // the warp's rows part, part + 4, ...: every step of the stage runs
        // (past the rows, only the diagonal sums move on)
        for (int r = part; r < R; r += TDKV_ROW_SPLIT) {
          const int i = r0 + r;
          const bool live = r < nr && !(causal && i < kw0);  // warp-uniform
          if (live) {
            const bool edge = (causal && i < kw0 + 15) || kw0 + 16 > seq_len;  // the mask's rows
            const bf16* qrow = q_of(buf) + (size_t)r * width;
            const bf16* drow = do_of(buf) + (size_t)r * width;
            const float* lrow = lse_of(buf) + (size_t)r * n_head;
            const float* drw = d_of(buf) + (size_t)r * n_head;
            // bias row of key g (+8 for the second half): u = r - (16 tile + g) + KEYS - 1
            const uint32_t* brow = bias_of(buf) + (r - 16 * tile - g + KEYS - 1) * bw + c;
            // one 16-head group; as a lambda (written inline in the row loop,
            // the kernel took 11% longer)
            auto heads16 = [&](int h0, float (&dgh)[2][4]) {
              // B fragments of the 16 heads: q and dO with k = dim, and with k = head
              uint32_t qf[HD / 16][4], df[HD / 16][4], qt[HD / 16][4], dt[HD / 16][4];
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk) {
                const int at = swz<HD>(h0 + ldsm_row(lane), 2 * kk + (ldsm_col(lane) >> 3));
                const int at_t = swz<HD>(h0 + ldsm_row_t(lane), 2 * kk + (ldsm_col_t(lane) >> 3));
                ldsm_x4(qf[kk], qrow + at);
                ldsm_x4(df[kk], drow + at);
                ldsm_x4_t(qt[kk], qrow + at_t);
                ldsm_x4_t(dt[kk], drow + at_t);
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
                uint32_t bias2[2];  // bf16 pairs of heads hh, hh + 1 for keys g, g + 8
                bias2[0] = brow[(h0 + 8 * t) / 2];
                bias2[1] = brow[(h0 + 8 * t) / 2 - 8 * bw];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float lv = (e & 1) ? l2.y : l2.x, dv_ = (e & 1) ? d2.y : d2.x;
                  const int key = kw0 + g + (e >> 1) * 8;
                  float sv = st_[t][e];
                  sv = fmaf(sv, scale, (e & 1) ? bf_hi(bias2[e >> 1]) : bf_lo(bias2[e >> 1]));
                  float pv = ex2(fmaf(sv, LOG2E, -lv * LOG2E));
                  if (edge && (key >= seq_len || (causal && key > i))) pv = 0.f;
                  p[t][e] = pv;
                  ds[t][e] = pv * (dpt[t][e] - dv_);
                  if constexpr (DTABLE) dgh[t][e] += ds[t][e];
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
            };
#pragma unroll
            for (int hg = 0; hg < NG; ++hg) heads16(16 * hg, dg[hg]);
          }
          if constexpr (DTABLE) {
            // the next row of the warp is 4 on, so each diagonal moves 4 keys on:
            // key kl takes key kl - 4's sum (lane g - 4, or the other half of lane
            // g + 4), keys 0..3 start at 0, and keys 12..15 (the second half of
            // lanes g >= 4) leave: lane g < 4 stores key 12 + g's sums at slot
            // r - part + 3 - g, i.e. at diagonal i - kw0 - 12 - g less the warp's base
            // r0 + part - kw0 - 15
#pragma unroll
            for (int hg = 0; hg < NG; ++hg)
#pragma unroll
              for (int t = 0; t < 2; ++t) {
                float out[2];
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  const float v0 = __shfl_xor_sync(0xffffffffu, dg[hg][t][j], 16);
                  const float v1 = __shfl_xor_sync(0xffffffffu, dg[hg][t][2 + j], 16);
                  out[j] = v1;
                  dg[hg][t][j] = g >= 4 ? v0 : 0.f;
                  dg[hg][t][2 + j] = g >= 4 ? v1 : v0;
                }
                if (g < 4)
                  *reinterpret_cast<float2*>(ex + (size_t)(r - part + 3 - g) * n_head + 16 * hg + 8 * t + 2 * c) =
                      make_float2(out[0], out[1]);
              }
          }
        }
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) dka[nt][e] += sdk[nt][e], dva[nt][e] += sdv[nt][e];
        if (st + 1 < n_stages) bias_store(st + 1);  // its buffer was last read a stage ago
        __syncthreads();  // the next iteration's copy overwrites this buffer
        if constexpr (DTABLE) {
          // the warps' exits of this stage, in a fixed order, into the window:
          // diagonal u (table row l = nk + r0 - k0 - 63 + u) is slot u - 48 -
          // part + 16 tile of warp (tile, part). Rows u < R are then complete
          // for this item (later stages start R rows on), and every row after
          // the drain stage: they go into the block's slice (their old values
          // prefetched, but for the drain's) and leave the window.
          const int l0 = nk + r0 - k0 - (KEYS - 1);
          const float* pfs = pf + (size_t)(st & 1) * R * H;
          for (int idx = threadIdx.x; idx < n_diag * H; idx += blockDim.x) {
            const int u = idx / H, h = idx - u * H, l = l0 + u;
            if (l < 0 || l >= n_table) continue;
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < TDKV_KEY_TILES * TDKV_ROW_SPLIT; ++w) {
              const int slot = u - 48 - w / TDKV_KEY_TILES + 16 * (w % TDKV_KEY_TILES);
              if (slot >= 0 && slot < R) sum += ex_all[((size_t)w * R + slot) * H + h];
            }
            float* wc = win + (size_t)(l % n_diag) * H + h;
            const float acc = *wc + sum;
            if (real && u >= R) {
              *wc = acc;
            } else {
              slice[(size_t)l * H + h] = (real ? pfs[idx] : slice[(size_t)l * H + h]) + acc;
              *wc = 0.f;
            }
          }
          __syncthreads();  // the exits are read before the next stage stores them
        }
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
         tdkv_rows(n_head, head_dim, false) >= TDKV_ROW_SPLIT;
}

// with the bias, the dK/dV kernel carries the table gradient of each 16-head
// group in registers: 1 or 2 groups (H = 16 or 32, LTHM's), hd in {16, 32, 64}
bool tc_bias_dkv_ok(int kvh, int n_head, int head_dim, int is_bf16) {
  return is_bf16 && kvh == 1 && (n_head == 16 || n_head == 32) &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64) &&
         tdkv_rows(n_head, head_dim, true) >= TDKV_ROW_SPLIT;
}

// the bias tensor-core dQ kernel takes bf16, MQA, 1 to TC_WARPS groups of 16
// heads and hd in {16, 32, 64}
bool tc_bias_dq_ok(int kvh, int n_head, int head_dim, int is_bf16) {
  return is_bf16 && kvh == 1 && n_head % 16 == 0 && n_head / 16 <= TC_WARPS &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

// mqa_mma_dq_kernel takes the bias dQ of more groups (up to 512 heads): bf16,
// MQA, 16-head groups and hd in {16, 32, 64}, where a 16-key K/V tile and its
// bias run fit its budget
bool mma_dq_ok(int kvh, int n_head, int head_dim, int is_bf16) {
  if (!(is_bf16 && kvh == 1 && n_head % 16 == 0 && n_head <= 512 &&
        (head_dim == 16 || head_dim == 32 || head_dim == 64)))
    return false;
  const int qrows = n_head >= 256 ? 1 : 16 / (n_head / 16);
  return (size_t)2 * head_dim * (3 * 16 + 8) + (size_t)2 * n_head * bias_ustride(qrows, 16) <=
         (size_t)SMEM_BUDGET;
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

template <int HD>
int launch_tc_bias_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* dcol, void* dq, int batch, int seq_len, int n_head, int causal, Bias bias,
                      cudaStream_t stream) {
  const int groups = n_head / 16;
  const int slices = TC_WARPS / groups;  // row slices of a block
  const int rows = slices * tc_dq_rows_per_warp<HD>();
  const int n_qb = (seq_len + rows - 1) / rows;
  if ((long long)n_qb * batch > 0x7fffffffLL) return -1;
  const size_t smem = tc_bias_smem<HD, TC_KEY_TILE>(rows, n_head);
  cudaError_t e = cudaFuncSetAttribute(mqa_tc_bias_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = (float)(1.0 / sqrt((double)HD));
  mqa_tc_bias_dq_kernel<HD><<<n_qb * batch, slices * groups * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(dcol),
      static_cast<bf16*>(dq), bias.table, batch, seq_len, n_head, rows, n_qb, causal, scale, bias.n_table, bias.nk);
  return (int)cudaGetLastError();
}

// the dK/dV kernel's shared memory for this shape, opted in above 48 KB, and
// the blocks the card holds at once (SMs x blocks per SM); NG > 0: with the
// bias, H = 16 NG
template <int HD, int NG>
int tdkv_prepare(int n_head, size_t* smem, int* resident) {
  *smem = tdkv_smem(tdkv_rows(n_head, HD, NG > 0), n_head, HD, NG > 0);
  const void* kernel;
  if constexpr (NG == 0) kernel = (const void*)mqa_tc_dkv_kernel<HD>;
  else kernel = (const void*)mqa_tc_bias_dkv_kernel<HD, NG>;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (rc) return rc;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TDKV_THREADS, *smem);
  *resident = sms * per_sm;
  return rc ? rc : (*resident < 1 ? -1 : 0);
}

// the persistent dK/dV grid: one block per resident slot, or one per item
// when there are fewer; with the bias also the number of table-gradient slices
int tdkv_items(int batch, int seq_len) {
  return (seq_len + 16 * TDKV_KEY_TILES - 1) / (16 * TDKV_KEY_TILES) * batch;
}

template <int HD, int NG>
int tdkv_grid(int batch, int seq_len, int n_head, size_t* smem) {
  int resident = 0;
  const int rc = tdkv_prepare<HD, NG>(n_head, smem, &resident);
  if (rc) return rc > 0 ? -rc : rc;
  const int items = tdkv_items(batch, seq_len);
  return items < resident ? items : resident;
}

template <int HD, int NG>
int launch_tc_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dcol, void* dk, void* dv, void* dtable_part, int batch, int seq_len,
                  int n_head, int causal, Bias bias, cudaStream_t stream) {
  size_t smem = 0;
  const int grid = tdkv_grid<HD, NG>(batch, seq_len, n_head, &smem);
  if (grid < 1) return grid < 0 ? -grid : -1;
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int rows = tdkv_rows(n_head, HD, NG > 0);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  const float *lf = static_cast<const float*>(lse), *df = static_cast<const float*>(dcol);
  bf16 *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
  if constexpr (NG == 0)
    mqa_tc_dkv_kernel<HD><<<grid, TDKV_THREADS, smem, stream>>>(qb, kb, vb, db, lf, df, dkb, dvb, batch,
                                                                seq_len, n_head, rows, causal, scale);
  else
    mqa_tc_bias_dkv_kernel<HD, NG><<<grid, TDKV_THREADS, smem, stream>>>(
        qb, kb, vb, db, lf, df, dkb, dvb, batch, seq_len, n_head, rows, causal, scale, bias.table,
        bias.n_table, bias.nk, static_cast<float*>(dtable_part));
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
    return which == 0 ? launch_tc_dkv<HD, 0>(q, k, v, dout, lse, dcol, dk, dv, nullptr, batch,    \
                                             seq_len, n_head, causal, bias, s)                    \
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
  } else if (which == 0 && tc_bias_dkv_ok(kvh, n_head, head_dim, is_bf16)) {
#define TB_CASE(HD)                                                                               \
  case HD:                                                                                        \
    return n_head == 16 ? launch_tc_dkv<HD, 1>(q, k, v, dout, lse, dcol, dk, dv, dtable_part,     \
                                               batch, seq_len, n_head, causal, bias, s)           \
                        : launch_tc_dkv<HD, 2>(q, k, v, dout, lse, dcol, dk, dv, dtable_part,     \
                                               batch, seq_len, n_head, causal, bias, s);
    switch (head_dim) {
      TB_CASE(16)
      TB_CASE(32)
      TB_CASE(64)
      default: return -1;
    }
#undef TB_CASE
  } else if (which == 1 && tc_bias_dq_ok(kvh, n_head, head_dim, is_bf16)) {
    switch (head_dim) {
      case 16: return launch_tc_bias_dq<16>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head, causal, bias, s);
      case 32: return launch_tc_bias_dq<32>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head, causal, bias, s);
      case 64: return launch_tc_bias_dq<64>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head, causal, bias, s);
      default: return -1;
    }
  } else if (which == 1 && mma_dq_ok(kvh, n_head, head_dim, is_bf16)) {
    switch (head_dim) {
      case 16: return launch_mma_dq<16, true>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head, causal, bias, s);
      case 32: return launch_mma_dq<32, true>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head, causal, bias, s);
      case 64: return launch_mma_dq<64, true>(q, k, v, dout, lse, dcol, dq, batch, seq_len, n_head, causal, bias, s);
      default: return -1;
    }
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

// The dK/dV grid of this call on the current device: the blocks of the
// persistent tensor-core kernel (with the bias, also its table-gradient
// slices), or 0 where the FMA kernels take the call; negative on an error.
int dkv_grid_of_call(int batch, int seq_len, int n_head, int kvh, int head_dim, int is_bf16, int bias) {
  if (!(bias ? tc_bias_dkv_ok(kvh, n_head, head_dim, is_bf16) : tc_bwd_ok(kvh, n_head, head_dim, is_bf16)))
    return 0;
  size_t smem = 0;
  const int ng = bias ? n_head / 16 : 0;
#define GRID_CASE(HD)                                                                             \
  case HD:                                                                                        \
    return ng == 0 ? tdkv_grid<HD, 0>(batch, seq_len, n_head, &smem)                              \
                   : ng == 1 ? tdkv_grid<HD, 1>(batch, seq_len, n_head, &smem)                    \
                             : tdkv_grid<HD, 2>(batch, seq_len, n_head, &smem);
  switch (head_dim) {
    GRID_CASE(16)
    GRID_CASE(32)
    GRID_CASE(64)
    default: return -1;
  }
#undef GRID_CASE
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

// The number of table-gradient slices flash_bias_dkv writes for this shape on
// the current device: one per block of its persistent grid, or one where the
// FMA kernels take the call; negative on an error.
extern "C" int flash_bias_dkv_slices(int batch, int seq_len, int n_head, int kvh, int head_dim,
                                     int is_bf16) {
  const int grid = dkv_grid_of_call(batch, seq_len, n_head, kvh, head_dim, is_bf16, 1);
  return grid == 0 ? 1 : grid;
}

// The (key block, batch row) items one block of the dK/dV kernel walks for
// this shape on the current device (at most), without (bias = 0) or with the
// position bias; 0 where the FMA kernels take the call, negative on an error.
extern "C" int flash_dkv_items_per_block(int batch, int seq_len, int n_head, int kvh,
                                         int head_dim, int is_bf16, int bias) {
  const int grid = dkv_grid_of_call(batch, seq_len, n_head, kvh, head_dim, is_bf16, bias);
  if (grid <= 0) return grid;
  return (tdkv_items(batch, seq_len) + grid - 1) / grid;
}
