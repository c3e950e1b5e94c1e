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
// Bound on an H100 SXM at the LTHM-base training shape (B=64, T=257, H=32,
// hd=16, MQA, bf16, causal, one call): it moves about 57 MB (q, dO, dq at
// 16.8 MB each; k, v, dk, dv; lse and D), about 17 us at 3.35 TB/s, and does
// five products over the live pairs, about 10.9 GFLOP or 11 us at the 989
// TFLOP/s bf16 tensor-core peak. So it is bound by bytes.
//
// Design: two kernels, FA2-style, so that no output is written by two blocks
// and no float atomics are used (two runs give the same bits):
// - a dK/dV kernel over (batch row, key tile), which walks every causally
//   live query row and every head of it and accumulates its keys' dK and dV;
// - a dQ kernel over (batch row, query rows), which walks the live keys.
// Both recompute s and p from lse. Two specializations of each, chosen from
// the inputs:
// - tensor cores (bf16, MQA, heads a multiple of 16, hd in {16, 32, 64}, the
//   training path). At MQA the 16 heads of one query row share K, V and the
//   causal extent. In the dQ kernel they are the 16 rows of an
//   mma.sync m16n8k16 tile, as in the forward: S = qs.K^T, dP = dO.V^T and
//   dq += round(dS).K run on the tensor cores, and the dS accumulator,
//   rounded, is already the A operand of the dq product. In the dK/dV kernel
//   a warp owns 16 keys and the roles turn over: S^T = K.qs^T and
//   dP^T = V.dO^T take the warp's K and V as A operands held in registers,
//   and dV += round(P^T).dO, dK += round(dS^T).q contract over the 16 heads of
//   a row. The query rows a block needs are staged in shared memory (qs, q,
//   dO, lse, D); four warps split each key tile's rows and add their sums in
//   a fixed order at the end.
// - FMA (float32, MHA, other head counts and dims): one thread per (query
//   row, head) for dQ and per (key, kv head) for dK/dV.
// No wgmma or TMA yet: a right and simple kernel first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bias.cuh"

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

DkvGrid dkv_grid(int batch, int seq_len, int causal, bool bias, int resident_blocks) {
  const int n_kb = (seq_len + 16 * DKV_KEY_TILES - 1) / (16 * DKV_KEY_TILES);
  if (!bias) return DkvGrid{n_kb, batch, 1, 0};
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
  return dkv_grid(batch, seq_len, causal, BIAS, BIAS ? dkv_resident_blocks<HD, BIAS>(n_head) : 0);
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

// One backward half for the call's types: which = 0 dK/dV (and, with the bias,
// the table gradient into dtable_part), 1 dQ.
template <bool BIAS>
int backward(int which, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* dcol, void* dq, void* dk, void* dv, void* dtable_part,
             int batch, int seq_len, int n_head, int kvh, int head_dim, int causal, int is_bf16,
             Bias bias, cudaStream_t s) {
  if (n_head < 1 || n_head > 1024 || batch < 1 || seq_len < 1 || batch > 65535) return -1;
  if (mma_ok(kvh, n_head, head_dim, is_bf16, BIAS)) {
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
