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
template <typename T, int HD>
__global__ void fma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dcol,
                              T* __restrict__ dq, int seq_len, int n_head, int kvh,
                              int rows_per_block, int causal, float scale) {
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
    qs[d] = round_to<T>(qs[d] * scale);
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
    const float ds = round_to<T>(expf(s - l) * (dp - dd));
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, kf[d], acc[d]);
  }
  store_row<T, HD>(dq + q_off, acc, scale);
}

// One thread per (key, kv head): dk and dv over the live query rows and every
// head that reads this kv head (all H at MQA, one at MHA).
template <typename T, int HD>
__global__ void fma_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dcol,
                               T* __restrict__ dk, T* __restrict__ dv, int seq_len, int n_head,
                               int kvh, int keys_per_block, int causal, float scale) {
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
        s = fmaf(round_to<T>(qv[d] * scale), kf[d], s);
        dp = fmaf(dov[d], vf[d], dp);
      }
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

template <typename T, int HD>
int launch_fma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dcol, void* dq, void* dk, void* dv, int batch, int seq_len,
               int n_head, int kvh, int causal, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const int keys = kvh >= THREADS ? 1 : THREADS / kvh;
  fma_dkv_kernel<T, HD><<<dim3((seq_len + keys - 1) / keys, batch), keys * kvh, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<T*>(dk), static_cast<T*>(dv), seq_len,
      n_head, kvh, keys, causal, scale);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int rows = n_head >= THREADS ? 1 : THREADS / n_head;
  fma_dq_kernel<T, HD><<<dim3((seq_len + rows - 1) / rows, batch), rows * n_head, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dcol), static_cast<T*>(dq), seq_len, n_head, kvh, rows, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* dcol, void* dq, void* dk, void* dv, int batch, int seq_len,
                 int n_head, int kvh, int head_dim, int causal, cudaStream_t s) {
  switch (head_dim) {
    case 8: return launch_fma<T, 8>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, kvh, causal, s);
    case 16: return launch_fma<T, 16>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, kvh, causal, s);
    case 32: return launch_fma<T, 32>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, kvh, causal, s);
    case 64: return launch_fma<T, 64>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, kvh, causal, s);
    default: return -1;
  }
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
template <int HD>
__global__ void mqa_mma_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ dcol,
                                  bf16* __restrict__ dq, int seq_len, int n_head,
                                  int rows_per_block, int tile_rows, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = tile_rows + 8;           // padded K^T rows
  bf16* ks = reinterpret_cast<bf16*>(smem);    // [tile_rows][HD]
  bf16* vs = ks + (size_t)tile_rows * HD;      // [tile_rows][HD]
  bf16* kt = vs + (size_t)tile_rows * HD;      // [HD][kstride]

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
  load_a<HD>(qa, q + q_row, HD, active ? 16 : 0, g, c, scale);
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
    __syncthreads();
    const int j1 = min(t1, my_keys);
    for (int j0 = t0; j0 < j1; j0 += 16) {
      float s0[4], s1[4], dp0[4], dp1[4];
      head_key_tile<HD>(s0, qa, ks, j0 - t0, g, c);
      head_key_tile<HD>(s1, qa, ks, j0 - t0 + 8, g, c);
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

// dK/dV: a warp owns 16 keys and a quarter of the block's query rows; the block
// stages its rows' qs, q, dO, lse and D in shared memory.
template <int HD>
__global__ void mqa_mma_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ dcol,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, int seq_len,
                                   int n_head, int rows_per_stage, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = n_head * HD;
  bf16* qs_s = reinterpret_cast<bf16*>(smem);                      // [R][width] round(q*scale)
  bf16* q_s = qs_s + (size_t)rows_per_stage * width;               // [R][width] q
  bf16* do_s = q_s + (size_t)rows_per_stage * width;               // [R][width] dO
  float* lse_s = reinterpret_cast<float*>(do_s + (size_t)rows_per_stage * width);  // [R][H]
  float* d_s = lse_s + (size_t)rows_per_stage * n_head;                            // [R][H]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int tile = warp % DKV_KEY_TILES, part = warp / DKV_KEY_TILES;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * 16 * DKV_KEY_TILES;  // block's first key
  const int kw0 = k0 + 16 * tile;                  // warp's first key

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
  for (int r0 = causal ? k0 : 0; r0 < seq_len; r0 += rows_per_stage) {
    const int nr = min(rows_per_stage, seq_len - r0);
    __syncthreads();
    const __nv_bfloat162* qsrc = reinterpret_cast<const __nv_bfloat162*>(q + qbase + (size_t)r0 * width);
    const __nv_bfloat162* dsrc = reinterpret_cast<const __nv_bfloat162*>(dout + qbase + (size_t)r0 * width);
    for (int i = threadIdx.x; i < nr * width / 2; i += blockDim.x) {
      const __nv_bfloat162 qp = qsrc[i];
      reinterpret_cast<__nv_bfloat162*>(q_s)[i] = qp;
      reinterpret_cast<uint32_t*>(qs_s)[i] =
          pack_bf16(__bfloat162float(qp.x) * scale, __bfloat162float(qp.y) * scale);
      reinterpret_cast<__nv_bfloat162*>(do_s)[i] = dsrc[i];
    }
    for (int i = threadIdx.x; i < nr * n_head; i += blockDim.x) {
      lse_s[i] = lse[rbase + (size_t)r0 * n_head + i];
      d_s[i] = dcol[rbase + (size_t)r0 * n_head + i];
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
            const int key = kw0 + g + (e >> 1) * 8;
            const int hh = h0 + 8 * t + 2 * c + (e & 1);
            const bool live = key < seq_len && (!causal || key <= i);
            const float pv = live ? expf(st[t][e] - lrow[hh]) : 0.f;
            p[t][e] = pv;
            ds[t][e] = pv * (dpt[t][e] - dd[hh]);
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
  if (part != 0) return;
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

// rows staged at a time by the dK/dV kernel, or 0 when one row does not fit
__host__ int dkv_rows_per_stage(int n_head, int head_dim) {
  const size_t row_bytes = (size_t)3 * n_head * head_dim * sizeof(bf16) + (size_t)2 * n_head * 4;
  const size_t fit = SMEM_BUDGET / row_bytes;
  return (int)(fit < DKV_MAX_ROWS ? fit : DKV_MAX_ROWS);
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dcol, void* dq, void* dk, void* dv, int batch, int seq_len,
               int n_head, int causal, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)HD));
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  const float* lb = static_cast<const float*>(lse);
  const float* cb = static_cast<const float*>(dcol);

  // dK/dV
  const int rows = dkv_rows_per_stage(n_head, HD);
  const size_t row_bytes = (size_t)3 * n_head * HD * sizeof(bf16) + (size_t)2 * n_head * 4;
  size_t smem = rows * row_bytes;
  const size_t red_bytes = (size_t)2 * DKV_KEY_TILES * 16 * HD * sizeof(float);
  if (smem < red_bytes) smem = red_bytes;
  const int key_block = 16 * DKV_KEY_TILES;
  mqa_mma_dkv_kernel<HD><<<dim3((seq_len + key_block - 1) / key_block, batch),
                           32 * DKV_KEY_TILES * DKV_ROW_SPLIT, smem, stream>>>(
      qb, kb, vb, db, lb, cb, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq_len, n_head,
      rows, causal, scale);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;

  // dQ
  const int groups = n_head / 16;
  int qrows = 16 / groups;  // up to 16 warps per block
  if (qrows < 1) qrows = 1;
  auto smem_of = [](int t) { return (size_t)2 * HD * (3 * t + 8); };
  int tile = KV_TILE;
  while (tile > 16 && smem_of(tile) > (size_t)SMEM_BUDGET) tile >>= 1;
  int need = 16;
  while (need < seq_len) need <<= 1;
  if (tile > need) tile = need;
  mqa_mma_dq_kernel<HD><<<dim3((seq_len + qrows - 1) / qrows, batch), qrows * groups * 32,
                          smem_of(tile), stream>>>(qb, kb, vb, db, lb, cb, static_cast<bf16*>(dq),
                                                   seq_len, n_head, qrows, tile, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, cudaGetLastError() after a refused launch, or -1 for
// a shape the kernels do not take (head_dim, n_head > 1024, batch > 65535).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dcol, void* dq, void* dk, void* dv,
                         int batch, int seq_len, int n_head, int kvh, int head_dim, int causal,
                         int is_bf16, void* stream) {
  if (n_head < 1 || n_head > 1024 || batch < 1 || seq_len < 1 || batch > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && kvh == 1 && n_head % 16 == 0 && n_head <= 512 &&
      dkv_rows_per_stage(n_head, head_dim) >= DKV_ROW_SPLIT) {
    switch (head_dim) {
      case 16: return launch_mma<16>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, causal, s);
      case 32: return launch_mma<32>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, causal, s);
      case 64: return launch_mma<64>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, causal, s);
      default: break;  // other head dims take the FMA kernels
    }
  }
  if (is_bf16)
    return dispatch_fma<bf16>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, kvh,
                              head_dim, causal, s);
  return dispatch_fma<float>(q, k, v, dout, lse, dcol, dq, dk, dv, batch, seq_len, n_head, kvh,
                             head_dim, causal, s);
}
