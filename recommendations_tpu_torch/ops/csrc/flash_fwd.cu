// Flash-attention forward over folded heads, for Hopper (sm_90a).
//
// Replaces the TPU kernel recommendations_tpu/ops/fused_attention.py::_fwd_kernel
// (launched by _fused_fwd_impl for T_pad <= 512) and computes what the no-bias
// mode of _fwd_kernel_grid computes for longer sequences (an online softmax
// over key chunks), so T is not capped by shared memory.
//
// Layout, as at the JAX call site: q and o are (B, T, H*hd) with the heads in
// the last dimension; k and v are (B, T, hd) for multi-query attention or
// (B, T, H*hd) for multi-head attention; lse is (B, T, H) float32.
//
// Arithmetic mirrors the TPU kernel: q is scaled by 1/sqrt(hd) in f32 and
// rounded to the operand type; s = q.k accumulates in f32; an online softmax
// over key chunks: per chunk the running max m rises to the chunk's, what
// earlier chunks summed is rescaled by exp(m_old - m), p = exp(s - m) and
// l = sum(p) in f32, and the PV product uses p rounded to v's type with f32
// accumulation; o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
// Keys past the sequence end, and past the row under the causal mask, add
// nothing, which is what the TPU kernel's -1e30 mask yields for every row
// that sees a key. The chunk is the TPU kernel's 512 keys in the FMA kernel,
// and 16 keys (its tile) in the tensor-core kernel, which also takes each
// exponential as 2^(s log2(e) - m log2(e)) on the special-function unit.
//
// Bound on an H100 SXM (MQA 32x16, bf16, causal, one call): at B=64, T=257
// the call moves 36.8 MB (q, o, k, v, lse), 11.0 us at 3.35 TB/s, and does
// 4.3 GFLOP, 4.4 us at the 989 TFLOP/s tensor-core peak; at B=16, T=1025,
// 36.7 MB and 17.2 GFLOP, 17.4 us. Either way the exponentials bind
// harder: one per live (row, head, key), B H T (T+1) / 2 = 269 M at T=1025,
// 64 us at 16 a clock per SM (132 SMs, 1.98 GHz); at hd=16 the softmax work
// around the products, not the products, sets the pace.
//
// Four kernels, chosen from the inputs:
// - mqa_tc_fwd_kernel (bf16, MQA, 16 to 128 heads in groups of 16, hd in
//   {16, 32, 64}; the no-bias path of LTHM). The 16 heads of one query row
//   share K, V and the causal extent, so they are the 16 rows of an
//   mma.sync m16n8k16 tile, and a warp owns 64 / hd such rows: one K/V
//   fragment load (ldmatrix from shared memory; V transposed by
//   ldmatrix.trans) serves them all. Against the softmax work:
//   * one pass: S = qs.K^T is computed once per 16-key tile, and the online
//     softmax rescales acc and l when the tile raises a row's max (the S
//     accumulator, exponentiated and rounded to bf16, is the PV product's A
//     fragment);
//   * exp2 on the special-function unit (ex2.approx, one FFMA for the
//     argument), and the mask compare only on a row's diagonal tile and the
//     ragged last tile;
//   * K and V tiles of 64 keys arrive by 16-byte cp.async, two in flight, so
//     the copy of the next tile overlaps the work on this one;
//   * heavy first: under the causal mask the query blocks with the longest
//     extent take the first block indices, so the scheduler starts the long
//     blocks first and the short ones fill in behind.
//   mma.sync and not wgmma: at hd=16 the products are a quarter of the
//   exponential floor (above), so the tensor-core route is not what bounds
//   the kernel; wgmma's 64-row tiles would also mix 4 query rows of
//   different causal extents in one tile.
// - mqa_tc_bias_fwd_kernel (the position-bias case, entry flash_bias_fwd,
//   for the same inputs: the production LTHM's path): the same design, with
//   the bias run of each head staged per 64-key tile beside K and V (see
//   the kernel). It is a kernel of its own, not a template case of the one
//   above, so that the no-bias kernel compiles as it did.
// - mqa_mma_kernel (the position-bias case for the bias head counts the
//   one-pass kernel does not take, more than TC_WARPS groups of 16, up to
//   512 heads): a warp owns 16 heads of one query row; two passes per staged
//   tile (max, then the exponentials), as the tile is the softmax chunk.
// - fma_kernel (float32, MHA, other head counts): a thread owns one (query
//   row, head) pair, the heads of a row in neighbouring lanes, so a warp reads
//   q and writes o as one contiguous run and its lanes share the causal extent.
//
// The relative-position-bias case (entry flash_bias_fwd) replaces the
// bias_mode forward of _fwd_kernel_grid (launched by _fused_bias_fwd_impl),
// with the grid kernel's arithmetic: s = (q.k) * scale in f32 with q
// unrounded, plus the table entry table[q - k + nk, h] rounded to bf16 (the
// TPU kernel expands the table in bf16 for any operand type), before the
// mask. The table is (L, H) float32. Its softmax chunk is 16 keys (and exp2)
// in mqa_tc_bias_fwd_kernel, the staged tile in mqa_mma_kernel, whose block
// stages, per key tile, the bias its rows need: for the rows [row0, row0 + R)
// and keys [t0, t1) that is the run table[row0 - (t1 - 1) + nk .. row0 + R -
// 1 - t0 + nk] of every head, one contiguous, reversed run per head; and 512
// keys in fma_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bias.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int KV_CHUNK = 512;  // softmax chunk, the TPU kernel's KV_CHUNK
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_BUDGET = 48 * 1024;  // K + V staging, bytes per block
constexpr int THREADS = 256;            // target (row, head) pairs per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int HD>
__device__ __forceinline__ float dot(const float (&q)[HD], const T* __restrict__ kr) {
  float kf[HD];
  load_row<T, HD>(kr, kf);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(q[d], kf[d], s);
  return s;
}

// Block-wide copy of n_elems contiguous elements (a multiple of 16 bytes).
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src, int n_elems) {
  const int n_vec = n_elems * (int)sizeof(T) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) d[i] = s[i];
}

template <typename T, int HD, bool BIAS>
__global__ void fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                           int seq_len, int n_head, int kvh, int rows_per_block, int tile_rows,
                           int causal, float scale, const float* __restrict__ table, int nk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = kvh * HD;  // K/V row width in elements
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)tile_rows * width;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int r_local = threadIdx.x / n_head;
  const int h = threadIdx.x - r_local * n_head;
  const int row = row0 + r_local;
  const bool active = r_local < rows_per_block && row < seq_len;
  const int kv_col = (kvh == 1 ? 0 : h) * HD;

  // keys any row of this block attends to (block-uniform), and this row's
  const int last_row = min(row0 + rows_per_block, seq_len) - 1;
  const int block_keys = causal ? last_row + 1 : seq_len;
  const int my_keys = active ? (causal ? row + 1 : seq_len) : 0;

  const size_t q_off = ((size_t)b * seq_len + row) * (size_t)n_head * HD + (size_t)h * HD;
  const T* kb = k + (size_t)b * seq_len * width;
  const T* vb = v + (size_t)b * seq_len * width;

  float qv[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qv[d] = 0.f;
    acc[d] = 0.f;
  }
  if (active) {
    load_row<T, HD>(q + q_off, qv);
    if constexpr (!BIAS) {
#pragma unroll
      for (int d = 0; d < HD; ++d) qv[d] = round_to<T>(qv[d] * scale);
    }
  }
  // the logit of key j: qs.k (no bias), or (q.k) * scale + bias (the grid kernel)
  auto logit = [&](int j, const T* kr) {
    const float dk = dot<T, HD>(qv, kr);
    if constexpr (BIAS) return dk * scale + bias_at(table, row - j + nk, n_head, h);
    return dk;
  };
  float m = NEG_INF, l = 0.f;

  int staged = -1;  // first key of the tile held in shared memory (block-uniform)
  for (int c0 = 0; c0 < block_keys; c0 += KV_CHUNK) {
    const int c1 = min(c0 + KV_CHUNK, block_keys);

    // pass 1: the running max over this chunk
    float m_new = m;
    for (int t0 = c0; t0 < c1; t0 += tile_rows) {
      const int t1 = min(t0 + tile_rows, c1);
      if (staged != t0) {
        __syncthreads();
        stage(ks, kb + (size_t)t0 * width, (t1 - t0) * width);
        stage(vs, vb + (size_t)t0 * width, (t1 - t0) * width);
        __syncthreads();
        staged = t0;
      }
      const int j1 = min(t1, my_keys);
      for (int j = t0; j < j1; ++j)
        m_new = fmaxf(m_new, logit(j, ks + (size_t)(j - t0) * width + kv_col));
    }

    // pass 2: rescale what earlier chunks summed, then add this chunk
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
    for (int t0 = c0; t0 < c1; t0 += tile_rows) {
      const int t1 = min(t0 + tile_rows, c1);
      if (staged != t0) {
        __syncthreads();
        stage(ks, kb + (size_t)t0 * width, (t1 - t0) * width);
        stage(vs, vb + (size_t)t0 * width, (t1 - t0) * width);
        __syncthreads();
        staged = t0;
      }
      const int j1 = min(t1, my_keys);
      for (int j = t0; j < j1; ++j) {
        const size_t off = (size_t)(j - t0) * width + kv_col;
        const float p = expf(logit(j, ks + off) - m_new);
        l += p;
        const float pr = round_to<T>(p);
        float vf[HD];
        load_row<T, HD>(vs + off, vf);
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(pr, vf[d], acc[d]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float den = fmaxf(l, 1e-30f);
    alignas(16) T out[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) out[d] = from_f<T>(acc[d] / den);
#pragma unroll
    for (int i = 0; i < HD * (int)sizeof(T) / 16; ++i)
      reinterpret_cast<uint4*>(o + q_off)[i] = reinterpret_cast<const uint4*>(out)[i];
    lse[((size_t)b * seq_len + row) * n_head + h] = m + logf(den);
  }
}

template <typename T, int HD, bool BIAS>
int launch_fma(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
               int seq_len, int n_head, int kvh, int causal, const float* table, int nk,
               cudaStream_t stream) {
  const size_t row_bytes = (size_t)kvh * HD * sizeof(T);
  int rows = THREADS / n_head;
  if (rows < 1) rows = 1;
  // staging tile: the largest power of two <= KV_CHUNK whose K and V fit the
  // budget, and no longer than the sequence needs
  int tile = KV_CHUNK;
  while (tile > 1 && 2 * row_bytes * tile > (size_t)SMEM_BUDGET) tile >>= 1;
  if (2 * row_bytes * tile > (size_t)SMEM_BUDGET) return -1;
  int need = 1;
  while (need < seq_len) need <<= 1;
  if (tile > need) tile = need;
  const size_t smem = 2 * row_bytes * tile;
  const dim3 grid((seq_len + rows - 1) / rows, batch);
  const dim3 block(rows * n_head);
  const float scale = (float)(1.0 / sqrt((double)HD));
  fma_kernel<T, HD, BIAS><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq_len, n_head, kvh, rows, tile, causal,
      scale, table, nk);
  return (int)cudaGetLastError();
}

// ---- tensor-core specialization: bf16, MQA, 16 heads of one row per warp ----

typedef __nv_bfloat16 bf16;

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

// S for 16 heads x 8 keys: keys n0..n0+7 of the staged K tile (row-major).
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[4], const uint32_t (&qa)[HD / 16][4],
                                        const bf16* ks, int n0, int g, int c) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const bf16* kr = ks + (size_t)(n0 + g) * HD + 2 * c;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma_16816(s, qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
              *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
}

// Stages keys [t0, t1): K row-major, V transposed (so a B fragment of the PV
// product is one 32-bit load); rows past t1 up to a multiple of 16 are zeros.
template <int HD>
__device__ __forceinline__ void stage_kv_t(bf16* ks, bf16* vt, int vstride, const bf16* kb,
                                           const bf16* vb, int t0, int t1) {
  const int n = t1 - t0, n16 = (n + 15) & ~15;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < n16 * HD; i += blockDim.x) {
    const int j = i / HD, d = i - j * HD;
    const bool in = j < n;
    ks[i] = in ? kb[(size_t)t0 * HD + i] : zero;
    vt[d * vstride + j] = in ? vb[(size_t)t0 * HD + i] : zero;
  }
}

template <int HD, bool BIAS>
__global__ void mqa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ o,
                               float* __restrict__ lse, int seq_len, int n_head,
                               int rows_per_block, int tile_rows, int causal, float scale,
                               const float* __restrict__ table, int n_table, int nk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int vstride = tile_rows + 8;  // padded V^T rows: conflict-free B loads
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [tile_rows][HD]
  bf16* vt = ks + (size_t)tile_rows * HD;     // [HD][vstride]
  const int ustride = bias_ustride(rows_per_block, tile_rows);
  bf16* bs = vt + (size_t)HD * vstride;       // [n_head][ustride] (BIAS)
  // the softmax chunk: the TPU kernel's KV_CHUNK, or with the bias one staged tile
  const int chunk = BIAS ? tile_rows : KV_CHUNK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int groups = n_head >> 4;  // 16-head groups per query row
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int row = row0 + warp / groups;
  const int h0 = (warp % groups) * 16;
  const bool active = row < seq_len;

  const int last_row = min(row0 + rows_per_block, seq_len) - 1;
  const int block_keys = causal ? last_row + 1 : seq_len;  // block-uniform
  const int my_keys = active ? (causal ? row + 1 : seq_len) : 0;  // warp-uniform

  const size_t q_row = ((size_t)b * seq_len + row) * (size_t)n_head * HD;
  const bf16* kb = k + (size_t)b * seq_len * HD;
  const bf16* vb = v + (size_t)b * seq_len * HD;

  // A operand: heads h0+g and h0+g+8 of this row, scaled in f32 and rounded
  // (with the bias, as the grid kernel: unscaled, the product scaled after)
  const float qmul = BIAS ? 1.f : scale;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int hh = h0 + g + (r & 1) * 8;
      const int d = kk * 16 + 2 * c + (r >> 1) * 8;
      float x0 = 0.f, x1 = 0.f;
      if (active) {
        const __nv_bfloat162 pair =
            *reinterpret_cast<const __nv_bfloat162*>(q + q_row + (size_t)hh * HD + d);
        x0 = __bfloat162float(pair.x) * qmul;
        x1 = __bfloat162float(pair.y) * qmul;
      }
      qa[kk][r] = pack_bf16(x0, x1);
    }
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g+8 (heads h0+g, h0+g+8)
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums

  // S for 16 heads x 8 keys from key j0 of the tile [t0, t1); with the bias,
  // (q.k) * scale + bias (row r of the fragment is head h0 + g + 8r)
  const int r_local = row - row0;
  auto logits = [&](float (&s)[4], int j0, int t0, int t1) {
    qk_tile<HD>(s, qa, ks, j0 - t0, g, c);
    if constexpr (BIAS) {
      const int u = r_local + (t1 - 1 - j0 - 2 * c);
      const bf16* b0 = bs + (size_t)(h0 + g) * ustride + u;
      const bf16* b1 = b0 + (size_t)8 * ustride;
      s[0] = s[0] * scale + __bfloat162float(b0[0]);
      s[1] = s[1] * scale + __bfloat162float(b0[-1]);
      s[2] = s[2] * scale + __bfloat162float(b1[0]);
      s[3] = s[3] * scale + __bfloat162float(b1[-1]);
    }
  };
  auto stage = [&](int t0, int t1) {
    __syncthreads();
    stage_kv_t<HD>(ks, vt, vstride, kb, vb, t0, t1);
    if constexpr (BIAS)
      stage_bias(bs, ustride, table, n_table, n_head, nk, row0, rows_per_block, t0, t1);
    __syncthreads();
  };

  int staged = -1;  // first key of the tile in shared memory (block-uniform)
  for (int c0 = 0; c0 < block_keys; c0 += chunk) {
    const int c1 = min(c0 + chunk, block_keys);

    // pass 1: the running max over this chunk
    float mx[2] = {m[0], m[1]};
    for (int t0 = c0; t0 < c1; t0 += tile_rows) {
      const int t1 = min(t0 + tile_rows, c1);
      if (staged != t0) {
        stage(t0, t1);
        staged = t0;
      }
      const int j1 = min(t1, my_keys);
      for (int j0 = t0; j0 < j1; j0 += 8) {
        float s[4];
        logits(s, j0, t0, t1);
        const int j = j0 + 2 * c;
        if (j < my_keys) mx[0] = fmaxf(mx[0], s[0]), mx[1] = fmaxf(mx[1], s[2]);
        if (j + 1 < my_keys) mx[0] = fmaxf(mx[0], s[1]), mx[1] = fmaxf(mx[1], s[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    // pass 2: rescale what earlier chunks summed, then add this chunk
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float corr = expf(m[r] - mx[r]);
      l[r] *= corr;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) acc[nt][2 * r] *= corr, acc[nt][2 * r + 1] *= corr;
      m[r] = mx[r];
    }
    for (int t0 = c0; t0 < c1; t0 += tile_rows) {
      const int t1 = min(t0 + tile_rows, c1);
      if (staged != t0) {
        stage(t0, t1);
        staged = t0;
      }
      const int j1 = min(t1, my_keys);
      for (int j0 = t0; j0 < j1; j0 += 16) {
        float s0[4], s1[4], p0[4], p1[4];
        logits(s0, j0, t0, t1);
        logits(s1, j0 + 8, t0, t1);
        const int j = j0 + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int je = j + (e & 1);
          p0[e] = je < my_keys ? expf(s0[e] - m[e >> 1]) : 0.f;
          p1[e] = je + 8 < my_keys ? expf(s1[e] - m[e >> 1]) : 0.f;
        }
        l[0] += (p0[0] + p0[1]) + (p1[0] + p1[1]);
        l[1] += (p0[2] + p0[3]) + (p1[2] + p1[3]);
        // the S accumulators are the PV product's A fragment; p rounds to bf16
        const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                                pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
        const bf16* vr = vt + (size_t)g * vstride + (j0 - t0) + 2 * c;
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt)
          mma_16816(acc[nt], pa, *reinterpret_cast<const uint32_t*>(vr + nt * 8 * vstride),
                    *reinterpret_cast<const uint32_t*>(vr + nt * 8 * vstride + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (active) {
    const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
    bf16* orow = o + q_row;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int d = nt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(orow + (size_t)(h0 + g) * HD + d) =
          pack_bf16(acc[nt][0] / den0, acc[nt][1] / den0);
      *reinterpret_cast<uint32_t*>(orow + (size_t)(h0 + g + 8) * HD + d) =
          pack_bf16(acc[nt][2] / den1, acc[nt][3] / den1);
    }
    if (c == 0) {
      float* lrow = lse + ((size_t)b * seq_len + row) * n_head;
      lrow[h0 + g] = m[0] + logf(den0);
      lrow[h0 + g + 8] = m[1] + logf(den1);
    }
  }
}

template <int HD, bool BIAS>
int launch_mma(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
               int seq_len, int n_head, int causal, Bias bias, cudaStream_t stream) {
  const int groups = n_head / 16;
  int rows = 16 / groups;  // up to 16 warps per block
  if (rows < 1) rows = 1;
  if (rows * groups * 32 > 1024) return -1;
  auto smem_of = [&](int tile) {
    return (size_t)2 * HD * (2 * tile + 8) +
           (BIAS ? (size_t)2 * n_head * bias_ustride(rows, tile) : 0);
  };
  int tile = KV_CHUNK;
  while (tile > 16 && smem_of(tile) > (size_t)SMEM_BUDGET) tile >>= 1;
  if (smem_of(tile) > (size_t)SMEM_BUDGET) return -1;
  int need = 16;
  while (need < seq_len) need <<= 1;
  if (tile > need) tile = need;
  const dim3 grid((seq_len + rows - 1) / rows, batch);
  const float scale = (float)(1.0 / sqrt((double)HD));
  mqa_mma_kernel<HD, BIAS><<<grid, rows * groups * 32, smem_of(tile), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), seq_len, n_head, rows, tile, causal,
      scale, bias.table, bias.n_table, bias.nk);
  return (int)cudaGetLastError();
}

// ---- the no-bias tensor-core forward: one pass, async staging, heavy first ----

constexpr int TC_WARPS = 8;       // warps per block
constexpr int TC_KEY_TILE = 64;   // keys per staged K/V tile (two tiles in flight)

// A warp owns 64 / HD query rows of one 16-head group: each row is an m16
// tile (its 16 heads), and one K/V fragment load serves them all.
template <int HD> __host__ __device__ constexpr int tc_rows_per_warp() { return 64 / HD; }

template <int HD, bool BIAS>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
    mqa_tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int batch, int seq_len, int n_head, int rows_per_block, int n_qb, int causal,
                      float scale) {
  static_assert(!BIAS, "the position bias takes mqa_tc_bias_fwd_kernel");
  constexpr int RPW = tc_rows_per_warp<HD>();
  constexpr int KT = TC_KEY_TILE;
  constexpr int KS = HD + 8;  // padded row: the 8 rows of an ldmatrix hit 8 bank groups
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][KT][KS]
  bf16* vs = ks + 2 * KT * KS;               // [2][KT][KS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int groups = n_head >> 4;
  // heavy first: under the causal mask the last query blocks walk the most
  // keys, and they take the first block indices
  const int qb = causal ? n_qb - 1 - (int)blockIdx.x / batch : (int)blockIdx.x / batch;
  const int b = blockIdx.x % batch;
  const int row0 = qb * rows_per_block;
  const int wrow = row0 + (warp / groups) * RPW;  // the warp's first row
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

  // A operands: q of each row's 16 heads, scaled in f32 and rounded
  uint32_t qa[RPW][HD / 16][4];
  float acc[RPW][HD / 8][4];
  float m[RPW][2], l[RPW][2];  // the raw running max of rows g, g+8; this lane's share of the sums
#pragma unroll
  for (int rt = 0; rt < RPW; ++rt) {
    const int row = wrow + rt;
    const bf16* qrow = q + ((size_t)b * seq_len + row) * n_head * HD + (size_t)h0 * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x0 = 0.f, x1 = 0.f;
        if (row < seq_len) {
          const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(
              qrow + (size_t)(g + (r & 1) * 8) * HD + kk * 16 + 2 * c + (r >> 1) * 8);
          x0 = __bfloat162float(pair.x) * scale;
          x1 = __bfloat162float(pair.y) * scale;
        }
        qa[rt][kk][r] = pack_bf16(x0, x1);
      }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) acc[rt][nt][0] = acc[rt][nt][1] = acc[rt][nt][2] = acc[rt][nt][3] = 0.f;
    m[rt][0] = m[rt][1] = NEG_INF;
    l[rt][0] = l[rt][1] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) stage(tile + 1);  // overlaps this tile's work
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int t0 = tile * KT;
    const bf16* kt = ks + (tile & 1) * KT * KS;
    const bf16* vt = vs + (tile & 1) * KT * KS;
    const int j_end = min(t0 + KT, warp_keys);
    for (int j0 = t0; j0 < j_end; j0 += 16) {
      // keys j0..j0+15: K as B of S = qs.K^T, V (transposed by ldmatrix) as B of P.V
      uint32_t kf[HD / 16][4], vf[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(kf[kk], kt + (j0 - t0 + ldsm_row(lane)) * KS + kk * 16 + ldsm_col(lane));
        ldsm_x4_t(vf[kk], vt + (j0 - t0 + ldsm_row_t(lane)) * KS + kk * 16 + ldsm_col_t(lane));
      }
#pragma unroll
      for (int rt = 0; rt < RPW; ++rt) {
        const int row = wrow + rt;
        if (row >= seq_len || (causal && j0 > row)) continue;  // warp-uniform
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) mma_16816(s[nt], qa[rt][kk], kf[kk][2 * nt], kf[kk][2 * nt + 1]);
        }
        // the mask, on the diagonal tile and the ragged last tile only
        if ((causal && j0 + 15 > row) || j0 + 16 > seq_len) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = j0 + nt * 8 + 2 * c + (e & 1);
              if (key >= seq_len || (causal && key > row)) s[nt][e] = -INFINITY;
            }
        }
        // online softmax over the 16-key tile: the running max rises to the
        // tile's and what earlier tiles summed is rescaled (by 1 where the max
        // stays: no branch, so the row tiles' work interleaves)
        float mxl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]), fmaxf(s[1][2 * r], s[1][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2)), m[rt][r]);
          const float corr = ex2((m[rt][r] - mx) * LOG2E);
          m[rt][r] = mx;
          l[rt][r] *= corr;
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt) acc[rt][nt][2 * r] *= corr, acc[rt][nt][2 * r + 1] *= corr;
          mxl[r] = mx * LOG2E;
        }
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] = ex2(fmaf(s[nt][e], LOG2E, -mxl[e >> 1]));
        l[rt][0] += (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
        l[rt][1] += (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
        // the S accumulators are the PV product's A fragment; p rounds to bf16
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          mma_16816(acc[rt][2 * kk], pa, vf[kk][0], vf[kk][1]);
          mma_16816(acc[rt][2 * kk + 1], pa, vf[kk][2], vf[kk][3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

#pragma unroll
  for (int rt = 0; rt < RPW; ++rt) {
    const int row = wrow + rt;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[rt][r] += __shfl_xor_sync(0xffffffffu, l[rt][r], 1);
      l[rt][r] += __shfl_xor_sync(0xffffffffu, l[rt][r], 2);
    }
    if (row >= seq_len) continue;
    const float den0 = fmaxf(l[rt][0], 1e-30f), den1 = fmaxf(l[rt][1], 1e-30f);
    bf16* orow = o + ((size_t)b * seq_len + row) * n_head * HD + (size_t)h0 * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int d = nt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(orow + (size_t)g * HD + d) = pack_bf16(acc[rt][nt][0] / den0, acc[rt][nt][1] / den0);
      *reinterpret_cast<uint32_t*>(orow + (size_t)(g + 8) * HD + d) =
          pack_bf16(acc[rt][nt][2] / den1, acc[rt][nt][3] / den1);
    }
    if (c == 0) {
      float* lrow = lse + ((size_t)b * seq_len + row) * n_head + h0;
      lrow[g] = m[rt][0] + logf(den0);
      lrow[g + 8] = m[rt][1] + logf(den1);
    }
  }
}

// ---- the bias tensor-core forward: the same design, the bias staged per tile ----
//
// mqa_tc_fwd_kernel's design (a warp owns 64 / HD rows of a 16-head group;
// 64-key K/V tiles by cp.async; one pass with the online softmax over 16-key
// tiles; ex2 with one FFMA; masks on the diagonal and ragged tiles only;
// heavy first), with the grid kernel's logits: s = (q.k) * scale + bias, q
// the unscaled bf16 operand, the bias bf16(table[i - j + nk, h]).
//
// The bias is staged in the layout of BiasTile (flash_bias.cuh, where it is
// explained), shared with mqa_tc_bias_dq_kernel: the table rows of tile t + 2
// arrive by cp.async beside K/V at the top of tile t, tile t + 1's are
// converted to bf16 copies, tile t is computed; one barrier a tile. Per 16
// keys and row a lane adds 2 bias loads, 8 unpacks and 8 FFMAs to the
// no-bias kernel's work.

template <int HD>
__global__ void __launch_bounds__(32 * TC_WARPS, 2)
    mqa_tc_bias_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                           const float* __restrict__ table, int batch, int seq_len, int n_head,
                           int rows_per_block, int n_qb, int causal, float scale, int n_table, int nk) {
  constexpr int RPW = tc_rows_per_warp<HD>();
  constexpr int KT = TC_KEY_TILE;
  constexpr int KS = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);        // [3][KT][KS]
  bf16* vs = ks + TC_BIAS_KV_BUFS * KT * KS;        // [3][KT][KS]
  const BiasTile<KT> bt(rows_per_block, n_head);
  // [2 tiles][2 copies][n_head / 2 head pairs][hs / 2 words]: pair (16 G + g, 16 G + g + 8) is pair 8 G + g
  uint2* bw = reinterpret_cast<uint2*>(vs + TC_BIAS_KV_BUFS * KT * KS);
  const int copy_pairs = n_head / 2 * (bt.hs / 2);
  float* raw = reinterpret_cast<float*>(bw + 4 * copy_pairs);  // [2 tiles][nr][rs]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int groups = n_head >> 4;
  const int qb = causal ? n_qb - 1 - (int)blockIdx.x / batch : (int)blockIdx.x / batch;
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
  cp_async_wait<0>();
  __syncthreads();
  if (n_tiles > 0) convert(0);

  // A operands: q of each row's 16 heads, unscaled (the product is scaled after)
  uint32_t qa[RPW][HD / 16][4];
  float acc[RPW][HD / 8][4];
  float m[RPW][2], l[RPW][2];
#pragma unroll
  for (int rt = 0; rt < RPW; ++rt) {
    const int row = wrow + rt;
    const bf16* qrow = q + ((size_t)b * seq_len + row) * n_head * HD + (size_t)h0 * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[rt][kk][r] = row < seq_len ? *reinterpret_cast<const uint32_t*>(
                                            qrow + (size_t)(g + (r & 1) * 8) * HD + kk * 16 + 2 * c + (r >> 1) * 8)
                                      : 0u;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) acc[rt][nt][0] = acc[rt][nt][1] = acc[rt][nt][2] = acc[rt][nt][3] = 0.f;
    m[rt][0] = m[rt][1] = NEG_INF;
    l[rt][0] = l[rt][1] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();  // tile + 1's copies, issued a tile ago
    __syncthreads();     // ... have landed for every thread; tile's bias is converted; tile - 1 is done
    if (tile + 2 < n_tiles) stage(tile + 2);
    if (tile + 1 < n_tiles) convert(tile + 1);
    const int t0 = tile * KT;
    const bf16* kt = ks + (tile % TC_BIAS_KV_BUFS) * KT * KS;
    const bf16* vt = vs + (tile % TC_BIAS_KV_BUFS) * KT * KS;
    const uint2* bt_w = bw + (tile & 1) * 2 * copy_pairs + (h0 / 2 + g) * (bt.hs / 2) + c;
    const int j_end = min(t0 + KT, warp_keys);
    for (int j0 = t0; j0 < j_end; j0 += 16) {
      uint32_t kf[HD / 16][4], vf[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(kf[kk], kt + (j0 - t0 + ldsm_row(lane)) * KS + kk * 16 + ldsm_col(lane));
        ldsm_x4_t(vf[kk], vt + (j0 - t0 + ldsm_row_t(lane)) * KS + kk * 16 + ldsm_col_t(lane));
      }
      // the bias words of row wrow + rt: z = zw - rt at key j0, in copy p =
      // z & 1 at word (z + p) / 2: rows of the warp's first row's parity
      // read copy pe at word we - rt / 2, the others copy 1 - pe at word
      // wo - (rt - 1) / 2
      const int zw = zrow - wrow + j0 - t0, pe = zw & 1;
      const uint2* bpe = bt_w + pe * copy_pairs + (zw + pe) / 2;
      const uint2* bpo = bt_w + (1 - pe) * copy_pairs + (zw - pe) / 2;
#pragma unroll
      for (int rt = 0; rt < RPW; ++rt) {
        const int row = wrow + rt;
        if (row >= seq_len || (causal && j0 > row)) continue;  // warp-uniform
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) mma_16816(s[nt], qa[rt][kk], kf[kk][2 * nt], kf[kk][2 * nt + 1]);
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
        if ((causal && j0 + 15 > row) || j0 + 16 > seq_len) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = j0 + nt * 8 + 2 * c + (e & 1);
              if (key >= seq_len || (causal && key > row)) s[nt][e] = -INFINITY;
            }
        }
        float mxl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]), fmaxf(s[1][2 * r], s[1][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2)), m[rt][r]);
          const float corr = ex2((m[rt][r] - mx) * LOG2E);
          m[rt][r] = mx;
          l[rt][r] *= corr;
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt) acc[rt][nt][2 * r] *= corr, acc[rt][nt][2 * r + 1] *= corr;
          mxl[r] = mx * LOG2E;
        }
        float pr[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pr[nt][e] = ex2(fmaf(s[nt][e], LOG2E, -mxl[e >> 1]));
        l[rt][0] += (pr[0][0] + pr[0][1]) + (pr[1][0] + pr[1][1]);
        l[rt][1] += (pr[0][2] + pr[0][3]) + (pr[1][2] + pr[1][3]);
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          mma_16816(acc[rt][2 * kk], pa, vf[kk][0], vf[kk][1]);
          mma_16816(acc[rt][2 * kk + 1], pa, vf[kk][2], vf[kk][3]);
        }
      }
    }
  }

#pragma unroll
  for (int rt = 0; rt < RPW; ++rt) {
    const int row = wrow + rt;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[rt][r] += __shfl_xor_sync(0xffffffffu, l[rt][r], 1);
      l[rt][r] += __shfl_xor_sync(0xffffffffu, l[rt][r], 2);
    }
    if (row >= seq_len) continue;
    const float den0 = fmaxf(l[rt][0], 1e-30f), den1 = fmaxf(l[rt][1], 1e-30f);
    bf16* orow = o + ((size_t)b * seq_len + row) * n_head * HD + (size_t)h0 * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int d = nt * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(orow + (size_t)g * HD + d) = pack_bf16(acc[rt][nt][0] / den0, acc[rt][nt][1] / den0);
      *reinterpret_cast<uint32_t*>(orow + (size_t)(g + 8) * HD + d) =
          pack_bf16(acc[rt][nt][2] / den1, acc[rt][nt][3] / den1);
    }
    if (c == 0) {
      float* lrow = lse + ((size_t)b * seq_len + row) * n_head + h0;
      lrow[g] = m[rt][0] + logf(den0);
      lrow[g + 8] = m[rt][1] + logf(den1);
    }
  }
}

// the tensor-core forward takes bf16, MQA, and 1 to TC_WARPS groups of 16 heads
bool tc_fwd_ok(int kvh, int n_head, int head_dim, int is_bf16) {
  return is_bf16 && kvh == 1 && n_head % 16 == 0 && n_head / 16 <= TC_WARPS &&
         (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

template <int HD>
int launch_tc_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                  int seq_len, int n_head, int causal, cudaStream_t stream) {
  const int groups = n_head / 16;
  const int slices = TC_WARPS / groups;  // row slices of a block
  const int rows = slices * tc_rows_per_warp<HD>();
  const int n_qb = (seq_len + rows - 1) / rows;
  if ((long long)n_qb * batch > 0x7fffffffLL) return -1;
  const size_t smem = (size_t)2 * 2 * TC_KEY_TILE * (HD + 8) * sizeof(bf16);
  const float scale = (float)(1.0 / sqrt((double)HD));
  mqa_tc_fwd_kernel<HD, false><<<n_qb * batch, slices * groups * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), batch, seq_len, n_head, rows, n_qb, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc_bias_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                       int seq_len, int n_head, int causal, Bias bias, cudaStream_t stream) {
  const int groups = n_head / 16;
  const int slices = TC_WARPS / groups;
  const int rows = slices * tc_rows_per_warp<HD>();
  const int n_qb = (seq_len + rows - 1) / rows;
  if ((long long)n_qb * batch > 0x7fffffffLL) return -1;
  const size_t smem = tc_bias_smem<HD, TC_KEY_TILE>(rows, n_head);
  cudaError_t e = cudaFuncSetAttribute(mqa_tc_bias_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const float scale = (float)(1.0 / sqrt((double)HD));
  mqa_tc_bias_fwd_kernel<HD><<<n_qb * batch, slices * groups * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), bias.table, batch, seq_len, n_head, rows, n_qb, causal,
      scale, bias.n_table, bias.nk);
  return (int)cudaGetLastError();
}

template <typename T, bool BIAS>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
             int seq_len, int n_head, int kvh, int head_dim, int causal, Bias bias,
             cudaStream_t s) {
  switch (head_dim) {
    case 8: return launch_fma<T, 8, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, kvh, causal, bias.table, bias.nk, s);
    case 16: return launch_fma<T, 16, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, kvh, causal, bias.table, bias.nk, s);
    case 32: return launch_fma<T, 32, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, kvh, causal, bias.table, bias.nk, s);
    case 64: return launch_fma<T, 64, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, kvh, causal, bias.table, bias.nk, s);
    default: return -1;
  }
}

template <bool BIAS>
int forward(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
            int seq_len, int n_head, int kvh, int head_dim, int causal, int is_bf16, Bias bias,
            void* stream) {
  if (n_head < 1 || n_head > 1024 || batch < 1 || seq_len < 1 || batch > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!BIAS) {
    if (tc_fwd_ok(kvh, n_head, head_dim, is_bf16)) {
      switch (head_dim) {
        case 16: return launch_tc_fwd<16>(q, k, v, o, lse, batch, seq_len, n_head, causal, s);
        case 32: return launch_tc_fwd<32>(q, k, v, o, lse, batch, seq_len, n_head, causal, s);
        case 64: return launch_tc_fwd<64>(q, k, v, o, lse, batch, seq_len, n_head, causal, s);
        default: break;
      }
    }
  } else if (tc_fwd_ok(kvh, n_head, head_dim, is_bf16)) {
    switch (head_dim) {
      case 16: return launch_tc_bias_fwd<16>(q, k, v, o, lse, batch, seq_len, n_head, causal, bias, s);
      case 32: return launch_tc_bias_fwd<32>(q, k, v, o, lse, batch, seq_len, n_head, causal, bias, s);
      case 64: return launch_tc_bias_fwd<64>(q, k, v, o, lse, batch, seq_len, n_head, causal, bias, s);
      default: break;
    }
  } else if (is_bf16 && kvh == 1 && n_head % 16 == 0 && n_head <= 512) {
    switch (head_dim) {  // more groups of 16 heads than the one-pass kernel's warps
      case 16: return launch_mma<16, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, causal, bias, s);
      case 32: return launch_mma<32, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, causal, bias, s);
      case 64: return launch_mma<64, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, causal, bias, s);
      default: break;  // other head dims take the FMA kernel
    }
  }
  if (is_bf16)
    return dispatch<__nv_bfloat16, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, kvh, head_dim,
                                         causal, bias, s);
  return dispatch<float, BIAS>(q, k, v, o, lse, batch, seq_len, n_head, kvh, head_dim, causal,
                               bias, s);
}

}  // namespace

// Returns 0 on success, cudaGetLastError() after a refused launch, or -1 for
// a shape the kernel does not take (head_dim, n_head > 1024, or a K/V row
// too wide to stage).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int batch, int seq_len, int n_head, int kvh, int head_dim,
                         int causal, int is_bf16, void* stream) {
  return forward<false>(q, k, v, o, lse, batch, seq_len, n_head, kvh, head_dim, causal, is_bf16,
                        Bias{nullptr, 0, 0}, stream);
}

// The same with the relative-position bias table (n_table, n_head) float32;
// the caller checks that seq_len - 1 + nk < n_table (and, without the causal
// mask, nk >= seq_len - 1), so every live pair reads inside the table.
extern "C" int flash_bias_fwd(const void* q, const void* k, const void* v, const void* table,
                              void* o, void* lse, int batch, int seq_len, int n_head, int kvh,
                              int head_dim, int n_table, int nk, int causal, int is_bf16,
                              void* stream) {
  if (n_table < 1 || nk < 0) return -1;
  return forward<true>(q, k, v, o, lse, batch, seq_len, n_head, kvh, head_dim, causal, is_bf16,
                       Bias{static_cast<const float*>(table), n_table, nk}, stream);
}

// The K/V tiles the heaviest block of flash_fwd walks for this shape (the
// tensor-core kernel's 64-key tiles), or 0 where the FMA kernel takes the call.
extern "C" int flash_fwd_tiles_per_block(int seq_len, int n_head, int kvh, int head_dim,
                                         int is_bf16) {
  if (!tc_fwd_ok(kvh, n_head, head_dim, is_bf16)) return 0;
  return (seq_len + TC_KEY_TILE - 1) / TC_KEY_TILE;
}
