// Fused in-batch contrastive cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the four TPU kernels of recommendations_tpu/ops/fused_ce.py:
//   ce_row_diag  <- _row_diag_kernel  diag[i] = q_i.c_i * inv_t where v[i], else -1e9
//   ce_fwd       <- _ce_fwd_kernel    ce, rank and the backward's lse per row
//   ce_dq        <- _ce_dq_kernel     dq = sum_j bf16(g[i, j]) c_j
//   ce_dc        <- _ce_dc_kernel     dc = sum_i bf16(g[i, j]) q_i
// over the (N, N) plane of logits = q.c^T * inv_t, without ever storing it:
//   masked[i, j] = (i/s == j/s and i != j) or not v[j] or j >= n
//   logit        = masked ? -1e9 : q_i.c_j * inv_t        (f32 product of bf16)
//   adj          = i == j ? logit : logit - beta * lq[j]
//   lse_i        = m + log(sum_j exp(adj - m)),  m = inv_t + beta * max|lq| + 1
//   ce_i         = lse_i - diag_i;  the backward's residual is ce_i + diag_i
//   rank_i       = #{j != i : logit[i, j] > diag_i}
//   g[i, j]      = (p - [i == j]) * dce_i * inv_t,  p = exp(adj - lse_i), or 0
//                  where lse_i <= -1e8 (padded or fully masked rows)
// m is computed by the caller and read from device memory.
//
// The rank counts only j != i, as the JAX package's unfused _ce_core does. The
// TPU kernel counts column i too, comparing the tile's product q_i.c_i with
// the separately summed diag_i; where the two sums round apart, its rank is
// one higher.
//
// Bound on an H100 SXM at the LTHM-base training shape (N = 8192 rows of one
// 32-user loss chunk, D = 128, bf16; 12 calls a step): the forward does
// 2 N^2 D = 17.2 GFLOP of products, 0.017 ms at the 989 TFLOP/s bf16 tensor
// peak, and each backward kernel twice that; the inputs are 4 MB. So each is
// bound by operations. But each call also takes N^2 = 67 M exponentials and
// some 15-25 integer and float instructions per logit for the masks, the
// shift, the sums and the compares: at the full instruction rate that alone is
// 0.03-0.05 ms, above the product bound, so these kernels are limited by
// their per-logit elementwise work.
//
// Design. A block owns 64 rows of its own side (query rows for ce_fwd and
// ce_dq, candidate rows for ce_dc) and walks every row of the other side (the
// stream) in stages of 128 rows, double-buffered in shared memory with
// cp.async. Eight warps: four row groups of 16 own rows times two halves of
// each stage. The own rows are the A operand of mma.sync.m16n8k16, held in
// registers; S = own.stream^T runs on the tensor cores with B read by
// ldmatrix; the masks come from the indices and per-row metadata (user,
// validity, -beta*lq, lse, dce*inv_t) staged beside each stage. In the
// backward, g rounded to bf16 is already the A operand of grad += g.stream,
// whose B operand is the same staged tile read by ldmatrix.trans. The two
// halves of a row group add their sums in a fixed order at the end: no
// atomics, so two runs give the same bits. N = 8192 gives 128 blocks of 8
// warps for 132 SMs, one wave; the column split is inside the block, so it
// needs no second pass. No wgmma or TMA yet: a right and simple kernel first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float BIG_NEG = -1e9f;    // a masked logit
constexpr float LSE_GUARD = -1e8f;  // rows at or below this lse take p = 0
constexpr int ROW_GROUPS = 4;       // warps that split a block's own rows, 16 each
constexpr int STREAM_SPLIT = 2;     // warps that split a stage's stream rows
constexpr int OWN_ROWS = 16 * ROW_GROUPS;
constexpr int SUB = 64;                            // stream rows per warp per stage
constexpr int STAGE_ROWS = SUB * STREAM_SPLIT;     // stream rows per stage
constexpr int THREADS = 32 * ROW_GROUPS * STREAM_SPLIT;
constexpr int PAD = 8;  // bf16 padding per staged row: ldmatrix rows fall on distinct banks

static_assert(STREAM_SPLIT == 2, "the end-of-block reduction adds two halves");
static_assert(STAGE_ROWS <= THREADS, "one thread stages each stream row's metadata");

enum Kind { FWD = 0, DQ = 1, DC = 2 };

struct CeArgs {
  const bf16* own;     // (n, D): Q for FWD and DQ, C for DC
  const bf16* strm;    // (n, D): C for FWD and DQ, Q for DC
  const uint8_t* v;    // (n,) candidate validity
  const float* lq;     // (n,) logQ of each candidate
  const float* m;      // scalar shift (FWD)
  const float* diag;   // (n,) FWD
  const float* lse;    // (n,) DQ, DC
  const float* dce;    // (n,) DQ, DC
  float* ce;           // (n,) FWD
  float* lse_out;      // (n,) FWD
  int* rank;           // (n,) FWD
  bf16* grad;          // (n, D) DQ, DC
  int n, s;
  float inv_t, beta;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
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

// Four 8x8 b16 matrices from shared memory; lane t gives the address of row
// t % 8 of matrix t / 8. Plain: lane gets M[g][2c..2c+1] of each; trans:
// M[2c..2c+1][g].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// 16 bytes from global to shared memory; zeros when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// A fragments of 16 rows x D of a row-major (rows, D) matrix from base; rows
// at or past n_rows are zeros.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* base, int n_rows, int g,
                                       int c) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = g + (r & 1) * 8;
      const int d = kk * 16 + 2 * c + (r >> 1) * 8;
      a[kk][r] = m < n_rows ? *reinterpret_cast<const uint32_t*>(base + (size_t)m * D + d) : 0u;
    }
  }
}

// Stream rows row0 .. row0 + STAGE_ROWS - 1 into a padded shared tile; rows at
// or past n are zeros.
template <int D>
__device__ __forceinline__ void load_stage(bf16* dst, const bf16* src, int row0, int n) {
  constexpr int PER_ROW = D / 8;  // 16-byte copies
  for (int idx = threadIdx.x; idx < STAGE_ROWS * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, k = idx - r * PER_ROW;
    const int row = row0 + r;
    const bool in = row < n;
    cp_async16(dst + r * (D + PAD) + k * 8, in ? src + (size_t)row * D + k * 8 : src, in);
  }
}

// Per-row metadata. Candidate side (j): user j/s, or -1 where j is invalid or
// padding (a masked column); x = -beta*lq[j]. Query side (i): user i/s, or -1
// past n; for FWD x = diag[i]; for DQ and DC x = lse[i] (-1e9 past n) and
// y = dce[i]*inv_t (0 past n).
template <bool CANDIDATE, int KIND>
__device__ __forceinline__ void row_meta(const CeArgs& A, int t, int& u, float& x, float& y) {
  const bool in = t < A.n;
  if constexpr (CANDIDATE) {
    u = (in && A.v[t]) ? t / A.s : -1;
    x = in ? -(A.beta * A.lq[t]) : 0.f;
    y = 0.f;
  } else {
    u = in ? t / A.s : -1;
    if constexpr (KIND == FWD) {
      x = in ? A.diag[t] : BIG_NEG;
      y = 0.f;
    } else {
      x = in ? A.lse[t] : BIG_NEG;
      y = in ? A.dce[t] * A.inv_t : 0.f;
    }
  }
}

// The body of the three tile kernels below: one block, 64 own rows against
// every stream row.
template <int D, int KIND>
__device__ __forceinline__ void ce_tile(const CeArgs& A) {
  constexpr int LD = D + PAD;
  constexpr int KK = D / 16;
  constexpr bool OWN_IS_CAND = KIND == DC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [2][STAGE_ROWS][LD]
  int* s_user = reinterpret_cast<int*>(smem + (size_t)2 * STAGE_ROWS * LD * sizeof(bf16));
  float* s_x = reinterpret_cast<float*>(s_user + 2 * STAGE_ROWS);  // [2][STAGE_ROWS]
  float* s_y = s_x + 2 * STAGE_ROWS;                                // [2][STAGE_ROWS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int rg = warp % ROW_GROUPS, half = warp / ROW_GROUPS;
  const int n = A.n;
  const int own0 = blockIdx.x * OWN_ROWS + rg * 16;
  const int own_i[2] = {own0 + g, own0 + g + 8};

  uint32_t a[KK][4];
  load_a<D>(a, A.own + (size_t)own0 * D, n - own0, g, c);
  int own_u[2];
  float own_x[2], own_y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_meta<OWN_IS_CAND, KIND>(A, own_i[r], own_u[r], own_x[r], own_y[r]);

  const float inv_t = A.inv_t;
  const float m_shift = KIND == FWD ? *A.m : 0.f;
  float se[2] = {0.f, 0.f};
  int rk[2] = {0, 0};
  float out[KIND == FWD ? 1 : D / 8][4];
#pragma unroll
  for (int nt = 0; nt < (KIND == FWD ? 1 : D / 8); ++nt) out[nt][0] = out[nt][1] = out[nt][2] = out[nt][3] = 0.f;

  const int stages = (n + STAGE_ROWS - 1) / STAGE_ROWS;
  load_stage<D>(tiles, A.strm, 0, n);
  cp_async_commit();
  if (threadIdx.x < STAGE_ROWS) {
    int u;
    float x, y;
    row_meta<!OWN_IS_CAND, KIND>(A, threadIdx.x, u, x, y);
    s_user[threadIdx.x] = u, s_x[threadIdx.x] = x, s_y[threadIdx.x] = y;
  }

  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    const bool more = st + 1 < stages;
    if (more) load_stage<D>(tiles + (size_t)(buf ^ 1) * STAGE_ROWS * LD, A.strm, (st + 1) * STAGE_ROWS, n);
    cp_async_commit();
    int nu = -1;
    float nx = 0.f, ny = 0.f;
    if (more && threadIdx.x < STAGE_ROWS)
      row_meta<!OWN_IS_CAND, KIND>(A, (st + 1) * STAGE_ROWS + threadIdx.x, nu, nx, ny);
    cp_async_wait_one();
    __syncthreads();

    const int t0 = st * STAGE_ROWS + half * SUB;  // the warp's first stream row
    if (t0 < n) {
      const bf16* tile = tiles + (size_t)buf * STAGE_ROWS * LD + (size_t)half * SUB * LD;
      const int* su = s_user + buf * STAGE_ROWS + half * SUB;
      const float* sx = s_x + buf * STAGE_ROWS + half * SUB;
      const float* sy = s_y + buf * STAGE_ROWS + half * SUB;

      // S = own . stream^T: 16 own rows x 64 stream rows, f32
      float sacc[SUB / 8][4];
#pragma unroll
      for (int nt = 0; nt < SUB / 8; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int np = 0; np < SUB / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, tile + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_16816(sacc[2 * np], a[kk], b[0], b[1]);
          mma_16816(sacc[2 * np + 1], a[kk], b[2], b[3]);
        }
      }

#pragma unroll
      for (int ks = 0; ks < SUB / 16; ++ks) {
        float gv[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int nt = 2 * ks + h2;
          const int tl = nt * 8 + 2 * c;
          const int2 uu = *reinterpret_cast<const int2*>(su + tl);
          const float2 xx = *reinterpret_cast<const float2*>(sx + tl);
          float2 yy = make_float2(0.f, 0.f);
          if constexpr (KIND == DC) yy = *reinterpret_cast<const float2*>(sy + tl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int t = t0 + tl + (e & 1);
            const int us = (e & 1) ? uu.y : uu.x;
            const float xs = (e & 1) ? xx.y : xx.x;
            const bool eye = own_i[r] == t;
            const int ucol = OWN_IS_CAND ? own_u[r] : us;
            const int urow = OWN_IS_CAND ? us : own_u[r];
            const bool masked = ucol < 0 || (ucol == urow && !eye);
            const float logit = masked ? BIG_NEG : sacc[nt][e] * inv_t;
            const float nb = OWN_IS_CAND ? own_x[r] : xs;
            const float adj = eye ? logit : logit + nb;
            if constexpr (KIND == FWD) {
              se[r] += __expf(adj - m_shift);
              rk[r] += (!eye && logit > own_x[r]) ? 1 : 0;
            } else {
              const float lse = OWN_IS_CAND ? xs : own_x[r];
              const float av = OWN_IS_CAND ? ((e & 1) ? yy.y : yy.x) : own_y[r];
              const float p = lse > LSE_GUARD ? __expf(adj - lse) : 0.f;
              gv[h2][e] = (p - (eye ? 1.f : 0.f)) * av;
            }
          }
        }
        if constexpr (KIND != FWD) {
          // g rounded to bf16 is the A operand of grad += g . stream
          const uint32_t ga[4] = {pack_bf16(gv[0][0], gv[0][1]), pack_bf16(gv[0][2], gv[0][3]),
                                  pack_bf16(gv[1][0], gv[1][1]), pack_bf16(gv[1][2], gv[1][3])};
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(b, tile + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + dp * 16 + (lane >> 4) * 8);
            mma_16816(out[2 * dp], ga, b[0], b[1]);
            mma_16816(out[2 * dp + 1], ga, b[2], b[3]);
          }
        }
      }
    }

    if (more && threadIdx.x < STAGE_ROWS) {
      const int at = (buf ^ 1) * STAGE_ROWS + threadIdx.x;
      s_user[at] = nu, s_x[at] = nx, s_y[at] = ny;
    }
    __syncthreads();
  }

  // the two halves of each row group add up in a fixed order: half 1 hands its
  // sums to half 0 through shared memory (the stage tiles are free now)
  if constexpr (KIND == FWD) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      se[r] += __shfl_xor_sync(0xffffffffu, se[r], 1);
      se[r] += __shfl_xor_sync(0xffffffffu, se[r], 2);
      rk[r] += __shfl_xor_sync(0xffffffffu, rk[r], 1);
      rk[r] += __shfl_xor_sync(0xffffffffu, rk[r], 2);
    }
    float* red_se = reinterpret_cast<float*>(smem);      // [ROW_GROUPS][16]
    int* red_rk = reinterpret_cast<int*>(red_se + OWN_ROWS);
    if (half == 1 && c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        red_se[rg * 16 + g + 8 * r] = se[r];
        red_rk[rg * 16 + g + 8 * r] = rk[r];
      }
    }
    __syncthreads();
    if (half == 0 && c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = own_i[r];
        if (i >= n) continue;
        const float total = se[r] + red_se[rg * 16 + g + 8 * r];
        const float lse = m_shift + logf(total);
        const float ce = lse - own_x[r];
        A.ce[i] = ce;
        A.lse_out[i] = ce + own_x[r];
        A.rank[i] = rk[r] + red_rk[rg * 16 + g + 8 * r];
      }
    }
  } else {
    float* red = reinterpret_cast<float*>(smem) + (size_t)rg * 16 * D;  // [ROW_GROUPS][16][D]
    if (half == 1) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(g + (e >> 1) * 8) * D + nt * 8 + 2 * c + (e & 1)] = out[nt][e];
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int d = nt * 8 + 2 * c;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = own_i[r];
          if (i >= n) continue;
          const float* o = red + (g + 8 * r) * D + d;
          *reinterpret_cast<uint32_t*>(A.grad + (size_t)i * D + d) =
              pack_bf16(out[nt][2 * r] + o[0], out[nt][2 * r + 1] + o[1]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) ce_fwd_kernel(const CeArgs A) { ce_tile<D, FWD>(A); }

template <int D>
__global__ void __launch_bounds__(THREADS, 1) ce_dq_kernel(const CeArgs A) { ce_tile<D, DQ>(A); }

template <int D>
__global__ void __launch_bounds__(THREADS, 1) ce_dc_kernel(const CeArgs A) { ce_tile<D, DC>(A); }

// One warp per row: diag[i] = q_i.c_i * inv_t (an f32 sum of the bf16
// products) where v[i], else -1e9.
template <int D>
__global__ void row_diag_kernel(const bf16* __restrict__ q, const bf16* __restrict__ cm,
                                const uint8_t* __restrict__ v, float* __restrict__ diag, int n,
                                float inv_t) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  float acc = 0.f;
#pragma unroll
  for (int d = 2 * lane; d < D; d += 64) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(q + (size_t)row * D + d);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(cm + (size_t)row * D + d);
    acc = fmaf(__bfloat162float(a.x), __bfloat162float(b.x), acc);
    acc = fmaf(__bfloat162float(a.y), __bfloat162float(b.y), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) diag[row] = v[row] ? acc * inv_t : BIG_NEG;
}

template <int D, int KIND>
int launch_tile(const CeArgs& A, cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)2 * STAGE_ROWS * (D + PAD) * sizeof(bf16) + (size_t)2 * STAGE_ROWS * 3 * 4;
  static_assert((size_t)ROW_GROUPS * 16 * D * 4 <= (size_t)2 * STAGE_ROWS * (D + PAD) * sizeof(bf16),
                "the end-of-block reduction fits in the stage tiles");
  void (*kern)(CeArgs) = KIND == FWD ? ce_fwd_kernel<D> : KIND == DQ ? ce_dq_kernel<D> : ce_dc_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (A.n + OWN_ROWS - 1) / OWN_ROWS;
  kern<<<blocks, THREADS, smem, stream>>>(A);
  return (int)cudaGetLastError();
}

template <int KIND>
int dispatch_tile(const CeArgs& A, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_tile<16, KIND>(A, stream);
    case 32: return launch_tile<32, KIND>(A, stream);
    case 64: return launch_tile<64, KIND>(A, stream);
    case 128: return launch_tile<128, KIND>(A, stream);
    default: return -1;
  }
}

bool bad_shape(int n, int d, int s) {
  return n < 1 || s < 1 || !(d == 16 || d == 32 || d == 64 || d == 128);
}

}  // namespace

// Each entry returns 0 on success, cudaGetLastError() after a refused launch,
// or -1 for a shape the kernels do not take (n < 1, s < 1, d not in
// {16, 32, 64, 128}). All pointers are device pointers; q, c (and dq, dc) are
// (n, d) bf16 row-major and 16-byte aligned; v is (n,) bool as bytes; lq,
// diag, lse, dce, ce are (n,) float32; rank is (n,) int32; m is one float32.

extern "C" int ce_row_diag(const void* q, const void* c, const void* v, void* diag, int n, int d,
                           float inv_t, void* stream) {
  if (bad_shape(n, d, 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int ROWS = 8;  // warps per block
  const dim3 grid((n + ROWS - 1) / ROWS), block(32 * ROWS);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* cb = static_cast<const bf16*>(c);
  const uint8_t* vb = static_cast<const uint8_t*>(v);
  float* out = static_cast<float*>(diag);
  switch (d) {
    case 16: row_diag_kernel<16><<<grid, block, 0, st>>>(qb, cb, vb, out, n, inv_t); break;
    case 32: row_diag_kernel<32><<<grid, block, 0, st>>>(qb, cb, vb, out, n, inv_t); break;
    case 64: row_diag_kernel<64><<<grid, block, 0, st>>>(qb, cb, vb, out, n, inv_t); break;
    default: row_diag_kernel<128><<<grid, block, 0, st>>>(qb, cb, vb, out, n, inv_t); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int ce_fwd(const void* q, const void* c, const void* v, const void* lq, const void* m,
                      const void* diag, void* ce, void* lse_out, void* rank, int n, int d, int s,
                      float inv_t, float beta, void* stream) {
  if (bad_shape(n, d, s)) return -1;
  CeArgs A = {};
  A.own = static_cast<const bf16*>(q);
  A.strm = static_cast<const bf16*>(c);
  A.v = static_cast<const uint8_t*>(v);
  A.lq = static_cast<const float*>(lq);
  A.m = static_cast<const float*>(m);
  A.diag = static_cast<const float*>(diag);
  A.ce = static_cast<float*>(ce);
  A.lse_out = static_cast<float*>(lse_out);
  A.rank = static_cast<int*>(rank);
  A.n = n, A.s = s, A.inv_t = inv_t, A.beta = beta;
  return dispatch_tile<FWD>(A, d, static_cast<cudaStream_t>(stream));
}

static int ce_grad(int kind, const void* q, const void* c, const void* v, const void* lq,
                   const void* lse, const void* dce, void* grad, int n, int d, int s, float inv_t,
                   float beta, void* stream) {
  if (bad_shape(n, d, s)) return -1;
  CeArgs A = {};
  A.own = static_cast<const bf16*>(kind == DQ ? q : c);
  A.strm = static_cast<const bf16*>(kind == DQ ? c : q);
  A.v = static_cast<const uint8_t*>(v);
  A.lq = static_cast<const float*>(lq);
  A.lse = static_cast<const float*>(lse);
  A.dce = static_cast<const float*>(dce);
  A.grad = static_cast<bf16*>(grad);
  A.n = n, A.s = s, A.inv_t = inv_t, A.beta = beta;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kind == DQ ? dispatch_tile<DQ>(A, d, st) : dispatch_tile<DC>(A, d, st);
}

extern "C" int ce_dq(const void* q, const void* c, const void* v, const void* lq, const void* lse,
                     const void* dce, void* dq, int n, int d, int s, float inv_t, float beta,
                     void* stream) {
  return ce_grad(DQ, q, c, v, lq, lse, dce, dq, n, d, s, inv_t, beta, stream);
}

extern "C" int ce_dc(const void* q, const void* c, const void* v, const void* lq, const void* lse,
                     const void* dce, void* dc, int n, int d, int s, float inv_t, float beta,
                     void* stream) {
  return ce_grad(DC, q, c, v, lq, lse, dce, dc, n, d, s, inv_t, beta, stream);
}
