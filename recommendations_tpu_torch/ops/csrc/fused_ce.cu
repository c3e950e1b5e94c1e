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
// Design of ce_fwd (ce_tile; ce_dq and ce_dc share their own wgmma kernel,
// see ce_grad_tc_kernel below). A block owns 64 query rows and walks every
// candidate row (the stream) in stages of 128 rows, double-buffered in shared
// memory with cp.async. Eight warps: four row groups of 16 own rows times two
// halves of each stage. The own rows are the A operand of mma.sync.m16n8k16,
// held in registers; S = own.stream^T runs on the tensor cores with B read by
// ldmatrix; the masks come from the indices and per-row metadata (user,
// validity, -beta*lq, diag) staged beside each stage. The two halves of a row
// group add their sums in a fixed order at the end: no atomics, so two runs
// give the same bits. N = 8192 gives 128 blocks of 8 warps for 132 SMs, one
// wave; the column split is inside the block, so it needs no second pass. The
// forward does one product a logit, against the backward's two, so it has no
// wgmma or TMA yet.

#include <cuda.h>
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

enum Kind { FWD = 0, DQ = 1, DC = 2 };  // ce_tile takes FWD; DQ and DC are ce_grad_tc_kernel

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
// t % 8 of matrix t / 8; lane gets M[g][2c..2c+1] of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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
// past n; x = diag[i] (-1e9 past n).
template <bool CANDIDATE>
__device__ __forceinline__ void row_meta(const CeArgs& A, int t, int& u, float& x) {
  const bool in = t < A.n;
  if constexpr (CANDIDATE) {
    u = (in && A.v[t]) ? t / A.s : -1;
    x = in ? -(A.beta * A.lq[t]) : 0.f;
  } else {
    u = in ? t / A.s : -1;
    x = in ? A.diag[t] : BIG_NEG;
  }
}

// The body of ce_fwd_kernel: one block, 64 own (query) rows against every
// stream (candidate) row.
template <int D>
__device__ __forceinline__ void ce_tile(const CeArgs& A) {
  constexpr int LD = D + PAD;
  constexpr int KK = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);  // [2][STAGE_ROWS][LD]
  int* s_user = reinterpret_cast<int*>(smem + (size_t)2 * STAGE_ROWS * LD * sizeof(bf16));
  float* s_x = reinterpret_cast<float*>(s_user + 2 * STAGE_ROWS);  // [2][STAGE_ROWS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int rg = warp % ROW_GROUPS, half = warp / ROW_GROUPS;
  const int n = A.n;
  const int own0 = blockIdx.x * OWN_ROWS + rg * 16;
  const int own_i[2] = {own0 + g, own0 + g + 8};

  uint32_t a[KK][4];
  load_a<D>(a, A.own + (size_t)own0 * D, n - own0, g, c);
  int own_u[2];
  float own_x[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_meta<false>(A, own_i[r], own_u[r], own_x[r]);

  const float inv_t = A.inv_t;
  const float m_shift = *A.m;
  float se[2] = {0.f, 0.f};
  int rk[2] = {0, 0};

  const int stages = (n + STAGE_ROWS - 1) / STAGE_ROWS;
  load_stage<D>(tiles, A.strm, 0, n);
  cp_async_commit();
  if (threadIdx.x < STAGE_ROWS) {
    int u;
    float x;
    row_meta<true>(A, threadIdx.x, u, x);
    s_user[threadIdx.x] = u, s_x[threadIdx.x] = x;
  }

  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    const bool more = st + 1 < stages;
    if (more) load_stage<D>(tiles + (size_t)(buf ^ 1) * STAGE_ROWS * LD, A.strm, (st + 1) * STAGE_ROWS, n);
    cp_async_commit();
    int nu = -1;
    float nx = 0.f;
    if (more && threadIdx.x < STAGE_ROWS) row_meta<true>(A, (st + 1) * STAGE_ROWS + threadIdx.x, nu, nx);
    cp_async_wait_one();
    __syncthreads();

    const int t0 = st * STAGE_ROWS + half * SUB;  // the warp's first stream row
    if (t0 < n) {
      const bf16* tile = tiles + (size_t)buf * STAGE_ROWS * LD + (size_t)half * SUB * LD;
      const int* su = s_user + buf * STAGE_ROWS + half * SUB;
      const float* sx = s_x + buf * STAGE_ROWS + half * SUB;

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
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int nt = 2 * ks + h2;
          const int tl = nt * 8 + 2 * c;
          const int2 uu = *reinterpret_cast<const int2*>(su + tl);
          const float2 xx = *reinterpret_cast<const float2*>(sx + tl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int t = t0 + tl + (e & 1);
            const int us = (e & 1) ? uu.y : uu.x;
            const float xs = (e & 1) ? xx.y : xx.x;
            const bool eye = own_i[r] == t;
            const bool masked = us < 0 || (us == own_u[r] && !eye);
            const float logit = masked ? BIG_NEG : sacc[nt][e] * inv_t;
            const float adj = eye ? logit : logit + xs;
            se[r] += __expf(adj - m_shift);
            rk[r] += (!eye && logit > own_x[r]) ? 1 : 0;
          }
        }
      }
    }

    if (more && threadIdx.x < STAGE_ROWS) {
      const int at = (buf ^ 1) * STAGE_ROWS + threadIdx.x;
      s_user[at] = nu, s_x[at] = nx;
    }
    __syncthreads();
  }

  // the two halves of each row group add up in a fixed order: half 1 hands its
  // sums to half 0 through shared memory (the stage tiles are free now)
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
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) ce_fwd_kernel(const CeArgs A) { ce_tile<D>(A); }

// ---- ce_dq and ce_dc on Hopper: wgmma, a TMA ring, two consumer warpgroups --
//
// dc = sum_i bf16(g[i, j]) q_i has the structure of flash attention's forward
// with the softmax known in advance: per stream tile (query rows i), S =
// own.stream^T (own = candidate rows j) and then dc += G.stream, G made from
// S in registers. dq = sum_j bf16(g[i, j]) c_j is the same with the roles
// swapped: own = query rows i, stream = candidate rows j. At D = 128 each
// logit costs 256 tensor-core MACs against one exponential, so the products
// bind, and only wgmma reaches the dense tensor-core rate (mma.sync does not).
// One kernel template, ce_grad_tc_kernel<D, SPLIT, KIND>, serves both roles.
//
// Design. A block owns 128 own rows (two warpgroups of 64) or, where that
// leaves SMs idle (N / 128 below the SM count: LTHM-base's N = 8192), 64
// rows whose stream the two warpgroups split, each taking 64 rows of every
// stage (S by m64n64k16 then) and adding their sums at the end in a fixed
// order. The stream rows arrive by TMA in stages of
// 128 rows into a 4-deep ring of shared memory (128-byte swizzled panels of
// 64 columns), signalled by mbarriers; one thread of a warpgroup issues a
// stage's copy when all 8 warps have released its slot. (No producer warp:
// a block of 256 threads may give each 255 registers, and the pipeline below
// needs about 220.) Per stage: S by an SS wgmma (m64n128k16:
// the own tile and the stage, both K-major); g = bf16(exp2(S * inv_t * log2e
// + term_i + term_j)) straight from the accumulator registers, which is the
// A fragment of the gradient product, an RS wgmma (m64nDk16) whose B is the
// same staged tile read N-major (the transpose bit), so no transposed copy is
// staged. The stages run as a pipeline: while one stage's gradient product
// runs on the tensor cores, the next stage's S is ready and its g is formed;
// each warpgroup computes its stages' row terms itself, a stage ahead. The
// gradient product accumulates in place over the whole stream, in f32.
//
// Arithmetic, the plain version's: the per-row terms fold in the mask of an
// invalid candidate (term_j = -inf), the logQ shift (term_j = -beta lq_j
// log2e), the LSE_GUARD rows and the weight dce * inv_t (term_i =
// log2|dce_i inv_t| - lse_i log2e, or -inf; its sign apart), so that a tile
// away from the users' block diagonal takes one add, one FFMA and one exp2 a
// logit and no compare (but a sign where a weight is negative); only
// tiles that meet a user's block (1 in 8 at s = 1024) apply the same-user
// mask and the diagonal's own term, g_ii = p_ii dce_i inv_t - dce_i inv_t
// (p_ii without the logQ shift, 0 where candidate i is invalid).
// The roles differ only in which side holds which term: for ce_dc the own
// rows (candidates j) hold term_j and the stream rows term_i with the
// weight's sign (a stage with a negative weight multiplies by it); for
// ce_dq the own rows (queries i) hold term_i and its sign (a warp whose rows
// have a negative weight multiplies by it), the stream rows term_j. The
// diagonal term and the same-user mask are symmetric.
// g rounds to bf16 before the product and the gradient once at the end. No
// atomics: two runs give the same bits.

constexpr int WG_ROWS = 64;               // own rows of a consumer warpgroup
constexpr int TC_STREAM = 128;            // stream rows a stage
constexpr int TC_STAGES = 4;              // stages in the ring
constexpr int TC_CONSUMERS = 2;           // consumer warpgroups
constexpr int TC_THREADS = 128 * TC_CONSUMERS;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (ex2.approx: 2 ulp; -inf gives 0)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// rows [c1, c1 + box rows) x columns [c0, c0 + box columns) of a 2D tensor
// map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units) and the swizzle (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

// d (+)= A.B^T: A (64 x 16) and B (64 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A.B^T: A (64 x 16) and B (128 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A.B: A (64 x 16) in registers, B (16 x 16) N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A.B: A (64 x 16) in registers, B (16 x 32) N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A.B: A (64 x 16) in registers, B (16 x 64) N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A.B: A (64 x 16) in registers, B (16 x 128) N-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// A staged matrix of D bf16 columns is held as D / P panels of P columns
// (P = min(D, 64), a row of a panel = one swizzle row of 2P bytes), each
// panel `rows` rows deep: the layout TMA writes with the matching swizzle
// and wgmma reads both K-major (rows as M or N) and N-major (rows as K).
template <int D> struct Panels {
  static constexpr int P = D < 64 ? D : 64;
  static constexpr int ROW_BYTES = 2 * P;
  static constexpr int SWIZZLE = P == 64 ? 1 : P == 32 ? 2 : 3;
  static constexpr int K_PER_PANEL = P / 16;  // k16 slices in a panel row
};

// Shared memory of ce_grad_tc_kernel (from a 1024-byte aligned base): the own
// tile (128 rows), the ring of stages, each warpgroup's stream terms (two
// stages' worth: terms, and for ce_dc signs and per-warp negative-weight
// flags), the stream-split reduction buffer (64 x D f32), and the mbarriers.
template <int D> struct GradSmem {
  static constexpr int TILE = TC_STREAM * D * 2;  // one staged 128-row tile
  static constexpr int OWN = 0;
  static constexpr int RING = OWN + TILE;
  static constexpr int TERMS = RING + TC_STAGES * TILE;
  static constexpr int TERM_FLOATS = 2 * TC_STREAM + 4;  // a stage's terms, signs, flags
  static constexpr int RED = TERMS + TC_CONSUMERS * 2 * TERM_FLOATS * 4;
  static constexpr int BARS = RED + WG_ROWS * D * 4;
  static constexpr int TOTAL = BARS + (2 * TC_STAGES + 1) * 8;
  static constexpr int ALLOC = TOTAL + 1024;  // room to align the base
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db, int acc) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db, acc);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db, acc);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db, acc);
  else wgmma_rs_n128(d, a, db, acc);
}

__device__ __forceinline__ void wg_bar(int id) {  // the 128 threads of one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// KIND: DC (own = candidates, stream = queries) or DQ (own = queries, stream
// = candidates). SPLIT: the two warpgroups share 64 own rows and take 64
// stream rows of each stage each; otherwise each owns 64 of the block's 128
// rows and takes all 128 stream rows of every stage.
template <int D, bool SPLIT, int KIND>
__global__ void __launch_bounds__(TC_THREADS, 1)
    ce_grad_tc_kernel(const __grid_constant__ CUtensorMap own_map, const __grid_constant__ CUtensorMap stream_map,
                      const CeArgs A) {
  static_assert(KIND == DC || KIND == DQ, "ce_fwd takes ce_tile");
  constexpr int SR = SPLIT ? TC_STREAM / 2 : TC_STREAM;  // stream rows a warpgroup takes of a stage
  using PN = Panels<D>;
  using SM = GradSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::BARS);
  uint64_t* empty = full + TC_STAGES;
  uint64_t* own_bar = empty + TC_STAGES;

  const int n = A.n;
  const int own_rows = SPLIT ? WG_ROWS : TC_CONSUMERS * WG_ROWS;
  const int own_base = blockIdx.x * own_rows;
  const int n_stages = (n + TC_STREAM - 1) / TC_STREAM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3, tid = threadIdx.x & 127;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = SPLIT ? SR * wg : 0;  // the warpgroup's first stream row of a stage
  constexpr float LOG2E_F = 1.4426950408889634f;

  // Stages are issued by thread 0 of warpgroup 0: the first TC_STAGES at the
  // start, then stage st + TC_STAGES when stage st's slot is released by
  // every warp (both warpgroups read every stage).
  const bool issuer = threadIdx.x == 0;
  auto issue_stage = [&](int st) {
    const int slot = st % TC_STAGES;
    mbar_expect_tx(&full[slot], (uint32_t)SM::TILE);
    for (int p = 0; p < D / PN::P; ++p)
      tma_load_2d(smem + SM::RING + slot * SM::TILE + p * TC_STREAM * PN::ROW_BYTES, &stream_map, p * PN::P,
                  st * TC_STREAM, &full[slot]);
    mbar_arrive(&full[slot]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);                              // the issuer (and the TMA bytes)
      mbar_init(&empty[s], 4 * TC_CONSUMERS);  // each warp
    }
    mbar_init(own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(own_bar, (uint32_t)SM::TILE);
    for (int p = 0; p < D / PN::P; ++p)
      tma_load_2d(smem + SM::OWN + p * TC_STREAM * PN::ROW_BYTES, &own_map, p * PN::P, own_base, own_bar);
    mbar_arrive(own_bar);
  }
  if (issuer)
    for (int st = 0; st < n_stages && st < TC_STAGES; ++st) issue_stage(st);

  const int own0 = own_base + (SPLIT ? 0 : WG_ROWS * wg);  // the warpgroup's first own row
  // this thread's two own rows (accumulator rows wq*16 + g and + 8): their
  // off-diagonal term (ce_dc: the candidate's, ce_dq: the query's), diagonal
  // term, weight, its sign, and user
  float own_term[2], eye_term[2], own_a[2], own_sign[2];
  int own_j[2], own_u[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = own0 + 16 * wq + g + 8 * r;
    own_j[r] = j;
    own_u[r] = j / A.s;
    const bool in = j < n, valid = in && A.v[j];
    if constexpr (KIND == DC) {
      own_term[r] = valid ? -(A.beta * A.lq[j]) * LOG2E_F : -INFINITY;
      own_a[r] = in ? A.dce[j] * A.inv_t : 0.f;
      own_sign[r] = own_a[r] < 0.f ? -1.f : 1.f;
      eye_term[r] = (valid && A.lse[j] > LSE_GUARD) ? log2f(fabsf(own_a[r])) - A.lse[j] * LOG2E_F : -INFINITY;
    } else {
      own_a[r] = in ? A.dce[j] * A.inv_t : 0.f;
      own_sign[r] = own_a[r] < 0.f ? -1.f : 1.f;
      own_term[r] = (in && A.lse[j] > LSE_GUARD) ? log2f(fabsf(own_a[r])) - A.lse[j] * LOG2E_F : -INFINITY;
      eye_term[r] = valid ? own_term[r] : -INFINITY;
    }
  }
  // ce_dq: a warp one of whose own rows has a negative weight applies the signs
  const bool own_neg = KIND == DQ && __any_sync(0xffffffffu, own_a[0] < 0.f || own_a[1] < 0.f);
  const float k1 = A.inv_t * LOG2E_F;

  // The stream rows' terms, computed by the warpgroup itself for its rows,
  // one row a thread, a stage ahead. ce_dc: log2|dce_i inv_t| - lse_i log2e,
  // or -inf past n and on LSE_GUARD rows (p = 0 there); the weight's sign
  // apart, and a flag for a stage with a negative weight. ce_dq: -beta lq_j
  // log2e, or -inf past n and where candidate j is invalid.
  float* terms = reinterpret_cast<float*>(smem + SM::TERMS) + wg * 2 * SM::TERM_FLOATS;  // [2][TERM_FLOATS]
  float pre_lse = BIG_NEG, pre_a = 0.f;  // ce_dq: the term itself in pre_lse
  auto fetch_terms = [&](int st) {
    const int i = st * TC_STREAM + row0 + tid;
    const bool in = tid < SR && st < n_stages && i < n;
    if constexpr (KIND == DC) {
      pre_lse = in ? A.lse[i] : BIG_NEG;
      pre_a = in ? A.dce[i] * A.inv_t : 0.f;
    } else {
      pre_lse = (in && A.v[i]) ? -(A.beta * A.lq[i]) * LOG2E_F : -INFINITY;
    }
  };
  auto store_terms = [&](int buf) {
    float* tm = terms + buf * SM::TERM_FLOATS;
    if constexpr (KIND == DC) {
      if (tid < SR) {
        tm[tid] = pre_lse > LSE_GUARD ? log2f(fabsf(pre_a)) - pre_lse * LOG2E_F : -INFINITY;
        tm[TC_STREAM + tid] = pre_a < 0.f ? -1.f : 1.f;
      }
      const bool neg = __any_sync(0xffffffffu, pre_a < 0.f);
      if (lane == 0) tm[2 * TC_STREAM + wq] = neg ? 1.f : 0.f;
    } else {
      if (tid < SR) tm[tid] = pre_lse;
    }
  };

  const uint32_t own_addr = smem_u32(smem + SM::OWN) + (SPLIT ? 0 : WG_ROWS * wg) * PN::ROW_BYTES;
  constexpr uint32_t PANEL_BYTES = TC_STREAM * PN::ROW_BYTES;
  constexpr uint32_t SBO = 8 * PN::ROW_BYTES;  // 8 rows: one swizzle atom

  // S = own . stream^T of the warpgroup's rows of a stage: 64 own x SR stream rows
  float s[SR / 2];
  auto issue_s = [&](int st) {
    const int slot = st % TC_STAGES;
    mbar_wait(&full[slot], (st / TC_STAGES) & 1);
    const uint32_t tile = smem_u32(smem + SM::RING + slot * SM::TILE) + row0 * PN::ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk / PN::K_PER_PANEL) * PANEL_BYTES + (kk % PN::K_PER_PANEL) * 32;
      wgmma_ss<SR>(s, gmma_desc(own_addr + koff, 16, SBO, PN::SWIZZLE),
                   gmma_desc(tile + koff, 16, SBO, PN::SWIZZLE), kk > 0);
    }
    wgmma_commit();
  };
  // g from S: the accumulator (own row wq*16 + g + 8 (e >> 1), stream column
  // 8 jj + 2 c + (e & 1)) is the A fragment of the gradient product
  auto make_g = [&](int st, int buf, uint32_t (&ga)[SR / 16][4]) {
    const int i0 = st * TC_STREAM + row0;
    const float* tm = terms + buf * SM::TERM_FLOATS;
    const float* fl = tm + 2 * TC_STREAM;
    // a negative weight here: ce_dc, on a stream row of the stage
    const bool neg = KIND == DC && (fl[0] != 0.f || fl[1] != 0.f || fl[2] != 0.f || fl[3] != 0.f);
    const bool diag_tile = i0 / A.s <= (own0 + WG_ROWS - 1) / A.s && own0 / A.s <= (i0 + SR - 1) / A.s;
#pragma unroll
    for (int jj = 0; jj < SR / 8; ++jj) {
      const float2 t2 = *reinterpret_cast<const float2*>(tm + 8 * jj + 2 * c);
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        gv[e] = ex2_approx(fmaf(s[4 * jj + e], k1, ((e & 1) ? t2.y : t2.x) + own_term[r]));
      }
      if (neg) {
        const float2 sg = *reinterpret_cast<const float2*>(tm + TC_STREAM + 8 * jj + 2 * c);
        gv[0] *= sg.x, gv[1] *= sg.y, gv[2] *= sg.x, gv[3] *= sg.y;
      }
      if (own_neg) {
        gv[0] *= own_sign[0], gv[1] *= own_sign[0], gv[2] *= own_sign[1], gv[3] *= own_sign[1];
      }
      if (diag_tile) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, i = i0 + 8 * jj + 2 * c + (e & 1);
          if (i == own_j[r])
            gv[e] = ex2_approx(fmaf(s[4 * jj + e], k1, eye_term[r])) * own_sign[r] - own_a[r];
          else if (i / A.s == own_u[r])
            gv[e] = 0.f;
        }
      }
      // n8 block jj is k columns 8 (jj & 1) .. of k16 slice jj / 2
      ga[jj >> 1][(jj & 1) * 2] = pack_bf16(gv[0], gv[1]);
      ga[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(gv[2], gv[3]);
    }
  };
  // grad += G . stream: B = the stage's rows, 16 at a time, read N-major
  float total[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) total[e] = 0.f;
  auto issue_gq = [&](int st, const uint32_t (&ga)[SR / 16][4]) {
    const uint32_t tile = smem_u32(smem + SM::RING + (st % TC_STAGES) * SM::TILE) + row0 * PN::ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < SR / 16; ++kk)
      wgmma_rs<D>(total, ga[kk], gmma_desc(tile + 16 * kk * PN::ROW_BYTES, PANEL_BYTES, SBO, PN::SWIZZLE), 1);
    wgmma_commit();
  };
  // a warp is done with stage st: release its slot; the issuer refills it
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % TC_STAGES]);
    if (issuer && st + TC_STAGES < n_stages) {
      mbar_wait(&empty[st % TC_STAGES], (st / TC_STAGES) & 1);
      issue_stage(st + TC_STAGES);
    }
    __syncwarp();  // the warp meets again before the next aligned instruction
  };

  // The pipeline, one stage at a time: while the gradient product of stage
  // st runs on the tensor cores, S of the next stage is ready and its g is
  // formed (two A fragments, one per stage parity, so that neither is
  // written while a product reads it).
  mbar_wait(own_bar, 0);
  uint32_t ga0[SR / 16][4], ga1[SR / 16][4];
  fetch_terms(0);
  store_terms(0);
  fetch_terms(1);
  wg_bar(1 + wg);  // the first stage's terms are in place
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  for (int st = 0; st < n_stages; st += 2) {
    // an even stage of the warpgroup: fragments ga0, terms buffer 0
    make_g(st, 0, ga0);
    store_terms(1);  // the next stage's terms (buffer 1 was last read a stage ago)
    fetch_terms(st + 2);
    wgmma_fence();
    if (st + 1 < n_stages) issue_s(st + 1);
    issue_gq(st, ga0);
    wgmma_wait<1>();  // S of the next stage is ready; this stage's product may run on
    if (st > 0) release(st - 1);  // its product completed in the wait above
    wg_bar(1 + wg);
    if (st + 1 >= n_stages) break;
    // an odd stage: fragments ga1, terms buffer 1
    make_g(st + 1, 1, ga1);
    store_terms(0);
    fetch_terms(st + 3);
    wgmma_fence();
    if (st + 2 < n_stages) issue_s(st + 2);
    issue_gq(st + 1, ga1);
    wgmma_wait<1>();
    release(st);
    wg_bar(1 + wg);
  }
  wgmma_wait<0>();
  release(n_stages - 1);

  // the gradient rounded to bf16 once; with the split, warpgroup 1 hands its sums to
  // warpgroup 0 through shared memory, which adds them in a fixed order
  float* red = reinterpret_cast<float*>(smem + SM::RED);
  if constexpr (SPLIT) {
    if (wg == 1) {
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(red + (16 * wq + g + 8 * r) * D + 8 * jj + 2 * c) =
              make_float2(total[4 * jj + 2 * r], total[4 * jj + 2 * r + 1]);
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 o = *reinterpret_cast<const float2*>(red + (16 * wq + g + 8 * r) * D + 8 * jj + 2 * c);
        total[4 * jj + 2 * r] += o.x;
        total[4 * jj + 2 * r + 1] += o.y;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = own_j[r];
    if (j >= n) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(A.grad + (size_t)j * D + 8 * jj + 2 * c) =
          pack_bf16(total[4 * jj + 2 * r], total[4 * jj + 2 * r + 1]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (n, D) bf16 rows as a tensor map of 128-row boxes of P columns, swizzled
// as the panels; rows past n read as zeros
template <int D>
int row_map(CUtensorMap* map, const bf16* base, int n) {
  using PN = Panels<D>;
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return -2;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)PN::P, (cuuint32_t)TC_STREAM};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle sw = PN::P == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : PN::P == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// ce_dq or ce_dc: the own-row split where the 128-row tiles fill the SMs, else
// the stream split.
template <int D, int KIND>
int launch_grad(const CeArgs& A, cudaStream_t stream) {
  CUtensorMap own_map, stream_map;
  int rc = row_map<D>(&own_map, A.own, A.n);
  if (!rc) rc = row_map<D>(&stream_map, A.strm, A.n);
  if (rc) return rc;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const bool split = (A.n + TC_CONSUMERS * WG_ROWS - 1) / (TC_CONSUMERS * WG_ROWS) < sms;
  const int own_rows = split ? WG_ROWS : TC_CONSUMERS * WG_ROWS;
  constexpr int smem = GradSmem<D>::ALLOC;
  void (*kern)(const CUtensorMap, const CUtensorMap, const CeArgs) =
      split ? ce_grad_tc_kernel<D, true, KIND> : ce_grad_tc_kernel<D, false, KIND>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(A.n + own_rows - 1) / own_rows, TC_THREADS, smem, stream>>>(own_map, stream_map, A);
  return (int)cudaGetLastError();
}

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
int launch(const CeArgs& A, cudaStream_t stream) {
  if constexpr (KIND != FWD) {
    return launch_grad<D, KIND>(A, stream);
  } else {
    constexpr size_t smem =
        (size_t)2 * STAGE_ROWS * (D + PAD) * sizeof(bf16) + (size_t)2 * STAGE_ROWS * 2 * 4;
    cudaError_t e = cudaFuncSetAttribute(ce_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ce_fwd_kernel<D><<<(A.n + OWN_ROWS - 1) / OWN_ROWS, THREADS, smem, stream>>>(A);
    return (int)cudaGetLastError();
  }
}

template <int KIND>
int dispatch(const CeArgs& A, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, KIND>(A, stream);
    case 32: return launch<32, KIND>(A, stream);
    case 64: return launch<64, KIND>(A, stream);
    case 128: return launch<128, KIND>(A, stream);
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
  return dispatch<FWD>(A, d, static_cast<cudaStream_t>(stream));
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
  return kind == DQ ? dispatch<DQ>(A, d, st) : dispatch<DC>(A, d, st);
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
