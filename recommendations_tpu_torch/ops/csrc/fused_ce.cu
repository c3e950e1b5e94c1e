// Fused in-batch contrastive cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the four TPU kernels of recommendations_tpu/ops/fused_ce.py:
//   ce_row_diag  <- _row_diag_kernel  diag[i] = q_i.c_i * inv_t where v[i], else -1e9,
//                                     and the shift m below
//   ce_fwd       <- _ce_fwd_kernel    ce, rank and the backward's lse per row
//   ce_dq        <- _ce_dq_kernel     dq = sum_j bf16(g[i, j]) c_j
//   ce_dc        <- _ce_dc_kernel     dc = sum_i bf16(g[i, j]) q_i
// over the (N, N) plane of logits = q.c^T * inv_t, without ever storing it:
//   masked[i, j] = (i/s == j/s and i != j) or not v[j] or j >= n
//   logit        = masked ? -1e9 : q_i.c_j * inv_t        (f32 product of bf16)
//   adj          = i == j ? logit : logit - beta * lq[j]
//   lse_i        = m + log(sum_j exp(adj - m)),  m = (inv_t + beta * max|lq|) + 1
//   ce_i         = lse_i - diag_i;  the backward's residual is ce_i + diag_i
//   rank_i       = #{j != i : logit[i, j] > diag_i}
//   g[i, j]      = (p - [i == j]) * dce_i * inv_t,  p = exp(adj - lse_i), or 0
//                  where lse_i <= -1e8 (padded or fully masked rows)
// ce_row_diag forms m (and diag) in one launch; ce_fwd reads both from device
// memory.
//
// The rounded case (ce_row_diag_rounded, ce_fwd_rounded, ce_dq_rounded,
// ce_dc_rounded; the kernels' ROUND_S, built from fused_ce_rounded.cu, which
// includes this file with CE_ROUNDED defined, as a library of its own, so a
// process compiles only the case it launches): the same function with the product
// q_i.c_j stored in bf16 before the float32 scale by inv_t, as the JAX
// package's unfused _ce_core stores its GEMM output:
//   logit        = masked ? -1e9 : f32(bf16(q_i.c_j)) * inv_t
//   diag_i       = f32(bf16(q_i.c_i)) * inv_t where v[i], else -1e9
// Every use of a tile's S (the sums, the rank compares, the diagonal's own
// term, p in both gradients) rounds the f32 accumulator to bf16 (to nearest
// even) and widens it first, a pair of logits at a time (one cvt.rn.bf16x2.f32
// and two integer operations); everything after it is the unrounded case's.
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
// Design. All three plane kernels share one layout on Hopper's tensor-core
// path: a block owns 128 own rows (two consumer warpgroups of 64), or 64
// whose stream the two warpgroups split where N / 128 leaves SMs idle; the
// stream rows arrive by TMA in 128-row stages into a 4-deep mbarrier ring;
// S = own.stream^T comes from an SS wgmma; the row terms are folded so that
// a logit away from the users' block diagonal takes an add, an FFMA and an
// exp2. ce_fwd is ce_fwd_tc_kernel (one product a logit: S, then the row
// sums and ranks, the next stage's S running meanwhile), ce_dq and ce_dc
// are ce_grad_tc_kernel (S, then the gradient product). Sums are added in a
// fixed order and no atomics are used, so two runs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float BIG_NEG = -1e9f;    // a masked logit
constexpr float LSE_GUARD = -1e8f;  // rows at or below this lse take p = 0
enum Kind { FWD = 0, DQ = 1, DC = 2 };  // FWD is ce_fwd_tc_kernel; DQ and DC are ce_grad_tc_kernel

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

// S of the rounded case: each of two f32 values rounded to bf16 (to nearest
// even) and widened back to f32
__device__ __forceinline__ void round_bf16x2(float& lo, float& hi) {
  const uint32_t u = pack_bf16(lo, hi);
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

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
// rows and takes all 128 stream rows of every stage. ROUND_S: S rounded to
// bf16 before p is formed (the rounded case).
template <int D, bool SPLIT, int KIND, bool ROUND_S>
__global__ void __launch_bounds__(TC_THREADS, 1)
    ce_grad_tc_kernel(const __grid_constant__ CUtensorMap own_map, const __grid_constant__ CUtensorMap stream_map,
                      const CeArgs A) {
  static_assert(KIND == DC || KIND == DQ, "ce_fwd takes ce_fwd_tc_kernel");
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
      float x[4] = {s[4 * jj], s[4 * jj + 1], s[4 * jj + 2], s[4 * jj + 3]};
      if constexpr (ROUND_S) {
        round_bf16x2(x[0], x[1]);
        round_bf16x2(x[2], x[3]);
      }
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        gv[e] = ex2_approx(fmaf(x[e], k1, ((e & 1) ? t2.y : t2.x) + own_term[r]));
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
            gv[e] = ex2_approx(fmaf(x[e], k1, eye_term[r])) * own_sign[r] - own_a[r];
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

// the registers as written here: no read of them moves above this point, no
// write of them below it
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- ce_fwd on Hopper: S by wgmma from the TMA ring, the row sums beside it --
//
// ce_grad_tc_kernel's layout, ring and shared memory (the own tile, 128-row
// stages by TMA, a warpgroup's stream terms a stage ahead, S by an SS wgmma),
// with the gradient product's place taken by the row sums and ranks. There
// is no gradient product and no D-wide accumulator, so a warpgroup holds two
// S accumulators and issues stage st + 1's S before it forms stage st's sums:
// the tensor cores run while the exponentials do (at one product a logit the
// two weigh about the same).
//
// Arithmetic, the plain version's. Per logit away from the users' block
// diagonal: se_i += exp2(S inv_t log2e + t_j), t_j = -(beta lq_j + m) log2e,
// or -inf where candidate j is invalid or past n (one FFMA and one ex2 toward
// the sum); rank_i += fma(S, inv_t, r_j) > diag_i, r_j = 0, or -inf where j
// is masked: with a zero addend the FFMA rounds once, as the product, so the
// compare is the plain version's logit S * inv_t against diag_i (a masked
// logit, -1e9 there, never exceeds diag_i >= -1e9 either). Only tiles that
// meet a user's block apply the same-user mask and the diagonal's own term
// (exp2(S inv_t log2e - m log2e) where candidate i is valid, no logQ shift,
// and no rank). Each stage's sums are added into the row totals apart, two
// chains a row. At the end lse_i = m + log(sum), ce_i = lse_i - diag_i, and
// the backward's residual ce_i + diag_i.
constexpr int FWD_TURN = 4;  // stages a turn of ce_fwd_tc_kernel's pipeline (even)

// A thread's two own rows in ce_fwd_tc_kernel: diag, the diagonal's term,
// index, and the first row of its user.
struct FwdRows {
  float x[2], eye[2];
  int i[2], lo[2];
};

// One stage's row sums and ranks from its S accumulator (own row g + 8 (e >>
// 1) of the warp's 16, stream column j = jc + 8 jj + (e & 1), jc = the
// stage's first column + 2 c), with the stream terms tm[16 jj + 0..3] =
// {t_j, t_j+1, r_j, r_j+1}. DIAG: the tile meets a user's block. ROUND_S: S
// rounded to bf16 before any use (the rounded case).
template <bool DIAG, int SR, bool ROUND_S>
__device__ __forceinline__ void fwd_stage_sums(const float (&s)[SR / 2], const float* tm, const FwdRows& rows,
                                               int jc, int per_user, float k1, float inv_t, float (&se)[2],
                                               int (&rk)[2]) {
  float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row][jj parity]: two chains a row
#pragma unroll
  for (int jj = 0; jj < SR / 8; ++jj) {
    const float4 tt = *reinterpret_cast<const float4*>(tm + 16 * jj);
    float xs[4] = {s[4 * jj], s[4 * jj + 1], s[4 * jj + 2], s[4 * jj + 3]};
    if constexpr (ROUND_S) {
      round_bf16x2(xs[0], xs[1]);
      round_bf16x2(xs[2], xs[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float x = xs[e];
      float ev = ex2_approx(fmaf(x, k1, (e & 1) ? tt.y : tt.x));
      bool gt = fmaf(x, inv_t, (e & 1) ? tt.w : tt.z) > rows.x[r];
      if constexpr (DIAG) {
        const int j = jc + 8 * jj + (e & 1);
        if (j == rows.i[r]) {
          ev = ex2_approx(fmaf(x, k1, rows.eye[r]));
          gt = false;
        } else if ((unsigned)(j - rows.lo[r]) < (unsigned)per_user) {  // the row's user
          ev = 0.f;
          gt = false;
        }
      }
      part[r][jj & 1] += ev;
      rk[r] += gt ? 1 : 0;
    }
  }
  se[0] += part[0][0] + part[0][1];
  se[1] += part[1][0] + part[1][1];
}

template <int D, bool SPLIT, bool ROUND_S>
__global__ void __launch_bounds__(TC_THREADS, 1)
    ce_fwd_tc_kernel(const __grid_constant__ CUtensorMap own_map, const __grid_constant__ CUtensorMap stream_map,
                     const CeArgs A) {
  constexpr int SR = SPLIT ? TC_STREAM / 2 : TC_STREAM;  // stream rows a warpgroup takes of a stage
  using PN = Panels<D>;
  using SM = GradSmem<D>;
  static_assert(2 * TC_STREAM <= SM::TERM_FLOATS, "a stage's two terms a stream row");
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

  // stages are issued by thread 0, as in ce_grad_tc_kernel
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
    for (int st = 0; st < TC_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * TC_CONSUMERS);
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
  const float m_shift = *A.m;
  // this thread's two own (query) rows, accumulator rows wq*16 + g and + 8
  FwdRows rows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = own0 + 16 * wq + g + 8 * r;
    const bool in = i < n;
    rows.i[r] = i;
    rows.lo[r] = i / A.s * A.s;
    rows.x[r] = in ? A.diag[i] : BIG_NEG;
    rows.eye[r] = (in && A.v[i]) ? -m_shift * LOG2E_F : -INFINITY;
  }
  const float k1 = A.inv_t * LOG2E_F, inv_t = A.inv_t;

  // The stream rows' terms, one row a thread, a stage ahead: a column pair
  // (2x, 2x + 1) at tm[4x..4x + 3] = {t_2x, t_2x+1, r_2x, r_2x+1}
  float* terms = reinterpret_cast<float*>(smem + SM::TERMS) + wg * 2 * SM::TERM_FLOATS;  // [2][TERM_FLOATS]
  float pre_t = -INFINITY, pre_r = -INFINITY;
  auto fetch_terms = [&](int st) {
    const int j = st * TC_STREAM + row0 + tid;
    const bool live = tid < SR && st < n_stages && j < n && A.v[j];
    pre_t = live ? -(A.beta * A.lq[j] + m_shift) * LOG2E_F : -INFINITY;
    pre_r = live ? 0.f : -INFINITY;
  };
  auto store_terms = [&](int buf) {
    float* tm = terms + buf * SM::TERM_FLOATS + 4 * (tid >> 1) + (tid & 1);
    if (tid < SR) tm[0] = pre_t, tm[2] = pre_r;
  };

  const uint32_t own_addr = smem_u32(smem + SM::OWN) + (SPLIT ? 0 : WG_ROWS * wg) * PN::ROW_BYTES;
  constexpr uint32_t PANEL_BYTES = TC_STREAM * PN::ROW_BYTES;
  constexpr uint32_t SBO = 8 * PN::ROW_BYTES;  // 8 rows: one swizzle atom

  // S = own . stream^T of the warpgroup's rows of a stage: 64 own x SR stream
  // rows (past the end: on a stale slot, unread)
  auto issue_s = [&](int st, float (&s)[SR / 2]) {
    const int slot = st % TC_STAGES;
    if (st < n_stages) mbar_wait(&full[slot], (st / TC_STAGES) & 1);
    const uint32_t tile = smem_u32(smem + SM::RING + slot * SM::TILE) + row0 * PN::ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk / PN::K_PER_PANEL) * PANEL_BYTES + (kk % PN::K_PER_PANEL) * 32;
      wgmma_ss<SR>(s, gmma_desc(own_addr + koff, 16, SBO, PN::SWIZZLE),
                   gmma_desc(tile + koff, 16, SBO, PN::SWIZZLE), kk > 0);
    }
    wgmma_commit();
  };
  // a warp is done with stage st's tile: release its slot; the issuer refills it
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % TC_STAGES]);
    if (issuer && st + TC_STAGES < n_stages) {
      mbar_wait(&empty[st % TC_STAGES], (st / TC_STAGES) & 1);
      issue_stage(st + TC_STAGES);
    }
    __syncwarp();
  };
  // the sums and ranks of a stage, into the row totals; the tiles that meet a
  // user's block take a body of their own, so that the others carry none of
  // its compares
  float se[2] = {0.f, 0.f};
  int rk[2] = {0, 0};
  auto sums = [&](int st, int buf, const float (&s)[SR / 2]) {
    const int j0 = st * TC_STREAM + row0;
    const float* tm = terms + buf * SM::TERM_FLOATS + 4 * c;
    if (j0 / A.s <= (own0 + WG_ROWS - 1) / A.s && own0 / A.s <= (j0 + SR - 1) / A.s)
      fwd_stage_sums<true, SR, ROUND_S>(s, tm, rows, j0 + 2 * c, A.s, k1, inv_t, se, rk);
    else
      fwd_stage_sums<false, SR, ROUND_S>(s, tm, rows, j0 + 2 * c, A.s, k1, inv_t, se, rk);
  };

  // The pipeline, FWD_TURN stages a turn: S of the turn's first stage, then
  // for each stage the next one's S (the accumulators sa, sb alternate), the
  // wait for this one's, its tile released, its sums while the next S runs.
  // Every wgmma group is issued and waited for within its turn, the same on
  // every path (a stage past the end is computed on a stale slot and never
  // read): ptxas serializes every wgmma when a group is still in flight
  // where the loop turns, or differs between paths. The register fences
  // keep each read of an accumulator after the wait that completes it.
  mbar_wait(own_bar, 0);
  float sa[SR / 2], sb[SR / 2];
  fetch_terms(0);
  store_terms(0);
  fetch_terms(1);
  wg_bar(1 + wg);  // the first stage's terms are in place
  for (int st0 = 0; st0 < n_stages; st0 += FWD_TURN) {
    fence_regs(sa);
    wgmma_fence();
    issue_s(st0, sa);
#pragma unroll
    for (int k = 0; k < FWD_TURN; ++k) {
      float (&cur)[SR / 2] = (k & 1) ? sb : sa;
      float (&nxt)[SR / 2] = (k & 1) ? sa : sb;
      if (k + 1 < FWD_TURN) {
        fence_regs(nxt);
        wgmma_fence();
        issue_s(st0 + k + 1, nxt);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(cur);
      const int st = st0 + k;  // of the parity of k: FWD_TURN is even
      if (st < n_stages) {
        release(st);
        store_terms((k + 1) & 1);  // the next stage's terms (its buffer was last read a stage ago)
        fetch_terms(st + 2);
        sums(st, k & 1, cur);
        wg_bar(1 + wg);
      }
    }
  }

  // the four lanes of a row add up in a fixed order; with the split,
  // warpgroup 1 hands its sums to warpgroup 0 through shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    se[r] += __shfl_xor_sync(0xffffffffu, se[r], 1);
    se[r] += __shfl_xor_sync(0xffffffffu, se[r], 2);
    rk[r] += __shfl_xor_sync(0xffffffffu, rk[r], 1);
    rk[r] += __shfl_xor_sync(0xffffffffu, rk[r], 2);
  }
  if constexpr (SPLIT) {
    float* red_se = reinterpret_cast<float*>(smem + SM::RED);  // [64]
    int* red_rk = reinterpret_cast<int*>(red_se + WG_ROWS);    // [64]
    if (wg == 1 && c == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        red_se[16 * wq + g + 8 * r] = se[r];
        red_rk[16 * wq + g + 8 * r] = rk[r];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      se[r] += red_se[16 * wq + g + 8 * r];
      rk[r] += red_rk[16 * wq + g + 8 * r];
    }
  }
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rows.i[r];
      if (i >= n) continue;
      const float ce = m_shift + logf(se[r]) - rows.x[r];
      A.ce[i] = ce;
      A.lse_out[i] = ce + rows.x[r];
      A.rank[i] = rk[r];
    }
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

// ce_fwd, ce_dq or ce_dc, or their rounded case: the own-row split where the
// 128-row tiles fill the SMs, else the stream split.
template <int D, int KIND, bool ROUND_S>
int launch_plane(const CeArgs& A, cudaStream_t stream) {
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
  void (*kern)(const CUtensorMap, const CUtensorMap, const CeArgs);
  if constexpr (KIND == FWD) kern = split ? ce_fwd_tc_kernel<D, true, ROUND_S> : ce_fwd_tc_kernel<D, false, ROUND_S>;
  else kern = split ? ce_grad_tc_kernel<D, true, KIND, ROUND_S> : ce_grad_tc_kernel<D, false, KIND, ROUND_S>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(A.n + own_rows - 1) / own_rows, TC_THREADS, smem, stream>>>(own_map, stream_map, A);
  return (int)cudaGetLastError();
}

// ce_row_diag, one launch for both outputs of this step of the CE forward:
//   diag[i] = q_i.c_i * inv_t (an f32 sum of the bf16 products) where v[i], else -1e9
//   m       = (inv_t + beta * max|lq|) + 1, in float32 in that order (JAX forms it
//             beside _row_diag_kernel, at _fwd_impl)
// Bound by bytes: q and c (2 N D bf16), and v, lq and diag (9 N bytes); no
// shared memory, no tensor cores. A thread reads 8 bf16 of q and 8
// of c with one 16-byte load each, so a row is D/8 threads (16 at D = 128, 2
// at D = 16), and each thread issues the loads of RD_ROWS rows before it sums
// any. The grid is one wave at most (the occupancy query times the SMs), and
// its last block forms m alone: it takes no rows and reduces |lq| with
// RD_LQ 16-byte loads a thread in flight (on an H100 it ends before the rows
// do, at N = 8192 and 32768). A thread sums its 8 products in
// order, then the row's threads add by xor shuffles (both partners form the
// same sum), so two runs give the same bits. ROUND_S (the rounded case)
// rounds the row's f32 dot to bf16 before the scale by inv_t.
constexpr int RD_THREADS = 256;
constexpr int RD_ROWS = 4;
constexpr int RD_LQ = 8;

__device__ __forceinline__ float dot8(const uint4 a, const uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;  // a product of two bf16 is exact in f32: the FMA rounds only the sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}

// |x| as bits: for non-negative floats the unsigned order is the float order,
// and a NaN lies above +inf, so an unsigned max propagates NaN as
// torch.amax and jnp.max do (fmaxf would drop it).
__device__ __forceinline__ uint32_t abs_bits(uint32_t x) { return x & 0x7fffffffu; }

__device__ __forceinline__ uint32_t max4(const uint4 x) {
  return max(max(abs_bits(x.x), abs_bits(x.y)), max(abs_bits(x.z), abs_bits(x.w)));
}

// m from all n of lq, by one block. lq is only 4-byte aligned: the scalars
// before its first 16-byte boundary and after its last are read one by one.
__device__ __forceinline__ void lq_shift(const float* __restrict__ lq, float* __restrict__ m, int n,
                                         float inv_t, float beta) {
  __shared__ uint32_t warp_max[RD_THREADS / 32];
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(lq);
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(lq) & 15)) & 15) / 4);
  const int quads = (n - head) / 4;
  const uint4* body = reinterpret_cast<const uint4*>(lq + head);
  uint32_t mx = 0;
  for (int i = threadIdx.x; i < head; i += RD_THREADS) mx = max(mx, abs_bits(__ldg(bits + i)));
  for (int i = head + 4 * quads + threadIdx.x; i < n; i += RD_THREADS) mx = max(mx, abs_bits(__ldg(bits + i)));
  for (int i0 = threadIdx.x; i0 < quads; i0 += RD_LQ * RD_THREADS) {
    uint4 x[RD_LQ];
#pragma unroll
    for (int j = 0; j < RD_LQ; ++j) {
      const int i = i0 + j * RD_THREADS;
      x[j] = i < quads ? __ldg(body + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < RD_LQ; ++j) mx = max(mx, max4(x[j]));
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < RD_THREADS / 32; ++w) mx = max(mx, warp_max[w]);
    // _rn: one rounding an operation, no FMA contraction of beta * max + inv_t
    *m = __fadd_rn(__fadd_rn(inv_t, __fmul_rn(beta, __uint_as_float(mx))), 1.0f);
  }
}

template <int D, bool ROUND_S>
__global__ void __launch_bounds__(RD_THREADS)
    row_diag_kernel(const bf16* __restrict__ q, const bf16* __restrict__ cm, const uint8_t* __restrict__ v,
                    const float* __restrict__ lq, float* __restrict__ diag, float* __restrict__ m, int n,
                    float inv_t, float beta) {
  if (blockIdx.x == gridDim.x - 1) {
    lq_shift(lq, m, n, inv_t, beta);
    return;
  }
  constexpr int LANES = D / 8;                       // threads of one row
  constexpr int SLOTS_PER_BLOCK = RD_THREADS / LANES;  // rows a block reads at once
  const int part = threadIdx.x % LANES;
  const int slot = blockIdx.x * SLOTS_PER_BLOCK + threadIdx.x / LANES;
  const int slots = (gridDim.x - 1) * SLOTS_PER_BLOCK;
  const int warp_slot = slot - (threadIdx.x & 31) / LANES;  // the warp's first: the loop is warp-uniform
  for (int base = 0; warp_slot + base < n; base += RD_ROWS * slots) {
    uint4 a[RD_ROWS], b[RD_ROWS];
    bool ok[RD_ROWS];
#pragma unroll
    for (int k = 0; k < RD_ROWS; ++k) {
      const int row = slot + base + k * slots;
      a[k] = b[k] = make_uint4(0u, 0u, 0u, 0u);
      ok[k] = false;
      if (row < n) {
        a[k] = __ldg(reinterpret_cast<const uint4*>(q + (size_t)row * D) + part);
        b[k] = __ldg(reinterpret_cast<const uint4*>(cm + (size_t)row * D) + part);
        ok[k] = __ldg(v + row) != 0;
      }
    }
#pragma unroll
    for (int k = 0; k < RD_ROWS; ++k) {
      float acc = dot8(a[k], b[k]);
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if constexpr (ROUND_S) acc = __bfloat162float(__float2bfloat16_rn(acc));
      const int row = slot + base + k * slots;
      if (part == 0 && row < n) diag[row] = ok[k] ? acc * inv_t : BIG_NEG;
    }
  }
}

template <int D, bool ROUND_S>
int launch_row_diag(const void* q, const void* c, const void* v, const void* lq, void* diag, void* m, int n,
                    float inv_t, float beta, cudaStream_t stream) {
  static const int per_sm = [] {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, row_diag_kernel<D, ROUND_S>, RD_THREADS, 0);
    return blocks;
  }();
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  constexpr int rows_per_block = RD_THREADS / (D / 8) * RD_ROWS;
  const int row_blocks = max(1, min(per_sm * sms - 1, (n + rows_per_block - 1) / rows_per_block));
  row_diag_kernel<D, ROUND_S><<<row_blocks + 1, RD_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(c), static_cast<const uint8_t*>(v),
      static_cast<const float*>(lq), static_cast<float*>(diag), static_cast<float*>(m), n, inv_t, beta);
  return (int)cudaGetLastError();
}

template <int KIND, bool ROUND_S>
int dispatch(const CeArgs& A, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_plane<16, KIND, ROUND_S>(A, stream);
    case 32: return launch_plane<32, KIND, ROUND_S>(A, stream);
    case 64: return launch_plane<64, KIND, ROUND_S>(A, stream);
    case 128: return launch_plane<128, KIND, ROUND_S>(A, stream);
    default: return -1;
  }
}

bool bad_shape(int n, int d, int s) {
  return n < 1 || s < 1 || !(d == 16 || d == 32 || d == 64 || d == 128);
}

template <bool ROUND_S>
int row_diag(const void* q, const void* c, const void* v, const void* lq, void* diag, void* m, int n, int d,
             float inv_t, float beta, void* stream) {
  if (bad_shape(n, d, 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_row_diag<16, ROUND_S>(q, c, v, lq, diag, m, n, inv_t, beta, st);
    case 32: return launch_row_diag<32, ROUND_S>(q, c, v, lq, diag, m, n, inv_t, beta, st);
    case 64: return launch_row_diag<64, ROUND_S>(q, c, v, lq, diag, m, n, inv_t, beta, st);
    default: return launch_row_diag<128, ROUND_S>(q, c, v, lq, diag, m, n, inv_t, beta, st);
  }
}

template <bool ROUND_S>
int fwd(const void* q, const void* c, const void* v, const void* lq, const void* m, const void* diag, void* ce,
        void* lse_out, void* rank, int n, int d, int s, float inv_t, float beta, void* stream) {
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
  return dispatch<FWD, ROUND_S>(A, d, static_cast<cudaStream_t>(stream));
}

template <int KIND, bool ROUND_S>
int grad(const void* q, const void* c, const void* v, const void* lq, const void* lse, const void* dce, void* out,
         int n, int d, int s, float inv_t, float beta, void* stream) {
  if (bad_shape(n, d, s)) return -1;
  CeArgs A = {};
  A.own = static_cast<const bf16*>(KIND == DQ ? q : c);
  A.strm = static_cast<const bf16*>(KIND == DQ ? c : q);
  A.v = static_cast<const uint8_t*>(v);
  A.lq = static_cast<const float*>(lq);
  A.lse = static_cast<const float*>(lse);
  A.dce = static_cast<const float*>(dce);
  A.grad = static_cast<bf16*>(out);
  A.n = n, A.s = s, A.inv_t = inv_t, A.beta = beta;
  return dispatch<KIND, ROUND_S>(A, d, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Each entry returns 0 on success, cudaGetLastError() after a refused launch,
// or -1 for a shape the kernels do not take (n < 1, s < 1, d not in
// {16, 32, 64, 128}). All pointers are device pointers; q, c (and dq, dc) are
// (n, d) bf16 row-major and 16-byte aligned; v is (n,) bool as bytes; lq,
// diag, lse, dce, ce are (n,) float32, 4-byte aligned; rank is (n,) int32; m is
// one float32. With CE_ROUNDED defined (fused_ce_rounded.cu) the file gives
// the *_rounded entries instead: each takes its unrounded entry's arguments
// and launches the rounded case.

#ifndef CE_ROUNDED

extern "C" int ce_row_diag(const void* q, const void* c, const void* v, const void* lq, void* diag, void* m,
                           int n, int d, float inv_t, float beta, void* stream) {
  return row_diag<false>(q, c, v, lq, diag, m, n, d, inv_t, beta, stream);
}

extern "C" int ce_fwd(const void* q, const void* c, const void* v, const void* lq, const void* m,
                      const void* diag, void* ce, void* lse_out, void* rank, int n, int d, int s,
                      float inv_t, float beta, void* stream) {
  return fwd<false>(q, c, v, lq, m, diag, ce, lse_out, rank, n, d, s, inv_t, beta, stream);
}

extern "C" int ce_dq(const void* q, const void* c, const void* v, const void* lq, const void* lse,
                     const void* dce, void* dq, int n, int d, int s, float inv_t, float beta,
                     void* stream) {
  return grad<DQ, false>(q, c, v, lq, lse, dce, dq, n, d, s, inv_t, beta, stream);
}

extern "C" int ce_dc(const void* q, const void* c, const void* v, const void* lq, const void* lse,
                     const void* dce, void* dc, int n, int d, int s, float inv_t, float beta,
                     void* stream) {
  return grad<DC, false>(q, c, v, lq, lse, dce, dc, n, d, s, inv_t, beta, stream);
}

#else

extern "C" int ce_row_diag_rounded(const void* q, const void* c, const void* v, const void* lq, void* diag,
                                   void* m, int n, int d, float inv_t, float beta, void* stream) {
  return row_diag<true>(q, c, v, lq, diag, m, n, d, inv_t, beta, stream);
}

extern "C" int ce_fwd_rounded(const void* q, const void* c, const void* v, const void* lq, const void* m,
                              const void* diag, void* ce, void* lse_out, void* rank, int n, int d, int s,
                              float inv_t, float beta, void* stream) {
  return fwd<true>(q, c, v, lq, m, diag, ce, lse_out, rank, n, d, s, inv_t, beta, stream);
}

extern "C" int ce_dq_rounded(const void* q, const void* c, const void* v, const void* lq, const void* lse,
                             const void* dce, void* dq, int n, int d, int s, float inv_t, float beta,
                             void* stream) {
  return grad<DQ, true>(q, c, v, lq, lse, dce, dq, n, d, s, inv_t, beta, stream);
}

extern "C" int ce_dc_rounded(const void* q, const void* c, const void* v, const void* lq, const void* lse,
                             const void* dce, void* dc, int n, int d, int s, float inv_t, float beta,
                             void* stream) {
  return grad<DC, true>(q, c, v, lq, lse, dce, dc, n, d, s, inv_t, beta, stream);
}

#endif  // CE_ROUNDED
