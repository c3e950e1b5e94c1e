// The CE kernels' rounded case (ROUND_S: the logits stored in bf16 before the
// scale by inv_t) as a library of its own: fused_ce.cu with CE_ROUNDED
// defined, whose C entries are then ce_row_diag_rounded, ce_fwd_rounded,
// ce_dq_rounded and ce_dc_rounded. A process that launches one case compiles
// only that case's instantiations.
#define CE_ROUNDED
#include "fused_ce.cu"
