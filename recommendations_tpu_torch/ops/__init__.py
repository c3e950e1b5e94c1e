"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""

# registers the flash-attention operators, which a loaded torch.export
# program of the LTHM encoder calls
from recommendations_tpu_torch.ops import fused_attention  # noqa: F401,E402
