"""recommendations_tpu_torch — the PyTorch and CUDA port of ``recommendations_tpu``.

The JAX package stays beside this one as the reference. This package imports
``torch``, ``numpy`` and the standard library only, never JAX or the JAX
package. Its kernels are CUDA C++ written by hand for Hopper (sm_90a), built
from ``ops/csrc`` at first use; each has a plain PyTorch version that runs
when the tensors lie on the CPU.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise instead of running on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when it asks for a card that
    is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
